"""Checkpointing must be ~free on the happy path: the measurement, the
counterpart of the JAX package's resilience/overhead.py.

``measure_resume_overhead`` fabricates a small synthetic cohort, runs
the port's full ``run_cohortdepth`` path three ways — plain,
checkpointing into a fresh store, and resuming a fully-committed store —
and reports the checkpointed/plain overhead fraction, on ``device``
(the card unless the caller asks for the CPU; the BAM cohort takes the
hybrid host engine wherever the native library loads, as in
``cohortdepth``).

Best-of-N timing on every leg; the fixture is sized so per-region
journal fsyncs and column pickles are amortized the way a real run
amortizes them.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time


class _Null:
    def write(self, *_):
        pass


def _build_fixture(d: str, n_samples: int, ref_len: int,
                   n_reads: int, n_regions: int):
    import numpy as np

    from ..io.bai import build_bai, write_bai
    from ..io.bam import BamWriter

    rng = np.random.default_rng(7)
    starts = np.sort(rng.integers(0, ref_len - 100, size=n_reads))
    base = os.path.join(d, "s000.bam")
    with open(base, "wb") as fh:
        with BamWriter(
            fh, "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:"
            f"{ref_len}\n@RG\tID:r\tSM:s000\n", ["chr1"], [ref_len],
            level=1,
        ) as w:
            for i, s in enumerate(starts):
                w.write_record(0, int(s), [(100, 0)], mapq=60,
                               name=f"r{i}")
    write_bai(build_bai(base), base + ".bai")
    bams = [base]
    for i in range(1, n_samples):
        p = os.path.join(d, f"s{i:03d}.bam")
        shutil.copyfile(base, p)
        shutil.copyfile(base + ".bai", p + ".bai")
        bams.append(p)
    fai = os.path.join(d, "ref.fa.fai")
    with open(fai, "w") as fh:
        fh.write(f"chr1\t{ref_len}\t6\t60\t61\n")
    # a bed tiling the contig into n_regions intervals = n_regions
    # checkpoint shards (STEP alone would give one shard at this size)
    bed = os.path.join(d, "regions.bed")
    step = ref_len // n_regions
    with open(bed, "w") as fh:
        for lo in range(0, ref_len, step):
            fh.write(f"chr1\t{lo}\t{min(ref_len, lo + step)}\n")
    return bams, fai, bed


def measure_resume_overhead(quick: bool = True,
                            n_samples: int | None = None,
                            ref_len: int | None = None,
                            repeats: int = 3, device=None) -> dict:
    """The JAX package's ``cohort_resume_overhead`` entry, on
    ``device``; ``platform`` is the torch device type (cuda / cpu)."""
    from ..commands.cohortdepth import run_cohortdepth
    from ..device import resolve_device
    from .checkpoint import CheckpointStore

    if n_samples is None:
        n_samples = 3 if quick else 6
    if ref_len is None:
        ref_len = 400_000 if quick else 2_000_000
    n_regions = 8
    window = 500
    dev = resolve_device(device)
    d = tempfile.mkdtemp(prefix="goleft_resume_")
    try:
        bams, fai, bed = _build_fixture(
            d, n_samples, ref_len, n_reads=ref_len // 50,
            n_regions=n_regions)

        def run(checkpoint_dir=None, resume=False):
            t0 = time.perf_counter()
            rc = run_cohortdepth(
                bams, fai=fai, window=window, bed=bed, out=_Null(),
                processes=2, checkpoint_dir=checkpoint_dir,
                resume=resume, device=dev)
            if rc:
                raise RuntimeError(
                    f"cohortdepth degraded (rc={rc}) on a healthy "
                    "fixture")
            return time.perf_counter() - t0

        run()  # warmup: first-touch out of the timings
        plain = min(run() for _ in range(repeats))
        ckpt = float("inf")
        for i in range(repeats):
            ck_dir = os.path.join(d, f"ck{i}")
            ckpt = min(ckpt, run(checkpoint_dir=ck_dir))
        # resume replay of the last (fully committed) store: the other
        # end of the bargain — near-zero recompute
        resumed = min(run(checkpoint_dir=os.path.join(
            d, f"ck{repeats - 1}"), resume=True) for _ in range(2))
        store = CheckpointStore(os.path.join(d, f"ck{repeats - 1}"),
                                resume=True)
        committed = store.completed_count
        store.close()
        return {
            "samples": n_samples,
            "regions": n_regions,
            "window": window,
            "ref_len": ref_len,
            "committed_shards": committed,
            "seconds_plain": round(plain, 4),
            "seconds_checkpointed": round(ckpt, 4),
            "seconds_resumed": round(resumed, 4),
            "overhead_frac": round(ckpt / plain - 1.0, 4),
            "resume_speedup": round(plain / max(resumed, 1e-9), 2),
            "platform": dev.type,
            "note": "run_cohortdepth best-of-%d: plain vs fresh "
                    "--checkpoint-dir vs --resume replay; budget "
                    "<=5%% overhead" % repeats,
        }
    finally:
        shutil.rmtree(d, ignore_errors=True)
