"""cohortdepth: the windowed depth matrix of a cohort of BAM/CRAM files.

The counterpart of the JAX package's commands/cohortdepth.py, with the
same flags, exit codes (0, or 3 when the run completed degraded) and
matrix bytes: ``#chrom start end sample...`` rows of round-half-up
integer window means, what the reference's ``depthwed`` derives from
per-sample ``depth`` beds.

Engines, per (sample, shard), chosen as the reference chooses them:
  - ``hybrid`` (the ``auto`` choice when every input has a fused
    reducer: a CRAM, or a BAM opened with the native library): the
    handle's ``window_reduce`` on the host, exact int64 window sums. A
    BAM streams through csrc/fastio.cpp's lean window accumulation (the
    capped dense pass reruns a region only where a pileup could reach
    the cap); a CRAM decodes and sums in numpy. No kernel runs, as in
    the reference.
  - ``device`` (``auto`` when a BAM has no native library): the
    sample's filtered, clipped segments through the depth command's
    ``DepthEngine``, i.e. the hand-written depth kernel
    (csrc/depth_kernel.cu), one call per sample per shard; its window
    sums are the JAX package's f32 sums, exact while window x cap <
    2^24.

``--decode-device`` installs ops/rans_device.py's DeviceBlockDecoder on
every CRAM handle: the rANS-Nx16 entropy stage of each container runs
in the CUDA kernel of csrc/rans_kernel.cu, and the records decode from
its output on the host.

``--checkpoint-dir`` commits each computed region's per-sample columns
to resilience/checkpoint.py's store in one journal commit, keyed by
(file_key(input), window, mapq, region) as the JAX package keys them, so
a store either package wrote resumes under the other; ``--resume``
replays the journal and skips every fully committed region (no decode,
no launch). Each computed region passes the ``shard`` fault site, where
``--inject-faults shard:after=N:kill`` kills the run between commits.
Inputs may be ``https://`` or ``s3://`` URLs (io/remote.py).

In a world of processes (``GOLEFT_TPU_COORDINATOR``,
``GOLEFT_TPU_NUM_PROCESSES``, ``GOLEFT_TPU_PROCESS_ID``; parallel/mesh.py)
process i decodes every P-th sample on its own card and the matrix
assembles over Gloo (parallel/distributed_cohort.py); process 0 writes
it, the others write nothing. As in the JAX package that path runs
without the quarantine; ``--checkpoint-dir`` is refused there.

The device engine splits the samples over ``devices`` (default: every
visible card), one ``DepthEngine`` a card; the matrix is the same bytes.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import os
import sys

import numpy as np

from .. import obs
from ..device import resolve_device, resolve_devices
from ..io import native, remote
from ..io.bai import query_voffset, read_bai
from ..io.bam import DEPTH_SKIP_FLAGS, open_bam_file
from ..io.fai import read_fai, write_fai
from ..ops.coverage import window_bounds, window_count
from ..utils.decode_scaling import auto_processes, effective_cores
from ..utils.profiling import StageTimer
from . import add_no_crc_flag, apply_no_crc
from .depth import (
    DEPTH_CAP_EXTRA, STEP, DepthEngine, _decode_shard_segments, gen_regions,
)

def get_short_name(path: str, header) -> str:
    """Sample name: the unique SM tag of the header's @RG lines, else
    derived from the file name (commands/indexcov.py::get_short_name of
    the JAX package, reading the already opened handle's header)."""
    seen = []
    for line in header.text.splitlines():
        if line.startswith("@RG"):
            for tok in line.split("\t")[1:]:
                if tok.startswith("SM:") and tok[3:] and tok[3:] not in seen:
                    seen.append(tok[3:])
    if len(seen) == 1:
        return seen[0]
    parts = path.rsplit("/", 1)[-1].split(".")
    if len(parts) <= 2:
        return parts[0]
    return "-".join(parts[:-1])


def cohort_regions(fai_records, chrom: str, window: int,
                   bed: str | None):
    """Shards: gen_regions' STEP-sized fai shards; bed intervals are
    filtered by ``chrom`` and split at absolute multiples of the
    STEP-aligned shard size (interior split points land on window
    boundaries, so the windows equal an unsplit run's)."""
    regions = gen_regions(fai_records, chrom, window, bed)
    if not bed:
        return regions
    if chrom:
        regions = [r for r in regions if r[0] == chrom]
    step = max(1, STEP // window) * window
    out = []
    for c, s, e in regions:
        lo = s
        while lo < e:
            hi = min(e, (lo // step + 1) * step)
            out.append((c, lo, hi))
            lo = hi
    return out


def cohort_matrix_blocks(bams: list[str], reference: str | None = None,
                         fai: str | None = None, window: int = 250,
                         mapq: int = 1, chrom: str = "",
                         processes: int = 8, engine: str = "auto",
                         bed: str | None = None, prefetch_depth: int = 0,
                         *, quarantine, checkpoint=None,
                         decode_device: bool = False, device=None,
                         devices=None):
    """(sample_names, block generator). Each block is (chrom, starts,
    ends, vals), vals an int64 (samples, n_windows) array of
    round-half-up window means.

    ``prefetch_depth`` >= 1 decodes up to that many shards ahead of the
    one being emitted (parallel/prefetch.py); 0 is the serial path with
    one shard of lookahead. Both give the same matrix.

    Each per-sample shard task runs under the retry policy. A sample
    that fails to open is dropped before any output; one that fails
    permanently mid-run is put in ``quarantine`` and zero-fills its
    remaining shards. ``checkpoint`` (a CheckpointStore): each computed
    region's columns are committed after it is emitted, and a region
    whose every column is committed is restored from the store with no
    decode and no launch. Without a ``quarantine`` (``cnv``), a sample
    that fails to open or fails permanently raises instead. ``device``:
    the card unless ``"cpu"``; the device engine runs on ``devices``
    (:func:`~goleft_tpu_torch.device.resolve_devices`: every visible card
    unless the caller names a device or a list), contiguous blocks of
    samples a device."""
    asked = device
    device = resolve_device(device)
    fai_path = fai or (reference + ".fai" if reference else None)
    if fai_path is None:
        raise SystemExit("cohortdepth: need -r reference or --fai")
    if not remote.exists(fai_path) and reference \
            and not remote.is_remote(reference):
        write_fai(reference)
    regions = cohort_regions(read_fai(fai_path), chrom, window, bed)
    if not regions:
        raise SystemExit(
            "cohortdepth: no regions ("
            + (f"bed {bed!r} has no usable intervals"
               + (f" on chromosome {chrom!r}" if chrom else "")
               if bed else f"chromosome {chrom!r} not in {fai_path}?")
            + ")")

    def load(b):
        h = open_bam_file(b)
        if getattr(h, "is_cram", False):
            bai = None
        else:
            bai = read_bai(b + ".bai" if remote.exists(b + ".bai")
                           else b[:-4] + ".bai")
        return h, bai, get_short_name(b, h.header)

    handles, bais, names, paths = [], [], [], []
    with cf.ThreadPoolExecutor(max_workers=max(1, processes)) as ex:
        futs = [ex.submit(load, b) for b in bams]
        for b, f in zip(bams, futs):
            try:
                h, bai, nm = f.result()
            except (Exception, SystemExit) as e:  # noqa: BLE001
                if quarantine is None:
                    raise
                base = b.rsplit("/", 1)[-1]
                quarantine.add(("open", b), base.rsplit(".", 1)[0], b, e,
                               classification="permanent", phase="open")
                continue
            handles.append(h)
            bais.append(bai)
            names.append(nm)
            paths.append(b)
    if not handles:
        raise SystemExit(
            "cohortdepth: every input failed to open — " + "; ".join(
                f"{e['source']}: {e['error']}"
                for e in quarantine.summary()["quarantined"]))

    is_cram = [getattr(h, "is_cram", False) for h in handles]
    if decode_device:
        from ..obs import get_logger
        from ..ops.rans_device import DeviceBlockDecoder

        dec = DeviceBlockDecoder(device=device)
        for h, c in zip(handles, is_cram):
            if c:
                h.set_block_decoder(dec)
        if not any(is_cram):
            get_logger("cohortdepth").warning(
                "--decode-device: no CRAM inputs in this cohort; the flag "
                "is a no-op")
    # a fused reducer: a BAM opened with the native library, or a CRAM
    fused = all(getattr(h, "native", False) or c
                for h, c in zip(handles, is_cram))
    if engine == "auto":
        engine = "hybrid" if fused else "device"
    if engine == "hybrid" and not fused:
        raise SystemExit("cohortdepth: engine=hybrid needs the native io")
    depth_engines = []
    if engine == "device":
        max_span = max(e - (s // window) * window for _, s, e in regions)
        # the caller's device or list, else every visible card, found
        # under the bring-up watchdog (the reference's, at its device
        # engine)
        from ..utils.device_guard import devices_with_watchdog

        devs = devices_with_watchdog(
            discover=lambda: resolve_devices(devices, asked))
        depth_engines = [DepthEngine(window, 4, 0, mapq, max_span=max_span,
                                     device=d) for d in devs]
    tid_maps = [{n: i for i, n in enumerate(h.header.ref_names)}
                for h in handles]

    from ..plan import Executor, Step

    pex = Executor(quarantine=quarantine, checkpoint=checkpoint)
    timer = StageTimer()
    # the sample threads' spans parent under the caller's span
    span_ctx = obs.capture()

    def sample_sums(i, region):
        """Window sums of sample i over one shard, under the per-sample
        resilience boundary (retry, then quarantine and zero-fill)."""
        c, s, e = region
        h, tid = handles[i], tid_maps[i].get(c, -1)
        w0 = s // window * window
        n_win = window_count(s, e, window)

        def fallback():
            return np.zeros(n_win, np.int64)

        def body():
            if tid < 0:
                return fallback()
            if not depth_engines:
                voff = None
                if bais[i] is not None:  # a BAM: start at its index
                    voff = query_voffset(bais[i], tid, s)
                    if voff is None:
                        return fallback()
                return h.window_reduce(tid, s, e, w0, n_win * window,
                                       window, DEPTH_CAP_EXTRA, mapq,
                                       DEPTH_SKIP_FLAGS, voffset=voff)
            seg_s, seg_e = _decode_shard_segments(h, bais[i], tid, s, e,
                                                  mapq)
            # samples split over the devices in contiguous blocks
            eng = depth_engines[i * len(depth_engines) // len(handles)]
            with timer.stage("reduce"):
                return eng.run_segments(seg_s, seg_e, None, s, e)[2]

        with obs.attach(span_ctx), timer.stage("sample-shard"):
            return pex.run(Step(key=(names[i], s, e), fn=body,
                                quarantine_key=i, quarantine_name=names[i],
                                quarantine_source=paths[i],
                                fallback=fallback))

    def emit_block(region, sums):
        """Window sums → round-half-up integer means, for both engines."""
        c, s, e = region
        starts, ends, _, _ = window_bounds(s, e, window)
        spans = (ends - starts).astype(np.float64)
        vals = (0.5 + sums[:, :len(starts)] / spans[None, :]) \
            .astype(np.int64)
        return c, starts, ends, vals

    # checkpoint keys: content identity per (sample, region). A region
    # whose every column is committed leaves the list the engines see,
    # so it is neither decoded nor launched
    fkeys = []
    if checkpoint is not None:
        from ..parallel.scheduler import file_key

        fkeys = [file_key(b) for b in paths]

    def region_keys(r):
        return [("cohortdepth", fk, window, mapq, tuple(r)) for fk in fkeys]

    compute_regions = [
        r for r in regions if checkpoint is None
        or not all(checkpoint.has(k) for k in region_keys(r))]

    S = len(handles)

    def shard_serial(region):
        return np.stack([sample_sums(i, region) for i in range(S)])

    def blocks():
        if processes <= 1 or effective_cores() <= 1:
            for r in compute_regions:
                yield emit_block(r, shard_serial(r))
            return
        with cf.ThreadPoolExecutor(max_workers=processes) as ex:
            def submit(r):
                return [ex.submit(sample_sums, i, r) for i in range(S)]

            pending = submit(compute_regions[0])
            for k, r in enumerate(compute_regions):
                sums = np.stack([f.result() for f in pending])
                if k + 1 < len(compute_regions):
                    pending = submit(compute_regions[k + 1])
                yield emit_block(r, sums)

    def blocks_prefetched():
        from ..parallel.prefetch import ChunkPrefetcher

        with ChunkPrefetcher(compute_regions, shard_serial,
                             depth=prefetch_depth,
                             processes=processes) as pf:
            for ch in pf:
                yield emit_block(ch.meta, ch.value)

    gen = blocks_prefetched() if prefetch_depth > 0 else blocks()

    from ..resilience import faults

    def region_step(r, it):
        """One region as a plan Step: the ``shard`` fault site fires per
        computed region (between journal commits, where a kill clause
        lands), and a fully committed region is restored from the store
        (no fault site, no decode). ``retry=False``: the per-sample
        Steps inside carry the policy."""
        c, s, e = r

        def restore(cols):
            starts, ends, _, _ = window_bounds(s, e, window)
            return c, starts, ends, np.stack(cols)

        def commit(blk):
            vals = blk[3]
            return [(k, vals[i]) for i, k in enumerate(region_keys(r))
                    if quarantine is None or i not in quarantine]

        return Step(key=tuple(r), fn=lambda: next(it), site="shard",
                    retry=False,
                    checkpoint_keys=(region_keys(r)
                                     if checkpoint is not None else None),
                    restore=restore, commit=commit)

    def with_resilience(inner):
        """Resumed blocks (from the store, in region order) between the
        computed ones, each computed region committed in one journal
        commit, all through the plan Executor."""
        it = iter(inner)
        for r in regions:
            yield pex.run(region_step(r, it))

    if checkpoint is not None or faults.get_plan() is not None:
        gen = with_resilience(gen)
    return names, gen


def format_block(c, starts, ends, vals) -> str:
    """Matrix rows of one block: chrom, start, end, one value per
    sample."""
    cols = [np.asarray(starts).astype(str), np.asarray(ends).astype(str),
            *vals.astype(str)]
    return "".join(f"{c}\t" + "\t".join(row) + "\n" for row in zip(*cols))


def matrix_rows(c, starts, ends, vals) -> str:
    """:func:`format_block`'s text, written by the host library's C
    formatter when it is loaded."""
    buf = native.format_matrix_rows(c, starts, ends, vals)
    return format_block(c, starts, ends, vals) if buf is None \
        else buf.decode("ascii")


def run_cohortdepth(bams: list[str], reference: str | None = None,
                    fai: str | None = None, window: int = 250,
                    mapq: int = 1, chrom: str = "", processes: int = 8,
                    out=None, engine: str = "auto", bed: str | None = None,
                    prefetch_depth: int = 0,
                    checkpoint_dir: str | None = None,
                    resume: bool = False, decode_device: bool = False,
                    device=None) -> int:
    """Write the matrix to ``out`` (stdout); return the exit code: 0, or
    3 when samples were quarantined (the partial matrix was written, and
    with ``checkpoint_dir`` its ``quarantine.json``). ``checkpoint_dir``
    commits each computed region; ``resume`` replays the store's journal
    first and skips the regions it holds."""
    from ..parallel.mesh import world

    n_proc, rank = world()
    if n_proc > 1:
        return _run_distributed(
            bams, rank, checkpoint_dir, resume, reference=reference,
            fai=fai,
            window=window, mapq=mapq, chrom=chrom, processes=processes,
            out=out or sys.stdout, engine=engine, bed=bed,
            prefetch_depth=prefetch_depth, decode_device=decode_device,
            device=device)
    if resume and not checkpoint_dir:
        raise SystemExit("cohortdepth: --resume requires --checkpoint-dir")
    from ..resilience.checkpoint import CheckpointStore
    from ..resilience.policy import Quarantine

    out = out or sys.stdout
    timer = StageTimer()
    quarantine = Quarantine()
    checkpoint = CheckpointStore(checkpoint_dir, resume=resume) \
        if checkpoint_dir else None
    try:
        names, blocks = cohort_matrix_blocks(
            bams, reference=reference, fai=fai, window=window, mapq=mapq,
            chrom=chrom, processes=processes, engine=engine, bed=bed,
            prefetch_depth=prefetch_depth, quarantine=quarantine,
            checkpoint=checkpoint, decode_device=decode_device,
            device=device)
        out.write("#chrom\tstart\tend\t" + "\t".join(names) + "\n")
        for blk in blocks:
            with timer.stage("format"):
                out.write(matrix_rows(*blk))
    finally:
        if checkpoint is not None:
            checkpoint.close()
    if quarantine:
        if checkpoint_dir:
            quarantine.write(os.path.join(checkpoint_dir,
                                          "quarantine.json"))
        print(quarantine.exit_summary(), file=sys.stderr)
        return 3
    return 0


def _run_distributed(bams, rank, checkpoint_dir, resume, out,
                     **kw) -> int:
    """The multi-process path: samples split over the world's
    processes, the matrix gathered on all; process 0 writes it."""
    if checkpoint_dir or resume:
        raise SystemExit("cohortdepth: --checkpoint-dir and --resume are "
                         "not supported in a multi-process world")
    from ..parallel.distributed_cohort import distributed_cohort_matrix

    names, chroms, starts, ends, mat = distributed_cohort_matrix(bams, **kw)
    if rank != 0:
        return 0
    out.write("#chrom\tstart\tend\t" + "\t".join(names) + "\n")
    lo = 0
    for hi in range(1, len(chroms) + 1):
        if hi == len(chroms) or chroms[hi] != chroms[lo]:
            out.write(matrix_rows(chroms[lo], starts[lo:hi], ends[lo:hi],
                                  mat[lo:hi].T.astype(np.int64)))
            lo = hi
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(
        "goleft-tpu-torch cohortdepth",
        description="windowed depth matrix for a cohort, on the CUDA card")
    p.add_argument("-w", "--windowsize", type=int, default=250)
    p.add_argument("-Q", "--mapq", type=int, default=1)
    p.add_argument("-c", "--chrom", default="")
    p.add_argument("-b", "--bed", default=None,
                   help="restrict to regions in this bed")
    p.add_argument("-r", "--reference", default=None)
    p.add_argument("--fai", default=None)
    p.add_argument("-p", "--processes", type=int, default=None,
                   help="decode threads (default: one per effective core, "
                        "capped at 8)")
    p.add_argument("--engine", choices=("auto", "hybrid", "device"),
                   default="auto",
                   help="hybrid: exact host window reduction (the "
                        "default when the native io is loaded or every "
                        "input is a CRAM); device: segments to the depth "
                        "kernel on the card")
    p.add_argument("--prefetch-depth", type=int, default=0,
                   help="decode up to N shards ahead of the shard being "
                        "emitted (0 = serial path, identical output)")
    p.add_argument("--decode-device", action="store_true",
                   help="CRAM inputs: run the rANS-Nx16 entropy decode of "
                        "each container in the CUDA kernel on the card "
                        "(identical output)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="atomic checkpoint store: each region's per-sample "
                        "columns and an fsync'd journal; with --resume a "
                        "killed run restarts from its committed regions "
                        "with the same output")
    p.add_argument("--resume", action="store_true",
                   help="replay the checkpoint journal and skip committed "
                        "regions (requires --checkpoint-dir)")
    add_no_crc_flag(p)
    p.add_argument("bams", nargs="+")
    a = p.parse_args(argv)
    apply_no_crc(a.no_crc)
    if a.resume and not a.checkpoint_dir:
        p.error("--resume requires --checkpoint-dir")
    return run_cohortdepth(
        a.bams, reference=a.reference, fai=a.fai, window=a.windowsize,
        mapq=a.mapq, chrom=a.chrom,
        processes=auto_processes() if a.processes is None else a.processes,
        engine=a.engine, bed=a.bed, prefetch_depth=a.prefetch_depth,
        checkpoint_dir=a.checkpoint_dir, resume=a.resume,
        decode_device=a.decode_device)


if __name__ == "__main__":
    sys.exit(main())
