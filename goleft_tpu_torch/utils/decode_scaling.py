"""Decode-pool sizing and the decode-thread scaling measurement, copied
from the JAX package's utils/decode_scaling.py: ``effective_cores``,
``auto_processes``, the fixture (``build_cohort``), and the curve the
bench's headline picks its pool size from (``measure_scaling_curve``,
``optimal_threads``) with its two-point case (``measure_scaling``)."""

from __future__ import annotations

import concurrent.futures as cf
import os
import shutil
import time

import numpy as np


def effective_cores() -> int:
    """Affinity/cgroup-aware core count (a container pinned to 1 CPU on
    a 64-core host must count as 1)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover - non-Linux
        return os.cpu_count() or 1


def auto_processes(cap: int = 8) -> int:
    """Affinity-aware default worker count for decode pools: one per
    effective core, capped. On a 1-core host this is 1, which routes
    the cohort engine onto its serial path (no thread churn)."""
    return max(1, min(cap, effective_cores()))


def build_cohort(tmp_dir, n_files: int = 4, ref_len: int = 2_000_000,
                 coverage: int = 4, read_len: int = 100):
    """Fabricate ``n_files`` identical single-chromosome BAMs+BAIs →
    (paths, ref_len)."""
    from ..io.bai import build_bai, write_bai
    from ..io.bam import BamWriter

    n_reads = ref_len * coverage // read_len
    rng = np.random.default_rng(5)
    starts = np.sort(rng.integers(0, ref_len - read_len, size=n_reads))
    base = os.path.join(str(tmp_dir), "s0.bam")
    with open(base, "wb") as fh:
        with BamWriter(
            fh, "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:"
            f"{ref_len}\n", ["chr1"], [ref_len], level=1,
        ) as w:
            for i, s in enumerate(starts):
                w.write_record(0, int(s), [(read_len, 0)], mapq=60,
                               name=f"r{i}")
    write_bai(build_bai(base), base + ".bai")
    paths = [base]
    for i in range(1, n_files):
        p = os.path.join(str(tmp_dir), f"s{i}.bam")
        shutil.copyfile(base, p)
        shutil.copyfile(base + ".bai", p + ".bai")
        paths.append(p)
    return paths, ref_len


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def measure_scaling(paths, ref_len: int, window: int = 500,
                    repeats: int = 2):
    """(serial_seconds, threaded_seconds, n_tasks) for one full-region
    reduce per file, best-of-``repeats``: the two-point case of
    :func:`measure_scaling_curve`."""
    if not len(paths):
        raise ValueError("measure_scaling: paths is empty — need at "
                         "least one BAM to measure decode scaling")
    curve = measure_scaling_curve(paths, ref_len, window, repeats,
                                  thread_counts=[1, len(paths)])
    return curve[1], curve[len(paths)], len(paths)


def default_thread_counts(cores: int | None = None, n_tasks: int = 4):
    """Worker counts worth measuring on this host: 1, the core count,
    the midpoint, one oversubscribed point (capped by tasks — more
    workers than tasks measures nothing) and the full task width."""
    cores = effective_cores() if cores is None else cores
    cand = {1, min(2, n_tasks), min(cores, n_tasks),
            min(2 * cores, n_tasks), n_tasks}
    return sorted(cand)


def measure_scaling_curve(paths, ref_len: int, window: int = 500,
                          repeats: int = 2, thread_counts=None):
    """Speedup-vs-workers curve: {n_workers: best_seconds} for one
    full-region native window reduction per file under an
    ``n_workers``-thread pool (n=1 is the serial wall)."""
    from ..io.bam import BamFile

    if not len(paths):
        raise ValueError("measure_scaling_curve: paths is empty — "
                         "need at least one BAM to measure decode "
                         "scaling")
    if thread_counts is None:
        thread_counts = default_thread_counts(n_tasks=len(paths))
    handles = [BamFile.from_file(p) for p in paths]

    def reduce_one(h):
        return h.window_reduce(0, 0, ref_len, 0, ref_len, window,
                               2500, 1, 0x704)

    for h in handles:  # warm page cache + native lib
        reduce_one(h)

    curve = {}
    for n in thread_counts:
        if n <= 1:
            curve[1] = min(
                _timed(lambda: [reduce_one(h) for h in handles])
                for _ in range(repeats))
            continue
        with cf.ThreadPoolExecutor(max_workers=n) as ex:
            curve[n] = min(
                _timed(lambda: list(ex.map(reduce_one, handles)))
                for _ in range(repeats))
    return curve


def optimal_threads(curve: dict) -> int:
    """The worker count a cohort run should use: fastest point of the
    measured curve; ties break toward fewer threads."""
    return min(sorted(curve), key=lambda n: (curve[n], n))
