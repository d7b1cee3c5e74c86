"""depth: windowed depth + callable-region classification on the card.

The counterpart of the JAX package's commands/depth.py, with the same
flags and the same output bytes. The BAM is decoded on the host into
filtered, clipped segment endpoints (BAI linear-index seek per shard);
the hand-written CUDA kernel turns them into window sums and 2-bit packed
classes (ops/depth_pipeline.py); the host writes the two BED files:

  <prefix>.depth.bed     chrom  s  e  %.4g-mean [gc cpg masked with -s]
  <prefix>.callable.bed  chrom  s  e  NO_/LOW_/CALLABLE/EXCESSIVE_COVERAGE

Semantics preserved from the reference (goleft depth/depth.go):
  - windows aligned to absolute coordinates, clipped to the region, mean
    denominator = clipped span (:293-305, 329-341)
  - per-base classes with NO_COVERAGE gap fill (:307-323, 343-359);
    class thresholds at getCovClass (:223-234)
  - shard step = 10Mb rounded to a window multiple (:48, 130-132)
  - samtools flags inherited: -Q mapq cutoff (keep mapq ≥ Q), skip
    UNMAP/SECONDARY/QCFAIL/DUP, per-base cap -d = MaxMeanDepth+2500
    (:45, 116); deletions/ref-skips don't count (M/=/X blocks only)
  - -b BED restricts to listed regions; ``-s`` appends GC/CpG/masked
    ("%.3g") per window (:191-200)
"""

from __future__ import annotations

import argparse
import os
import sys
import threading

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..io.bai import query_voffset, read_bai
from ..io.bam import DEPTH_SKIP_FLAGS, filter_clip_segments, open_bam_file
from ..io.fai import Faidx, read_fai
from ..ops.coverage import (
    CLASS_NAMES, bucket_size, pack_segments_u16, run_length_encode,
    window_bounds,
)
from ..ops.depth_pipeline import (
    shard_depth_pipeline_batch_cls_packed, shard_depth_pipeline_cls_packed,
    shard_depth_pipeline_packed_cls_packed, unpack_cls_2bit,
)
from ..utils.xopen import xopen
from . import add_no_crc_flag, apply_no_crc

STEP = 10_000_000  # shard size, depth/depth.go:48
DEPTH_CAP_EXTRA = 2500  # -d = MaxMeanDepth + 2500, depth/depth.go:116


def gen_regions(
    fai_records, chrom: str, window: int, bed: str | None
) -> list[tuple[str, int, int]]:
    """(chrom, start, end) 0-based half-open shards (depth.go:103-159)."""
    if bed:
        out = []
        with xopen(bed) as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line or line.startswith(("#", "track")):
                    continue
                t = line.split("\t")
                if len(t) < 3:
                    raise ValueError(
                        f"{bed}:{lineno}: bed line needs chrom/start/"
                        f"end, got {len(t)} fields"
                    )
                try:
                    out.append((t[0], max(int(t[1]), 0), int(t[2])))
                except ValueError:
                    raise ValueError(
                        f"{bed}:{lineno}: non-integer bed coordinate"
                    )
        return out
    step = max(1, STEP // window) * window
    out = []
    for rec in fai_records:
        if chrom and rec.name != chrom:
            continue
        for i in range(0, rec.length, step):
            out.append((rec.name, i, min(i + step, rec.length)))
    return out


_EMPTY_SEGS = (np.empty(0, np.int32), np.empty(0, np.int32))


def _decode_shard_segments(bam, bai, tid: int, start: int, end: int,
                           min_mapq: int,
                           flag_mask: int = DEPTH_SKIP_FLAGS):
    """Host decode of the shard's FILTERED clipped segment endpoints —
    what the device pipeline consumes. Returns (seg_start, seg_end);
    pair with an all-true keep mask. A CRAM handle (``bai`` None) selects
    its containers through its .crai and decodes columns."""
    if tid < 0:
        return _EMPTY_SEGS
    if bai is None:
        cols = bam.read_columns(tid=tid, start=start, end=end)
        return filter_clip_segments(cols, start, end, min_mapq, flag_mask)
    voff = query_voffset(bai, tid, start)
    if voff is None:
        return _EMPTY_SEGS
    return bam.read_segments(tid, start, end, min_mapq, flag_mask,
                             voffset=voff)


class DepthEngine:
    """Reusable shard → (window sums, classes) runner over
    stream-extracted segment endpoints."""

    def __init__(self, window: int, min_cov: int, max_mean_depth: int,
                 mapq: int, max_span: int = STEP,
                 packed: bool | None = None, device=None):
        """``max_span`` = max over regions of (end - aligned_origin) —
        the longest per-base buffer any shard needs. ``packed`` ships
        segments as u16 delta+length (4 bytes/segment vs 9) and
        reconstructs them on the card, falling back to the unpacked wire
        for ultra-long segments (≥ 65536 bases). Default (None): enabled
        when the host has cores to spare (packing trades host cycles for
        link bytes). ``device``: the card unless ``"cpu"``."""
        self.window = window
        self.min_cov = min_cov
        self.max_mean = max_mean_depth
        self.mapq = mapq
        if packed is None:
            packed = (os.cpu_count() or 1) >= 4
        self.packed = packed
        self.cap = max_mean_depth + DEPTH_CAP_EXTRA
        self.device = resolve_device(device)
        # one launch per shard from whichever worker thread decoded it:
        # the copies and the kernel of one shard stay together
        self._lock = threading.Lock()
        # one static length (a multiple of the window covering the
        # longest region from its aligned origin); windows larger than
        # the span mean every region fits one absolute window, so the
        # whole buffer is a single window
        if window >= max_span:
            self.w_eff = ((max_span + 1023) // 1024) * 1024
            self.length = self.w_eff
        else:
            self.w_eff = window
            self.length = (max_span + window - 1) // window * window

    def run_segments(self, seg_start, seg_end, kp, start: int,
                     end: int):
        """Shard runner over segment endpoint arrays. ``kp=None`` means
        all segments are keepers (the _decode_shard_segments contract)."""
        w0 = start // self.window * self.window
        assert end - w0 <= self.length
        n = len(seg_start)
        scalars = (w0, start, end, self.cap, self.min_cov, self.max_mean)
        sel = slice(None) if kp is None else kp
        packed = pack_segments_u16(seg_start, seg_end, sel) \
            if self.packed else None
        if packed is not None:
            d, ln, base, n_ent = packed
            b = bucket_size(max(n_ent, 1))
            dd = np.zeros(b, np.uint16)
            ll = np.zeros(b, np.uint16)
            dd[:n_ent] = d
            ll[:n_ent] = ln
            with self._lock:
                sums, cls_p = obs.dispatch(
                    "depth", shard_depth_pipeline_packed_cls_packed,
                    self._put(dd), self._put(ll), int(base), *scalars,
                    length=self.length, window=self.w_eff,
                )
                sums, cls_p = sums.cpu().numpy(), cls_p.cpu().numpy()
        else:
            b = bucket_size(n)
            seg_s = np.zeros(b, dtype=np.int32)
            seg_e = np.zeros(b, dtype=np.int32)
            keep = np.zeros(b, dtype=bool)
            if n:
                seg_s[:n] = seg_start
                seg_e[:n] = seg_end
                keep[:n] = True if kp is None else kp
            with self._lock:
                sums, cls_p = obs.dispatch(
                    "depth", shard_depth_pipeline_cls_packed,
                    self._put(seg_s), self._put(seg_e), self._put(keep),
                    *scalars, length=self.length, window=self.w_eff,
                )
                sums, cls_p = sums.cpu().numpy(), cls_p.cpu().numpy()
        starts, ends, _, _ = window_bounds(start, end, self.window)
        n_win = len(starts)
        sums = sums[:n_win]
        # classes come back 2-bit packed (1/4 of the device→host bytes)
        # and unpack on the host with vectorized shifts
        cls = unpack_cls_2bit(cls_p, self.length)
        cls = cls[start - w0 : end - w0]
        return starts, ends, sums, cls

    def run_segments_batch(self, segs, start: int, end: int):
        """B samples' filtered ``(seg_start, seg_end)`` arrays over the
        same region in ONE kernel launch (the serve daemon's coalesced
        /v1/depth pass). On the u16 wire when every sample packs, else
        on the int32 wire; row i equals :meth:`run_segments` on sample i
        alone, on either wire. Returns (starts, ends, sums (B, n_win),
        cls (B, span)), as the JAX package's ``run_segments_batch``."""
        w0 = start // self.window * self.window
        assert end - w0 <= self.length
        packs = [pack_segments_u16(ss, ee, slice(None)) for ss, ee in segs] \
            if self.packed else [None]
        wire16 = all(p is not None for p in packs)
        # each sample's entries from a 16-byte boundary (8 u16 entries);
        # the padding is zero-length entries, which add nothing
        if wire16:
            cols = [(p[0], p[1]) for p in packs]
        else:
            cols = [(np.asarray(ss, np.int32), np.asarray(ee, np.int32))
                    for ss, ee in segs]
        counts = [len(c[0]) for c in cols]
        padded = [(n + 7) // 8 * 8 for n in counts]
        offsets = np.concatenate([[0], np.cumsum(padded)]).astype(np.int64)
        total = int(offsets[-1])
        a = np.zeros(total, np.uint16 if wire16 else np.int32)
        b = np.zeros_like(a)
        keep = None if wire16 else np.zeros(total, bool)
        for (x, y), lo, n in zip(cols, offsets, counts):
            a[lo:lo + n] = x
            b[lo:lo + n] = y
            if keep is not None:
                keep[lo:lo + n] = True
        scalars = (w0, start, end, self.cap, self.min_cov, self.max_mean)
        with self._lock:
            sums, cls_p = obs.dispatch(
                "depth", shard_depth_pipeline_batch_cls_packed,
                self._put(a), self._put(b), offsets.tolist(), *scalars,
                length=self.length, window=self.w_eff,
                keep=None if keep is None else self._put(keep),
                bases=[int(p[2]) for p in packs] if wire16 else None)
            sums, cls_p = sums.cpu().numpy(), cls_p.cpu().numpy()
        starts, ends, _, _ = window_bounds(start, end, self.window)
        sums = sums[:, :len(starts)]
        cls = np.stack([unpack_cls_2bit(row, self.length)[start - w0:end - w0]
                        for row in cls_p]) if len(segs) else \
            np.zeros((0, end - start), np.int8)
        return starts, ends, sums, cls

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)


def write_shard_output(
    chrom: str, starts, ends, sums, cls, region_start: int,
    depth_out, call_out, fa: Faidx | None,
) -> None:
    from ..io import native

    spans = ends - starts
    means = sums / spans
    use_native = native.get_lib() is not None
    if fa is None:
        if use_native:
            depth_out.write(
                native.format_depth_rows(chrom, starts, ends, means)
                .decode("ascii")
            )
        else:
            for s, e, m in zip(starts, ends, means):
                depth_out.write(f"{chrom}\t{s}\t{e}\t{m:.4g}\n")
    else:
        for s, e, m in zip(starts, ends, means):
            st = fa.window_stats(chrom, int(s), int(e))
            depth_out.write(
                f"{chrom}\t{s}\t{e}\t{m:.4g}"
                f"\t{st['gc']:.3g}\t{st['cpg']:.3g}\t{st['masked']:.3g}\n"
            )
    rs, re_, rv = run_length_encode(cls)
    if use_native:
        call_out.write(
            native.format_class_rows(
                chrom, rs.astype(np.int64) + region_start,
                re_.astype(np.int64) + region_start, rv,
            ).decode("ascii")
        )
    else:
        for s, e, v in zip(rs, re_, rv):
            call_out.write(
                f"{chrom}\t{s + region_start}\t{e + region_start}\t"
                f"{CLASS_NAMES[v]}\n"
            )


def _setup(bam, reference, fai, window, min_cov, max_mean_depth, mapq,
           chrom, bed, stats, device):
    """Open the BAM (its .bai) or CRAM (its .crai, inside the handle),
    local or a URL, make the regions and the engine (the engine's device
    check initialises CUDA)."""
    from ..io import remote

    handle = open_bam_file(bam)
    if getattr(handle, "is_cram", False):
        bai = None
    else:
        bai = read_bai(bam + ".bai" if remote.exists(bam + ".bai")
                       else bam[:-4] + ".bai")
    fai_path = fai or (reference + ".fai" if reference else None)
    if bed is None:
        if fai_path is None:
            raise SystemExit(
                "depth: need -r reference (with .fai) or -b bed regions"
            )
        if not remote.exists(fai_path):
            if reference and not remote.is_remote(reference) \
                    and os.path.exists(reference):
                from ..io.fai import write_fai

                write_fai(reference)
            else:
                raise SystemExit(f"depth: fasta index not found: {fai_path}")
        fai_records = read_fai(fai_path)
    else:
        fai_records = []
    regions = gen_regions(fai_records, chrom, window, bed)

    fa = Faidx(reference) if stats and reference else None
    max_span = max(
        (e - (s // window) * window for _, s, e in regions), default=1
    )
    engine = DepthEngine(window, min_cov, max_mean_depth, mapq,
                         max_span=max_span, device=device)
    return handle, bai, regions, fa, engine


def run_depth(
    bam: str,
    prefix: str,
    reference: str | None = None,
    fai: str | None = None,
    window: int = 250,
    min_cov: int = 4,
    max_mean_depth: int = 0,
    mapq: int = 1,
    chrom: str = "",
    bed: str | None = None,
    stats: bool = False,
    processes: int = 4,
    cache_dir: str | None = None,
    profile_dir: str | None = None,
    stage_totals: dict | None = None,
    device=None,
) -> tuple[str, str]:
    """``stage_totals``, when given, receives the StageTimer's seconds:
    ``setup`` and ``shard-loop`` (wall clock of the main thread), and
    ``host-decode`` / ``device-compute`` / ``write-output`` (summed over
    the shard threads). ``device``: the card unless ``"cpu"``.

    ``cache_dir`` keys each shard's host arrays as (chrom, start, end,
    (file_key(bam), (window, min_cov, max_mean_depth, mapq))), as the
    JAX package does: a hit replays them with no decode and no launch.
    ``profile_dir`` runs the shard loop under ``torch.profiler`` (a
    Chrome trace in the directory) and logs the stage report."""
    from ..obs import get_registry
    from ..parallel.scheduler import ResultCache, file_key, run_sharded
    from ..utils.profiling import StageTimer, trace

    timer = StageTimer()
    reg = get_registry()
    with timer.stage("setup"):
        handle, bai, regions, fa, engine = _setup(
            bam, reference, fai, window, min_cov, max_mean_depth, mapq,
            chrom, bed, stats, device)
    hdr = handle.header
    suffix = f".{chrom}" if chrom else ""
    depth_path = f"{prefix}{suffix}.depth.bed"
    call_path = f"{prefix}{suffix}.callable.bed"
    tid_of = {n: i for i, n in enumerate(hdr.ref_names)}
    rc = ResultCache(cache_dir) if cache_dir else None
    fkey = file_key(bam) if cache_dir else bam

    def shard_fn(c, s, e, _fk):
        with timer.stage("host-decode"):
            seg_s, seg_e = _decode_shard_segments(
                handle, bai, tid_of.get(c, -1), s, e, mapq)
        with timer.stage("device-compute"):
            return engine.run_segments(seg_s, seg_e, None, s, e)

    params = (window, min_cov, max_mean_depth, mapq)
    tasks = [(c, s, e, (fkey, params)) for (c, s, e) in regions]
    n_failed = 0
    with timer.stage("shard-loop"), trace(profile_dir), \
            open(depth_path, "w") as dout, open(call_path, "w") as cout:
        for (c, s, e), res in zip(
            regions, run_sharded(tasks, shard_fn, processes=processes,
                                 retries=1, cache=rc),
        ):
            reg.counter("depth.shards_total").inc()
            if res.error is not None:
                # reference behavior: failed shard reports in red, others
                # keep going, nonzero exit at the end
                # (depth/depth.go:395-399)
                msg = f"ERROR with shard {c}:{s}-{e}: {res.error}"
                if sys.stderr.isatty():
                    msg = f"\033[31m{msg}\033[0m"
                print(msg, file=sys.stderr)
                n_failed += 1
                reg.counter("depth.shards_failed_total").inc()
                continue
            starts, ends, sums, cls = res.value
            with timer.stage("write-output"):
                write_shard_output(c, starts, ends, sums, cls, s,
                                   dout, cout, fa)
    if profile_dir:
        timer.log_report()
    if stage_totals is not None:
        stage_totals.update(timer.totals)
    if n_failed:
        raise SystemExit(1)
    return depth_path, call_path


def main(argv=None):
    p = argparse.ArgumentParser(
        "goleft-tpu-torch depth",
        description="windowed depth + callable regions on the CUDA card",
    )
    p.add_argument("-w", "--windowsize", type=int, default=250)
    p.add_argument("-m", "--maxmeandepth", type=int, default=0,
                   help="per-base depths >= this are EXCESSIVE_COVERAGE")
    p.add_argument("-Q", "--mapq", type=int, default=1,
                   help="mapping quality cutoff (keep >= Q)")
    p.add_argument("-c", "--chrom", default="")
    p.add_argument("--mincov", type=int, default=4,
                   help="minimum depth considered callable")
    p.add_argument("-o", "--ordered", action="store_true",
                   help="accepted for reference-CLI parity; output here "
                        "is ALWAYS in input order")
    p.add_argument("-s", "--stats", action="store_true",
                   help="report GC CpG masked stats per window")
    p.add_argument("-r", "--reference", default=None,
                   help="reference fasta (with .fai)")
    p.add_argument("-p", "--processes", type=int, default=4)
    p.add_argument("-b", "--bed", default=None,
                   help="restrict to regions in this bed")
    p.add_argument("--cache", default=None,
                   help="shard result-cache directory: a rerun replays "
                        "cached shards without decoding or launching")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace of the "
                        "shard loop to this directory")
    p.add_argument("--prefix", required=True)
    add_no_crc_flag(p)
    p.add_argument("bam")
    a = p.parse_args(argv)
    apply_no_crc(a.no_crc)
    run_depth(
        a.bam, a.prefix, reference=a.reference, window=a.windowsize,
        min_cov=a.mincov, max_mean_depth=a.maxmeandepth, mapq=a.mapq,
        chrom=a.chrom, bed=a.bed, stats=a.stats, processes=a.processes,
        cache_dir=a.cache, profile_dir=a.profile,
    )


if __name__ == "__main__":
    main()
