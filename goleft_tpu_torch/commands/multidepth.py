"""multidepth: joint depth blocks across many BAMs, on the CUDA card.

The counterpart of the JAX package's commands/multidepth.py (a rebuild
of the reference's unregistered prototype, multidepth/multidepth.go),
with the same flags and output bytes. Per 5 Mb chunk each sample's
filtered segment endpoints are decoded on the host and turned into
per-base depth by the depth kernel (csrc/depth_kernel.cu, its dense
output: window 1, the cap, the chunk as the region), one launch a
sample; the (samples × bases) matrix stays on the card, where the
qualifying positions are found (> minSamples samples with depth ≥
MinCov, and any depth at all: samtools only emits covered rows), and
only those columns come back. On the host, qualifying positions are
split into runs at gaps > MaxSkip (":163-171,242-254"), runs shorter
than MinSize sites dropped (":245"), long runs discretized to Window
(":184-199"), and per-sample mean depth written as %.2f (":270-283").

The reference processes chunks in parallel with a skip-until-gap
handshake at chunk boundaries (":217-241"); this streams chunks in
order with the current run carried, so blocks spanning chunk boundaries
are exact rather than heuristic. A run's finished blocks are written as
soon as the run has MinSize sites, so the carried columns stay within
one Window.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..io.bai import read_bai
from ..io.bam import open_bam_file
from ..ops import depth_kernel
from ..ops.coverage import bucket_size, pack_segments_u16
from .depth import _decode_shard_segments
from .indexcov import get_short_name

CHUNK = 5_000_000


def _sample_depth(seg_start, seg_end, start: int, end: int, max_cov: int,
                  dev) -> torch.Tensor:
    """(end-start,) int32 per-base depth of one sample over [start, end)
    on ``dev``: one depth-kernel launch (its plain version on the CPU),
    on the u16 wire unless a segment is 65,536 bases or longer. The
    classes the kernel also writes are not used (min_cov and max_mean
    0)."""
    length = end - start
    scalars = (start, start, end, max_cov, 0, 0)
    packed = pack_segments_u16(seg_start, seg_end, slice(None))
    if packed is not None:
        d, ln, base, n = packed
        b = bucket_size(max(n, 1))
        dd = np.zeros(b, np.uint16)
        ll = np.zeros(b, np.uint16)
        dd[:n] = d
        ll[:n] = ln
        out = obs.dispatch(
            "depth", depth_kernel.fused_depth_wire,
            torch.from_numpy(dd).to(dev), torch.from_numpy(ll).to(dev),
            int(base), *scalars, length=length, window=1, dense=True)
    else:
        n = len(seg_start)
        b = bucket_size(max(n, 1))
        ss = np.zeros(b, np.int32)
        ee = np.zeros(b, np.int32)
        ss[:n] = seg_start
        ee[:n] = seg_end
        keep = np.arange(b) < n
        out = obs.dispatch(
            "depth", depth_kernel.fused_depth,
            torch.from_numpy(ss).to(dev), torch.from_numpy(ee).to(dev),
            torch.from_numpy(keep).to(dev), *scalars, length=length,
            window=1, dense=True)
    return out[3]


def _chunk_columns(handles, bais, tid, start, end, mapq, min_cov,
                   max_cov, n_min, dev):
    """One chunk → (qualifying positions relative to ``start`` (int64),
    their (positions, samples) int32 depth columns), both on the host.
    The depth matrix and the qualifying mask stay on ``dev``."""
    rows = []
    for handle, bai in zip(handles, bais):
        ss, ee = _decode_shard_segments(handle, bai, tid, start, end, mapq)
        rows.append(_sample_depth(ss, ee, start, end, max_cov, dev))
    mat = torch.stack(rows)
    qual = ((mat >= min_cov).sum(dim=0) > n_min) & (mat.sum(dim=0) > 0)
    idx = torch.nonzero(qual)[:, 0]
    cols = mat.index_select(1, idx).T
    return idx.cpu().numpy(), np.ascontiguousarray(cols.cpu().numpy())


def run_multidepth(
    bams: list[str],
    chrom: str,
    mapq: int = 10,
    min_cov: int = 7,
    max_cov: int = 1000,
    max_skip: int = 10,
    min_size: int = 15,
    window: int = 10_000_000,
    min_samples: float = 0.5,
    out=None,
    device=None,
):
    """The command's body on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    out = out or sys.stdout
    handles = []
    bais = []
    names = []
    tid = None
    chrom_len = None
    for b in bams:
        handles.append(open_bam_file(b))
        hdr = handles[-1].header
        if getattr(handles[-1], "is_cram", False):
            bais.append(None)  # CRAM region access rides its .crai
        else:
            bai_p = b + ".bai" if os.path.exists(b + ".bai") \
                else b[:-4] + ".bai"
            bais.append(read_bai(bai_p))
        names.append(get_short_name(b))
        if tid is None:
            if chrom not in hdr.ref_names:
                raise SystemExit(
                    f"multidepth: chromosome {chrom} not found in {b}"
                )
            tid = hdr.tid(chrom)
            chrom_len = hdr.ref_lens[tid]

    n_min = int(0.5 + min_samples * len(bams))
    out.write("#chrom\tstart\tend\t" + "\t".join(names) + "\n")

    # the current run of qualifying sites, carried across chunks;
    # run_ok: it already has min_size sites, some of its blocks written
    run_pos = np.zeros(0, np.int64)
    run_cols = np.zeros((0, len(bams)), np.int32)
    run_ok = False

    def write_blocks(pos, cols, last: bool):
        """Write a run's blocks (multidepth.go:184-199): each block takes
        the sites within ``window`` of its first; per-sample mean over
        the block's sites divided by its span → the sites not written
        (the open last block, unless ``last``)."""
        i = 0
        while i < len(pos):
            j = int(np.searchsorted(pos, pos[i] + window))
            if j == len(pos) and not last:
                break
            bs, be = int(pos[i]), int(pos[j - 1]) + 1
            means = cols[i:j].sum(axis=0, dtype=np.int64) / (be - bs)
            out.write(f"{chrom}\t{bs}\t{be}\t"
                      + "\t".join(f"{m:.2f}" for m in means) + "\n")
            i = j
        return pos[i:], cols[i:]

    for cstart in range(0, chrom_len, CHUNK):
        cend = min(cstart + CHUNK, chrom_len)
        idx, cols = _chunk_columns(handles, bais, tid, cstart, cend, mapq,
                                   min_cov, max_cov, n_min, dev)
        pos = np.concatenate([run_pos, cstart + idx.astype(np.int64)])
        cols = np.concatenate([run_cols, cols])
        # a gap wider than max_skip ends a run: every run but the last
        # is complete, and written if it has min_size sites
        lo = 0
        for hi in np.flatnonzero(np.diff(pos) - 1 > max_skip) + 1:
            if run_ok or hi - lo >= min_size:
                write_blocks(pos[lo:hi], cols[lo:hi], True)
            lo, run_ok = hi, False
        run_pos, run_cols = pos[lo:], cols[lo:]
        if run_ok or len(run_pos) >= min_size:
            run_ok = True
            run_pos, run_cols = write_blocks(run_pos, run_cols, False)
    if run_ok or len(run_pos) >= min_size:
        write_blocks(run_pos, run_cols, True)


def main(argv=None):
    p = argparse.ArgumentParser(
        "goleft-tpu-torch multidepth",
        description="joint depth blocks across many bams",
    )
    p.add_argument("-Q", "--mapq", type=int, default=10)
    p.add_argument("-c", "--chrom", required=True)
    p.add_argument("--mincov", type=int, default=7)
    p.add_argument("--maxcov", type=int, default=1000)
    p.add_argument("-k", "--maxskip", type=int, default=10)
    p.add_argument("-m", "--minsize", type=int, default=15)
    p.add_argument("-w", "--window", type=int, default=10_000_000)
    p.add_argument("--minsamples", type=float, default=0.5)
    from . import add_no_crc_flag, apply_no_crc

    add_no_crc_flag(p)
    p.add_argument("bams", nargs="+")
    a = p.parse_args(argv)
    apply_no_crc(a.no_crc)
    run_multidepth(
        a.bams, a.chrom, mapq=a.mapq, min_cov=a.mincov, max_cov=a.maxcov,
        max_skip=a.maxskip, min_size=a.minsize, window=a.window,
        min_samples=a.minsamples,
    )


if __name__ == "__main__":
    main()
