#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (goleft_tpu_torch).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--out FILE] [--trace-dir DIR]

1. prints the card's provenance (torch / CUDA versions, name, power limit);
2. builds the hand-written kernels (csrc/depth_kernel.cu,
   csrc/pairhmm_kernel.cu, csrc/rans_kernel.cu) from the checkout, one
   nvcc each, started together, and prints the build seconds and the
   ptxas reports;
3. holds the depth kernel against its plain PyTorch version on the card at
   one full production shard (10 Mb, 2,000,000 segments of 150 bp, window
   250, max mean depth 100, cap 2600), on both wires and on the u16 wire
   with one 65,535-base segment more (the tile kernel's widest halo),
   with edge cases (a 10,000-segment hotspot in one 1024-base region,
   endpoints at 0 and at the shard end, keep-masked segments, a region
   strictly inside the shard, segments of 65,536 bases and more, a gap
   that needs u16 fillers), then the small cases of DEPTH_EDGES on both
   wires (no segments, all in one tile past the cap, a length that is no
   multiple of the tile, windows of 7, 251 and 250, one window wider
   than a tile, window sums above 2^24, ...). Depth, window sums,
   classes and packed classes must be bitwise equal; prints the
   kernel's time per shard by CUDA events around one call and as device
   time (a CUDA graph of 20 calls), the plain version's, the bound, and
   the bytes a dense=False call allocates (it fails on the u16 wire if
   they could hold a per-base int32 buffer);
4. fabricates a coordinate-sorted 25 Mb BAM + BAI (5,000,000 reads of
   150 bp, MAPQ 0 / DUP / SECONDARY reads, D / N / S / I CIGARs, a pileup
   above the cap), runs ``python -m goleft_tpu_torch depth`` on it in a
   fresh process (launch counts start at 0 there and come back in its
   ``--metrics-out`` run manifest) and compares both BED files byte for byte
   with an independent numpy oracle;
5. holds the pair-HMM kernel against its plain version on the card, f32
   rescaled and f64 unscaled, contribs and shifts bitwise: one bucket of
   4,096 pairs of 150 bp reads (quals 2-41, mismatches, indels, N) x
   416 bp haplotypes, edge buckets (read longer than hap, a 1-base read,
   a q93 read, 300 bp junk reads below 1e-100), a bucket of 1,100 bp
   reads (r1 1,121: five strips of 256 rows), buckets of r1 = 32 R and
   32 R + 1 rows for every compiled R = 1..8 (256 | 257: the strip edge)
   and the adoption trap (pm = 0 where each read's first base meets its
   hap's first base, zero priors in other rows); the ptxas registers and
   spills of every instantiation (no spills allowed); padding invariance on
   the card (a pair alone = in its bucket; bucket 32 = bucket 128 over
   each pair's live steps); 16 pairs against a copy of the test suite's
   numpy f64 log-space oracle and the long bucket against a row-at-a-time
   f64 oracle checked against it (1e-4 log10 in f32, 1e-9 in f64); prints the kernel's and the
   plain version's median ms, GCUPS and the compute bound;
6. fabricates a windows document of 1,000 windows (4 haplotypes of
   350-452 bp, 80 reads of 150 bp each), runs ``python -m
   goleft_tpu_torch pairhmm --candidates`` on ~80% of it in a fresh
   process, checks the table, the launch count (one per length bucket)
   and 20 windows' genotype, GQ and PL (+-1) against the oracle, prints
   the seconds, pairs/s, GCUPS and stage split; then a run with a
   permanent injected fault must exit 3 with a quarantine manifest;
7. fabricates a CRAM cohort with tools/bulk_cram.py: 4 samples of
   200,000 reads of 150 bp with quality strings (3% MAPQ 0, 2%
   duplicates) on one 2,000,000 bp contig, 10,000 records per container,
   rANS-Nx16 blocks ORDER0, ORDER1, ORDER1 and STRIPE 4 (the JAX
   package's make_cram_cohort with a second ORDER1 sample, so two sample
   threads launch ORDER1 at once); and the matrix from the generated
   reads;
8. holds the rANS kernel against its plain version bitwise: N = 4 and X32
   x ORDER0 and ORDER1 x plain, RLE, PACK and RLE+PACK at the sizes of
   tests/test_rans_device.py up to 20,000 bytes, and STRIPE with uneven
   lanes, on the card; eight threads, each on its own CUDA stream,
   launching ORDER1 groups of seven table sizes at once, each launch
   against the plain version; then every launch of one real 10,000-record
   container of each codec (ORDER0, ORDER1, STRIPE 4) against the plain
   version run on the host CPU on copies of the same inputs; the device
   decode (kernel, expansions, interleave) against the data and the host
   decoder; a missing ORDER1 context must raise; prints the kernel's and
   the plain version's time per container of each codec, its cycles a
   round (ms x the SM clock / the longest stream's rounds; that stream
   alone too) and both bounds;
9. runs ``python -m goleft_tpu_torch cohortdepth --decode-device`` on the
   cohort in fresh processes, with the hybrid engine (the main path), the
   device engine, and ``GOLEFT_TPU_FAULTS=decode:after=1:transient``;
   every matrix must equal the oracle byte for byte, with no decode
   fallback and exactly the rans launches counted on the host from the
   files (per shard, the containers it decodes; per container, its
   launch groups), whose split it prints; prints the seconds, import
   seconds, stage seconds and samples x contig bp per second;
10. the flags: ``depth --cache DIR`` twice on phase 4's BAM (3 depth
   launches, then 0 with a cache hit per shard; both BEDs byte-identical
   to the oracle each time), ``depth --profile DIR`` (torch.profiler's
   Chrome trace holds each shard's ``wire_starts`` and ``depth_tiles``),
   ``cohortdepth --decode-device`` and ``pairhmm`` under ``--trace-out``
   (output bytes unchanged; one ``run.<command>`` root, every span
   parented, one fenced ``device.<kernel>`` span per launch, the
   manifest's trace id; prints the fenced-kernel share beside the
   untraced command's seconds), and ``cohortdepth --checkpoint-dir``
   on a four-region BED killed by ``--inject-faults
   shard:after=2:kill`` (SIGKILL), resumed (the oracle's bytes, fewer
   rans launches than an uninterrupted run) and resumed again over the
   complete store (0 rans launches, the same bytes);
11. the EM at cohort width: an int16 matrix of 64,445 windows (chr20 at
   1 kb) x 2,504 samples (the 1000 Genomes phase-3 cohort) with planted
   deletions and duplications, through ``call_cnvs``'s normalisation and
   ``_batched_em`` on the card (four 16,384-window f64 chunks); λ of 64
   sampled windows within rtol = atol = 1e-9 of tests/oracle_emdepth.py
   and their CN equal to its CN clamped at 8; cn.mops on one chunk
   against the port's CPU path on 64 of its rows; prints the ms a chunk
   (CUDA events), the peak of ``torch.cuda.max_memory_allocated`` and
   window-samples a second;
12. ``python -m goleft_tpu_torch cnv -w 1000 --vcf --matrix-out`` on 8
   BAMs of 400,000 150 bp reads (15x) on one 4 Mb contig, a 200 kb het
   deletion in one sample and a 150 kb duplication in another, under
   ``--engine device`` (depth-kernel launches from its manifest) and the
   default engine: both byte-identical to the port's
   ``run_cnv(device="cpu")``, both planted events called; the
   ``cohortdepth -w 1000`` window-mean matrix of the same BAMs under
   ``--engine device`` (one depth launch a sample) byte-identical to the
   hybrid engine's; then ``emdepth --mops-out --gain-out`` on that
   matrix, on the card against the CPU (the differing windows are
   printed on a failure); prints samples x contig bp a second;
13. prints the kernels line, the card's ``nvidia-smi`` name and power
   limit, and as the last line ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, without a CUDA device, outside a
checkout, or when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

SHARD = 10_000_000  # one production shard (commands/depth.py STEP)
WINDOW = 250
MAX_MEAN = 100
CAP = MAX_MEAN + 2500
MIN_COV = 4
READ_LEN = 150
# H100 SXM data-sheet peaks: HBM bytes/s, and the float32 rate outside
# the tensor cores, used for this kernel's 32-bit integer operations
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12

E2E_LEN = 25_000_000
E2E_READS = 5_000_000
E2E_CIGARS = ["150M", "70M10D80M", "60M300N90M", "20S130M", "130M20S",
              "75M5I70M"]
E2E_CIGAR_P = [0.70, 0.06, 0.06, 0.06, 0.06, 0.06]
# (start, end) offsets of each CIGAR's M blocks from the read position
E2E_BLOCKS = [[(0, 150)], [(0, 70), (80, 160)], [(0, 60), (360, 450)],
              [(0, 130)], [(0, 130)], [(0, 75), (75, 145)]]
PILE_POS, PILE_READS = 12_345_678, 3_000


def log(*a):
    print(*a, flush=True)


def cuda_median_ms(fn, reps: int = 20) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def shard_segments(rng):
    """Absolute endpoints for one shard at w0 = 30,000,000: reads that
    overhang both shard ends (endpoints clip to 0 and to the shard
    length), a hotspot tile, zero- and one-base segments, a gap."""
    w0 = 30_000_000
    n = 2_000_000
    s = rng.integers(w0 - 500, w0 + SHARD + 500, n)
    e = s + READ_LEN
    hot_lo = w0 + 4884 * 1024  # one 1024-base tile of the shard
    hot = rng.integers(hot_lo, hot_lo + 1024, 10_000)
    edges_s = np.array([w0, w0, w0 + SHARD - 100, w0 + SHARD - 1, w0 + 7])
    edges_e = np.array([w0 + 100, w0 + 1, w0 + SHARD, w0 + SHARD, w0 + 7])
    s = np.concatenate([s, hot, edges_s])
    e = np.concatenate([e, hot + rng.integers(600, 1200, len(hot)),
                        edges_e])
    # a 200 kb gap, bridged on the u16 wire by 65535-base fillers
    gap = (s >= w0 + 6_000_000) & (s < w0 + 6_200_000)
    s, e = s[~gap], e[~gap]
    keep = rng.random(len(s)) > 0.05
    longs = (np.array([w0 + 3_000_000, w0 - 10]),
             np.array([w0 + 3_000_000 + 70_000, w0 + SHARD + 10]))
    return w0, (s.astype(np.int32), e.astype(np.int32), keep), longs


def cuda_graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    replayed between two events (median of ``reps``), divided by
    ``calls``. Unlike :func:`cuda_median_ms` the host's enqueue of each
    call (allocations, argument marshalling) is not inside the window."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


def u16_wire(s, e, keep):
    """The packed u16 wire of ``commands/depth.py`` (kept segments sorted,
    bucket-padded with zero entries; no entries when there are no
    segments) → (deltas, lens, base), or None for a segment of 65,536
    bases or more."""
    from goleft_tpu_torch.ops.coverage import bucket_size, pack_segments_u16

    order = np.argsort(s, kind="stable")
    packed = pack_segments_u16(s[order], e[order], keep[order])
    if packed is None:
        return None
    d, ln, base, n_ent = packed
    b = bucket_size(n_ent) if n_ent else 0
    dd = np.zeros(b, np.uint16)
    ll = np.zeros(b, np.uint16)
    dd[:n_ent], ll[:n_ent] = d, ln
    return dd, ll, int(base)


def depth_main_cases(dev, dk):
    """The kernel phase's 10 Mb shard (seed 2024) for ``dk``, a
    goleft_tpu_torch.ops.depth_kernel module: name → (kernel(dense),
    plain(), wire entries, wire bytes an entry). "int32": every segment,
    the ultra-long ones included, over the whole shard; "u16": the kept
    segments under 65,536 bases, a region strictly inside the shard;
    "u16_halo": the same plus one 65,535-base segment (the widest halo
    of the tile kernel)."""
    import torch

    from goleft_tpu_torch.ops.coverage import bucket_size

    rng = np.random.default_rng(2024)
    w0, (s, e, keep), (ls, le) = shard_segments(rng)
    full = (w0, w0, w0 + SHARD, CAP, MIN_COV, MAX_MEAN, SHARD, WINDOW)
    inner = (w0, w0 + 130, w0 + SHARD - 100, CAP, MIN_COV, MAX_MEAN, SHARD,
             WINDOW)

    # int32 wire: bucket-padded with keep=False
    s32 = np.concatenate([s, ls.astype(np.int32)])
    e32 = np.concatenate([e, le.astype(np.int32)])
    k32 = np.concatenate([keep, [True, True]])
    pad = bucket_size(len(s32)) - len(s32)
    s32 = np.concatenate([s32, np.zeros(pad, np.int32)])
    e32 = np.concatenate([e32, np.zeros(pad, np.int32)])
    k32 = np.concatenate([k32, np.zeros(pad, bool)])
    ts, te, tk = (torch.from_numpy(x).to(dev) for x in (s32, e32, k32))
    cases = {"int32": (
        lambda dense: dk.fused_depth(ts, te, tk, *full, dense=dense),
        lambda: dk.fused_depth_plain(ts, te, tk, *full), len(s32), 9)}

    halo_s = w0 + 4_000_000
    for name, (ss, ee) in (
            ("u16", (s, e)),
            ("u16_halo", (np.append(s, np.int32(halo_s)),
                          np.append(e, np.int32(halo_s + 0xFFFF))))):
        kk = np.append(keep, True) if len(ss) > len(s) else keep
        dd, ll, base = u16_wire(ss, ee, kk)
        assert (dd == 0xFFFF).any() and (ll == 0).any(), \
            "the u16 case must hold gap fillers"
        td, tl = (torch.from_numpy(x).to(dev) for x in (dd, ll))
        cases[name] = (
            lambda dense, td=td, tl=tl, base=base: dk.fused_depth_wire(
                td, tl, base, *inner, dense=dense),
            lambda td=td, tl=tl, base=base: dk.fused_depth_wire_plain(
                td, tl, base, *inner), len(dd), 4)
    return cases


def _edge_random(rng, n, lo, hi, max_len=400):
    s = np.sort(rng.integers(lo, hi, n)).astype(np.int32)
    e = (s + rng.integers(0, max_len, n)).astype(np.int32)
    return s, e, rng.random(n) < 0.9


def _edge_halo(rng):
    s, e, k = _edge_random(rng, 20_000, -300, 100_300)
    return (np.append(s, np.int32(5_000)), np.append(e, np.int32(70_535)),
            np.append(k, True), (0, 0, 100_000, CAP, MIN_COV, 40, 100_000,
                                 WINDOW))


def _edge_gap(rng):
    s, e, k = _edge_random(rng, 6_000, 0, 300_000)
    gap = (s >= 20_000) & (s < 220_000)
    s, e, k = s[~gap], e[~gap], k[~gap]
    return s, e, k, (0, 0, 300_000, CAP, MIN_COV, 40, 300_000, WINDOW)


def _edge_one_tile(rng):
    # 3,000 segments inside the tile [8,000, 12,000), all covering
    # [9,000, 11,000): the depth passes the cap of 2,600
    s = rng.integers(8_000, 9_000, 3_000).astype(np.int32)
    e = rng.integers(11_000, 12_000, 3_000).astype(np.int32)
    return s, e, np.ones(3_000, bool), (0, 0, 40_000, CAP, MIN_COV,
                                        MAX_MEAN, 40_000, WINDOW)


def _edge_empty(rng):
    z = np.zeros(0, np.int32)
    return z, z, np.zeros(0, bool), (0, 0, 40_000, CAP, MIN_COV, 40,
                                     40_000, WINDOW)


def _edge_inner(rng):
    w0 = 30_000_000
    s, e, k = _edge_random(rng, 8_000, w0 - 500, w0 + 40_500)
    return s, e, k, (w0, w0 + 130, w0 + 40_000 - 100, 60, MIN_COV, 40,
                     40_000, WINDOW)


def _edge_ragged(rng):
    s, e, k = _edge_random(rng, 2_000, -100, 10_350)
    return s, e, k, (0, 0, 10_250, 60, MIN_COV, 40, 10_250, WINDOW)


def _edge_window(w):
    def build(rng):
        length = w * (20_000 // w)
        s, e, k = _edge_random(rng, 3_000, -100, length + 100)
        return s, e, k, (0, 5, length - 3, 60, MIN_COV, 40, length, w)
    return build


def _edge_wide_window(rng):
    # DepthEngine's single window when window >= max_span (300,000 bp)
    s, e, k = _edge_random(rng, 5_000, 0, 300_000)
    return s, e, k, (0, 130, 299_930, 60, MIN_COV, 5, 300_032, 300_032)


def _edge_big_sums(rng):
    # 300-deep everywhere: a window sums 19,660,800 > 2**24
    length = 2 * 65_536
    s = np.arange(0, length, 60_000, dtype=np.int32).repeat(300)
    e = np.minimum(s + 0xFFFF, length).astype(np.int32)
    return s, e, np.ones(len(s), bool), (0, 0, length, CAP, MIN_COV,
                                         MAX_MEAN, length, 65_536)


#: the depth kernel's edge cases: name → builder(rng) → (seg_start,
#: seg_end, keep, (w0, rs, re, cap, min_cov, max_mean, length, window));
#: tests/test_torch_cuda.py runs them on the card and
#: tests/test_torch_depth_pipeline.py against the JAX package
DEPTH_EDGES = {
    "halo_65535": _edge_halo,
    "gap_200kb": _edge_gap,
    "one_tile_to_cap": _edge_one_tile,
    "empty": _edge_empty,
    "inner_region": _edge_inner,
    "ragged_length": _edge_ragged,
    "window_7": _edge_window(7),
    "window_251": _edge_window(251),
    "window_250": _edge_window(250),
    "window_wider_than_tile": _edge_wide_window,
    "sums_above_2e24": _edge_big_sums,
}


def depth_edge_case(name: str):
    """One edge case of :data:`DEPTH_EDGES` (its own seed) → (case, the
    u16 wire or None)."""
    seed = sorted(DEPTH_EDGES).index(name) + 70
    case = DEPTH_EDGES[name](np.random.default_rng(seed))
    return case, u16_wire(*case[:3])


def depth_edges_on_card(dev, dk) -> int:
    """Every edge case on both wires (the u16 wire where it can carry
    the segments), dense outputs, bitwise against the plain version.
    Returns the number of kernel calls checked."""
    import torch

    checked = 0
    for name in DEPTH_EDGES:
        (s, e, keep, args), wire = depth_edge_case(name)
        runs = [("int32", [torch.from_numpy(x).to(dev) for x in (s, e,
                                                                 keep)],
                 dk.fused_depth, dk.fused_depth_plain)]
        if wire is not None:
            dd, ll, base = wire
            runs.append(("u16", [torch.from_numpy(dd).to(dev),
                                 torch.from_numpy(ll).to(dev), base],
                         dk.fused_depth_wire, dk.fused_depth_wire_plain))
        for wname, t, kern, plain in runs:
            got = kern(*t, *args, dense=True)
            want = plain(*t, *args)
            torch.cuda.synchronize()
            for nm, g, w in zip(("sums", "packed", "cls", "depth"), got,
                                want):
                if g.dtype != w.dtype or g.shape != w.shape \
                        or not torch.equal(g, w):
                    raise AssertionError(
                        f"depth kernel edge case {name} ({wname} wire): "
                        f"{nm} differs from the plain version")
            checked += 1
    return checked


def depth_scratch_bytes(dev, kern) -> int:
    """Bytes a ``dense=False`` call allocates on the card beyond what is
    already there (its inputs): workspace and outputs, at their peak."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    out = kern(False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - before
    del out
    return int(peak)


def kernel_phase(dev):
    """Phase 3: kernel vs plain version at one full shard, both wires,
    and the edge cases."""
    import torch

    from goleft_tpu_torch.ops import depth_kernel as dk

    out = {}
    max_err = 0
    cases = depth_main_cases(dev, dk)
    for wire, (kern, plain, n_in, bytes_per) in cases.items():
        got = kern(True)
        want = plain()
        torch.cuda.synchronize()
        names = ("sums", "packed", "cls", "depth")
        for nm, g, w in zip(names, got, want):
            if g.dtype != w.dtype or g.shape != w.shape \
                    or not torch.equal(g, w):
                bad = (g.to(torch.float64) - w.to(torch.float64)).abs()
                raise AssertionError(
                    f"depth kernel ({wire} wire): {nm} differs from the "
                    f"plain version (max abs err {bad.max().item()})")
            max_err = max(max_err, (g.to(torch.float64)
                                    - w.to(torch.float64)).abs().max()
                          .item())
        assert int(got[3].max()) == CAP, "the hotspot must reach the cap"
        assert int((got[2] == 3).sum()) > 0, "class 3 must occur"
        ms = cuda_median_ms(lambda: kern(False))
        device_ms = cuda_graph_ms(lambda: kern(False))
        plain_ms = cuda_median_ms(plain)
        scratch = depth_scratch_bytes(dev, kern)
        n_win = SHARD // WINDOW
        bytes_moved = n_in * bytes_per + 4 * n_win + (SHARD + 3) // 4
        ops = 8 * SHARD + 10 * n_in
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT_OPS_PER_S * 1e3
        out[wire] = {
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "segments": n_in,
            "scratch_bytes": scratch,
        }
        log(f"depth kernel {wire} wire: bitwise equal to the plain version "
            f"(depth, sums, classes, packed); {n_in} entries, median "
            f"{ms:.4f} ms/shard by events around a call, {device_ms:.4f} "
            f"ms device time (CUDA graph of 20 calls), {plain_ms:.4f} ms "
            f"plain, bound {out[wire]['bound_ms']:.4f} ms "
            f"({out[wire]['bound_by']}); a dense=False call allocates "
            f"{scratch} bytes (workspace + outputs)")
    # the u16 wire must not allocate a per-base int32 buffer
    for wire in ("u16", "u16_halo"):
        assert out[wire]["scratch_bytes"] < 4 * SHARD, out[wire]
    out["edge_calls"] = depth_edges_on_card(dev, dk)
    log(f"depth kernel edge cases: {len(DEPTH_EDGES)} cases, "
        f"{out['edge_calls']} kernel calls bitwise equal to the plain "
        f"version ({', '.join(DEPTH_EDGES)})")
    out["max_abs_err"] = max_err
    return out


def fabricate(workdir: str, rng):
    """Phase 4 input: reads, BAM + BAI, FASTA."""
    from goleft_tpu_torch.io.bai import write_bai
    from tools.bulk_bam import write_bam_bulk

    n = E2E_READS
    pos = rng.integers(0, E2E_LEN - 500, n - PILE_READS)
    pos = np.sort(np.concatenate([pos, np.full(PILE_READS, PILE_POS)]))
    cig = rng.choice(len(E2E_CIGARS), n, p=E2E_CIGAR_P)
    mapq = np.where(rng.random(n) < 0.03, 0, 60).astype(np.uint8)
    flag = rng.choice([0, 0x400, 0x100], n, p=[0.95, 0.03, 0.02]) \
        .astype(np.uint16)
    bam = os.path.join(workdir, "smoke.bam")
    idx = write_bam_bulk(bam, "chr1", E2E_LEN, pos, cig, E2E_CIGARS, mapq,
                         flag)
    write_bai(idx, bam + ".bai")
    fa = os.path.join(workdir, "ref.fa")
    write_fasta(fa, rng, E2E_LEN)
    return bam, fa, (pos, cig, mapq, flag)


def write_fasta(path: str, rng, length: int) -> bytes:
    """A random ACGT contig ``chr1`` in 60-base lines → its bases."""
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)]
    full = length // 60 * 60
    rows = np.concatenate([seq[:full].reshape(-1, 60),
                           np.full((full // 60, 1), 10, np.uint8)], axis=1)
    with open(path, "wb") as fh:
        fh.write(b">chr1\n" + rows.tobytes())
        if length > full:
            fh.write(seq[full:].tobytes() + b"\n")
    return seq.tobytes()


def oracle_beds(reads) -> tuple[str, str]:
    """Both BED files from the generated read list: np.add.at-style
    bincount + cumsum, cap, %.4g window means, per-shard class runs."""
    pos, cig, mapq, flag = reads
    kept = (mapq >= 1) & ((flag & 0x704) == 0)
    starts, ends = [], []
    for t, blocks in enumerate(E2E_BLOCKS):
        p = pos[kept & (cig == t)]
        for a, b in blocks:
            starts.append(p + a)
            ends.append(p + b)
    starts = np.concatenate(starts)
    ends = np.concatenate(ends)
    delta = (np.bincount(starts, minlength=E2E_LEN + 1)
             - np.bincount(ends, minlength=E2E_LEN + 1))
    depth = np.minimum(np.cumsum(delta[:E2E_LEN]), CAP)
    cls = np.where(depth == 0, 0, np.where(
        depth < MIN_COV, 1, np.where(depth >= MAX_MEAN, 3, 2)))
    names = ("NO_COVERAGE", "LOW_COVERAGE", "CALLABLE", "EXCESSIVE_COVERAGE")
    sums = depth.reshape(-1, WINDOW).sum(axis=1)
    drows = [f"chr1\t{i * WINDOW}\t{(i + 1) * WINDOW}\t{s / WINDOW:.4g}\n"
             for i, s in enumerate(sums.tolist())]
    crows = []
    for lo in range(0, E2E_LEN, SHARD):
        c = cls[lo:lo + SHARD]
        cut = np.flatnonzero(c[1:] != c[:-1]) + 1
        rs = np.concatenate([[0], cut])
        re = np.concatenate([cut, [len(c)]])
        crows += [f"chr1\t{lo + a}\t{lo + b}\t{names[v]}\n"
                  for a, b, v in zip(rs.tolist(), re.tolist(),
                                     c[rs].tolist())]
    assert (cls == 3).any() and (depth == CAP).any()
    return "".join(drows), "".join(crows)


def import_breakdown(root: str, env: dict) -> dict:
    """Cumulative import seconds of torch, numpy and the depth command's
    module, from ``python -X importtime`` in a fresh process."""
    r = subprocess.run(
        [sys.executable, "-X", "importtime", "-c",
         "import goleft_tpu_torch.commands.depth"],
        cwd=root, env=env, capture_output=True, text=True, check=True)
    want = ("torch", "numpy", "goleft_tpu_torch.commands.depth")
    out = {}
    for line in r.stderr.splitlines():
        parts = line.split("|")
        if len(parts) == 3 and parts[2].strip() in want:
            out[parts[2].strip()] = int(parts[1]) / 1e6
    return out


def e2e_phase(root: str, workdir: str):
    """→ (results, (bam, fasta, the oracle's depth BED, callable BED))."""
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    bam, fa, reads = fabricate(workdir, rng)
    log(f"fabricated {E2E_READS} reads on a {E2E_LEN} bp contig in "
        f"{time.perf_counter() - t0:.1f} s")
    prefix = os.path.join(workdir, "out")
    report = os.path.join(workdir, "report.json")
    cmd = [sys.executable, "-m", "goleft_tpu_torch", "--metrics-out",
           report, "depth", "--prefix", prefix, "-r", fa, "-w",
           str(WINDOW), "-m", str(MAX_MEAN), bam]
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                       text=True)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"depth CLI failed ({r.returncode}):\n"
                             f"{r.stderr[-4000:]}")
    rep, cmd_s, stages = read_manifest(report, "depth")
    assert rep["native_io"], "the native host decoder was not loaded"
    launches = rep["kernel_launches"]["depth"]
    assert launches >= 1, "the depth CLI never launched the depth kernel"
    want_d, want_c = oracle_beds(reads)
    for path, want in ((prefix + ".depth.bed", want_d),
                       (prefix + ".callable.bed", want_c)):
        with open(path) as fh:
            _same_bytes(f"{os.path.basename(path)} (against the numpy "
                        "oracle)", fh.read(), want)
    log(f"depth CLI: {E2E_LEN} bp, {E2E_READS} reads; process wall "
        f"{wall:.3f} s = {E2E_LEN / wall / 1e9:.4f} Gbases/s, command "
        f"{cmd_s:.3f} s = {E2E_LEN / cmd_s / 1e9:.4f} Gbases/s end to end; "
        f"both BEDs byte-identical to the numpy oracle; kernel launches "
        f"{launches} for {-(-E2E_LEN // SHARD)} shards")
    imports = rep["import_seconds"]
    rest = cmd_s - imports - stages.get("setup", 0.0) \
        - stages.get("shard-loop", 0.0)
    log(f"stage seconds: interpreter start {wall - cmd_s:.3f}, command "
        f"import {imports:.3f}, unattributed {rest:.3f}, " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(stages.items()))
        + " (setup and shard-loop are wall clock; host-decode, "
        "device-compute and write-output are summed over shard threads)")
    import_split = import_breakdown(root, env)
    log("import breakdown (python -X importtime, a second process, "
        "cumulative seconds): " + json.dumps(import_split))
    return {"wall_s": wall, "command_s": cmd_s, "import_s": imports,
            "unattributed_s": rest, "import_breakdown": import_split,
            "gbases_per_s": E2E_LEN / cmd_s / 1e9,
            "gbases_per_s_process": E2E_LEN / wall / 1e9,
            "launches": launches, "stage_seconds": stages,
            "backend": rep["backend"]}, (bam, fa, want_d, want_c)


# ---- pair-HMM phases ---------------------------------------------------

PH_B = 4096  # pairs of the kernel phase's main bucket
PH_READ, PH_HAP = 150, 416  # r_pad 160 (r1 161), h_pad 416
PH_LONG = (1100, 1200, 8)  # read bp, hap bp, pairs: r1 1121, two strips
PH_WINDOWS, PH_WINDOW_READS = 1000, 80
PH_ORACLE_WINDOWS = 20
PH_FAULT_SPEC = "pairhmm:every=1:permanent:times=99"
# r1 values that reach each compiled R (r1 = 32 R) and the first r1 of
# the next (32 R + 1); 256 | 257 is the strip edge
PH_GEOMETRY_R1 = [r1 for rows in range(1, 9) for r1 in (32 * rows,
                                                        32 * rows + 1)]
# float32 / float64 instruction rates outside the tensor cores, counting
# a multiply or an add as one operation: 132 SMs x 128 (f32) or 64 (f64)
# lanes x 1.98 GHz. The data sheet's 67 / 34 TFLOP/s count an FMA as two
# operations, but the kernel is built with -fmad=false and issues every
# multiply and add on its own, so these are its peak rates.
F32_OPS_PER_S = 132 * 128 * 1.98e9
F64_OPS_PER_S = 132 * 64 * 1.98e9
_CODES = np.frombuffer(b"ACGTN", np.uint8)
_LN10 = np.log(10.0)


def oracle_log10(r, err, h, gap_open=45.0, gap_ext=10.0):
    """Row-major log-space forward, one cell at a time: a copy of
    tests/test_pairhmm.py::oracle_log10 taking base codes and error
    probabilities."""
    delta = 10.0 ** (-gap_open / 10.0)
    eps = 10.0 ** (-gap_ext / 10.0)
    l_mm = np.log(1 - 2 * delta)
    l_gap_open = np.log(delta)       # M→I and M→D
    l_gap_to_m = np.log1p(-eps)      # I→M and D→M
    l_gap_ext = np.log(eps)          # I→I and D→D
    R, H = len(r), len(h)
    M = np.full((R + 1, H + 1), -np.inf)
    I = np.full((R + 1, H + 1), -np.inf)
    D = np.full((R + 1, H + 1), -np.inf)
    D[0, :] = -np.log(H)
    lse = np.logaddexp
    for i in range(1, R + 1):
        lm = np.log1p(-err[i - 1])
        lx = np.log(err[i - 1] / 3.0)
        for j in range(1, H + 1):
            match = (r[i - 1] == h[j - 1]) or r[i - 1] == 4 \
                or h[j - 1] == 4
            prior = lm if match else lx
            M[i, j] = prior + lse(
                l_mm + M[i - 1, j - 1],
                lse(l_gap_to_m + I[i - 1, j - 1],
                    l_gap_to_m + D[i - 1, j - 1]))
            I[i, j] = lse(l_gap_open + M[i - 1, j],
                          l_gap_ext + I[i - 1, j])
            D[i, j] = lse(l_gap_open + M[i, j - 1],
                          l_gap_ext + D[i, j - 1])
    tot = -np.inf
    for j in range(1, H + 1):
        tot = lse(tot, lse(M[R, j], I[R, j]))
    return tot / np.log(10.0)


def oracle_log10_rows(reads, errs, h, gap_open=45.0, gap_ext=10.0):
    """The same forward for n reads of one length ((n, R) codes and
    errors) against one haplotype, row-major in f64 with each row scaled
    by its max and the log of the scales kept: M and I of row i from row
    i-1 as vectors, D along the row as the linear recurrence
    D[j] = δ M[j-1] + ε D[j-1] (scipy.signal.lfilter). → (n,) log10."""
    from scipy.signal import lfilter

    n, R = reads.shape
    H = len(h)
    delta = 10.0 ** (-gap_open / 10.0)
    eps = 10.0 ** (-gap_ext / 10.0)
    t_mm, t_gm = 1.0 - 2.0 * delta, 1.0 - eps
    M = np.zeros((n, H + 1))
    I = np.zeros((n, H + 1))
    D = np.full((n, H + 1), 1.0 / H)
    log_scale = np.zeros(n)
    for i in range(R):
        rb = reads[:, i][:, None]
        e = errs[:, i][:, None]
        match = (rb == h[None, :]) | (rb == 4) | (h[None, :] == 4)
        prior = np.where(match, 1.0 - e, e / 3.0)
        Mn = np.zeros((n, H + 1))
        In = np.zeros((n, H + 1))
        Mn[:, 1:] = prior * (t_mm * M[:, :-1]
                             + t_gm * (I[:, :-1] + D[:, :-1]))
        In[:, 1:] = delta * M[:, 1:] + eps * I[:, 1:]
        Dn = np.zeros((n, H + 1))
        Dn[:, 1:] = lfilter([delta], [1.0, -eps], Mn[:, :-1], axis=1)
        top = np.maximum(np.maximum(Mn.max(axis=1), In.max(axis=1)),
                         Dn.max(axis=1))[:, None]
        M, I, D = Mn / top, In / top, Dn / top
        log_scale += np.log(top[:, 0])
    return (np.log(np.sum(M[:, 1:] + I[:, 1:], axis=1)) + log_scale) \
        / _LN10


def oracle_genotype(ll):
    """(R, H) log10 → (genotype "a/b", GQ, PLs): diploid likelihoods over
    a ≤ b in VCF order, PL = rint(-10 (gl - max)) capped 99999, GQ the
    second-smallest PL capped 99."""
    gl, pairs = [], []
    for b in range(ll.shape[1]):
        for a in range(b + 1):
            pairs.append((a, b))
            gl.append(float(np.sum(
                np.logaddexp(ll[:, a] * _LN10, ll[:, b] * _LN10) / _LN10
                - np.log10(2.0))))
    gl = np.array(gl)
    best = int(np.argmax(gl))
    pl = np.clip(np.rint(-10.0 * (gl - gl[best])), 0, 99999).astype(int)
    gq = int(min(np.sort(pl)[1], 99)) if len(pl) > 1 else 0
    return f"{pairs[best][0]}/{pairs[best][1]}", gq, pl.tolist()


def ph_read(rng, hap, read_len, quals, indels=True):
    """Base codes of a read drawn from ``hap``: maybe a 1-3 bp insertion
    or deletion, base errors at each base's quality, N at 0.5%."""
    src = hap
    u = rng.random() if indels else 1.0
    if u < 0.2 and len(hap) > 4:
        v = int(rng.integers(1, len(hap) - 3))
        k = int(rng.integers(1, 4))
        src = (np.concatenate([hap[:v], rng.integers(0, 4, k), hap[v:]])
               if u < 0.1 else np.concatenate([hap[:v], hap[v + k:]]))
    st = int(rng.integers(0, max(1, len(src) - read_len + 1)))
    r = np.resize(src[st:st + read_len], read_len).astype(np.uint8)
    err = rng.random(read_len) < 10.0 ** (-np.asarray(quals) / 10.0)
    r[err] = (r[err] + rng.integers(1, 4, int(err.sum()))) % 4
    r[rng.random(read_len) < 0.005] = 4
    return r


def ph_pairs(rng, n, read_len, hap_len, qual=None, junk=False):
    """n (read codes, phred quals, hap codes) triples."""
    reads, quals, haps = [], [], []
    for _ in range(n):
        h = rng.integers(0, 4, hap_len).astype(np.uint8)
        q = np.full(read_len, qual) if qual is not None \
            else rng.integers(2, 42, read_len)
        r = rng.integers(0, 4, read_len).astype(np.uint8) if junk \
            else ph_read(rng, h, read_len, q)
        reads.append(r)
        quals.append(q)
        haps.append(h)
    return reads, quals, haps


def ph_packed(rng, n, r1, hap_len, dtype, qual=None, junk=False):
    """n pairs of (r1 - 1) bp reads x ``hap_len`` bp haps packed at
    exactly r1 rows (``_pack_bucket`` with r_pad = r1 - 1)."""
    from goleft_tpu_torch.ops import pairhmm as tph

    reads, quals, haps = ph_pairs(rng, n, r1 - 1, hap_len, qual, junk)
    return tph._pack_bucket(list(range(n)), reads,
                            [tph.phred_to_err(q) for q in quals], haps,
                            r1 - 1, tph._pad_up(hap_len), dtype)


def ph_trap_bucket(rng, n, read_len, hap_len, dtype):
    """The adoption trap, packed: junk q20 reads whose first base is
    their hap's first base, at pm = 0, so cell (1, 1) is all zero inside
    the valid area, and 3% of the other rows' pm and px zeroed. Such
    zero cells meet rows that renormalise on the same diagonal, where
    an all-zero cell must adopt the counter its upper neighbour has just
    computed."""
    from goleft_tpu_torch.ops import pairhmm as tph

    reads, quals, haps = ph_pairs(rng, n, read_len, hap_len, qual=20,
                                  junk=True)
    for r, h in zip(reads, haps):
        r[0] = h[0]
    reads_p, pm, px, rlens, haps_p, hlens = tph._pack_bucket(
        list(range(n)), reads, [tph.phred_to_err(q) for q in quals], haps,
        tph._pad_up(read_len), tph._pad_up(hap_len), dtype)
    pm[:, 1] = 0
    pm[:, 2:][rng.random(pm[:, 2:].shape) < 0.03] = 0
    px[:, 2:][rng.random(px[:, 2:].shape) < 0.03] = 0
    return reads_p, pm, px, rlens, haps_p, hlens


def kernel_resources(build_log: str) -> dict:
    """ptxas's report of the pair-HMM kernel's instantiations →
    {"float32 R6": {"registers", "spill_stores", "spill_loads"}, ...}."""
    import re

    out, key = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '\S*pairhmm_forward_kernel"
                      r"I([fd])Lb[01]ELi(\d)E", line)
        if m:
            key = f"{'float32' if m[1] == 'f' else 'float64'} R{m[2]}"
            out[key] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if key and m:
            out[key].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if key and m:
            out[key]["registers"] = int(m[1])
            key = None
    return out


def pairhmm_kernel_phase(dev):
    """Kernel vs plain version on the card (f32 rescaled, f64 unscaled):
    one full bucket of 4,096 pairs, edge buckets, a 1,100 bp bucket;
    padding invariance; 16 pairs against the log-space oracle and the
    long bucket against the row oracle; the main bucket's times and
    bound."""
    import torch

    from goleft_tpu_torch.ops import pairhmm as tph
    from goleft_tpu_torch.ops import pairhmm_kernel as pk

    resources = kernel_resources(pk.BUILD_LOG)
    if resources:
        log("pairhmm kernel instantiations (ptxas): " + json.dumps(resources))
        spills = {k: v for k, v in resources.items()
                  if v.get("spill_stores") or v.get("spill_loads")}
        assert len(resources) == 16 and not spills, spills
    rng = np.random.default_rng(150)
    cases = {
        "main": ph_pairs(rng, PH_B, PH_READ, PH_HAP),
        "read>hap": ph_pairs(rng, 8, PH_READ, 100),
        "1-base": ph_pairs(rng, 8, 1, PH_HAP),
        "q93": ph_pairs(rng, 8, PH_READ, PH_HAP, qual=93),
        "junk300": ph_pairs(rng, 4, 300, PH_HAP, qual=35, junk=True),
        "long1100": ph_pairs(rng, PH_LONG[2], PH_LONG[0], PH_LONG[1]),
    }
    folded = {}
    max_err = 0.0
    out = {}
    for name, (reads, quals, haps) in cases.items():
        errs = [tph.phred_to_err(q) for q in quals]
        r_pad = tph._pad_up(len(reads[0]))
        h_pad = tph._pad_up(len(haps[0]))
        idxs = list(range(len(reads)))
        for dtype in (np.float32, np.float64):
            rescale = dtype == np.float32
            packed = tph._pack_bucket(idxs, reads, errs, haps, r_pad, h_pad,
                                      dtype)
            trans = tph.transition_probs().astype(dtype)
            t = [torch.from_numpy(a).to(dev) for a in (*packed, trans)]
            got = pk.forward_bucket(*t, rescale=rescale)
            want = pk.forward_bucket_plain(*t, rescale=rescale)
            torch.cuda.synchronize()
            err = (got[0].double() - want[0].double()).abs().max().item()
            max_err = max(max_err, err)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(
                    f"pairhmm kernel ({name}, {np.dtype(dtype).name}): "
                    f"differs from the plain version (contribs max abs "
                    f"err {err}, shifts equal "
                    f"{torch.equal(got[1], want[1])})")
            lg = tph._fold_contribs(got[0].cpu().numpy(),
                                    got[1].cpu().numpy())
            lw = tph._fold_contribs(want[0].cpu().numpy(),
                                    want[1].cpu().numpy())
            assert np.abs(lg - lw).max() <= 1e-6 and np.isfinite(lg).all()
            if not rescale:
                assert not got[1].any(), "f64 shifts must stay 0"
            folded[name, rescale] = lg
            if name == "main":
                # padding invariance: pair 7 alone in a bucket of its own
                solo = tph._pack_bucket([7], reads, errs, haps, r_pad,
                                        h_pad, dtype)
                ts = [torch.from_numpy(a).to(dev) for a in (*solo, trans)]
                one = pk.forward_bucket(*ts, rescale=rescale)
                assert torch.equal(one[0][0], got[0][7]) and \
                    torch.equal(one[1][0], got[1][7]), \
                    "a pair alone differs from the same pair in its bucket"
                ms = cuda_median_ms(
                    lambda: pk.forward_bucket(*t, rescale=rescale))
                plain_ms = cuda_median_ms(
                    lambda: pk.forward_bucket_plain(*t, rescale=rescale),
                    reps=3)
                out[np.dtype(dtype).name] = {"ms": ms, "plain_ms": plain_ms}
        log(f"pairhmm kernel {name}: {len(reads)} pairs, r1 {r_pad + 1} "
            f"(R, strips: {pk.launch_geometry(r_pad + 1)}), h_pad {h_pad}: "
            f"contribs and shifts bitwise equal to the plain version in f32 "
            f"and f64")

    # every compiled R and its edges, the strip edge, and the adoption
    # trap: packed arrays straight to the kernel, bitwise
    grng = np.random.default_rng(32)
    geometry = {f"r1={r1}": lambda dtype, r1=r1: ph_packed(
        grng, 16, r1, 120, dtype, qual=40 if r1 % 2 else None,
        junk=bool(r1 % 2)) for r1 in PH_GEOMETRY_R1}
    geometry["trap"] = lambda dtype: ph_trap_bucket(grng, 64, PH_READ,
                                                    PH_HAP, dtype)
    for name, make in geometry.items():
        for dtype in (np.float32, np.float64):
            rescale = dtype == np.float32
            packed = make(dtype)
            trans = tph.transition_probs().astype(dtype)
            t = [torch.from_numpy(a).to(dev) for a in (*packed, trans)]
            got = pk.forward_bucket(*t, rescale=rescale)
            want = pk.forward_bucket_plain(*t, rescale=rescale)
            torch.cuda.synchronize()
            err = (got[0].double() - want[0].double()).abs().max().item()
            max_err = max(max_err, err)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(
                    f"pairhmm kernel ({name}, {np.dtype(dtype).name}): "
                    f"differs from the plain version (contribs max abs "
                    f"err {err}, shifts equal "
                    f"{torch.equal(got[1], want[1])})")
    log("pairhmm kernel geometry cases, (R, strips) by r1: " + ", ".join(
        f"{r1} {pk.launch_geometry(r1)}" for r1 in PH_GEOMETRY_R1)
        + "; and the adoption trap (64 pairs, 150 x 416): contribs and "
        "shifts bitwise equal to the plain version in f32 and f64")

    # padding invariance at bucket 32 vs bucket 128: each pair's kernel
    # outputs over its live steps bitwise; the host fold's np.sum runs
    # over the padded step count, whose pairwise order can move the last
    # bit, so the folded values are held within 1e-12
    sel = [(cases["main"], i) for i in range(min(480, PH_B))] + [
        (cases[n], i) for n in ("read>hap", "1-base", "q93", "junk300")
        for i in range(len(cases[n][0]))]
    reads = [c[0][i] for c, i in sel]
    quals = [c[1][i] for c, i in sel]
    haps = [c[2][i] for c, i in sel]
    errs = [tph.phred_to_err(q) for q in quals]
    trans = tph.transition_probs().astype(np.float32)
    per_bucket = []
    for bucket in (32, 128):
        outs = {}
        for (rp, hp), idxs in tph.bucket_pairs(reads, haps,
                                               bucket).items():
            packed = tph._pack_bucket(idxs, reads, errs, haps, rp, hp,
                                      np.float32)
            c, s = tph.forward_bucket_device(packed, trans, True, dev)
            for row, n in enumerate(idxs):
                live = len(reads[n]) + len(haps[n]) + 1
                outs[n] = (c[row, :live], s[row, :live],
                           tph._fold_contribs(c[row:row + 1],
                                              s[row:row + 1])[0])
        per_bucket.append(outs)
    fold_ulps = 0
    for n in range(len(reads)):
        (c32, s32, f32), (c128, s128, f128) = (o[n] for o in per_bucket)
        assert np.array_equal(c32, c128) and np.array_equal(s32, s128), \
            f"pair {n}: kernel outputs differ at bucket 32 and 128"
        assert abs(f32 - f128) <= 1e-12, (n, f32, f128)
        fold_ulps += int(f32 != f128)
    log(f"pairhmm padding invariance on the card: a pair alone = in its "
        f"bucket (f32, f64); {len(reads)} pairs' kernel outputs bitwise "
        f"equal at bucket 32 and bucket 128 ({fold_ulps} folded values "
        f"differ in the last bits through the host fold's summation "
        f"order, all within 1e-12)")

    # the log-space oracle (the test suite's, cell by cell) on 8 main
    # pairs + 2 of each edge case; the row oracle, checked against it,
    # on the long bucket
    worst = {True: 0.0, False: 0.0}
    picks = [("main", i) for i in range(8)] + [
        (n, i) for n in ("read>hap", "1-base", "q93", "junk300")
        for i in range(2)]
    for name, i in picks:
        r, q, h = (x[i] for x in cases[name])
        want = oracle_log10(r, tph.phred_to_err(q), h)
        if i == 0:
            rows = oracle_log10_rows(r[None, :],
                                     tph.phred_to_err(q)[None, :], h)[0]
            assert abs(rows - want) < 1e-9, (name, rows, want)
        if name == "junk300":
            assert want < -100, f"the junk read's log10 is {want}"
        for rescale in (True, False):
            worst[rescale] = max(worst[rescale],
                                 abs(folded[name, rescale][i] - want))
    assert worst[True] < 1e-4 and worst[False] < 1e-9, worst
    reads, quals, haps = cases["long1100"]
    long_err = {True: 0.0, False: 0.0}
    for i in range(len(reads)):
        want = oracle_log10_rows(reads[i][None, :],
                                 tph.phred_to_err(quals[i])[None, :],
                                 haps[i])[0]
        for rescale in (True, False):
            long_err[rescale] = max(long_err[rescale], abs(
                folded["long1100", rescale][i] - want))
    assert long_err[True] < 1e-4 and long_err[False] < 1e-9, long_err
    log(f"pairhmm vs the log-space oracle: 16 pairs max |err| "
        f"{worst[True]:.3e} (f32) / {worst[False]:.3e} (f64); "
        f"{len(reads)} pairs of 1,100 bp: {long_err[True]:.3e} / "
        f"{long_err[False]:.3e}")

    # times and bound of the main bucket
    reads, quals, haps = cases["main"]
    cells = sum(len(r) * len(h) for r, h in zip(reads, haps))
    r1, h_pad = tph._pad_up(PH_READ) + 1, tph._pad_up(PH_HAP)
    # cells the kernel sweeps: 32 R row slots a pair x r1 + hap diagonals
    row_slots = PH_B * pk.LANES * pk.launch_geometry(r1)[0] * (r1 + h_pad)
    bytes_moved = PH_B * (r1 * 9 + h_pad + 8 + (r1 + h_pad) * 8) + 20
    res = {"cells": cells, "row_slots": row_slots, "bytes": bytes_moved,
           "ops_per_cell": pk.OPS_PER_CELL, "max_abs_err": max_err,
           "oracle_err_f32": worst[True], "oracle_err_f64": worst[False],
           "geometry": {n: pk.launch_geometry(n)
                        for n in (r1, tph._pad_up(PH_LONG[0]) + 1)},
           "resources": resources}
    for name, rate in (("float32", F32_OPS_PER_S),
                       ("float64", F64_OPS_PER_S)):
        t_ops = pk.OPS_PER_CELL[name] * cells / rate * 1e3
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        m = out[name]
        m.update(bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 gcups=cells / m["ms"] / 1e6,
                 gcups_row_slots=row_slots / m["ms"] / 1e6)
        res[name] = m
        log(f"pairhmm kernel {name}, {PH_B} pairs of {PH_READ} x {PH_HAP}: "
            f"median {m['ms']:.4f} ms kernel, {m['plain_ms']:.4f} ms "
            f"plain; {m['gcups']:.2f} GCUPS over {cells} useful cells, "
            f"{m['gcups_row_slots']:.2f} over {row_slots} row slots swept; "
            f"bound {m['bound_ms']:.4f} ms ({m['bound_by']}: "
            f"{pk.OPS_PER_CELL[name]} ops/cell at {rate:.3g}/s; "
            f"{bytes_moved} bytes at {HBM_BYTES_PER_S:.3g}/s); "
            f"library: none")
    return res


def fabricate_windows(rng, n_windows: int, n_reads: int) -> dict:
    """A goleft-tpu.pairhmm-windows/1 document: per window 4 haplotypes
    of 350-452 bp (ref, a SNP, a 2 bp insertion, a 3 bp deletion) and
    ``n_reads`` 150 bp reads drawn from a diploid genotype of ref and one
    alt, with base errors at their qualities (85% q25-41, 15% q2-24) and
    phred+33 quality strings."""
    windows = []
    for w in range(n_windows):
        L = int(rng.integers(350, 451))
        ref = rng.integers(0, 4, L).astype(np.uint8)
        v = int(rng.integers(L // 3, 2 * L // 3))
        snp = ref.copy()
        snp[v] = (ref[v] + rng.integers(1, 4)) % 4
        ins = np.concatenate([ref[:v], rng.integers(0, 4, 2), ref[v:]])
        dele = np.concatenate([ref[:v], ref[v + 3:]])
        haps = [ref, snp, ins.astype(np.uint8), dele]
        alt = int(rng.integers(1, 4))
        gt = [(0, 0), (0, alt), (alt, alt)][int(rng.integers(3))]
        reads = []
        for k in range(n_reads):
            q = np.where(rng.random(PH_READ) < 0.85,
                         rng.integers(25, 42, PH_READ),
                         rng.integers(2, 25, PH_READ))
            r = ph_read(rng, haps[gt[k % 2]], PH_READ, q, indels=False)
            reads.append({"seq": _CODES[r].tobytes().decode(),
                          "quals": (q + 33).astype(np.uint8).tobytes()
                          .decode()})
        start = 100_000 * (w % 250)
        windows.append({"chrom": f"chr{1 + w // 250}", "start": start,
                        "end": start + L,
                        "haplotypes": [_CODES[h].tobytes().decode()
                                       for h in haps],
                        "reads": reads})
    return {"schema": "goleft-tpu.pairhmm-windows/1", "windows": windows}


def _write_candidates_bed(path: str, windows) -> None:
    with open(path, "w") as fh:
        fh.write("#goleft-tpu-candidates=1 source=chip_smoke\n")
        fh.write("#chrom\tstart\tend\tsample\tCN\tlog2FC\n")
        for w in windows:
            fh.write(f"{w['chrom']}\t{w['start']}\t{w['end']}\tsmoke\t1\t"
                     "-1.0000\n")


def _run_cli(root: str, args: list[str], env: dict):
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "goleft_tpu_torch", *args],
                       cwd=root, env=env, capture_output=True, text=True)
    return r, time.perf_counter() - t0


def read_manifest(path: str, prog: str):
    """A CLI run's ``--metrics-out`` run manifest, validated
    (obs/manifest.py) → (manifest, the command's seconds: its
    ``run.<prog>`` span, {stage: seconds} of the other spans)."""
    from goleft_tpu_torch.obs.manifest import load_manifest

    rep = load_manifest(path)
    spans = {k: v["seconds"] for k, v in rep["spans"].items()}
    return rep, spans.pop(f"run.{prog}"), spans


def pairhmm_e2e_phase(root: str, workdir: str) -> dict:
    """``python -m goleft_tpu_torch pairhmm`` at full width in a fresh
    process: 1,000 windows x 4 haplotypes x 80 reads of 150 bp, ~80% of
    them selected by a candidates BED; table rows, launch count, a
    20-window oracle subset; then a permanent fault quarantines and the
    run exits 3."""
    rng = np.random.default_rng(80)
    t0 = time.perf_counter()
    doc = fabricate_windows(rng, PH_WINDOWS, PH_WINDOW_READS)
    wpath = os.path.join(workdir, "windows.json")
    with open(wpath, "w") as fh:
        json.dump(doc, fh)
    keep = rng.random(PH_WINDOWS) < 0.8
    kept = [w for w, k in zip(doc["windows"], keep) if k]
    cpath = os.path.join(workdir, "candidates.bed")
    _write_candidates_bed(cpath, kept)
    n_pairs = sum(len(w["reads"]) * len(w["haplotypes"]) for w in kept)
    cells = sum(len(r["seq"]) * len(h) for w in kept for r in w["reads"]
                for h in w["haplotypes"])
    log(f"fabricated {PH_WINDOWS} windows ({len(kept)} selected: "
        f"{n_pairs} pairs, {cells} cells) in "
        f"{time.perf_counter() - t0:.1f} s")

    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GOLEFT_TPU_FAULTS", None)
    report = os.path.join(workdir, "pairhmm_report.json")
    table = os.path.join(workdir, "table.tsv")
    r, wall = _run_cli(root, ["--metrics-out", report, "pairhmm",
                              "--candidates", cpath, "--out", table, wpath],
                       env)
    if r.returncode != 0:
        raise AssertionError(f"pairhmm CLI failed ({r.returncode}):\n"
                             f"{r.stderr[-4000:]}")
    rep, cmd_s, stages = read_manifest(report, "pairhmm")
    launches = rep["kernel_launches"]["pairhmm"]
    counters = rep["metrics"]["counters"]
    buckets = counters["pairhmm.buckets_total"]
    assert launches >= 1 and launches == buckets, (launches, buckets)
    assert counters["pairhmm.pairs_total"] == n_pairs
    with open(table) as fh:
        rows = fh.read().splitlines()
    assert rows[0].startswith("#chrom\tstart\tend"), rows[0]
    assert len(rows) - 1 == len(kept), (len(rows) - 1, len(kept))
    by_key = {(t[0], int(t[1])): t for t in (x.split("\t")
                                             for x in rows[1:])}

    from goleft_tpu_torch.ops.pairhmm import encode_seq, phred_to_err

    t0 = time.perf_counter()
    pick = np.linspace(0, len(kept) - 1, PH_ORACLE_WINDOWS).astype(int)
    worst_pl = 0
    for wi in pick:
        w = kept[wi]
        reads = np.stack([encode_seq(x["seq"]) for x in w["reads"]])
        errs = np.stack([phred_to_err(np.frombuffer(
            x["quals"].encode(), np.uint8).astype(np.int64) - 33)
            for x in w["reads"]])
        ll = np.stack([oracle_log10_rows(reads, errs, encode_seq(h))
                       for h in w["haplotypes"]], axis=1)
        gt, gq, pl = oracle_genotype(ll)
        row = by_key[w["chrom"], w["start"]]
        got_pl = [int(x) for x in row[7].split(",")]
        worst_pl = max(worst_pl, max(abs(a - b)
                                     for a, b in zip(got_pl, pl)))
        if row[5] != gt or int(row[6]) != gq or len(got_pl) != len(pl) \
                or worst_pl > 1:
            raise AssertionError(
                f"window {w['chrom']}:{w['start']}: port {row[5:]} vs "
                f"oracle {gt} {gq} {pl}")
    log(f"pairhmm oracle subset: {PH_ORACLE_WINDOWS} windows, genotype and "
        f"GQ equal, PL max |diff| {worst_pl} "
        f"({time.perf_counter() - t0:.1f} s)")

    rest = cmd_s - rep["import_seconds"] - sum(stages.values())
    log(f"pairhmm CLI: {len(kept)} windows, {n_pairs} pairs, {cells} cells; "
        f"process wall {wall:.3f} s, command {cmd_s:.3f} s, import "
        f"{rep['import_seconds']:.3f} s; {n_pairs / cmd_s:.1f} pairs/s, "
        f"{cells / cmd_s / 1e9:.4f} GCUPS end to end; kernel launches "
        f"{launches} = {buckets} length buckets; stage seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items()))
        + f", unattributed {rest:.3f}")

    # degraded run: every bucket fails permanently → quarantine, exit 3
    small = dict(doc, windows=[dict(w, reads=w["reads"][:10])
                               for w in doc["windows"][:5]])
    spath = os.path.join(workdir, "small.json")
    with open(spath, "w") as fh:
        json.dump(small, fh)
    qpath = os.path.join(workdir, "quarantine.json")
    freport = os.path.join(workdir, "fault_report.json")
    r, _ = _run_cli(root, ["--metrics-out", freport, "pairhmm",
                           "--quarantine-out", qpath, "--out",
                           os.path.join(workdir, "fault.tsv"), spath],
                    dict(env, GOLEFT_TPU_FAULTS=PH_FAULT_SPEC))
    assert r.returncode == 3, (r.returncode, r.stderr[-2000:])
    with open(qpath) as fh:
        q = json.load(fh)["quarantined"]
    assert len(q) == 5 and all(e["phase"] == "pairhmm" for e in q), q
    with open(os.path.join(workdir, "fault.tsv")) as fh:
        assert fh.read().count("\n") == 1
    frep = read_manifest(freport, "pairhmm")[0]
    assert frep["exit_code"] == 3
    assert frep["metrics"]["counters"]["pairhmm.buckets_failed_total"] >= 1
    log(f"pairhmm with {PH_FAULT_SPEC}: exit 3, {len(q)} windows "
        "quarantined, manifest written")
    return {"wall_s": wall, "command_s": cmd_s,
            "import_s": rep["import_seconds"], "windows": len(kept),
            "pairs": n_pairs, "cells": cells,
            "pairs_per_s": n_pairs / cmd_s, "gcups": cells / cmd_s / 1e9,
            "unattributed_s": rest,
            "launches": launches, "stage_seconds": stages,
            "oracle_pl_max_diff": worst_pl,
            "fixture": {"windows": wpath, "candidates": cpath,
                        "table": table}}

# ---- rANS-Nx16 and cohortdepth phases --------------------------------

RANS_SIZES = [0, 1, 3, 17, 63, 64, 65, 127, 4095, 4097, 8191, 20000]
RANS_STRIPE_SIZES = (20000, 19999, 19998, 4097, 101, 7)
RANS_O1_SHIFTS = (10, 7)
# the dependent chain of one N = 4 round of csrc/rans_kernel.cu, in SM
# cycles (assumed from its instructions, see PERF.md §6). ORDER0: the next
# slot's address (mask, shift-add, ~8), the 64-bit shared slot load (~30),
# the frequency mask and the multiply-add (~9), the compare and the rank
# adds (~9), the word permute, the merge permute and the select (~12).
# ORDER1: the entry's address from the previous entry and the slot (~12),
# the 64-bit entry load (~30), the bounds' extraction and the step check
# (~12), the multiply-add (~9), then as ORDER0 (~21). STRIPE lanes are
# ORDER0.
RANS_CYCLES_PER_ROUND = {"ORDER0": 68, "ORDER1": 84, "STRIPE4": 68}
CO_SAMPLES, CO_LEN, CO_READS = 4, 2_000_000, 200_000
CO_RPC, CO_WINDOW = 10_000, 500
# (rANS order, stripe lanes) per sample, as the JAX package's
# ops/decode_smoke.py::make_cram_cohort (ORDER0, ORDER0, ORDER1, STRIPE 4)
# with its second sample ORDER1 too: the sample threads then launch
# ORDER1 groups of different table sizes at once
CO_CODECS = [(0, 0), (1, 0), (1, 0), (0, 4)]
CO_FAULT = "decode:after=1:transient"


def rans_flag_matrix(rng):
    """(data, stream) cases: N = 4 and X32 x ORDER0 and ORDER1 x plain,
    RLE, PACK and RLE+PACK at tests/test_rans_device.py's sizes, ORDER1
    at shifts 10 and 7 and with 256 contexts, and STRIPE with uneven lanes
    (ORDER0, X32 and ORDER1 lanes)."""
    from goleft_tpu_torch.io import rans_nx16 as rx

    ramp = (np.cumsum(rng.choice([0, 0, 0, 1, 2, 5], 20000)) % 120) \
        .astype(np.uint8)
    cases = []
    for x32 in (False, True):
        for order in (0, 1):
            for rle, pack in ((False, False), (True, False), (False, True),
                              (True, True)):
                for sz in RANS_SIZES:
                    if order:
                        d = ramp[:sz] % 11 if pack else ramp[:sz]
                    else:
                        a = 7 if pack else int(rng.integers(2, 48))
                        d = rng.integers(0, a, sz).astype(np.uint8)
                    d = d.tobytes()
                    cases.append((d, rx.encode(d, order=order, use_rle=rle,
                                               use_pack=pack, x32=x32)))
        for shift in RANS_O1_SHIFTS:
            for sz in RANS_SIZES[-4:]:
                d = ramp[:sz].tobytes()
                cases.append((d, rx.encode(d, order=1, x32=x32,
                                           shift=shift)))
    # 256 contexts: the widest ORDER1 table
    wide = (np.cumsum(rng.choice([0, 1, 2, 3, 255], RANS_SIZES[-1])) % 256) \
        .astype(np.uint8).tobytes()
    for x32 in (False, True):
        cases.append((wide, rx.encode(wide, order=1, x32=x32)))
        assert cases[-1][1][0] & rx.F_ORDER1
    for sz in RANS_STRIPE_SIZES:
        for kw in (dict(stripe=4), dict(stripe=3), dict(stripe=4, x32=True),
                   dict(stripe=2, order=1)):
            d = ramp[:sz].tobytes()
            cases.append((d, rx.encode(d, **kw)))
    assert sum(bool(e[0] & rx.F_ORDER1) for _, e in cases) > 20
    return cases


def rans_groups(plans, dev):
    """The launch groups of ops/rans_device.py (rans_device.launch_groups)
    with their tensors on ``dev``: [(key, streams, tensors)]."""
    import torch

    from goleft_tpu_torch.ops import rans_device as rd

    return [(key, grp, {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                        for k, v in host.items()})
            for key, grp, host in rd.launch_groups(plans)]


def rans_abs_err(got, want) -> int:
    """Largest |kernel - plain| over the symbols and, for ORDER1, the
    missing-context flags of one group."""
    err = int((got[0].cpu().int() - want[0].cpu().int()).abs().max())
    if got[1] is not None:
        err = max(err, int((got[1].cpu() - want[1].cpu()).abs().max()))
    return err


def rans_bitwise(groups, what: str, wants=None) -> tuple:
    """Kernel vs plain version on every group, bitwise: the plain version
    runs on the card, or ``wants`` holds its results from the host CPU
    (:func:`rans_plain_on_host`). Returns (groups held, max abs err)."""
    from goleft_tpu_torch.ops import rans_device as rd
    from goleft_tpu_torch.ops import rans_kernel as rk

    err = 0
    for i, (key, grp, t) in enumerate(groups):
        got = rd.group_stage(key, grp, t)
        want = wants[i] if wants is not None else rd.group_stage(
            key, grp, t, rk.rans_decode_plain)
        e = rans_abs_err(got, want)
        if e:
            raise AssertionError(
                f"rans kernel ({what}, group {key}): differs from the "
                f"plain version (max abs err {e})")
        err = max(err, e)
    return len(groups), err


def rans_plain_on_host(groups) -> tuple:
    """The plain version of every launch group, on host-CPU copies of its
    inputs; run in a worker process, so the three real containers'
    comparisons (minutes each: a Python loop over 375,000 rounds) run at
    once. Returns ([(symbols, flags)], seconds)."""
    import torch

    from goleft_tpu_torch.ops import rans_device as rd
    from goleft_tpu_torch.ops import rans_kernel as rk

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = [rd.group_stage(key, grp, t, rk.rans_decode_plain)
           for key, grp, t in groups]
    return out, time.perf_counter() - t0


def rans_threads_check(dev) -> tuple:
    """Eight threads, each on its own CUDA stream as the cohort's sample
    threads are, launch ORDER1 groups of seven table sizes (2 to 256
    contexts: 4 KB to 199 KB of dynamic shared memory) at once, 42 each;
    every launch against the plain version on the host CPU. Returns
    (launches, max abs err)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from goleft_tpu_torch.io import rans_nx16 as rx
    from goleft_tpu_torch.ops import rans_device as rd
    from goleft_tpu_torch.ops import rans_kernel as rk

    rng = np.random.default_rng(61)
    ramp = np.cumsum(rng.choice([0, 1, 2, 3, 255], 6000)) % 256
    groups = []
    for a in (2, 3, 13, 39, 77, 150, 256):
        d = (ramp % a).astype(np.uint8).tobytes()
        p = rx.parse_nx16(rx.encode(d, order=1), len(d))
        assert p.order1 and p.n_ctx == a, (a, p.n_ctx)
        (key, grp, t), = rans_groups([p], dev)
        want = rd.group_stage(key, grp, {k: v.cpu() for k, v in t.items()},
                              rk.rans_decode_plain)
        groups.append((key, grp, t, want))
    torch.cuda.synchronize()

    def work(i):
        # launches queued back to back, one wait at the end: the threads'
        # launches then overlap on the host
        s = torch.cuda.Stream(dev)
        with torch.cuda.stream(s):
            order = [(i + r) % len(groups) for r in range(42)]
            outs = [rd.group_stage(*groups[g][:3]) for g in order]
        s.synchronize()
        return max(rans_abs_err(got, groups[g][3])
                   for g, got in zip(order, outs))

    with ThreadPoolExecutor(8) as pool:
        err = max(pool.map(work, range(8)))
    if err:
        raise AssertionError("rans kernel: ORDER1 launches from eight "
                             "threads differ from the plain version "
                             f"(max abs err {err})")
    return 8 * 42, err


class BlockRecorder:
    """A CRAM block decoder that keeps the raw blocks it is handed and
    decodes them on the host (io/cram.py's codecs)."""

    def __init__(self):
        self.raws = []

    def decode_blocks(self, raws):
        from goleft_tpu_torch.io.cram import decode_raw_block

        self.raws.append(list(raws))
        return [decode_raw_block(rb).data for rb in raws]


def first_container_blocks(path: str):
    """The raw blocks of a CRAM file's first container (the one its
    .crai lists first)."""
    from goleft_tpu_torch.io.crai import load_crai_entries
    from goleft_tpu_torch.io.cram import CramFile

    start = load_crai_entries(path + ".crai")[0][1]  # 1-based
    cf = CramFile.from_file(path)
    rec = BlockRecorder()
    cf.set_block_decoder(rec)
    cf.read_columns(tid=0, start=start - 1, end=start)
    return rec.raws[0]


def sm_clock_hz() -> float:
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=30)
    return float(r.stdout.strip().splitlines()[0]) * 1e6


def rans_kernel_phase(dev, crams) -> dict:
    """The rANS kernel against its plain version, bitwise, on the flag
    matrix and on one real 10,000-record container of each codec of the
    cohort; the device decode (kernel + expansions + interleave) against
    the data and the host decoder; a missing ORDER1 context must raise;
    times and bounds of each container."""
    import torch

    from goleft_tpu_torch.io import rans_nx16 as rx
    from goleft_tpu_torch.io.cram import M_RANSNX16
    from goleft_tpu_torch.ops import rans_device as rd
    from goleft_tpu_torch.ops import rans_kernel as rk

    rng = np.random.default_rng(57)
    t0 = time.perf_counter()
    cases = rans_flag_matrix(rng)
    plans = [rx.parse_nx16(e, len(d)) for d, e in cases]
    assert all(p is not None for p in plans)
    held, max_err = rans_bitwise(rans_groups(plans, dev), "flag matrix")
    got = rd.decode_parsed(plans, device=dev)
    bad = [i for i, ((d, _), g) in enumerate(zip(cases, got)) if g != d]
    assert not bad, f"device decode differs from the data in cases {bad}"
    coded = sum(not (c.cat or c.stripe) for c in plans) + sum(
        not ch.cat for c in plans if c.stripe for ch in c.children)
    log(f"rans kernel flag matrix: {len(cases)} streams ({coded} rANS "
        f"streams and lanes, the rest CAT), {held} launch "
        f"groups bitwise equal to the plain version; device decode (kernel, "
        f"RLE/PACK expansions, STRIPE interleave) equals the data "
        f"({time.perf_counter() - t0:.1f} s)")

    # a context row knocked out: the kernel's diagnostic, as the plain
    # version's, and the JAX package's error
    d, e = max(((d, e) for d, e in cases if e[0] & rx.F_ORDER1),
               key=lambda c: len(c[0]))
    p = rx.parse_nx16(e, len(d))
    used = np.flatnonzero(p.ctx_index >= 0)
    p.ctx_index = p.ctx_index.copy()
    p.ctx_index[used[len(used) // 2]] = -1
    (key, grp, t), = rans_groups([p], dev)
    kb = rd.group_stage(key, grp, t)[1]
    pb = rd.group_stage(key, grp, t, rk.rans_decode_plain)[1]
    assert int(kb[0]) == int(pb[0]) == 1, (kb, pb)
    try:
        rd.decode_parsed([p], device=dev)
    except ValueError as e:
        assert "missing order-1 context" in str(e), e
    else:
        raise AssertionError("a missing ORDER1 context did not raise")
    log("rans kernel: a missing ORDER1 context sets the kernel's "
        "diagnostic and raises 'rans-nx16: missing order-1 context'")
    t0 = time.perf_counter()
    n, err = rans_threads_check(dev)
    max_err = max(max_err, err)
    log(f"rans kernel: {n} ORDER1 launches of 2 to 256 contexts from eight "
        "threads on their own streams, at once, bitwise equal to the plain "
        f"version ({time.perf_counter() - t0:.1f} s)")

    out = {}
    clock = sm_clock_hz()
    # every group of each container against the plain version, run once
    # on the host CPU (on the card each of its rounds is a few dozen small
    # launches, minutes at 375,000 rounds), the three containers at once
    # in worker processes while the card times the kernel
    pending = []
    with ProcessPoolExecutor(3, mp_context=mp.get_context("spawn")) as pool:
        for k, label in ((0, "ORDER0"), (2, "ORDER1"), (3, "STRIPE4")):
            raws = [rb for rb in first_container_blocks(crams[k])
                    if rb.method == M_RANSNX16]
            cplans = [rx.parse_nx16(rb.raw, rb.rsize) for rb in raws]
            assert all(p is not None for p in cplans), label
            groups = rans_groups(cplans, dev)
            fut = pool.submit(rans_plain_on_host, [
                (key, grp, {n: v.cpu() for n, v in t.items()})
                for key, grp, t in groups])
            t0 = time.perf_counter()
            dec = rd.decode_parsed(cplans, device=dev)
            for rb, g in zip(raws, dec):
                if g != rx.decode(rb.raw, rb.rsize):
                    raise AssertionError(f"{label} container: block "
                                         f"{rb.content_id} differs from the "
                                         "host decoder")
            check_s = time.perf_counter() - t0

            def launch_all():
                for key, grp, t in groups:
                    rd.group_stage(key, grp, t)

            ms = cuda_median_ms(launch_all, reps=5)
            flat = [c for p in cplans
                    for c in (p.children if p.stripe else [p]) if not c.cat]

            def rounds_of(c):
                return rk.rounds_needed(torch.tensor([c.inner_len]),
                                        c.n_states, c.order1)

            longest = max(flat, key=rounds_of)
            rounds = rounds_of(longest)
            # the longest stream alone: its rounds without the container's
            # other launches queued before or after it on the stream
            (lkey, lgrp, lt), = rans_groups([longest], dev)
            lone_ms = cuda_median_ms(lambda: rd.group_stage(lkey, lgrp, lt),
                                     reps=5)
            nbytes = sum(c.payload_bytes + c.table_bytes + c.inner_len
                         for c in flat)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 16 * sum(c.inner_len for c in flat) / INT_OPS_PER_S * 1e3
            cyc = RANS_CYCLES_PER_ROUND[label]
            res = {"ms": ms, "launches_per_container": len(groups),
                   "group_keys": [list(k) for k, _, _ in groups],
                   "streams": len(flat), "longest_rounds": rounds,
                   "cycles_per_round": ms * 1e-3 * clock / rounds,
                   "longest_stream_ms": lone_ms,
                   "longest_stream_cycles_per_round":
                       lone_ms * 1e-3 * clock / rounds,
                   "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "chain_cycles_per_round": cyc,
                   "chain_bound_ms": rounds * cyc / clock * 1e3,
                   "sm_clock_hz": clock,
                   "qs_bytes": max(rb.rsize for rb in raws)}
            out[label] = res
            pending.append((label, groups, fut, len(raws), len(flat),
                            check_s))
        for label, groups, fut, n_raws, n_flat, check_s in pending:
            wants, plain_s = fut.result()
            _, err = rans_bitwise(groups, f"{label} container", wants)
            max_err = max(max_err, err)
            res = out[label]
            rounds, cyc = res["longest_rounds"], res["chain_cycles_per_round"]
            res["plain_ms"] = plain_s * 1e3
            res["plain_us_per_round"] = plain_s * 1e6 / rounds
            log(f"rans kernel, {label} container of {CO_RPC} records: "
                f"{n_raws} rANS blocks = {n_flat} streams in "
                f"{len(groups)} launches {res['group_keys']}, longest "
                f"{rounds} rounds; decode equals the host decoder "
                f"({check_s:.1f} s with the check); kernel median "
                f"{res['ms']:.3f} ms per container = "
                f"{res['cycles_per_round']:.1f} cycles a round at "
                f"{clock / 1e6:.0f} MHz (the longest stream alone "
                f"{res['longest_stream_ms']:.3f} ms = "
                f"{res['longest_stream_cycles_per_round']:.1f} cycles a "
                f"round), every group bitwise equal to the plain version on "
                f"the host CPU ({res['plain_ms']:.1f} ms, in a worker "
                f"process); bound {res['bound_ms']:.4f} ms "
                f"({res['bound_by']}: {res['bytes']} bytes), dependence "
                f"chain {res['chain_bound_ms']:.3f} ms ({rounds} rounds x "
                f"{cyc} cycles); library: none")
    out["max_abs_err"] = max_err
    return out


def cohort_fabricate(workdir: str, rng, n_reads=CO_READS, contig_len=CO_LEN,
                     rpc=CO_RPC):
    """The cohort: per sample ``n_reads`` 150 bp reads with quality
    strings (3% MAPQ 0, 2% duplicates), written by tools/bulk_cram.py with
    the sample's codec; a .fai. → (paths, fai, names, truth)."""
    from tools.bulk_cram import write_cram_files

    files, truth = [], []
    for i, (order, stripe) in enumerate(CO_CODECS):
        pos = np.sort(rng.integers(0, contig_len - READ_LEN, n_reads))
        mapq = np.where(rng.random(n_reads) < 0.03, 0, 60)
        flag = np.where(rng.random(n_reads) < 0.02, 0x400, 0)
        drift = np.arange(READ_LEN) // 10
        quals = (np.clip(rng.normal(38, 4, (n_reads, READ_LEN)) - drift, 2, 41)
                 + 33).astype(np.uint8)
        files.append(dict(path=os.path.join(workdir, f"co{i}.cram"),
                          contig="chr1", contig_len=contig_len,
                          sample=f"co{i}", pos=pos, mapq=mapq, flag=flag,
                          quals=quals, order=order, stripe=stripe))
        truth.append((pos, mapq, flag))
    write_cram_files(files, records_per_container=rpc, read_len=READ_LEN)
    fai = os.path.join(workdir, "co.fa.fai")
    with open(fai, "w") as fh:
        fh.write(f"chr1\t{contig_len}\t6\t60\t61\n")
    return [f["path"] for f in files], fai, [f["sample"] for f in files], \
        truth


def cohort_oracle(truth, names, contig_len=CO_LEN,
                  window=CO_WINDOW) -> str:
    """The matrix from the generated reads: kept reads (MAPQ >= 1, no
    0x704 flag) → per-base depth by bincount + cumsum → window sums →
    round-half-up means."""
    cols = []
    for pos, mapq, flag in truth:
        kept = pos[(mapq >= 1) & ((flag & 0x704) == 0)]
        delta = (np.bincount(kept, minlength=contig_len + 1)
                 - np.bincount(kept + READ_LEN, minlength=contig_len + 1))
        depth = np.minimum(np.cumsum(delta[:contig_len]), 2500)
        starts = np.arange(0, contig_len, window)
        sums = np.add.reduceat(depth, starts)
        spans = np.minimum(starts + window, contig_len) - starts
        cols.append((0.5 + sums / spans).astype(np.int64))
    rows = ["#chrom\tstart\tend\t" + "\t".join(names) + "\n"]
    for k, s in enumerate(range(0, contig_len, window)):
        rows.append(f"chr1\t{s}\t{min(s + window, contig_len)}\t"
                    + "\t".join(str(c[k]) for c in cols) + "\n")
    return "".join(rows)


def cohort_launch_plan(crams, fai) -> dict:
    """The rans launches a cohortdepth run makes, counted on the host from
    the files: per shard, each container the shard's .crai lookup decodes
    (one that straddles a shard boundary is decoded once per shard); per
    container, its launch groups (rans_device.launch_groups: one per
    (ORDER1, N, shift) of its non-CAT rANS streams, stripe lanes
    flattened). → {file: {launches per container: containers
    decoded}}."""
    from collections import Counter

    from goleft_tpu_torch.commands.cohortdepth import cohort_regions
    from goleft_tpu_torch.io import rans_nx16 as rx
    from goleft_tpu_torch.io.cram import (
        M_RANSNX16, ContainerHeader, CramFile, read_block_raw,
    )
    from goleft_tpu_torch.io.fai import read_fai
    from goleft_tpu_torch.ops import rans_device as rd

    regions = cohort_regions(read_fai(fai), "", CO_WINDOW, None)
    plan = {}
    for path in crams:
        cf = CramFile.from_file(path)
        groups_at, split = {}, Counter()
        for _, s, e in regions:
            for off in cf._region_offsets(0, s, e):
                if off not in groups_at:
                    hdr, pos = ContainerHeader.parse(cf._buf, off, False)
                    end, plans = pos + hdr.length, []
                    while pos < end:
                        rb, pos = read_block_raw(cf._buf, pos)
                        if rb.method == M_RANSNX16:
                            p = rx.parse_nx16(rb.raw, rb.rsize)
                            if p is not None:
                                plans.append(p)
                    groups_at[off] = len(rd.launch_groups(plans))
                split[groups_at[off]] += 1
        plan[os.path.basename(path)] = dict(sorted(split.items()))
    return plan


def cohort_e2e_phase(root: str, workdir: str, crams, fai, want: str) -> dict:
    """``python -m goleft_tpu_torch cohortdepth --decode-device`` on the
    cohort in fresh processes: the hybrid engine (the main path), the
    device engine, and a transient fault at the decode site; every
    matrix byte-identical to the oracle; decode counters, and exactly the
    rans launches of the host's count."""
    plan = cohort_launch_plan(crams, fai)
    planned = sum(k * n for split in plan.values() for k, n in split.items())
    log(f"cohortdepth rans launch plan (file: {{launches per container: "
        f"containers decoded}}): {plan}; {planned} launches in all")
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GOLEFT_TPU_FAULTS", None)
    runs = {}
    for name, extra, run_env in (
            ("hybrid", [], env), ("device", ["--engine", "device"], env),
            ("fault", [], dict(env, GOLEFT_TPU_FAULTS=CO_FAULT))):
        report = os.path.join(workdir, f"co_{name}.json")
        r, wall = _run_cli(root, ["--metrics-out", report, "cohortdepth",
                                  "--fai", fai, "-w", str(CO_WINDOW),
                                  "--decode-device", *extra, *crams],
                           run_env)
        if r.returncode != 0:
            raise AssertionError(f"cohortdepth ({name}) failed "
                                 f"({r.returncode}):\n{r.stderr[-4000:]}")
        _same_bytes(f"cohortdepth ({name}) matrix (against the oracle)",
                    r.stdout, want)
        rep, cmd_s, stages = read_manifest(report, "cohortdepth")
        c = rep["metrics"]["counters"]
        launches = rep["kernel_launches"]
        assert launches["rans"] == planned > 0, (launches, planned)
        assert c["decode.device_blocks_total"] > 0, c
        assert c["decode.device_fallback_total"] == 0, c
        if name == "device":
            assert launches["depth"] == CO_SAMPLES, launches
        if name == "fault":
            assert c.get("resilience.retries_total", 0) >= 1, c
        runs[name] = {"wall_s": wall, "command_s": cmd_s,
                      "import_s": rep["import_seconds"],
                      "stage_seconds": stages, "launches": launches,
                      "counters": {k: v for k, v in c.items()
                                   if k.startswith(("decode.", "prefetch.",
                                                    "resilience."))},
                      "bases_per_s": CO_SAMPLES * CO_LEN / cmd_s,
                      "launch_plan": plan}
        log(f"cohortdepth --decode-device ({name}): matrix byte-identical to "
            f"the oracle; process wall {wall:.3f} s, command {cmd_s:.3f} s, "
            f"import {rep['import_seconds']:.3f} s; "
            f"{CO_SAMPLES * CO_LEN / cmd_s / 1e6:.3f} Mbases/s "
            f"({CO_SAMPLES} samples x {CO_LEN} bp); launches {launches}; "
            f"device blocks {c['decode.device_blocks_total']}, fallbacks "
            f"{c['decode.device_fallback_total']}, host blocks "
            f"{c['decode.host_blocks_total']}, retries "
            f"{c.get('resilience.retries_total', 0)}; stage seconds: "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items())))
    return runs


# ---- flags phase: cache, profile, traces, kill and resume -------------

#: regions of the kill-and-resume runs: the cohort's contig cut in four
FLAG_REGIONS = 4
FLAG_KILL = "shard:after=2:kill"


def _same_bytes(what: str, got: str, want: str) -> None:
    if got != want:
        i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        lo = max(i - 80, 0)
        raise AssertionError(f"{what} differs at byte {i}: got "
                             f"{got[lo:i + 80]!r} want "
                             f"{want[lo:i + 80]!r}")


def load_trace(path: str) -> dict:
    """A ``--trace-out`` file: Chrome trace-event JSON with exactly one
    ``run.<command>`` root, every other span's parent in the file, the
    device spans fenced and of platform gpu → {"doc", "root", "spans"
    (the ph X events), "device" (the device.* events)}."""
    with open(path) as fh:
        doc = json.load(fh)
    assert isinstance(doc.get("traceEvents"), list), path
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    for e in spans:
        assert {"name", "ts", "dur", "pid", "tid", "args"} <= set(e), e
    roots = [e for e in spans if e["name"].startswith("run.")]
    assert len(roots) == 1, [e["name"] for e in roots]
    root = roots[0]
    ids = {e["args"]["span_id"] for e in spans}
    orphans = [e["name"] for e in spans if e is not root
               and e["args"].get("parent_id") not in ids]
    assert not orphans, f"spans without a parent in the trace: {orphans[:5]}"
    assert all(e["args"]["trace_id"] == root["args"]["trace_id"]
               for e in spans)
    device = [e for e in spans if e["name"].startswith("device.")]
    for e in device:
        assert e["cat"] == "device" and e["args"]["fenced"] is True, e
        assert e["args"]["platform"] == "gpu", e
    return {"doc": doc, "root": root, "spans": spans, "device": device}


def fenced_kernel_share(tr: dict) -> float:
    """The union of the fenced device.* intervals over the run span: an
    upper bound of the kernels' share of the run (a fenced span also
    holds the enqueue and the wait), not of the card's busy share: card
    work outside the launches (copies, rANS expansions) is in no span."""
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in tr["device"])
    busy, end = 0.0, -1.0
    for a, b in iv:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy / tr["root"]["dur"]


def profile_kernels(trace_dir: str) -> dict:
    """{kernel event name: count} of the CUDA kernel events in a
    ``depth --profile`` directory's Chrome trace."""
    from collections import Counter

    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    assert files, f"no Chrome trace in {trace_dir}"
    with open(os.path.join(trace_dir, files[0])) as fh:
        doc = json.load(fh)
    return dict(Counter(e["name"] for e in doc["traceEvents"]
                        if e.get("cat") == "kernel"))


def flags_phase(root: str, workdir: str, depth_fixture, pairhmm_run: dict,
                crams, fai, want: str, co_plan_launches: int,
                untraced: dict, keep_dir: str | None) -> dict:
    """The global and per-command flags through fresh processes of
    ``python -m goleft_tpu_torch`` on the fixtures of the phases before:
    ``depth --cache`` twice and ``--profile``; ``cohortdepth
    --decode-device`` and ``pairhmm`` under ``--trace-out``; a
    checkpointed cohortdepth killed by ``--inject-faults``, resumed, and
    resumed again over the complete store."""
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GOLEFT_TPU_FAULTS", None)
    out: dict = {}
    bam, fa, want_d, want_c = depth_fixture
    shards = -(-E2E_LEN // SHARD)

    # depth --cache, twice: the second run replays every shard
    cache = os.path.join(workdir, "depth_cache")
    for run in ("cold", "warm"):
        prefix = os.path.join(workdir, f"cache_{run}")
        report = os.path.join(workdir, f"cache_{run}.json")
        r, wall = _run_cli(root, ["--metrics-out", report, "depth",
                                  "--cache", cache, "--prefix", prefix,
                                  "-r", fa, "-w", str(WINDOW), "-m",
                                  str(MAX_MEAN), bam], env)
        assert r.returncode == 0, r.stderr[-4000:]
        for path, w in ((prefix + ".depth.bed", want_d),
                        (prefix + ".callable.bed", want_c)):
            with open(path) as fh:
                _same_bytes(f"depth --cache ({run}) "
                            f"{os.path.basename(path)}", fh.read(), w)
        rep, cmd_s, _ = read_manifest(report, "depth")
        c = rep["metrics"]["counters"]
        launches = rep["kernel_launches"]["depth"]
        hits = c.get("result_cache.hits_total", 0)
        if run == "cold":
            assert launches == shards and hits == 0, (launches, c)
        else:
            assert launches == 0 and hits == shards, (launches, c)
        out[f"cache_{run}"] = {"command_s": cmd_s, "launches": launches,
                               "hits": hits}
        log(f"depth --cache ({run}): both BEDs byte-identical to the "
            f"oracle; depth launches {launches}, cache hits {hits} of "
            f"{shards} shards; command {cmd_s:.3f} s")

    # depth --profile: torch.profiler's trace holds the depth kernels
    pdir = os.path.join(workdir, "depth_profile")
    r, _ = _run_cli(root, ["depth", "--profile", pdir, "--prefix",
                           os.path.join(workdir, "prof"), "-r", fa, "-w",
                           str(WINDOW), "-m", str(MAX_MEAN), bam], env)
    assert r.returncode == 0, r.stderr[-4000:]
    kern = profile_kernels(pdir)
    for name in ("wire_starts", "depth_tiles"):
        n = sum(v for k, v in kern.items() if name in k)
        assert n == shards, (name, kern)
    out["profile_kernels"] = kern
    log(f"depth --profile: CUDA kernel events {kern}")

    # cohortdepth --decode-device --trace-out: one device.rans span a launch
    trace = os.path.join(workdir, "co_trace.json")
    report = os.path.join(workdir, "co_trace_report.json")
    r, wall = _run_cli(root, ["--trace-out", trace, "--metrics-out", report,
                              "cohortdepth", "--fai", fai, "-w",
                              str(CO_WINDOW), "--decode-device", *crams],
                       env)
    assert r.returncode == 0, r.stderr[-4000:]
    _same_bytes("cohortdepth --trace-out matrix", r.stdout, want)
    rep, cmd_s, _ = read_manifest(report, "cohortdepth")
    tr = load_trace(trace)
    assert tr["root"]["name"] == "run.cohortdepth"
    assert rep["trace_id"] == tr["root"]["args"]["trace_id"]
    n_rans = sum(e["name"] == "device.rans" for e in tr["device"])
    assert n_rans == co_plan_launches == rep["kernel_launches"]["rans"], \
        (n_rans, co_plan_launches, rep["kernel_launches"])
    share = fenced_kernel_share(tr)
    out["cohort_trace"] = {"command_s": cmd_s,
                           "untraced_command_s": untraced["cohort"],
                           "device_spans": n_rans, "fenced_kernel_share": share,
                           "spans": len(tr["spans"])}
    log(f"cohortdepth --decode-device --trace-out: matrix byte-identical; "
        f"{len(tr['spans'])} spans, {n_rans} fenced device.rans spans = "
        f"the launch plan; fenced-kernel share (union of fenced device "
        f"spans over run.cohortdepth, an upper bound of kernel time "
        f"only) {share:.4f}; "
        f"command {cmd_s:.3f} s traced against {untraced['cohort']:.3f} s "
        f"without fences (phase 9's hybrid run)")
    if keep_dir:
        shutil.copy(trace, os.path.join(keep_dir, "cohortdepth_trace.json"))

    # pairhmm --trace-out: one device.pairhmm span per length bucket
    fx = pairhmm_run["fixture"]
    trace = os.path.join(workdir, "ph_trace.json")
    report = os.path.join(workdir, "ph_trace_report.json")
    table = os.path.join(workdir, "ph_trace_table.tsv")
    r, _ = _run_cli(root, ["--trace-out", trace, "--metrics-out", report,
                           "pairhmm", "--candidates", fx["candidates"],
                           "--out", table, fx["windows"]], env)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(table) as fh, open(fx["table"]) as fw:
        _same_bytes("pairhmm --trace-out table", fh.read(), fw.read())
    rep, cmd_s, _ = read_manifest(report, "pairhmm")
    tr = load_trace(trace)
    assert rep["trace_id"] == tr["root"]["args"]["trace_id"]
    n_ph = sum(e["name"] == "device.pairhmm" for e in tr["device"])
    assert n_ph == rep["kernel_launches"]["pairhmm"] \
        == pairhmm_run["launches"], (n_ph, rep["kernel_launches"])
    share = fenced_kernel_share(tr)
    out["pairhmm_trace"] = {"command_s": cmd_s,
                            "untraced_command_s": untraced["pairhmm"],
                            "device_spans": n_ph, "fenced_kernel_share": share}
    log(f"pairhmm --trace-out: table byte-identical; {n_ph} fenced "
        f"device.pairhmm spans = the launches; fenced-kernel share "
        f"{share:.4f}; command {cmd_s:.3f} s traced against "
        f"{untraced['pairhmm']:.3f} s without fences (phase 6)")
    if keep_dir:
        shutil.copy(trace, os.path.join(keep_dir, "pairhmm_trace.json"))

    # kill and resume: a BED that cuts the contig into FLAG_REGIONS regions
    bed = os.path.join(workdir, "co_regions.bed")
    step = CO_LEN // FLAG_REGIONS
    with open(bed, "w") as fh:
        for lo in range(0, CO_LEN, step):
            fh.write(f"chr1\t{lo}\t{min(lo + step, CO_LEN)}\n")
    base = ["cohortdepth", "--fai", fai, "-w", str(CO_WINDOW), "-b", bed,
            "--decode-device"]
    ck = os.path.join(workdir, "co_ck")
    runs = {}
    for name, extra in (("uninterrupted", []),
                        ("killed", ["--checkpoint-dir", ck,
                                    "--inject-faults", FLAG_KILL]),
                        ("resumed", ["--checkpoint-dir", ck, "--resume"]),
                        ("complete", ["--checkpoint-dir", ck, "--resume"])):
        report = os.path.join(workdir, f"co_{name}.json")
        r, wall = _run_cli(root, ["--metrics-out", report, *base, *extra,
                                  *crams], env)
        if name == "killed":
            assert r.returncode == -9, (r.returncode, r.stderr[-2000:])
            with open(os.path.join(ck, "journal.jsonl")) as fh:
                committed = sum(1 for _ in fh)
            runs[name] = {"wall_s": wall, "committed": committed}
            log(f"cohortdepth --checkpoint-dir --inject-faults {FLAG_KILL}: "
                f"killed by SIGKILL after {committed} committed columns")
            continue
        assert r.returncode == 0, r.stderr[-4000:]
        _same_bytes(f"cohortdepth -b ({name}) matrix", r.stdout, want)
        rep, cmd_s, _ = read_manifest(report, "cohortdepth")
        c = rep["metrics"]["counters"]
        runs[name] = {"command_s": cmd_s,
                      "rans": rep["kernel_launches"]["rans"],
                      "resumed": c.get("checkpoint.shards_resumed_total", 0),
                      "written": c.get("checkpoint.shards_written_total", 0)}
        log(f"cohortdepth -b {FLAG_REGIONS} regions ({name}): matrix "
            f"byte-identical to the oracle; rans launches "
            f"{runs[name]['rans']}, columns resumed "
            f"{runs[name]['resumed']}, written {runs[name]['written']}; "
            f"command {cmd_s:.3f} s")
    assert 0 < runs["killed"]["committed"] < FLAG_REGIONS * CO_SAMPLES
    assert 0 < runs["resumed"]["rans"] < runs["uninterrupted"]["rans"], runs
    assert runs["resumed"]["resumed"] == runs["killed"]["committed"], runs
    assert runs["complete"]["rans"] == 0, runs
    assert runs["complete"]["resumed"] == FLAG_REGIONS * CO_SAMPLES, runs
    out["kill_resume"] = runs
    return out


# ---- EM and cnv phases ------------------------------------------------

#: the EM at cohort width: chr20 (64,444,167 bp) in 1 kb windows x the
#: 2,504 samples of the 1000 Genomes phase-3 cohort
EM_WINDOWS = 64_445
EM_SAMPLES = 2_504
EM_CHECK = 64  # windows held against the pure-Python oracle
#: the cnv cohort: 8 BAMs of 400,000 150 bp reads (15x) on a 4 Mb contig
CNV_LEN = 4_000_000
CNV_READS = 400_000
CNV_SAMPLES = 8
CNV_WINDOW = 1000
CNV_DEL = (1_000_000, 1_200_000, 1)  # het deletion: start, end, sample
CNV_DUP = (2_500_000, 2_650_000, 5)  # duplication (CN3)


def load_em_oracle(root: str):
    """tests/oracle_emdepth.py: the pure-Python f64 transcription of the
    reference EM (no JAX)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "oracle_emdepth", os.path.join(root, "tests", "oracle_emdepth.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def em_matrix(rng, windows: int = None, samples: int = None) -> np.ndarray:
    """int16 (windows, samples) window means (EM_WINDOWS x EM_SAMPLES by
    default): per-sample coverage 20-40x times a per-window bias, Poisson
    counts; het deletions, homozygous deletions and duplications planted
    in blocks of samples."""
    windows = windows or EM_WINDOWS
    samples = samples or EM_SAMPLES
    cov = rng.uniform(20, 40, samples)
    bias = rng.gamma(50, 1 / 50, windows)
    m = np.empty((windows, samples), np.int16)
    for lo in range(0, windows, 4096):
        m[lo:lo + 4096] = rng.poisson(bias[lo:lo + 4096, None] * cov)
    for k in range(40):
        w = int(rng.integers(0, windows - 300))
        n = int(rng.integers(20, 300))
        s = rng.choice(samples, int(rng.integers(1, samples // 40 + 2)),
                       replace=False)
        blk = m[w:w + n, s]
        m[w:w + n, s] = (blk // 2, blk * 0, blk * 3 // 2)[k % 3]
    return m


def em_phase(root: str, dev) -> dict:
    """The EM at cohort width on the card: the int16 matrix through
    call_cnvs's normalisation (sample_medians) and _batched_em (four
    16,384-window f64 chunks); λ of EM_CHECK windows against the oracle
    (rtol = atol = 1e-9), their CN equal to its CN clamped at 8; cn.mops
    on the first chunk against the port's CPU path on the same rows."""
    import torch

    from goleft_tpu_torch.commands import emdepth_cmd as ec
    from goleft_tpu_torch.models import emdepth as em
    from goleft_tpu_torch.models import mops

    oracle = load_em_oracle(root)
    rng = np.random.default_rng(2504)
    t0 = time.perf_counter()
    depths = em_matrix(rng)
    fab_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    med, medmed = ec.sample_medians(depths)
    median_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    lam, cn = ec._batched_em(depths, med, medmed, device=dev)
    b.record()
    b.synchronize()
    em_wall = time.perf_counter() - t0
    em_ms = a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated(dev)
    n_chunks = -(-EM_WINDOWS // ec.EM_CHUNK)
    assert lam.shape == (EM_WINDOWS, 9) and cn.shape == depths.shape
    assert np.isfinite(lam).all() and cn.min() >= 0 and cn.max() <= 8

    chunk = ec._norm_chunk(depths[:ec.EM_CHUNK], med, medmed, np.float64,
                           dev)

    def em_chunk():
        em.cn_batch(em.em_depth_batch(chunk), chunk)

    chunk_ms = cuda_median_ms(em_chunk, reps=3)

    check = np.sort(rng.choice(EM_WINDOWS, EM_CHECK, replace=False))
    rows = depths[check] / med * medmed  # the host's scaling, in numpy
    worst = 0.0
    for j, w in enumerate(check):
        want = np.array(oracle.em_depth(rows[j]))
        np.testing.assert_allclose(lam[w], want, rtol=1e-9, atol=1e-9,
                                   err_msg=f"window {w}")
        worst = max(worst, float(np.max(np.abs(lam[w] - want))))
        want_cn = [min(oracle.cn_type(want, x), em.MAX_CN) for x in rows[j]]
        if cn[w].tolist() != want_cn:
            bad = np.flatnonzero(cn[w] != np.array(want_cn))
            raise AssertionError(f"window {w}: CN of samples {bad[:10]} "
                                 f"{cn[w][bad[:10]]} != oracle "
                                 f"{np.array(want_cn)[bad[:10]]}")

    torch.cuda.reset_peak_memory_stats(dev)

    def mops_chunk():
        r = mops.mops_batch(chunk)
        return mops.posterior_cn(r["aik"]), mops.information_gain(r["aik"])

    mops_ms = cuda_median_ms(mops_chunk, reps=2)
    mops_peak = torch.cuda.max_memory_allocated(dev)
    r = mops.mops_batch(chunk)
    sub = np.sort(rng.choice(ec.EM_CHUNK, EM_CHECK, replace=False))
    rc = mops.mops_batch(ec._norm_chunk(depths[sub], med, medmed,
                                        np.float64, "cpu"))
    aik = r["aik"][torch.from_numpy(sub).to(dev)].cpu()
    np.testing.assert_allclose(aik.numpy(), rc["aik"].numpy(), rtol=1e-9,
                               atol=1e-9)
    assert torch.equal(mops.posterior_cn(aik), mops.posterior_cn(rc["aik"]))
    np.testing.assert_allclose(mops.information_gain(aik).numpy(),
                               mops.information_gain(rc["aik"]).numpy(),
                               rtol=1e-9, atol=1e-9)
    mops_err = float((aik - rc["aik"]).abs().max())
    del chunk, r
    torch.cuda.empty_cache()
    cells = EM_WINDOWS * EM_SAMPLES
    log(f"EM at {EM_WINDOWS} windows x {EM_SAMPLES} samples (int16 matrix, "
        f"{depths.nbytes / 1e6:.1f} MB, fabricated in {fab_s:.1f} s): "
        f"sample medians {median_s:.3f} s; _batched_em {n_chunks} chunks of "
        f"{ec.EM_CHUNK} in {em_wall:.3f} s wall ({em_ms:.3f} ms by CUDA "
        f"events, {em_ms / n_chunks:.3f} ms a chunk with the copies and "
        f"the scaling on the card; {cells / em_wall / 1e6:.3f} M "
        f"window-samples/s), peak device memory {peak / 1e9:.3f} GB; "
        f"EM + CN of one resident chunk {chunk_ms:.3f} ms; λ of "
        f"{EM_CHECK} windows within 1e-9 of the oracle (max abs err "
        f"{worst:.3g}) and their CN equal; cn.mops of one chunk "
        f"{mops_ms:.3f} ms (peak {mops_peak / 1e9:.3f} GB), {EM_CHECK} rows "
        f"equal to the CPU path (aik max abs err {mops_err:.3g})")
    return {"windows": EM_WINDOWS, "samples": EM_SAMPLES,
            "chunks": n_chunks, "fabricate_s": fab_s, "median_s": median_s,
            "batched_em_wall_s": em_wall, "batched_em_ms": em_ms,
            "ms_a_chunk": em_ms / n_chunks, "resident_chunk_ms": chunk_ms,
            "window_samples_per_s": cells / em_wall,
            "peak_bytes": peak, "lambda_max_abs_err": worst,
            "mops_chunk_ms": mops_ms, "mops_peak_bytes": mops_peak,
            "mops_aik_max_abs_err": mops_err}


def cnv_fabricate(workdir: str, rng):
    """8 BAMs (cnv0..cnv7) of CNV_READS 150 bp reads on a CNV_LEN contig,
    half the reads of CNV_DEL's sample dropped in its region and half as
    many again added in CNV_DUP's; the FASTA. → (bams, fasta)."""
    from goleft_tpu_torch.io.bai import write_bai
    from tools.bulk_bam import write_bam_bulk

    bams = []
    for i in range(CNV_SAMPLES):
        pos = rng.integers(0, CNV_LEN - READ_LEN, CNV_READS)
        lo, hi, who = CNV_DEL
        if i == who:
            pos = pos[~((pos >= lo) & (pos < hi)
                        & (rng.random(len(pos)) < 0.5))]
        lo, hi, who = CNV_DUP
        if i == who:
            extra = CNV_READS * (hi - lo) // CNV_LEN // 2
            pos = np.concatenate([pos, rng.integers(lo, hi, extra)])
        pos = np.sort(pos)
        n = len(pos)
        p = os.path.join(workdir, f"cnv{i}.bam")
        idx = write_bam_bulk(p, "chr1", CNV_LEN, pos, np.zeros(n, np.int64),
                             ["150M"], np.full(n, 60, np.uint8),
                             np.zeros(n, np.uint16))
        write_bai(idx, p + ".bai")
        bams.append(p)
    fa = os.path.join(workdir, "cnv.fa")
    write_fasta(fa, rng, CNV_LEN)
    return bams, fa


def _diff_rows(what: str, got: str, want: str) -> None:
    """Fail with the differing rows (windows) of two tables."""
    if got == want:
        return
    g, w = got.splitlines(), want.splitlines()
    bad = [(k, a, b) for k, (a, b) in enumerate(zip(g, w)) if a != b]
    raise AssertionError(
        f"{what}: {len(bad)} rows differ ({len(g)} against {len(w)} rows); "
        + "; ".join(f"row {k}: got {a!r} want {b!r}" for k, a, b in bad[:8]))


def cnv_e2e_phase(root: str, workdir: str) -> dict:
    """``python -m goleft_tpu_torch cnv -w 1000 --vcf --matrix-out`` on 8
    fabricated BAMs under ``--engine device`` (depth-kernel launches
    counted, from 0 in the fresh process) and the default engine: equal
    bytes, equal to the port's ``run_cnv(device="cpu")``, both planted
    events called; the ``cohortdepth`` window-mean matrix of the same
    BAMs under ``--engine device`` byte-identical to the hybrid
    engine's (the depth kernel checked exactly at cnv's shapes); then
    ``emdepth --mops-out --gain-out`` on that matrix, on the card and
    on the CPU."""
    import io

    from goleft_tpu_torch.commands.cnv import run_cnv
    from goleft_tpu_torch.commands.emdepth_cmd import run_emdepth

    t0 = time.perf_counter()
    bams, fa = cnv_fabricate(workdir, np.random.default_rng(20))
    log(f"fabricated {CNV_SAMPLES} BAMs of {CNV_READS} reads on a {CNV_LEN} "
        f"bp contig in {time.perf_counter() - t0:.1f} s")
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GOLEFT_TPU_FAULTS", None)
    runs, outs = {}, {}
    for name, extra in (("device", ["--engine", "device"]), ("default", [])):
        report = os.path.join(workdir, f"cnv_{name}.json")
        vcf = os.path.join(workdir, f"cnv_{name}.vcf")
        mat = os.path.join(workdir, f"cnv_{name}.cn.tsv")
        r, wall = _run_cli(root, ["--metrics-out", report, "cnv", "-w",
                                  str(CNV_WINDOW), "-r", fa, "--vcf", vcf,
                                  "--matrix-out", mat, *extra, *bams], env)
        if r.returncode != 0:
            raise AssertionError(f"cnv ({name}) failed ({r.returncode}):\n"
                                 f"{r.stderr[-4000:]}")
        rep, cmd_s, stages = read_manifest(report, "cnv")
        with open(vcf) as fh, open(mat) as mh:
            outs[name] = (r.stdout, fh.read(), mh.read())
        runs[name] = {"wall_s": wall, "command_s": cmd_s,
                      "import_s": rep["import_seconds"],
                      "stage_seconds": stages,
                      "launches": rep["kernel_launches"],
                      "native_io": rep["native_io"],
                      "bases_per_s": CNV_SAMPLES * CNV_LEN / cmd_s}
        log(f"cnv ({name} engine): process wall {wall:.3f} s, command "
            f"{cmd_s:.3f} s, import {rep['import_seconds']:.3f} s; "
            f"{CNV_SAMPLES * CNV_LEN / cmd_s / 1e6:.3f} Mbases/s "
            f"({CNV_SAMPLES} samples x {CNV_LEN} bp); launches "
            f"{rep['kernel_launches']}; stage seconds: "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items())))
    assert runs["device"]["launches"]["depth"] == CNV_SAMPLES, runs["device"]
    # with the native library, auto picks the hybrid engine (no kernel)
    assert runs["default"]["native_io"], runs["default"]
    assert runs["default"]["launches"]["depth"] == 0, runs["default"]
    buf = io.StringIO()
    vcf = os.path.join(workdir, "cnv_cpu.vcf")
    mat = os.path.join(workdir, "cnv_cpu.cn.tsv")
    t0 = time.perf_counter()
    calls = run_cnv(bams, reference=fa, window=CNV_WINDOW, out=buf,
                    vcf_out=vcf, matrix_out=mat, device="cpu")
    cpu_s = time.perf_counter() - t0
    with open(vcf) as fh, open(mat) as mh:
        outs["cpu"] = (buf.getvalue(), fh.read(), mh.read())
    for name in ("device", "default"):
        for what, got, want in zip(("calls", "VCF", "CN matrix"),
                                   outs[name], outs["cpu"]):
            _diff_rows(f"cnv {what} ({name} engine on the card against the "
                       "CPU)", got, want)
    lo, hi, who = CNV_DEL
    assert any(c[3] == f"cnv{who}" and c[1] < hi and c[2] > lo
               and c[5] < -0.5 for c in calls), calls
    lo, hi, who = CNV_DUP
    assert any(c[3] == f"cnv{who}" and c[1] < hi and c[2] > lo
               and c[5] > 0.3 for c in calls), calls
    log(f"cnv: both engines byte-identical to run_cnv(device='cpu') "
        f"({cpu_s:.3f} s on the host CPU): {len(calls)} calls, the planted "
        f"deletion and duplication among them: "
        + "; ".join(f"{c[3]} {c[1]}-{c[2]} CN {c[4]} log2FC {c[5]:.3f}"
                    for c in calls if c[3] in (f"cnv{CNV_DEL[2]}",
                                               f"cnv{CNV_DUP[2]}")))

    matrix = os.path.join(workdir, "cnv.matrix.tsv")
    mats, cd_launches = {}, {}
    for name in ("hybrid", "device"):
        report = os.path.join(workdir, f"cohortdepth_{name}.json")
        r, _ = _run_cli(root, ["--metrics-out", report, "cohortdepth",
                               "-w", str(CNV_WINDOW), "-r", fa,
                               "--engine", name, *bams], env)
        if r.returncode != 0:
            raise AssertionError(f"cohortdepth ({name}) failed "
                                 f"({r.returncode}):\n{r.stderr[-4000:]}")
        mats[name] = r.stdout
        cd_launches[name] = read_manifest(
            report, "cohortdepth")[0]["kernel_launches"]["depth"]
    assert cd_launches == {"hybrid": 0, "device": CNV_SAMPLES}, cd_launches
    _diff_rows("cohortdepth window means (depth kernel against the hybrid "
               "engine)", mats["device"], mats["hybrid"])
    log(f"cohortdepth -w {CNV_WINDOW} on the same BAMs: --engine device "
        f"({cd_launches['device']} depth launches) byte-identical to the "
        f"hybrid engine over {len(mats['device'].splitlines()) - 1} "
        f"windows x {CNV_SAMPLES} samples")
    with open(matrix, "w") as fh:
        fh.write(mats["hybrid"])
    report = os.path.join(workdir, "emdepth.json")
    files = {k: os.path.join(workdir, f"em_{k}.tsv") for k in
             ("mops", "gain", "mops_cpu", "gain_cpu")}
    r, wall = _run_cli(root, ["--metrics-out", report, "emdepth",
                              "--mops-out", files["mops"], "--gain-out",
                              files["gain"], matrix], env)
    if r.returncode != 0:
        raise AssertionError(f"emdepth failed ({r.returncode}):\n"
                             f"{r.stderr[-4000:]}")
    rep, em_s, em_stages = read_manifest(report, "emdepth")
    buf = io.StringIO()
    run_emdepth(matrix, out=buf, mops_out=files["mops_cpu"],
                gain_out=files["gain_cpu"], device="cpu")
    _diff_rows("emdepth calls (card against CPU)", r.stdout, buf.getvalue())
    for k in ("mops", "gain"):
        with open(files[k]) as g, open(files[k + "_cpu"]) as c:
            _diff_rows(f"emdepth --{k}-out (card against CPU)", g.read(),
                       c.read())
    n_win = CNV_LEN // CNV_WINDOW
    log(f"emdepth --mops-out --gain-out on the cohortdepth matrix "
        f"({n_win} windows x {CNV_SAMPLES} samples): card and CPU "
        f"byte-identical; process wall {wall:.3f} s, command {em_s:.3f} s "
        f"= {n_win * CNV_SAMPLES / em_s / 1e6:.4f} M window-samples/s; "
        f"stage seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(em_stages.items())))
    return {"runs": runs, "cpu_s": cpu_s, "calls": len(calls),
            "cohortdepth_launches": cd_launches,
            "emdepth": {"wall_s": wall, "command_s": em_s,
                        "stage_seconds": em_stages,
                        "window_samples_per_s":
                            n_win * CNV_SAMPLES / em_s}}


def build_kernels(mods) -> dict:
    """One nvcc per kernel source, all started together → build seconds
    per kernel."""
    from concurrent.futures import ThreadPoolExecutor

    def build(mod):
        t0 = time.perf_counter()
        mod.load_library()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(mods)) as pool:
        futs = {name: pool.submit(build, mod) for name, mod in mods.items()}
        return {name: f.result() for name, f in futs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--trace-dir", help="keep the flags phase's "
                    "--trace-out files in this directory")
    args = ap.parse_args(argv)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from goleft_tpu_torch.device import card_provenance, nvidia_smi_line
    from goleft_tpu_torch.ops import depth_kernel as dk
    from goleft_tpu_torch.ops import pairhmm_kernel as pk
    from goleft_tpu_torch.ops import rans_kernel as rk

    prov = card_provenance()
    log("provenance: " + json.dumps(prov))
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    built = build_kernels({"depth": dk, "pairhmm": pk, "rans": rk})
    log(f"kernels built in parallel in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))
    for mod in (dk, pk, rk):
        log(mod.BUILD_LOG.strip())

    blank = {"status": "fail", "launches": 0, "max_abs_err": None,
             "ms": None, "plain_ms": None, "bound_ms": None,
             "bound_by": None, "library_ms": None}
    depth = dict(name="depth", route="cuda",
                 source="goleft_tpu_torch/csrc/depth_kernel.cu",
                 replaces="goleft_tpu/ops/pallas_coverage.py:96", **blank)
    pairhmm = dict(name="pairhmm", route="cuda",
                   source="goleft_tpu_torch/csrc/pairhmm_kernel.cu",
                   replaces="goleft_tpu/ops/pairhmm.py:576", **blank)
    rans = dict(name="rans", route="cuda",
                source="goleft_tpu_torch/csrc/rans_kernel.cu",
                replaces="goleft_tpu/ops/rans_device.py:494", **blank)
    kernels = [depth, pairhmm, rans]
    results = {"provenance": prov, "build_s": built}
    workdir = os.path.join(root, "build", "chip_smoke")
    try:
        results["kernel"] = kres = kernel_phase(dev)
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        results["e2e"], depth_fixture = e2e_phase(root, workdir)
        e2e = results["e2e"]
        main_wire = kres["u16"]  # the packed wire is the main path's
        depth.update(status="pass", launches=e2e["launches"],
                     max_abs_err=kres["max_abs_err"],
                     ms=main_wire["ms"], plain_ms=main_wire["plain_ms"],
                     bound_ms=main_wire["bound_ms"],
                     bound_by=main_wire["bound_by"],
                     device_ms=main_wire["device_ms"],
                     scratch_bytes=main_wire["scratch_bytes"])
        results["pairhmm_kernel"] = pres = pairhmm_kernel_phase(dev)
        results["pairhmm_e2e"] = pe2e = pairhmm_e2e_phase(root, workdir)
        f32 = pres["float32"]  # the main path's instantiation
        pairhmm.update(status="pass", launches=pe2e["launches"],
                       max_abs_err=pres["max_abs_err"], ms=f32["ms"],
                       plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
                       bound_by=f32["bound_by"])

        t0 = time.perf_counter()
        crams, fai, names, truth = cohort_fabricate(
            workdir, np.random.default_rng(31))
        want = cohort_oracle(truth, names)
        log(f"fabricated {CO_SAMPLES} CRAMs of {CO_READS} reads on a "
            f"{CO_LEN} bp contig ({CO_RPC} records per container, "
            f"{sum(os.path.getsize(c) for c in crams)} bytes) and the "
            f"oracle matrix in {time.perf_counter() - t0:.1f} s")
        results["rans_kernel"] = rres = rans_kernel_phase(dev, crams)
        results["cohort_e2e"] = co = cohort_e2e_phase(root, workdir, crams,
                                                      fai, want)
        results["flags"] = flags_phase(
            root, workdir, depth_fixture, pe2e, crams, fai, want,
            co["hybrid"]["launches"]["rans"],
            {"cohort": co["hybrid"]["command_s"],
             "pairhmm": pe2e["command_s"]}, args.trace_dir)
        results["em"] = em_phase(root, dev)
        results["cnv_e2e"] = cnv = cnv_e2e_phase(root, workdir)
        depth["cnv_launches"] = cnv["runs"]["device"]["launches"]["depth"]
        o0 = rres["ORDER0"]  # the cohort's most common codec
        rans.update(status="pass", launches=co["hybrid"]["launches"]["rans"],
                    max_abs_err=rres["max_abs_err"], ms=o0["ms"],
                    plain_ms=o0["plain_ms"], bound_ms=o0["bound_ms"],
                    bound_by=o0["bound_by"],
                    chain_bound_ms=o0["chain_bound_ms"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"kernels": kernels}), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(dict(results, kernels=kernels), fh, indent=1)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
