#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (goleft_tpu_torch).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--out FILE]

1. prints the card's provenance (torch / CUDA versions, name, power limit);
2. builds the hand-written kernels (csrc/depth_kernel.cu,
   csrc/pairhmm_kernel.cu) from the checkout, one nvcc each, started
   together, and prints the build seconds and the ptxas reports;
3. holds the depth kernel against its plain PyTorch version on the card at
   one full production shard (10 Mb, 2,000,000 segments of 150 bp, window
   250, max mean depth 100, cap 2600), on both wires, with edge cases
   (a 10,000-segment hotspot in one 1024-base tile, endpoints at 0 and at
   the shard end, keep-masked segments, a region strictly inside the
   shard, segments of 65,536 bases and more, a gap that needs u16
   fillers). Depth, window sums, classes and packed classes must be
   bitwise equal; prints the kernel's and the plain version's median time
   per shard from CUDA events, and its bound;
4. fabricates a coordinate-sorted 25 Mb BAM + BAI (5,000,000 reads of
   150 bp, MAPQ 0 / DUP / SECONDARY reads, D / N / S / I CIGARs, a pileup
   above the cap), runs ``python -m goleft_tpu_torch depth`` on it in a
   fresh process (launch counts start at 0 there and come back in its
   ``--metrics-out`` report) and compares both BED files byte for byte
   with an independent numpy oracle;
5. holds the pair-HMM kernel against its plain version on the card, f32
   rescaled and f64 unscaled, contribs and shifts bitwise: one bucket of
   4,096 pairs of 150 bp reads (quals 2-41, mismatches, indels, N) x
   416 bp haplotypes, edge buckets (read longer than hap, a 1-base read,
   a q93 read, 300 bp junk reads below 1e-100) and a bucket of 1,100 bp
   reads (r1 1,121: rows beyond one per thread); padding invariance on
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
7. prints the kernels line, the card's ``nvidia-smi`` name and power
   limit, and as the last line ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, without a CUDA device, outside a
checkout, or when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

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


def kernel_phase(dev):
    """Phase 3: kernel vs plain version at one full shard, both wires."""
    import torch

    from goleft_tpu_torch.ops import depth_kernel as dk
    from goleft_tpu_torch.ops.coverage import bucket_size, pack_segments_u16

    rng = np.random.default_rng(2024)
    w0, (s, e, keep), (ls, le) = shard_segments(rng)
    # the int32 wire covers the whole shard (the main path's region); the
    # u16 wire a region strictly inside it
    full = (w0, w0, w0 + SHARD, CAP, MIN_COV, MAX_MEAN, SHARD, WINDOW)
    inner = (w0, w0 + 130, w0 + SHARD - 100, CAP, MIN_COV, MAX_MEAN, SHARD,
             WINDOW)
    out = {}
    max_err = 0

    # int32 wire: everything, the ultra-long segments included (they
    # force this wire on the main path), bucket-padded with keep=False
    s32 = np.concatenate([s, ls.astype(np.int32)])
    e32 = np.concatenate([e, le.astype(np.int32)])
    k32 = np.concatenate([keep, [True, True]])
    b = bucket_size(len(s32))
    pad = b - len(s32)
    s32 = np.concatenate([s32, np.zeros(pad, np.int32)])
    e32 = np.concatenate([e32, np.zeros(pad, np.int32)])
    k32 = np.concatenate([k32, np.zeros(pad, bool)])
    ts, te, tk = (torch.from_numpy(x).to(dev) for x in (s32, e32, k32))

    # u16 wire: the kept segments under 65,536 bases, packed and padded
    d, ln, base, n_ent = pack_segments_u16(s, e, keep)
    bw = bucket_size(n_ent)
    dd = np.zeros(bw, np.uint16)
    ll = np.zeros(bw, np.uint16)
    dd[:n_ent], ll[:n_ent] = d, ln
    td, tl = (torch.from_numpy(x).to(dev) for x in (dd, ll))
    assert (dd[:n_ent] == 0xFFFF).any() and (ll[:n_ent] == 0).any(), \
        "the u16 case must hold gap fillers"

    cases = {
        "int32": (lambda dense: dk.fused_depth(ts, te, tk, *full,
                                               dense=dense),
                  lambda: dk.fused_depth_plain(ts, te, tk, *full),
                  b, 9),
        "u16": (lambda dense: dk.fused_depth_wire(td, tl, int(base), *inner,
                                                  dense=dense),
                lambda: dk.fused_depth_wire_plain(td, tl, int(base),
                                                  *inner),
                bw, 4),
    }
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
        plain_ms = cuda_median_ms(plain)
        n_win = SHARD // WINDOW
        bytes_moved = n_in * bytes_per + 4 * n_win + (SHARD + 3) // 4
        ops = 8 * SHARD + 10 * n_in
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT_OPS_PER_S * 1e3
        out[wire] = {
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "segments": n_in,
        }
        log(f"depth kernel {wire} wire: bitwise equal to the plain version "
            f"(depth, sums, classes, packed); {n_in} entries, median "
            f"{ms:.4f} ms/shard kernel, {plain_ms:.4f} ms plain, bound "
            f"{out[wire]['bound_ms']:.4f} ms ({out[wire]['bound_by']})")
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
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, E2E_LEN)]
    full = E2E_LEN // 60 * 60
    rows = np.concatenate([seq[:full].reshape(-1, 60),
                           np.full((full // 60, 1), 10, np.uint8)], axis=1)
    with open(fa, "wb") as fh:
        fh.write(b">chr1\n" + rows.tobytes())
        if E2E_LEN > full:
            fh.write(seq[full:].tobytes() + b"\n")
    return bam, fa, (pos, cig, mapq, flag)


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
    with open(report) as fh:
        rep = json.load(fh)
    assert rep["native_io"], "the native host decoder was not loaded"
    launches = rep["kernel_launches"]["depth"]
    assert launches >= 1, "the depth CLI never launched the depth kernel"
    want_d, want_c = oracle_beds(reads)
    for path, want in ((prefix + ".depth.bed", want_d),
                       (prefix + ".callable.bed", want_c)):
        with open(path) as fh:
            got = fh.read()
        if got != want:
            i = next((k for k, (a, b) in enumerate(zip(got, want))
                      if a != b), min(len(got), len(want)))
            raise AssertionError(
                f"{os.path.basename(path)} differs from the numpy oracle "
                f"at byte {i}: got {got[i - 80:i + 80]!r} want "
                f"{want[i - 80:i + 80]!r}")
    stages = rep["stage_seconds"]
    cmd_s = rep["seconds"]
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
            "provenance": rep["provenance"]}


# ---- pair-HMM phases ---------------------------------------------------

PH_B = 4096  # pairs of the kernel phase's main bucket
PH_READ, PH_HAP = 150, 416  # r_pad 160 (r1 161), h_pad 416
PH_LONG = (1100, 1200, 8)  # read bp, hap bp, pairs: r1 1121, two strips
PH_WINDOWS, PH_WINDOW_READS = 1000, 80
PH_ORACLE_WINDOWS = 20
PH_FAULT_SPEC = "pairhmm:every=1:permanent:times=99"
# float32 / float64 rates outside the tensor cores (H100 SXM data sheet)
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
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


def pairhmm_kernel_phase(dev):
    """Kernel vs plain version on the card (f32 rescaled, f64 unscaled):
    one full bucket of 4,096 pairs, edge buckets, a 1,100 bp bucket;
    padding invariance; 16 pairs against the log-space oracle and the
    long bucket against the row oracle; the main bucket's times and
    bound."""
    import torch

    from goleft_tpu_torch.ops import pairhmm as tph
    from goleft_tpu_torch.ops import pairhmm_kernel as pk

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
        log(f"pairhmm kernel {name}: {len(reads)} pairs, r1 {r_pad + 1}, "
            f"h_pad {h_pad}: contribs and shifts bitwise equal to the "
            f"plain version in f32 and f64")

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
    lane_steps = PH_B * r1 * (r1 + h_pad)
    bytes_moved = PH_B * (r1 * 9 + h_pad + 8 + (r1 + h_pad) * 8) + 20
    res = {"cells": cells, "lane_steps": lane_steps, "bytes": bytes_moved,
           "ops_per_cell": pk.OPS_PER_CELL, "max_abs_err": max_err,
           "oracle_err_f32": worst[True], "oracle_err_f64": worst[False]}
    for name, rate in (("float32", F32_OPS_PER_S),
                       ("float64", F64_OPS_PER_S)):
        t_ops = pk.OPS_PER_CELL[name] * cells / rate * 1e3
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        m = out[name]
        m.update(bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 gcups=cells / m["ms"] / 1e6,
                 gcups_lane_steps=lane_steps / m["ms"] / 1e6)
        res[name] = m
        log(f"pairhmm kernel {name}, {PH_B} pairs of {PH_READ} x {PH_HAP}: "
            f"median {m['ms']:.4f} ms kernel, {m['plain_ms']:.4f} ms "
            f"plain; {m['gcups']:.2f} GCUPS over {cells} useful cells, "
            f"{m['gcups_lane_steps']:.2f} over {lane_steps} lane-steps; "
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
    with open(report) as fh:
        rep = json.load(fh)
    launches = rep["kernel_launches"]["pairhmm"]
    buckets = rep["counters"]["pairhmm.buckets_total"]
    assert launches >= 1 and launches == buckets, (launches, buckets)
    assert rep["counters"]["pairhmm.pairs_total"] == n_pairs
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

    stages = rep["stage_seconds"]
    cmd_s = rep["seconds"]
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
    with open(freport) as fh:
        frep = json.load(fh)
    assert frep["counters"]["pairhmm.buckets_failed_total"] >= 1
    log(f"pairhmm with {PH_FAULT_SPEC}: exit 3, {len(q)} windows "
        "quarantined, manifest written")
    return {"wall_s": wall, "command_s": cmd_s,
            "import_s": rep["import_seconds"], "windows": len(kept),
            "pairs": n_pairs, "cells": cells,
            "pairs_per_s": n_pairs / cmd_s, "gcups": cells / cmd_s / 1e9,
            "unattributed_s": rest,
            "launches": launches, "stage_seconds": stages,
            "oracle_pl_max_diff": worst_pl}

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
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from goleft_tpu_torch.device import card_provenance, nvidia_smi_line
    from goleft_tpu_torch.ops import depth_kernel as dk
    from goleft_tpu_torch.ops import pairhmm_kernel as pk

    prov = card_provenance()
    log("provenance: " + json.dumps(prov))
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    built = build_kernels({"depth": dk, "pairhmm": pk})
    log(f"kernels built in parallel in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))
    for mod in (dk, pk):
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
    kernels = [depth, pairhmm]
    results = {"provenance": prov, "build_s": built}
    workdir = os.path.join(root, "build", "chip_smoke")
    try:
        results["kernel"] = kres = kernel_phase(dev)
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        results["e2e"] = e2e = e2e_phase(root, workdir)
        main_wire = kres["u16"]  # the packed wire is the main path's
        depth.update(status="pass", launches=e2e["launches"],
                     max_abs_err=kres["max_abs_err"],
                     ms=main_wire["ms"], plain_ms=main_wire["plain_ms"],
                     bound_ms=main_wire["bound_ms"],
                     bound_by=main_wire["bound_by"])
        results["pairhmm_kernel"] = pres = pairhmm_kernel_phase(dev)
        results["pairhmm_e2e"] = pe2e = pairhmm_e2e_phase(root, workdir)
        f32 = pres["float32"]  # the main path's instantiation
        pairhmm.update(status="pass", launches=pe2e["launches"],
                       max_abs_err=pres["max_abs_err"], ms=f32["ms"],
                       plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
                       bound_by=f32["bound_by"])
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
