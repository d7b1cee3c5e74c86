#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (goleft_tpu_torch).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--out FILE]

1. prints the card's provenance (torch / CUDA versions, name, power limit);
2. builds the hand-written depth kernel (csrc/depth_kernel.cu) from the
   checkout and prints the build seconds and the ptxas report;
3. holds the kernel against its plain PyTorch version on the card at one
   full production shard (10 Mb, 2,000,000 segments of 150 bp, window
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
5. prints the kernels line, the card's ``nvidia-smi`` name and power
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

    prov = card_provenance()
    log("provenance: " + json.dumps(prov))
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    dk.load_library()
    log(f"depth kernel built in {time.perf_counter() - t0:.1f} s")
    log(dk.BUILD_LOG.strip())

    kernel = {"name": "depth", "route": "cuda",
              "source": "goleft_tpu_torch/csrc/depth_kernel.cu",
              "replaces": "goleft_tpu/ops/pallas_coverage.py:96",
              "status": "fail", "launches": 0, "max_abs_err": None,
              "ms": None, "plain_ms": None, "bound_ms": None,
              "bound_by": None, "library_ms": None}
    results = {"provenance": prov}
    workdir = os.path.join(root, "build", "chip_smoke")
    try:
        results["kernel"] = kres = kernel_phase(dev)
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        results["e2e"] = e2e = e2e_phase(root, workdir)
        main_wire = kres["u16"]  # the packed wire is the main path's
        kernel.update(status="pass", launches=e2e["launches"],
                      max_abs_err=kres["max_abs_err"],
                      ms=main_wire["ms"], plain_ms=main_wire["plain_ms"],
                      bound_ms=main_wire["bound_ms"],
                      bound_by=main_wire["bound_by"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"kernels": [kernel]}), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(dict(results, kernels=[kernel]), fh, indent=1)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
