#!/usr/bin/env python3
"""Time the depth kernel per 10 Mb shard, on one CUDA card.

Builds chip_smoke.py's kernel-phase shard with its seed (2,000,000
segments of 150 bp, a hotspot, a 200 kb gap, window 250) on the int32
wire, on the packed u16 wire, and on the u16 wire with one 65,535-base
segment more; checks each kernel output (dense) bitwise against the
plain version on the card, then times the kernel's ``dense=False`` call
two ways: CUDA events around one call (median of ``--reps``; the host's
enqueue is inside the window) and device time (a CUDA graph of 20 calls
replayed). Also reports the bytes one call allocates, and with
``--profile`` each launch's mean device time over 10 calls
(``torch.profiler``). Prints one JSON line.

    python3 tools/depth_bench.py [--reps N] [--pkg DIR] [--profile]

``--pkg DIR`` imports ``goleft_tpu_torch`` from the checkout at DIR
instead of this one, with the same data and timing code: to compare two
trees on one card, run parent, change, change, parent in one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch_us(fn, calls: int = 10) -> dict:
    """Mean device microseconds of each kernel ``fn`` launches, over
    ``calls`` calls after three warm-up calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or 0
        if us and ev.count and not ev.key.startswith("aten::"):
            out[ev.key[:48]] = us / calls
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--pkg", help="checkout whose goleft_tpu_torch to time")
    ap.add_argument("--profile", action="store_true",
                    help="also each launch's device time (torch.profiler)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.pkg or ROOT))
    import torch

    if not torch.cuda.is_available():
        print("depth_bench: no CUDA device is visible", file=sys.stderr)
        return 2
    # this checkout's chip_smoke.py (fixtures, timing), whatever --pkg is
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import goleft_tpu_torch
    from goleft_tpu_torch.ops import depth_kernel as dk

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    out = {"package": os.path.dirname(goleft_tpu_torch.__file__),
           "nvidia_smi": smi}
    for name, (kern, plain, n_in, _) in cs.depth_main_cases(dev,
                                                            dk).items():
        got = kern(True)
        want = plain()
        torch.cuda.synchronize()
        if not all(g.dtype == w.dtype and torch.equal(g, w)
                   for g, w in zip(got, want)):
            raise AssertionError(f"{name}: the kernel differs from the "
                                 "plain version")
        del got, want
        out[name] = {
            "entries": n_in,
            "ms": cs.cuda_median_ms(lambda: kern(False), reps=args.reps),
            "device_ms": cs.cuda_graph_ms(lambda: kern(False)),
            "scratch_bytes": cs.depth_scratch_bytes(dev, kern),
        }
        if args.profile:
            out[name]["launch_us"] = launch_us(lambda: kern(False))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
