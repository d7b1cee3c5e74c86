#!/usr/bin/env python3
"""Time indexcov's normalisation kernel (csrc/indexcov_norm.cu) on one
CUDA card.

Builds chip_smoke.py's kernel-phase case with its seed (2,504 samples x
15,195 bins: chr1 at 16 KB for the 1000 Genomes phase-3 cohort, ragged
tails, a run of skipped bins, the port's NormStats scalars), checks the
kernel bitwise against the plain version on the card once, then times
the kernel by CUDA events around one call (median of ``--reps``) and as
device time (``torch.profiler``, mean over 10 calls). Prints one JSON
line with the card's name and power limit.

    python3 tools/norm_bench.py [--reps N] [--pkg DIR]

``--pkg DIR`` imports ``goleft_tpu_torch`` from the checkout at DIR
instead of this one, with the same data and timing code: to compare two
trees on one card, run parent, change, change, parent in one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--pkg", help="checkout whose goleft_tpu_torch to time")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.pkg or ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("norm_bench: no CUDA device is visible", file=sys.stderr)
        return 2
    # this checkout's chip_smoke.py (fixture, timing), whatever --pkg is
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import goleft_tpu_torch
    from goleft_tpu_torch.device import nvidia_smi_line
    from goleft_tpu_torch.ops import norm_kernel as nk
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    d, ln, m, skip = cs.norm_main_case(np.random.default_rng(2504))
    t = (torch.from_numpy(d).to(dev), torch.from_numpy(ln).to(dev),
         torch.from_numpy(m).to(dev), torch.from_numpy(skip).to(dev))
    got = nk.norm_scan(*t)
    want = nk.apply_normalization_plain(*t)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ms = cs.cuda_median_ms(lambda: nk.norm_scan(*t), reps=args.reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            nk.norm_scan(*t)
        torch.cuda.synchronize()
    dev_us = sum(getattr(ev, "device_time_total", 0) or 0
                 for ev in prof.key_averages()
                 if "norm_scan" in ev.key) / 10
    print(json.dumps({
        "package": os.path.dirname(goleft_tpu_torch.__file__),
        "card": nvidia_smi_line(), "samples": int(d.shape[0]),
        "bins": int(d.shape[1]), "bitwise": True, "ms": ms,
        "device_ms": dev_us / 1e3 if dev_us else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
