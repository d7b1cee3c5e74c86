#!/usr/bin/env python3
"""Time the pair-HMM kernel per bucket, on one CUDA card.

Packs chip_smoke.py's buckets with its seed and generators: the main
bucket (4,096 pairs of 150 bp reads x 416 bp haps) and the 1,100 bp
bucket, in f32 (rescaled) and f64; checks each kernel output bitwise
against the plain version on the card, and times the kernel (CUDA
events, median of ``--reps``). Prints one JSON line.

    python3 tools/pairhmm_bench.py [--reps N] [--pkg DIR]

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--pkg", help="checkout whose goleft_tpu_torch to time")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.pkg or ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("pairhmm_bench: no CUDA device is visible", file=sys.stderr)
        return 2
    # this checkout's chip_smoke.py (fixtures, timing), whatever --pkg is
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import goleft_tpu_torch
    from goleft_tpu_torch.ops import pairhmm as tph
    from goleft_tpu_torch.ops import pairhmm_kernel as pk

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    out = {"package": os.path.dirname(goleft_tpu_torch.__file__),
           "nvidia_smi": smi, "sm_clock_hz": cs.sm_clock_hz()}
    rng = np.random.default_rng(150)  # chip_smoke.py's pair-HMM seed
    buckets = {"main": cs.ph_pairs(rng, cs.PH_B, cs.PH_READ, cs.PH_HAP),
               "long1100": cs.ph_pairs(rng, cs.PH_LONG[2], cs.PH_LONG[0],
                                       cs.PH_LONG[1])}
    for name, (reads, quals, haps) in buckets.items():
        errs = [tph.phred_to_err(q) for q in quals]
        r_pad = tph._pad_up(len(reads[0]))
        h_pad = tph._pad_up(len(haps[0]))
        for dtype in (np.float32, np.float64):
            rescale = dtype == np.float32
            packed = tph._pack_bucket(list(range(len(reads))), reads, errs,
                                      haps, r_pad, h_pad, dtype)
            trans = tph.transition_probs().astype(dtype)
            t = [torch.from_numpy(a).to(dev) for a in (*packed, trans)]
            got = pk.forward_bucket(*t, rescale=rescale)
            want = pk.forward_bucket_plain(*t, rescale=rescale)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} {np.dtype(dtype).name}: the "
                                     "kernel differs from the plain version")
            out[f"{name}_{np.dtype(dtype).name}_ms"] = cs.cuda_median_ms(
                lambda: pk.forward_bucket(*t, rescale=rescale),
                reps=args.reps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
