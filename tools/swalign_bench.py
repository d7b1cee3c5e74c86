#!/usr/bin/env python3
"""Time the mapper's swalign kernel (csrc/swalign_kernel.cu) and its
extend stage on one CUDA card.

Builds chip_smoke.py's main swalign bucket with its seed (4,096 pairs of
150 bp reads against windows of read + 2 x 32 bp: r1 161, w_pad 256),
checks the kernel bitwise against the plain version on the card once
(``sw_bucket``: best, bi, bj and every direction byte), then times two
things by CUDA events (median of ``--reps``) and as device time
(``torch.profiler``, mean over 5 calls: the kernel's launches, or every
kernel and copy of the stage):

- the kernel: one launch on inputs already on the card;
- the extend stage as ``ops/swalign.py::align_bucket`` runs it on the
  packed numpy bucket: upload, launch, the copies to the host and the
  host's traceback or CIGAR formatting, to the list of Alignments.

Prints one JSON line with the card's name and power limit.

    python3 tools/swalign_bench.py [--reps N] [--pkg DIR]

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


def device_ms(fn, name: str = "", calls: int = 5) -> float | None:
    """The device's own time of one ``fn()``, mean over ``calls``: the
    profiler's device-side entries (kernels and copies) whose name holds
    ``name``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.device_time_total for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA and name in ev.key)
    return us / calls / 1e3 if us else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--pkg", help="checkout whose goleft_tpu_torch to time")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.pkg or ROOT))
    import torch

    if not torch.cuda.is_available():
        print("swalign_bench: no CUDA device is visible", file=sys.stderr)
        return 2
    # this checkout's chip_smoke.py (fixture, timing), whatever --pkg is
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import goleft_tpu_torch
    from goleft_tpu_torch.device import nvidia_smi_line
    from goleft_tpu_torch.ops import swalign
    from goleft_tpu_torch.ops import swalign_kernel as sk

    dev = torch.device("cuda")
    host = cs.sw_case("main")
    sc = swalign.DEFAULT_SCORES
    t = [torch.from_numpy(a).to(dev) for a in host] + [torch.tensor(
        sc.astuple(), dtype=torch.int32, device=dev)]
    b, r1 = host[0].shape
    wcap = host[2].shape[1]
    got = swalign.sw_bucket(*t)
    want = swalign.sw_bucket_plain(*t)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    def kernel():
        return sk.launch(*t)

    def extend():
        return swalign.align_bucket(*host, scores=sc, device=dev)

    alignments = extend()
    assert len(alignments) == b
    print(json.dumps({
        "package": os.path.dirname(goleft_tpu_torch.__file__),
        "card": nvidia_smi_line(), "pairs": int(b), "r1": int(r1),
        "w_pad": int(wcap), "bitwise": True,
        "kernel_ms": cs.cuda_median_ms(kernel, reps=args.reps),
        "kernel_device_ms": device_ms(kernel, "sw_"),
        "extend_ms": cs.cuda_median_ms(extend, reps=args.reps),
        "extend_device_ms": device_ms(extend)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
