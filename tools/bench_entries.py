#!/usr/bin/env python3
"""Run entries of the port's bench one by one on the card, each with the
kernels' launch counts it made.

    python3 tools/bench_entries.py [--quick] NAME [NAME ...]

NAME is an entry function of goleft_tpu_torch/bench.py without its
``bench_`` prefix (``serve_throughput``, ``wire_decode``, ...); each is
called at the bench's full sizes, or its ``--quick`` ones, with the card
as its device where it takes one. Prints the card's ``nvidia-smi`` name
and power limit, then one JSON line an entry: its name, seconds, the
launches of each kernel during it and the entry's record.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("names", nargs="+")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from goleft_tpu_torch import bench, cli
    from goleft_tpu_torch.device import resolve_device
    from goleft_tpu_torch.obs.provenance import nvidia_smi_line

    dev = resolve_device()
    print(nvidia_smi_line(), flush=True)
    for name in args.names:
        fn = getattr(bench, f"bench_{name}")
        params = inspect.signature(fn).parameters
        kw = {k: v for k, v in (("quick", args.quick), ("dev", dev))
              if k in params}
        before = cli._kernel_launches()
        t0 = time.perf_counter()
        rec = fn(**kw)
        seconds = time.perf_counter() - t0
        after = cli._kernel_launches()
        print(json.dumps({
            "entry": name, "quick": args.quick, "seconds": seconds,
            "launches": {k: after[k] - before.get(k, 0) for k in after},
            "record": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
