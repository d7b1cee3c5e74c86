#!/usr/bin/env python3
"""Time the rANS-Nx16 kernel per container, on one CUDA card.

Fabricates one 10,000-record CRAM container of each codec of
chip_smoke.py's cohort (its reads, qualities and writer, on a 100 kb
contig), checks that the device decode equals the host decoder, and times
every launch group of the container queued on one stream (CUDA events,
median of ``--reps``) and its longest stream alone. Prints one JSON line.

    python3 tools/rans_bench.py [--reps N] [--pkg DIR]

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
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTIG_LEN = 100_000  # 10,000 reads of 150 bp at chip_smoke.py's 15x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--pkg", help="checkout whose goleft_tpu_torch to time")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.pkg or ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("rans_bench: no CUDA device is visible", file=sys.stderr)
        return 2
    # this checkout's chip_smoke.py (fixtures, timing), whatever --pkg is
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import goleft_tpu_torch
    from goleft_tpu_torch.io import rans_nx16 as rx
    from goleft_tpu_torch.io.cram import M_RANSNX16
    from goleft_tpu_torch.ops import rans_device as rd
    from goleft_tpu_torch.ops import rans_kernel as rk

    dev = torch.device("cuda")
    clock = cs.sm_clock_hz()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    out = {"package": os.path.dirname(goleft_tpu_torch.__file__),
           "nvidia_smi": smi, "sm_clock_hz": clock}
    with tempfile.TemporaryDirectory() as wd:
        crams, _, _, _ = cs.cohort_fabricate(
            wd, np.random.default_rng(71), n_reads=cs.CO_RPC,
            contig_len=CONTIG_LEN, rpc=cs.CO_RPC)
        for k, label in ((0, "ORDER0"), (2, "ORDER1"), (3, "STRIPE4")):
            raws = [rb for rb in cs.first_container_blocks(crams[k])
                    if rb.method == M_RANSNX16]
            plans = [rx.parse_nx16(rb.raw, rb.rsize) for rb in raws]
            got = rd.decode_parsed(plans, device=dev)
            if got != [rx.decode(rb.raw, rb.rsize) for rb in raws]:
                raise AssertionError(f"{label}: device decode differs from "
                                     "the host decoder")
            groups = cs.rans_groups(plans, dev)

            def launch_all():
                for key, grp, t in groups:
                    rd.group_stage(key, grp, t)

            flat = [c for p in plans
                    for c in (p.children if p.stripe else [p]) if not c.cat]

            def rounds_of(c):
                return rk.rounds_needed(torch.tensor([c.inner_len]),
                                        c.n_states, c.order1)

            longest = max(flat, key=rounds_of)
            (lkey, lgrp, lt), = cs.rans_groups([longest], dev)
            ms = cs.cuda_median_ms(launch_all, reps=args.reps)
            lone = cs.cuda_median_ms(lambda: rd.group_stage(lkey, lgrp, lt),
                                     reps=args.reps)
            rounds = rounds_of(longest)
            out[label] = {"ms": ms, "launches": len(groups),
                          "longest_rounds": rounds,
                          "cycles_per_round": ms * 1e-3 * clock / rounds,
                          "longest_stream_ms": lone}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
