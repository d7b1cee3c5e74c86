#!/usr/bin/env python3
"""Time ``cohortdepth --decode-device`` of several checkouts on one card.

Fabricates chip_smoke.py's cohort once (its CRAMs and their reads, 10,000
records per container, the same seed), then runs ``python -m
goleft_tpu_torch cohortdepth --decode-device`` (hybrid engine) with each
checkout's package, in the order given and then reversed, ``--reps``
times; every matrix must equal the oracle. ``--host`` drops
``--decode-device``: the CRAM blocks then decode on the host (the C
codecs of csrc/fastio.cpp where the checkout has them). Prints one JSON
line per run: the command and import seconds, the stage seconds and the
decode and prefetch counters of its ``--metrics-out`` run manifest
(every checkout given must write one).

    python3 tools/cohort_bench.py [--reps N] [--host] DIR [DIR ...]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--host", action="store_true",
                    help="decode the CRAM blocks on the host")
    ap.add_argument("dirs", nargs="+", help="checkouts to run")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    dirs = [os.path.abspath(d) for d in args.dirs]
    with tempfile.TemporaryDirectory() as wd:
        crams, fai, names, truth = cs.cohort_fabricate(
            wd, np.random.default_rng(31))
        want = cs.cohort_oracle(truth, names)
        for rep in range(args.reps):
            for d in dirs + dirs[::-1]:
                report = os.path.join(wd, "report.json")
                env = dict(os.environ, PYTHONPATH=d)
                env.pop("GOLEFT_TPU_FAULTS", None)
                r, wall = cs._run_cli(d, [
                    "--metrics-out", report, "cohortdepth", "--fai", fai,
                    "-w", str(cs.CO_WINDOW),
                    *([] if args.host else ["--decode-device"]), *crams],
                    env)
                if r.returncode != 0 or r.stdout != want:
                    raise AssertionError(f"cohortdepth with {d} failed or "
                                         f"differs from the oracle "
                                         f"({r.returncode}): "
                                         f"{r.stderr[-2000:]}")
                rep_, cmd_s, stages = cs.read_manifest(report,
                                                       "cohortdepth")
                print(json.dumps({
                    "checkout": d, "rep": rep, "host": args.host,
                    "nvidia_smi": smi,
                    "wall_s": wall, "command_s": cmd_s,
                    "import_s": rep_["import_seconds"],
                    "stage_seconds": stages,
                    "launches": rep_["kernel_launches"],
                    "counters": {k: v for k, v in
                                 rep_["metrics"]["counters"].items()
                                 if k.startswith(("decode.", "prefetch."))},
                }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
