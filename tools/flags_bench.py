#!/usr/bin/env python3
"""Time the three commands with and without ``--trace-out`` on one card,
and against other checkouts without it.

Fabricates chip_smoke.py's fixtures once (the 25 Mb BAM of its depth
phase, the 1,000-window document of its pairhmm phase with the same
~80% candidates, the 4-CRAM cohort of its cohortdepth phase), then for
each command runs ``python -m goleft_tpu_torch`` in fresh processes in
the order: every ``--pkg`` checkout, this checkout, this checkout with
``--trace-out``, the same traced run again, this checkout, the
checkouts again in reverse. Every output must equal chip_smoke.py's
oracle (pairhmm: the first run's table). Before them, one untraced run
of each checkout builds its kernels (nvcc, at first use) and warms the
host; it is printed with ``"warmup": true``. ``--reps N`` repeats the
order N times. Prints one JSON line per run:
the command's seconds (its ``run.<command>`` span), the import seconds,
the kernel launches, and for a traced run the fenced ``device.*`` spans
and the fenced-kernel share (chip_smoke.py::fenced_kernel_share).

    python3 tools/flags_bench.py [--reps N] [--pkg DIR ...]
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
    ap.add_argument("--pkg", action="append", default=[],
                    help="another checkout to run untraced (its root)")
    ap.add_argument("--reps", type=int, default=1)
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
    others = [os.path.abspath(d) for d in args.pkg]
    warmup = [(d, False, True) for d in [*others, ROOT]]
    order = warmup + args.reps * (
        [(d, False, False) for d in others]
        + [(ROOT, False, False), (ROOT, True, False), (ROOT, True, False),
           (ROOT, False, False)]
        + [(d, False, False) for d in others[::-1]])
    with tempfile.TemporaryDirectory() as wd:
        bam, fa, reads = cs.fabricate(wd, np.random.default_rng(7))
        want_d, want_c = cs.oracle_beds(reads)
        rng = np.random.default_rng(80)
        doc = cs.fabricate_windows(rng, cs.PH_WINDOWS, cs.PH_WINDOW_READS)
        wpath = os.path.join(wd, "windows.json")
        with open(wpath, "w") as fh:
            json.dump(doc, fh)
        keep = rng.random(cs.PH_WINDOWS) < 0.8
        cpath = os.path.join(wd, "candidates.bed")
        cs._write_candidates_bed(
            cpath, [w for w, k in zip(doc["windows"], keep) if k])
        crams, fai, names, truth = cs.cohort_fabricate(
            wd, np.random.default_rng(31))
        want_co = cs.cohort_oracle(truth, names)
        table = os.path.join(wd, "table.tsv")
        commands = {
            "depth": ["depth", "--prefix", os.path.join(wd, "o"), "-r", fa,
                      "-w", str(cs.WINDOW), "-m", str(cs.MAX_MEAN), bam],
            "pairhmm": ["pairhmm", "--candidates", cpath, "--out", table,
                        wpath],
            "cohortdepth": ["cohortdepth", "--fai", fai, "-w",
                            str(cs.CO_WINDOW), "--decode-device", *crams],
        }
        want_table = None
        for prog, cmd in commands.items():
            for d, traced, warm in order:
                report = os.path.join(wd, "report.json")
                trace = os.path.join(wd, "trace.json")
                env = dict(os.environ, PYTHONPATH=d)
                env.pop("GOLEFT_TPU_FAULTS", None)
                extra = ["--trace-out", trace] if traced else []
                r, wall = cs._run_cli(d, ["--metrics-out", report, *extra,
                                          *cmd], env)
                if r.returncode != 0:
                    raise AssertionError(f"{prog} ({d}) failed: "
                                         f"{r.stderr[-2000:]}")
                if prog == "depth":
                    for path, w in ((os.path.join(wd, "o.depth.bed"),
                                     want_d),
                                    (os.path.join(wd, "o.callable.bed"),
                                     want_c)):
                        with open(path) as fh:
                            cs._same_bytes(f"depth ({d})", fh.read(), w)
                elif prog == "pairhmm":
                    with open(table) as fh:
                        got = fh.read()
                    want_table = want_table or got
                    cs._same_bytes(f"pairhmm ({d})", got, want_table)
                else:
                    cs._same_bytes(f"cohortdepth ({d})", r.stdout, want_co)
                rep, cmd_s, stages = cs.read_manifest(report, prog)
                rec = {"command": prog, "tree": os.path.relpath(d, ROOT),
                       "traced": traced, "warmup": warm,
                       "command_s": cmd_s, "wall_s": wall,
                       "import_s": rep["import_seconds"],
                       "launches": rep["kernel_launches"],
                       "stage_seconds": stages, "card": smi}
                if traced:
                    tr = cs.load_trace(trace)
                    rec["device_spans"] = len(tr["device"])
                    rec["fenced_kernel_share"] = cs.fenced_kernel_share(tr)
                    rec["spans"] = len(tr["spans"])
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
