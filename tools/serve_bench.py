#!/usr/bin/env python3
"""Time ``/v1/pairhmm`` of the serve daemon against the ``pairhmm``
command on the same windows, on the card, in one call.

    python3 tools/serve_bench.py [--pkg DIR] [--reps 2] [--out FILE]

Fabricates chip_smoke.py's pairhmm document (``fabricate_windows``:
``PH_WINDOWS`` windows of 4 haplotypes x 80 reads of 150 bp, seed 80, ~80%
selected by a candidates BED), then alternates, ``--reps`` times: the
command in a fresh process (its ``run.pairhmm`` seconds and stage
spans) and the request to one ``serve --profile-hz 100`` process (the
server's latency, and the sampling profiler's stacks of the pass thread
while it ran). ``--pkg DIR`` times the checkout at DIR (its
goleft_tpu_torch). Prints one JSON object; ``--out`` writes it too.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _leaf(stack: str, depth: int = 3) -> str:
    """The innermost ``depth`` frames of a collapsed stack
    (``module:function:line`` each)."""
    return ";".join(stack.split(";")[-depth:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pkg", default=ROOT,
                    help="checkout whose goleft_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, a.pkg)
    from goleft_tpu_torch.serve.client import ServeClient

    work = tempfile.mkdtemp(prefix="serve_bench-")
    rng = np.random.default_rng(80)
    doc = cs.fabricate_windows(rng, cs.PH_WINDOWS, cs.PH_WINDOW_READS)
    wpath = os.path.join(work, "windows.json")
    with open(wpath, "w") as fh:
        json.dump(doc, fh)
    keep = rng.random(cs.PH_WINDOWS) < 0.8
    cpath = os.path.join(work, "candidates.bed")
    cs._write_candidates_bed(
        cpath, [w for w, k in zip(doc["windows"], keep) if k])
    env = dict(os.environ, PYTHONPATH=a.pkg)
    env.pop("GOLEFT_TPU_FAULTS", None)

    proc, url, _, _ = cs._serve_start(a.pkg, work, env,
                                      "--profile-hz", "100")
    client = ServeClient(url, timeout_s=900)
    out = {"cli_s": [], "cli_stages": [], "serve_s": [], "serve_client_s": [],
           "top_stacks": []}
    try:
        for rep_i in range(a.reps):
            report = os.path.join(work, f"cli{rep_i}.json")
            tpath = os.path.join(work, f"table{rep_i}.tsv")
            r, _ = cs._run_cli(a.pkg, ["--metrics-out", report, "pairhmm",
                                       "--candidates", cpath, "--out",
                                       tpath, wpath], env)
            assert r.returncode == 0, r.stderr[-4000:]
            _, cmd_s, stages = cs.read_manifest(report, "pairhmm")
            out["cli_s"].append(cmd_s)
            out["cli_stages"].append(stages)
            prof = {}
            t = threading.Thread(target=lambda: prof.update(
                client._request("/debug/profile?seconds=45")))
            t.start()
            t0 = time.perf_counter()
            resp = client.pairhmm(wpath, candidates=cpath,
                                  cache_buster=rep_i, timeout_s=900)
            out["serve_client_s"].append(time.perf_counter() - t0)
            t.join(timeout=120)
            with open(tpath) as fh:
                table = fh.read()
            assert resp["likelihoods_tsv"] == table, "tables differ"
            out["serve_s"].append(
                client.metrics()["latency_windows"]["pairhmm"][-1])
            agg: dict[str, int] = {}
            for stack, n in prof.get("stacks", {}).items():
                if "serve.executors" in stack:  # the pass thread
                    key = _leaf(stack)
                    agg[key] = agg.get(key, 0) + n
            out["top_stacks"].append(sorted(
                agg.items(), key=lambda kv: -kv[1])[:15])
            out["pass_samples"] = sum(agg.values())
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    from goleft_tpu_torch.obs.provenance import nvidia_smi_line

    out["card"] = nvidia_smi_line()
    print(json.dumps(out))
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
