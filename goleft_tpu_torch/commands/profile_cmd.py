"""profile: collect a fleet-wide (or single-worker) CPU profile. The
port's copy of the JAX package's commands/profile_cmd.py.

``goleft-tpu-torch profile --router URL --seconds N`` asks the router for
``GET /fleet/profile?seconds=N`` — every worker samples its own
threads for the SAME overlapping window and the router merges the
collapsed stacks with exact counter sums — and renders the result:

  default        top stacks by sample count (leaf-trimmed, terminal)
  --collapsed F  flamegraph collapsed format ("stack count" lines —
                 feed to flamegraph.pl / speedscope / inferno;
                 '-' = stdout)
  --json         the raw merged document

``--url`` targets one worker's ``/debug/profile`` directly instead.
Pure HTTP client — torch never loads here.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request


def _fetch_json(url: str, timeout_s: float) -> dict:
    req = urllib.request.Request(
        url, headers={"Accept": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout_s) as r:
        return json.loads(r.read().decode())


def _render_top(doc: dict, limit: int = 25) -> str:
    total = sum(doc["stacks"].values()) or 1
    lines = [f"profile: {doc.get('samples_total', 0)} samples, "
             f"{len(doc['stacks'])} distinct stacks, "
             f"{doc.get('stacks_dropped', 0)} dropped"
             + ("" if doc.get("enabled", True)
                else "  [profiling DISABLED on every target — "
                     "start workers with --profile-hz]")]
    ranked = sorted(doc["stacks"].items(),
                    key=lambda kv: (-kv[1], kv[0]))
    for stack, count in ranked[:limit]:
        frames = stack.split(";")
        leaf = frames[-1]
        caller = frames[-2] if len(frames) > 1 else ""
        pct = 100.0 * count / total
        lines.append(f"{count:>8} {pct:5.1f}%  {leaf}"
                     + (f"  <- {caller}" if caller else ""))
    if len(ranked) > limit:
        lines.append(f"... {len(ranked) - limit} more stacks "
                     "(--collapsed for the full set)")
    if doc.get("trace_ids"):
        ids = ", ".join(sorted(doc["trace_ids"])[:8])
        lines.append(f"traced requests sampled: {ids}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "goleft-tpu-torch profile",
        description="collect and render a sampling profile from a "
                    "fleet router or a single worker",
    )
    tgt = p.add_mutually_exclusive_group()
    tgt.add_argument("--router", default=None,
                     help="fleet router base URL: merged "
                          "/fleet/profile across every worker")
    tgt.add_argument("--url", default=None,
                     help="single worker base URL: /debug/profile")
    p.add_argument("--seconds", type=float, default=2.0,
                   help="collection window (overlapping across "
                        "workers when merged at the router)")
    p.add_argument("--collapsed", default=None, metavar="FILE",
                   help="write flamegraph collapsed format "
                        "('-' = stdout)")
    p.add_argument("--json", action="store_true",
                   help="print the raw merged JSON document")
    a = p.parse_args(argv)

    from ..obs.profiler import to_collapsed

    if a.router:
        url = a.router.rstrip("/") + \
            f"/fleet/profile?seconds={a.seconds}"
    else:
        base = a.url or "http://127.0.0.1:8080"
        url = base.rstrip("/") + f"/debug/profile?seconds={a.seconds}"
    try:
        doc = _fetch_json(url, timeout_s=a.seconds + 30.0)
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"goleft-tpu-torch profile: fetch {url} failed: {e}",
              file=sys.stderr)
        return 1
    if "stacks" not in doc:
        print(f"goleft-tpu-torch profile: {url} returned no profile "
              f"document", file=sys.stderr)
        return 1

    if a.json:
        json.dump(doc, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
        return 0
    if a.collapsed is not None:
        text = to_collapsed(doc)
        if a.collapsed == "-":
            sys.stdout.write(text)
        else:
            with open(a.collapsed, "w") as fh:
                fh.write(text)
            print(f"goleft-tpu-torch profile: wrote "
                  f"{len(doc['stacks'])} stacks to {a.collapsed}",
                  file=sys.stderr)
        return 0
    print(_render_top(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
