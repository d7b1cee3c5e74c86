"""trace: fetch and render one stitched cross-process fleet trace. The
port's copy of the JAX package's commands/trace_cmd.py.

``goleft-tpu-torch trace <id> --router URL`` asks the fleet router's
``GET /fleet/trace/<id>`` for the Dapper-style stitched tree — the
router's own ``fleet.request``/``fleet.forward`` spans plus every
worker's matching ``request.*`` flight tree and the linked ``batch.*``
tree carrying the plan-step and device-dispatch spans — and
pretty-prints it, one line per span with its process track.

The trace id is whatever rode ``x-goleft-trace``: mint one client-side
(``ServeClient(trace=True)`` → ``client.last_trace_id``) or read the
router's response header — it echoes the id it used either way.

``--perfetto FILE`` additionally writes the Chrome trace-event JSON
(one process track per OS process) that loads directly in Perfetto /
chrome://tracing; ``--json`` dumps the raw stitched document.

Flight rings are bounded: a trace older than the ring's horizon
answers 404 — this is a live-ops tool, not an archive (dump rings via
SIGUSR1 for the post-incident artifact).
"""

from __future__ import annotations

import argparse
import json
import sys


def run_trace(trace_id: str, router: str, timeout_s: float = 30.0,
              out=sys.stdout, as_json: bool = False,
              perfetto: str | None = None) -> int:
    from ..obs.fleetplane import format_tree
    from ..serve.client import ServeClient, ServeError

    client = ServeClient(router, timeout_s=timeout_s)
    try:
        doc = client.fleet_trace(trace_id)
    except ServeError as e:
        print(f"goleft-tpu-torch trace: {e.message or e}", file=sys.stderr)
        return 1
    except OSError as e:  # an unreachable router: one line, no traceback
        print(f"goleft-tpu-torch trace: {router}: {e}", file=sys.stderr)
        return 1
    if perfetto:
        with open(perfetto, "w") as fh:
            json.dump(doc.get("perfetto") or {}, fh)
        print(f"goleft-tpu-torch trace: Perfetto export written to "
              f"{perfetto}", file=sys.stderr)
    if as_json:
        json.dump(doc, out, indent=1, sort_keys=True)
        out.write("\n")
    else:
        out.write(format_tree(doc) + "\n")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "goleft-tpu-torch trace",
        description="fetch + pretty-print a stitched cross-process "
                    "fleet trace from the router's /fleet/trace")
    p.add_argument("trace_id",
                   help="the x-goleft-trace id (client-minted via "
                        "ServeClient(trace=True), or echoed in the "
                        "router's response header)")
    p.add_argument("--router", required=True, metavar="URL",
                   help="fleet router base URL (e.g. "
                        "http://127.0.0.1:8090)")
    p.add_argument("--timeout-s", type=float, default=30.0)
    p.add_argument("--json", action="store_true",
                   help="dump the raw stitched document instead of "
                        "the span tree rendering")
    p.add_argument("--perfetto", default=None, metavar="FILE",
                   help="also write Chrome trace-event JSON (loads "
                        "in Perfetto with one track per process)")
    a = p.parse_args(argv)
    return run_trace(a.trace_id, a.router, timeout_s=a.timeout_s,
                     as_json=a.json, perfetto=a.perfetto)


if __name__ == "__main__":
    sys.exit(main())
