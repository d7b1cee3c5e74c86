"""memory: render the memory observatory of a worker or a fleet. The
port's copy of the JAX package's commands/memory_cmd.py.

``goleft-tpu-torch memory --router URL`` asks the router for
``GET /fleet/memory`` — every worker's ``/debug/memory`` body merged
with exact counter sums and per-worker gauge min/max — and renders
host RSS, device live bytes by family, and the pressure picture.
``--url`` targets one worker's ``/debug/memory`` directly. ``--json``
prints the raw document. Pure HTTP client — torch never loads here.
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


def _mb(n) -> str:
    return f"{float(n) / (1024 * 1024):.1f}MB"


def _render_worker(doc: dict) -> str:
    host = doc.get("host") or {}
    dev = doc.get("device") or {}
    pres = doc.get("pressure") or {}
    lines = [
        f"memory: pid {doc.get('pid', '?')}  "
        f"rss {_mb(host.get('rss_bytes', 0))}  "
        f"peak {_mb(host.get('rss_peak_bytes', 0))}"
        + ("" if doc.get("enabled")
           else "  [sampler DISABLED — start with "
                "--mem-sample-interval-s]")]
    if pres.get("high_water_bytes"):
        sheds = (doc.get("counters") or {}).get(
            "memory.sheds_total", 0)
        lines.append(
            f"pressure: {pres.get('state', 'ok')}  "
            f"(high {_mb(pres.get('high_water_bytes', 0))}, "
            f"low {_mb(pres.get('low_water_bytes', 0))}, "
            f"sheds {sheds})")
    else:
        lines.append("pressure: unarmed (no --mem-high-water-mb)")
    dropped = int(dev.get("buffers_dropped", 0))
    lines.append(f"device live: {_mb(dev.get('total_bytes', 0))}"
                 + (f"  ({dropped} attribution(s) dropped)"
                    if dropped else ""))
    for fam, nb in sorted((dev.get("by_family") or {}).items(),
                          key=lambda kv: (-kv[1], kv[0])):
        lines.append(f"{nb:>14}  {_mb(nb):>10}  {fam}")
    for t in doc.get("tracemalloc_top") or []:
        lines.append(f"{t['size_bytes']:>14}  {t['count']:>6}x  "
                     f"{t['site']}")
    return "\n".join(lines)


def _render_merged(doc: dict) -> str:
    gauges = doc.get("gauges") or {}
    rss = gauges.get("memory.rss_bytes") or {}
    lines = [
        f"fleet memory: {doc.get('workers', 0)} worker(s), "
        f"{doc.get('workers_in_pressure', 0)} in pressure"
        + ("" if doc.get("enabled")
           else "  [sampler DISABLED on every worker]")]
    if rss:
        lines.append(
            f"rss: total {_mb(rss.get('sum', 0))}  "
            f"min {_mb(rss.get('min', 0))}  "
            f"max {_mb(rss.get('max', 0))} per worker")
    for k, v in sorted((doc.get("counters") or {}).items()):
        lines.append(f"{v:>14}  {k}")
    fams = doc.get("device_by_family") or {}
    if fams:
        lines.append(f"device live by family "
                     f"({len(fams)} families):")
        for fam, nb in sorted(fams.items(),
                              key=lambda kv: (-kv[1], kv[0])):
            lines.append(f"{nb:>14}  {_mb(nb):>10}  {fam}")
    per = doc.get("per_worker") or doc.get("per_fleet") or {}
    for target, row in sorted(per.items()):
        if "error" in row:
            lines.append(f"  {target}: ERROR {row['error']}")
        elif "workers" in row:
            lines.append(
                f"  {target}: {row['workers']} worker(s), "
                f"{row.get('workers_in_pressure', 0)} in pressure")
        else:
            lines.append(
                f"  {target}: rss {_mb(row.get('rss_bytes', 0))}  "
                f"device {_mb(row.get('device_live_bytes', 0))}  "
                f"{row.get('pressure', 'ok')}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "goleft-tpu-torch memory",
        description="render the host/device memory observatory of a "
                    "fleet router or a single worker",
    )
    tgt = p.add_mutually_exclusive_group()
    tgt.add_argument("--router", default=None,
                     help="fleet router base URL: merged "
                          "/fleet/memory across every worker")
    tgt.add_argument("--url", default=None,
                     help="single worker base URL: /debug/memory")
    p.add_argument("--timeout", type=float, default=10.0,
                   help="HTTP timeout in seconds")
    p.add_argument("--json", action="store_true",
                   help="print the raw JSON document")
    a = p.parse_args(argv)

    if a.router:
        url = a.router.rstrip("/") + "/fleet/memory"
    else:
        base = a.url or "http://127.0.0.1:8080"
        url = base.rstrip("/") + "/debug/memory"
    try:
        doc = _fetch_json(url, timeout_s=a.timeout)
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"goleft-tpu-torch memory: fetch {url} failed: {e}",
              file=sys.stderr)
        return 1
    if "counters" not in doc:
        print(f"goleft-tpu-torch memory: {url} returned no memory "
              f"document", file=sys.stderr)
        return 1

    if a.json:
        json.dump(doc, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
        return 0
    print(_render_worker(doc) if "host" in doc
          else _render_merged(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
