"""warmup: export the compile observatory's warmup manifest. The port's
copy of the JAX package's commands/warmup.py.

``goleft-tpu-torch warmup export`` pulls ``GET /debug/compiles`` from a live
worker (or ``GET /fleet/compiles`` from a router — the fleet-merged
view) and writes the ranked signature set as a validated
``goleft-tpu.warmup-manifest/1`` document, the artifact ``serve
--warmup`` pre-builds from: signatures ranked by
hit count × measured compile cost, merged monotonically into any
manifest already at ``--out`` (repeated exports only sharpen it).

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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "goleft-tpu-torch warmup",
        description="export the compile observatory's warmup manifest "
                    "from a live worker or fleet router",
    )
    sub = p.add_subparsers(dest="action", required=True)
    exp = sub.add_parser(
        "export", help="fetch compile stats and write the ranked "
                       "warmup manifest")
    exp.add_argument("--url", default="http://127.0.0.1:8080",
                     help="worker base URL (/debug/compiles) or — "
                          "with --router — router base URL "
                          "(/fleet/compiles)")
    exp.add_argument("--router", action="store_true",
                     help="treat --url as a fleet router: export the "
                          "fleet-merged manifest")
    exp.add_argument("--out", default="warmup-manifest.json",
                     help="manifest path (merged into any valid "
                          "manifest already there; '-' = stdout, "
                          "no merge)")
    exp.add_argument("--timeout-s", type=float, default=10.0)
    a = p.parse_args(argv)

    from ..obs.compiles import (
        WARMUP_SCHEMA, build_warmup_manifest, save_warmup_manifest,
        validate_warmup_manifest,
    )

    path = "/fleet/compiles" if a.router else "/debug/compiles"
    try:
        doc = _fetch_json(a.url.rstrip("/") + path, a.timeout_s)
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"goleft-tpu-torch warmup: fetch {a.url}{path} failed: {e}",
              file=sys.stderr)
        return 1

    # both endpoints carry a `signatures` list in manifest-entry form;
    # rebuild through the ranker so rank/ordering are recomputed here
    # (the authority on rank is this tool, not the server's snapshot)
    stats = {
        (s["family"], s["signature"], s["backend"]): {
            "hits": s["hits"], "compiles": s["compiles"],
            "compile_seconds": s["compile_seconds"]}
        for s in (doc.get("signatures") or [])
        if isinstance(s, dict)
    }
    manifest = build_warmup_manifest(stats)
    try:
        validate_warmup_manifest(manifest)
    except ValueError as e:
        print(f"goleft-tpu-torch warmup: server returned an invalid "
              f"signature set: {e}", file=sys.stderr)
        return 1

    if a.out == "-":
        json.dump(manifest, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
        return 0
    merged = save_warmup_manifest(a.out, manifest)
    n = len(merged["signatures"])
    top = merged["signatures"][0] if n else None
    print(f"goleft-tpu-torch warmup: wrote {a.out} "
          f"({WARMUP_SCHEMA}, {n} signatures"
          + (f", top {top['family']}/{top['signature']}" if top
             else "") + ")",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
