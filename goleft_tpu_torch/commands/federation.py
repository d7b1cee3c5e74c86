"""federation: N fleets behind the fleet-affinity federation router.
The port's copy of the JAX package's commands/federation.py; the fleets
it spawns are ``python -m goleft_tpu_torch fleet`` processes.

Two shapes:

  - ``goleft-tpu-torch federation --fleets N --workers M [...]``: spawn N
    ``goleft-tpu-torch fleet`` subprocesses (each a supervised fleet of M
    serve workers on ephemeral ports) and run the federation router
    in front of them. Losing an entire fleet — router included —
    degrades capacity, not availability: requests fail over to the
    next ring candidate byte-identically, and the dead fleet rejoins
    through a half-open probe when it heals.
  - ``goleft-tpu-torch federation --fleet URL --fleet URL [...]``: front
    already-running fleet routers you manage yourself (other hosts,
    containers). The federation cannot restart processes it does not
    own — healing below the fleet boundary belongs to each fleet's
    own supervisor.

Routing is fleet-affine (the SAME input-identity hash key the fleet
router uses one level down, so a file's whole serving path stays
warm), with saturation spillover (``--spill-threshold`` against each
fleet's polled ``fleet.slo.burn_rate_max``) and tenant-scoped
overload isolation (``--tenant-burn-threshold`` against the
``federation.tenant.burn_rate.<tenant>`` gauges; a breaching tenant's
best-effort traffic sheds 429 with an honest ``retry_after_s`` while
other tenants are untouched).

Lifecycle mirrors ``goleft-tpu-torch fleet``: one ``listening on
http://...`` line on stdout once the socket is bound (plus one
``fleet N at URL`` stderr line per spawned fleet), then block until
SIGTERM/SIGINT; spawned fleets are SIGTERMed (they drain their own
workers) on the way out. If fleet i of N fails to START, every
already-spawned fleet is killed before the command exits nonzero.
The federation process never imports torch.
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
import threading


def _spawn_fleet(workers: int, extra_args: list[str], env: dict):
    """One ``goleft-tpu-torch fleet`` child on an ephemeral port; returns
    (proc, url). The fleet prints its ``listening on`` line to stdout
    only once its router socket is bound and every worker announced."""
    from ..fleet.supervisor import WorkerSpawnError, read_announce

    child = subprocess.Popen(
        [sys.executable, "-m", "goleft_tpu_torch", "fleet", "--port", "0",
         "--workers", str(workers), *extra_args],
        stdout=subprocess.PIPE, text=True, env=env)
    url = read_announce(child, timeout_s=300.0)
    if url is None:
        child.kill()
        child.wait(timeout=10)
        if child.stdout is not None:
            child.stdout.close()
        raise WorkerSpawnError("fleet did not announce its port")
    return child, url


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(
        "goleft-tpu-torch federation",
        description="multi-fleet federation tier: whole-fleet "
                    "failover, saturation spillover, tenant-scoped "
                    "overload isolation",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8099,
                   help="federation port; 0 = ephemeral (printed)")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--fleets", type=int, default=0,
                   help="spawn this many supervised goleft-tpu-torch fleet "
                        "subprocesses on ephemeral ports")
    g.add_argument("--fleet", action="append", default=[],
                   metavar="URL",
                   help="front an already-running fleet router "
                        "(repeatable)")
    p.add_argument("--workers", type=int, default=2,
                   help="serve workers per SPAWNED fleet")
    p.add_argument("--fleet-args", default="",
                   help="extra flags passed through to each SPAWNED "
                        "fleet (one shell-quoted string, e.g. "
                        "--fleet-args '--quota mallory=2:2 "
                        "--shared-cache /tmp/c')")
    p.add_argument("--timeout-s", type=float, default=120.0,
                   help="default end-to-end request budget (requests "
                        "can override with timeout_s)")
    p.add_argument("--poll-interval-s", type=float, default=2.0,
                   help="fleet /healthz + /fleet/metrics poll "
                        "cadence (liveness, burn + tenant signals, "
                        "clock handshake)")
    p.add_argument("--down-after", type=int, default=2,
                   help="consecutive failed polls before a fleet is "
                        "marked down (a connection-level forward "
                        "failure marks it down immediately)")
    p.add_argument("--spill-threshold", type=float, default=0.0,
                   help="a fleet whose polled slo.burn_rate_max "
                        "exceeds this stops receiving NEW affinity "
                        "keys (existing keys stay for cache warmth; "
                        "spilled keys migrate home on recovery; "
                        "0 disables spillover)")
    p.add_argument("--spill-recover", type=float, default=None,
                   help="spilled keys return home only once the home "
                        "fleet's burn rate falls to/below this "
                        "(default: --spill-threshold — the two-sided "
                        "hysteresis band that stops burn-rate "
                        "flapping near the threshold from thrashing "
                        "key migration)")
    p.add_argument("--quota", action="append", default=[],
                   metavar="TENANT=RATE[:BURST]",
                   help="federation-level admission: per-tenant "
                        "token-bucket request quota enforced at the "
                        "front door (429 + retry_after_s before any "
                        "fleet budget burns; '*' sets the default "
                        "tenant; repeatable)")
    p.add_argument("--cache-sync-interval", type=float, default=0.0,
                   metavar="SECONDS",
                   help="replicate the fleets' shared result caches "
                        "(anti-entropy over /fleet/cache) every this "
                        "many seconds, plus immediately on half-open "
                        "rejoin (0 disables the timer; rejoin "
                        "warm-up still runs); pushes are HMAC-signed "
                        "with GOLEFT_TPU_FLEET_SECRET, which must be "
                        "set identically here and on every fleet or "
                        "replication stays disabled")
    p.add_argument("--tenant-burn-threshold", type=float,
                   default=0.0,
                   help="shed a tenant's best-effort traffic "
                        "(priority > 0) with 429 while its "
                        "federation.tenant.burn_rate gauge exceeds "
                        "this (0 disables tenant shedding)")
    p.add_argument("--tenant-shed-min", type=int, default=4,
                   help="windowed requests a tenant needs before its "
                        "burn rate can shed it (one unlucky outcome "
                        "must not exile a tenant)")
    p.add_argument("--error-budget", type=float, default=0.01,
                   help="allowed windowed error fraction tenant and "
                        "fleet burn rates are computed against")
    p.add_argument("--slo-p99-target-s", type=float, default=2.0,
                   help="per-tenant p99 latency target the "
                        "federation's own burn evidence uses")
    p.add_argument("--slo-window-s", type=float, default=300.0,
                   help="the rolling outcome window behind tenant "
                        "burn rates (and the honest retry_after_s a "
                        "shed carries)")
    p.add_argument("--vnodes", type=int, default=64,
                   help="virtual nodes per fleet on the hash ring")
    a = p.parse_args(argv)

    if a.fleets <= 0 and not a.fleet:
        p.error("need --fleets N or at least one --fleet URL")

    from ..fleet.federation import (
        FederationRouter, make_federation_server,
    )
    from ..obs.metrics import MetricsRegistry

    children: list = []
    urls = [u for u in a.fleet]
    env = dict(os.environ)
    fleet_extra = shlex.split(a.fleet_args)
    if a.fleets > 0:
        try:
            for i in range(a.fleets):
                child, url = _spawn_fleet(a.workers, fleet_extra,
                                          env)
                children.append(child)
                urls.append(url)
                print(f"goleft-tpu-torch federation: fleet {i} at {url}",
                      file=sys.stderr, flush=True)
        except Exception as e:  # noqa: BLE001 — startup failure:
            # kill whatever did spawn; a failed federation start must
            # not leave orphan fleets (each holding worker daemons)
            for child in children:
                if child.poll() is None:
                    child.terminate()
            for child in children:
                try:
                    child.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    child.kill()
                    child.wait(timeout=10)
                if child.stdout is not None:
                    child.stdout.close()
            print(f"goleft-tpu-torch federation: fleet spawn failed ({e});"
                  f" terminated {len(children)} already-spawned "
                  "fleet(s)", file=sys.stderr, flush=True)
            return 1

    registry = MetricsRegistry()
    app = FederationRouter(
        urls,
        poll_interval_s=a.poll_interval_s,
        down_after=a.down_after,
        default_timeout_s=a.timeout_s,
        spill_threshold=a.spill_threshold,
        spill_recover=a.spill_recover,
        quotas=a.quota,
        cache_sync_interval_s=a.cache_sync_interval,
        tenant_burn_threshold=a.tenant_burn_threshold,
        tenant_shed_min_requests=a.tenant_shed_min,
        error_budget=a.error_budget,
        slo_p99_target_s=a.slo_p99_target_s,
        slo_window_s=a.slo_window_s,
        vnodes=a.vnodes,
        registry=registry)
    app.start()
    httpd = make_federation_server(app, a.host, a.port)
    host, port = httpd.server_address[:2]
    print(f"goleft-tpu-torch federation: listening on "
          f"http://{host}:{port}", flush=True)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    t = threading.Thread(target=httpd.serve_forever,
                         kwargs={"poll_interval": 0.1},
                         name="goleft-federation-http")
    t.start()
    stop.wait()
    print("goleft-tpu-torch federation: draining", file=sys.stderr,
          flush=True)
    httpd.shutdown()
    t.join()
    httpd.server_close()
    app.close()
    rc = 0
    for child in children:
        if child.poll() is None:
            child.send_signal(signal.SIGTERM)
    for child in children:
        try:
            child.wait(timeout=60)
        except subprocess.TimeoutExpired:
            child.kill()
            rc = rc or 1
        if child.stdout is not None:
            child.stdout.close()
    print("goleft-tpu-torch federation: drained, bye", file=sys.stderr,
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
