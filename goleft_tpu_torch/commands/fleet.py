"""fleet: N serve workers behind the file-affinity router. The port's
copy of the JAX package's commands/fleet.py; its workers are
``python -m goleft_tpu_torch serve`` processes on the card.

Three shapes:

  - ``goleft-tpu-torch fleet --workers N [...]``: spawn N
    ``goleft-tpu-torch serve`` subprocesses on ephemeral ports and run the router in
    front of them, SUPERVISED (fleet/supervisor.py): dead workers are
    restarted with backoff, hung workers (healthz timeout) are
    SIGKILLed and recycled, crash-looping slots are quarantined (the
    fleet completes degraded and exits 3, cohortdepth's quarantine
    contract), and with ``--min-workers``/``--max-workers`` +
    ``--target-queue-age-s`` the fleet scales elastically against the
    router's queue-age signal.
  - ``goleft-tpu-torch fleet --workers N --no-supervise``: spawn-and-front
    only — the pre-supervisor behavior (a dead worker stays dead).
  - ``goleft-tpu-torch fleet --worker URL --worker URL [...]``: front
    already-running daemons you manage yourself (other hosts,
    containers). No supervision: the fleet cannot restart processes
    it does not own.

``--shared-cache DIR`` gives every SPAWNED worker the same
content-keyed ResultCache directory (``--cache DIR --cache-shared``),
so a restarted or rescheduled worker replays previously computed
responses instead of recomputing them.

Lifecycle mirrors the serve daemon: one ``listening on http://...``
line on stdout once the router socket is bound (plus one ``worker N
at URL`` line per spawned worker), then block until SIGTERM/SIGINT.
If any worker slot was quarantined, the exit code is 3 and
``--quarantine-manifest`` (when given) receives the same JSON
manifest shape cohortdepth writes for quarantined samples. If worker
i of N fails to START, every already-spawned child is killed before
the command exits nonzero — no orphan daemons. The router process
never imports torch — it stays a cheap, boring forwarder no matter what
the workers are chewing on.
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
import threading


def _spawn_worker(extra_args: list[str], env: dict):
    """One serve child on an ephemeral port; returns (proc, url)."""
    from ..fleet.supervisor import WorkerSpawnError, read_announce

    child = subprocess.Popen(
        [sys.executable, "-m", "goleft_tpu_torch", "serve", "--port", "0",
         *extra_args],
        stdout=subprocess.PIPE, text=True, env=env)
    url = read_announce(child, timeout_s=120.0)
    if url is None:
        child.kill()
        child.wait(timeout=10)
        if child.stdout is not None:
            child.stdout.close()
        raise WorkerSpawnError("worker did not announce its port")
    return child, url


def events_main(argv) -> int:
    """``goleft-tpu-torch fleet events``: query the supervisor's structured
    event journal (spawns, deaths, backoffs, hang-kills, quarantines,
    scale events, drains) — replayable after a SIGKILLed supervisor
    because every append is fsync'd and the reader tolerates the one
    torn tail line a crash can leave."""
    p = argparse.ArgumentParser(
        "goleft-tpu-torch fleet events",
        description="query the fleet supervisor's events.jsonl "
                    "lifecycle journal")
    p.add_argument("--journal", default="events.jsonl",
                   metavar="PATH",
                   help="the events.jsonl written via fleet "
                        "--events-journal (default: ./events.jsonl)")
    p.add_argument("--since", default=None, metavar="WHEN",
                   help="only events at/after WHEN: epoch seconds, a "
                        "relative window (30s/15m/2h/1d), or ISO8601")
    p.add_argument("--slot", type=int, default=None,
                   help="only events for this worker slot index")
    p.add_argument("--type", default=None, dest="etype",
                   metavar="TYPE",
                   help="only events of this type (spawn, restart, "
                        "death, backoff, hang_kill, quarantine, "
                        "scale_up, scale_down, drain, "
                        "memory_recycle, ...)")
    p.add_argument("--json", action="store_true",
                   help="emit the schema-stable JSON document "
                        "(goleft-tpu.fleet-events/1) instead of the "
                        "human table")
    a = p.parse_args(argv)

    import json as _json

    from ..obs.events import parse_since, read_events

    if not os.path.exists(a.journal):
        print(f"goleft-tpu-torch fleet events: no journal at {a.journal}",
              file=sys.stderr)
        return 1
    since = parse_since(a.since) if a.since else None
    events = read_events(a.journal, since=since, slot=a.slot,
                         type=a.etype)
    if a.json:
        print(_json.dumps({"schema": "goleft-tpu.fleet-events/1",
                           "journal": a.journal,
                           "count": len(events),
                           "events": events}, sort_keys=True,
                          indent=1))
        return 0
    for e in events:
        slot = e.get("slot")
        parts = [e.get("ts", "?"), f"{e.get('type', '?'):<13}"]
        parts.append(f"slot={slot}" if slot is not None else "slot=-")
        if e.get("worker"):
            parts.append(e["worker"])
        detail = {k: v for k, v in sorted(e.items())
                  if k not in ("schema", "t", "ts", "type", "slot",
                               "worker", "trace_id") and v is not None}
        if detail:
            parts.append(" ".join(f"{k}={v}" for k, v
                                  in detail.items()))
        print("  ".join(parts))
    print(f"# {len(events)} event(s) from {a.journal}",
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "events":
        return events_main(argv[1:])
    p = argparse.ArgumentParser(
        "goleft-tpu-torch fleet",
        description="multi-worker serve fleet behind a file-affinity "
                    "router with admission control, supervision and "
                    "elastic scaling",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8090,
                   help="router port; 0 = ephemeral (printed)")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--workers", type=int, default=0,
                   help="spawn this many goleft-tpu-torch serve workers on "
                        "ephemeral ports (supervised unless "
                        "--no-supervise)")
    g.add_argument("--worker", action="append", default=[],
                   metavar="URL",
                   help="front an already-running serve daemon "
                        "(repeatable; unsupervised)")
    p.add_argument("--worker-args", default="",
                   help="extra flags passed through to each SPAWNED "
                        "worker (one shell-quoted string, e.g. "
                        "--worker-args '--cache /tmp/c -p 2')")
    p.add_argument("--quota", action="append", default=[],
                   metavar="TENANT=RATE[:BURST]",
                   help="per-tenant token-bucket quota in requests/s "
                        "(repeatable; '*' sets the default every "
                        "unlisted tenant gets its own bucket from; "
                        "unlisted tenants are unmetered without it)")
    p.add_argument("--max-inflight", type=int, default=16,
                   help="concurrent forwards; excess requests wait in "
                        "the fair scheduler (priority + aging, "
                        "deadline-aware)")
    p.add_argument("--aging-rate", type=float, default=0.5,
                   help="priority points a waiting request gains per "
                        "queued second (starvation-freedom knob)")
    p.add_argument("--timeout-s", type=float, default=120.0,
                   help="default end-to-end request budget (requests "
                        "can override with timeout_s)")
    p.add_argument("--poll-interval-s", type=float, default=2.0,
                   help="worker /healthz + /metrics poll cadence "
                        "(health, breaker import, SLO shed signal)")
    p.add_argument("--down-after", type=int, default=2,
                   help="consecutive failed polls before a worker is "
                        "taken out of rotation")
    p.add_argument("--shed-below", type=float, default=0.0,
                   help="shed best-effort traffic (priority > 0) with "
                        "503 while polled fleet availability is below "
                        "this (0 disables)")
    p.add_argument("--redirect", action="store_true",
                   help="answer 307 with the affinity worker's URL "
                        "instead of proxying the body (clients must "
                        "follow redirects; serve/client.py does)")
    p.add_argument("--vnodes", type=int, default=64,
                   help="virtual nodes per worker on the hash ring")
    sup = p.add_argument_group(
        "supervision + elastic scaling (spawn mode only)")
    sup.add_argument("--no-supervise", action="store_true",
                     help="spawn workers without lifecycle "
                          "management (a dead worker stays dead)")
    sup.add_argument("--min-workers", type=int, default=0,
                     help="autoscaler floor (default: --workers)")
    sup.add_argument("--max-workers", type=int, default=0,
                     help="autoscaler ceiling (default: --workers)")
    sup.add_argument("--target-queue-age-s", type=float, default=0.0,
                     help="scale up while the router's queue age "
                          "exceeds this; scale down when idle "
                          "(0 disables the autoscaler)")
    sup.add_argument("--scale-cooldown-s", type=float, default=30.0,
                     help="quiet period after any scale event")
    sup.add_argument("--scale-down-idle-ticks", type=int, default=5,
                     help="consecutive idle supervision ticks before "
                          "a scale-down (hysteresis)")
    sup.add_argument("--supervise-interval-s", type=float,
                     default=1.0,
                     help="supervision tick cadence (liveness + hang "
                          "checks, autoscale evaluation)")
    sup.add_argument("--hang-timeout-s", type=float, default=5.0,
                     help="per-probe healthz budget; a worker "
                          "answering nothing is presumed hung")
    sup.add_argument("--hang-after", type=int, default=2,
                     help="consecutive healthz timeouts before a "
                          "worker is SIGKILLed and recycled")
    sup.add_argument("--restart-limit", type=int, default=5,
                     help="deaths inside --crash-window-s before a "
                          "slot is quarantined (fleet runs degraded, "
                          "exit 3)")
    sup.add_argument("--crash-window-s", type=float, default=300.0,
                     help="the crash-loop detection window")
    sup.add_argument("--drain-timeout-s", type=float, default=30.0,
                     help="scale-down: how long to wait for a "
                          "draining worker's in-flight forwards")
    sup.add_argument("--spawn-timeout-s", type=float, default=120.0,
                     help="how long a spawned worker may take to "
                          "announce its URL")
    sup.add_argument("--shared-cache", default=None, metavar="DIR",
                     help="content-keyed ResultCache directory "
                          "shared by ALL spawned workers (passes "
                          "--cache DIR --cache-shared through): "
                          "restarts and ring resizes replay instead "
                          "of recompute; also advertised at "
                          "/fleet/cache for cross-fleet replication "
                          "(pushes require GOLEFT_TPU_FLEET_SECRET)")
    sup.add_argument("--warmup", default=None, metavar="PATH",
                     help="warmup manifest forwarded to every "
                          "spawned worker (serve --warmup): workers "
                          "— including supervisor restarts after a "
                          "crash/preemption — pre-compile its top "
                          "signatures before reporting healthy")
    sup.add_argument("--quarantine-manifest", default=None,
                     metavar="PATH",
                     help="write the slot-quarantine JSON manifest "
                          "here on exit (same shape as cohortdepth's "
                          "sample quarantine)")
    obsg = p.add_argument_group("fleet observability plane")
    obsg.add_argument("--events-journal", default=None,
                      metavar="PATH",
                      help="append supervisor lifecycle events "
                           "(spawn/death/backoff/hang-kill/"
                           "quarantine/scale/drain) to this fsync'd "
                           "events.jsonl — query with `goleft-tpu-torch "
                           "fleet events --journal PATH`")
    obsg.add_argument("--burn-threshold", type=float, default=0.0,
                      help="scale up while the fleet SLO burn rate "
                           "(max over endpoints of p99 ratio and "
                           "error-rate/budget) exceeds this, even "
                           "with queue age below target (0 disables; "
                           "1.0 = scale when the budget burns faster "
                           "than it earns)")
    obsg.add_argument("--error-budget", type=float, default=0.01,
                      help="allowed windowed 5xx fraction the burn "
                           "rate is computed against")
    obsg.add_argument("--mem-recycle-mb", type=float, default=0.0,
                      help="memory hard cap per worker: a healthy "
                           "worker whose /debug/memory RSS exceeds "
                           "this is drained and recycled (a "
                           "memory_recycle event in the journal) "
                           "before the kernel OOM killer acts "
                           "(0 disables)")
    a = p.parse_args(argv)

    if a.workers <= 0 and not a.worker:
        p.error("need --workers N or at least one --worker URL")

    from ..fleet.router import RouterApp, make_router_server
    from ..obs.metrics import MetricsRegistry

    registry = MetricsRegistry()
    children: list = []
    supervisor = None
    urls = [u for u in a.worker]
    worker_extra = shlex.split(a.worker_args)
    if a.warmup:
        # same pass-through pattern as --shared-cache: every spawn —
        # initial, scale-up, or supervisor restart — gets the
        # manifest, so a restarted worker comes back pre-compiled
        worker_extra += ["--warmup", a.warmup]
    env = dict(os.environ)
    if a.workers > 0 and not a.no_supervise:
        from ..fleet.supervisor import Supervisor, WorkerSpawnError

        min_w = a.min_workers or a.workers
        max_w = a.max_workers or max(a.workers, min_w)
        supervisor = Supervisor(
            worker_args=worker_extra, env=env,
            min_workers=min_w, max_workers=max_w,
            registry=registry,
            interval_s=a.supervise_interval_s,
            hang_timeout_s=a.hang_timeout_s,
            hang_after=a.hang_after,
            crash_limit=a.restart_limit,
            crash_window_s=a.crash_window_s,
            target_queue_age_s=a.target_queue_age_s,
            scale_cooldown_s=a.scale_cooldown_s,
            scale_down_idle_ticks=a.scale_down_idle_ticks,
            drain_timeout_s=a.drain_timeout_s,
            spawn_timeout_s=a.spawn_timeout_s,
            shared_cache=a.shared_cache,
            events_journal=a.events_journal,
            burn_threshold=a.burn_threshold,
            mem_recycle_bytes=int(a.mem_recycle_mb * 1024 * 1024))
        try:
            urls = supervisor.spawn_initial(a.workers)
        except WorkerSpawnError as e:
            print(f"goleft-tpu-torch fleet: {e} (already-spawned workers "
                  "killed)", file=sys.stderr, flush=True)
            return 1
        for i, url in enumerate(urls):
            print(f"goleft-tpu-torch fleet: worker {i} at {url}",
                  file=sys.stderr, flush=True)
    elif a.workers > 0:
        extra = list(worker_extra)
        if a.shared_cache:
            os.makedirs(a.shared_cache, exist_ok=True)
            extra += ["--cache", a.shared_cache, "--cache-shared"]
        try:
            for i in range(a.workers):
                child, url = _spawn_worker(extra, env)
                children.append(child)
                urls.append(url)
                print(f"goleft-tpu-torch fleet: worker {i} at {url}",
                      file=sys.stderr, flush=True)
        except Exception as e:  # noqa: BLE001 — startup failure:
            # kill whatever did spawn; a failed `fleet` start must
            # not leave orphan serve daemons running
            for child in children:
                if child.poll() is None:
                    child.kill()
                child.wait(timeout=10)
                if child.stdout is not None:
                    child.stdout.close()
            print(f"goleft-tpu-torch fleet: worker spawn failed ({e}); "
                  f"killed {len(children)} already-spawned "
                  "worker(s)", file=sys.stderr, flush=True)
            return 1

    app = RouterApp(urls, quotas=a.quota,
                    max_inflight=a.max_inflight,
                    aging_rate=a.aging_rate,
                    default_timeout_s=a.timeout_s,
                    poll_interval_s=a.poll_interval_s,
                    down_after=a.down_after,
                    shed_below=a.shed_below,
                    redirect=a.redirect,
                    vnodes=a.vnodes,
                    registry=registry,
                    error_budget=a.error_budget,
                    cache_dir=a.shared_cache)
    if supervisor is not None:
        supervisor.bind(app)
    app.start()
    if supervisor is not None:
        supervisor.start()
    httpd = make_router_server(app, a.host, a.port)
    host, port = httpd.server_address[:2]
    print(f"goleft-tpu-torch fleet: listening on http://{host}:{port}",
          flush=True)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    t = threading.Thread(target=httpd.serve_forever,
                         kwargs={"poll_interval": 0.1},
                         name="goleft-fleet-http")
    t.start()
    stop.wait()
    print("goleft-tpu-torch fleet: draining", file=sys.stderr, flush=True)
    httpd.shutdown()
    t.join()
    httpd.server_close()
    app.close()
    rc = 0
    if supervisor is not None:
        supervisor.close()
        if supervisor.quarantine:
            if a.quarantine_manifest:
                supervisor.quarantine.write(a.quarantine_manifest)
                print("goleft-tpu-torch fleet: quarantine manifest at "
                      f"{a.quarantine_manifest}", file=sys.stderr,
                      flush=True)
            print(supervisor.quarantine.exit_summary(),
                  file=sys.stderr, flush=True)
            rc = 3
    for child in children:
        if child.poll() is None:
            child.send_signal(signal.SIGTERM)
    for child in children:
        try:
            child.wait(timeout=30)
        except subprocess.TimeoutExpired:
            child.kill()
            rc = rc or 1
        if child.stdout is not None:
            child.stdout.close()
    print("goleft-tpu-torch fleet: drained, bye", file=sys.stderr,
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
