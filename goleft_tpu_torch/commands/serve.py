"""serve: the long-running coverage daemon on the CUDA card.

The counterpart of the JAX package's commands/serve.py, with its flags.
The kernels are built and loaded once (``warmup``; ``--warmup PATH``
replays a warmup manifest's launch geometries); from then on each
request reuses them. Concurrent requests micro-batch into coalesced
passes (serve/batcher.py, serve/executors.py: a burst of depth requests
is one launch of the depth kernel a region); repeats on unchanged files
are replayed from the session cache without touching the card. Like the
other device commands it has no CPU switch: without a card it exits 1.

Lifecycle: prints one ``listening on http://host:port`` line (stdout,
flushed) once the socket is bound — scripts scrape it when ``--port
0`` picked an ephemeral port — then blocks until SIGTERM/SIGINT,
drains in-flight requests, and exits 0.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "goleft-tpu-torch serve",
        description="long-running coverage service with request "
                    "micro-batching on the CUDA card",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="0 = ephemeral (actual port is printed)")
    p.add_argument("--batch-mode", choices=("continuous", "window"),
                   default="continuous",
                   help="continuous (default): every dispatch admits "
                        "whatever compatible work is queued, no fixed "
                        "wait — the in-flight pass is the coalescing "
                        "horizon; window: the fixed --batch-window-ms "
                        "coalescing (the byte-identity reference)")
    p.add_argument("--batch-window-ms", type=float, default=10.0,
                   help="window mode only: how long a batch anchor "
                        "waits for compatible requests to coalesce")
    p.add_argument("--max-batch", type=int, default=16,
                   help="max requests per coalesced device pass")
    p.add_argument("--max-queue", type=int, default=64,
                   help="admission bound: beyond this many queued "
                        "requests new ones get HTTP 429")
    p.add_argument("--timeout-s", type=float, default=120.0,
                   help="default per-request deadline (queue wait "
                        "included; requests can override)")
    p.add_argument("--cache", default=None,
                   help="session result-cache directory: repeat "
                        "requests on unchanged files skip the device")
    p.add_argument("--cache-max-bytes", type=int,
                   default=256 * 1024 * 1024,
                   help="session cache bound (mtime-LRU eviction)")
    p.add_argument("--cache-shared", action="store_true",
                   help="mark --cache as a fleet-shared tier (safe: "
                        "keys are content identity, writes are "
                        "atomic); reported via /healthz and the "
                        "serve.cache.shared gauge")
    p.add_argument("-p", "--processes", type=int, default=4,
                   help="decode threads per batch")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the startup pass that loads the kernels "
                        "and makes one batched depth launch")
    p.add_argument("--warmup", default=None, metavar="PATH",
                   help="replay the top signatures of this warmup "
                        "manifest (goleft-tpu.warmup-manifest/1, as "
                        "--warmup-manifest writes it) as one launch "
                        "each before the port binds")
    p.add_argument("--warmup-top-k", type=int, default=8,
                   help="how many top-ranked --warmup manifest "
                        "signatures to replay (default %(default)s)")
    p.add_argument("--flight-records", type=int, default=32,
                   help="flight-recorder ring size (span trees of "
                        "the most recent completed requests/batches; "
                        "GET /debug/flight, SIGUSR1 dumps to a file)")
    p.add_argument("--flight-dir", default=".",
                   help="directory SIGUSR1 flight dumps are written "
                        "to (timestamped JSON)")
    p.add_argument("--slo-p99-target-s", type=float, default=2.0,
                   help="p99 latency target the /metrics SLO gauges "
                        "are computed against")
    p.add_argument("--slo-window-s", type=float, default=300.0,
                   help="availability/error-rate window for the SLO "
                        "gauges")
    p.add_argument("--grace-s", type=float, default=0.05,
                   help="how long past its deadline a waiter lets an "
                        "already-started batch deliver")
    p.add_argument("--no-bisect", action="store_true",
                   help="disable poison-request isolation (a failed "
                        "coalesced pass then fails every request in "
                        "it)")
    p.add_argument("--watchdog-s", type=float, default=300.0,
                   help="hung-dispatch budget: a device pass exceeding "
                        "it is abandoned and its requests re-queued "
                        "once, then failed 504 (0 disables)")
    p.add_argument("--watchdog-requeues", type=int, default=1,
                   help="re-queue budget per request before a hung "
                        "dispatch fails it")
    p.add_argument("--breaker-threshold", type=int, default=5,
                   help="consecutive 500-class failures per endpoint "
                        "before its circuit breaker trips open (503 "
                        "shedding)")
    p.add_argument("--breaker-cooldown-s", type=float, default=30.0,
                   help="how long a tripped breaker stays open before "
                        "a half-open probe")
    p.add_argument("--checkpoint-root", default=None,
                   help="enable checkpoint-backed requests: "
                        "cohortdepth requests with checkpoint: true "
                        "commit per-region shards under this "
                        "directory and resume across daemon restarts")
    p.add_argument("--profile-hz", type=float, default=0.0,
                   help="sampling-profiler rate (0 = off): enables "
                        "GET /debug/profile?seconds=N collected at "
                        "this frequency")
    p.add_argument("--mem-sample-interval-s", type=float, default=0.0,
                   help="memory-plane sampling interval (0 = no "
                        "sampler thread; GET /debug/memory still "
                        "answers on demand)")
    p.add_argument("--mem-high-water-mb", type=float, default=0.0,
                   help="arm the memory pressure controller: while "
                        "RSS is above this, POST admissions shed "
                        "with 503 + retry_after_s (0 = disabled)")
    p.add_argument("--mem-low-water-mb", type=float, default=0.0,
                   help="recovery threshold of the pressure band "
                        "(default 80%% of the high water mark)")
    p.add_argument("--mem-trace", action="store_true",
                   help="run tracemalloc and ship top allocation "
                        "sites in /debug/memory (real overhead — "
                        "diagnostics only)")
    p.add_argument("--warmup-manifest", default=None,
                   help="write the compile observatory's warmup "
                        "manifest (goleft-tpu.warmup-manifest/1) to "
                        "this path at drain — merged into any "
                        "existing manifest there")
    a = p.parse_args(argv)

    from .. import obs
    from ..serve.server import ServeApp, make_server

    # the daemon publishes into the process-global registry: its
    # counters share the namespace the prefetch/caching layers and a
    # --metrics-out manifest snapshot
    app = ServeApp(batch_window_s=a.batch_window_ms / 1000.0,
                   max_batch=a.max_batch, max_queue=a.max_queue,
                   default_timeout_s=a.timeout_s, cache_dir=a.cache,
                   cache_max_bytes=a.cache_max_bytes,
                   processes=a.processes, registry=obs.get_registry(),
                   flight_records=a.flight_records,
                   slo_p99_target_s=a.slo_p99_target_s,
                   slo_window_s=a.slo_window_s,
                   grace_s=a.grace_s,
                   bisect_isolation=not a.no_bisect,
                   watchdog_s=a.watchdog_s if a.watchdog_s > 0
                   else None,
                   watchdog_requeues=a.watchdog_requeues,
                   breaker_threshold=a.breaker_threshold,
                   breaker_cooldown_s=a.breaker_cooldown_s,
                   checkpoint_root=a.checkpoint_root,
                   batch_mode=a.batch_mode,
                   cache_shared=a.cache_shared,
                   profile_hz=a.profile_hz,
                   mem_sample_interval_s=a.mem_sample_interval_s,
                   mem_high_water_bytes=int(
                       a.mem_high_water_mb * 1024 * 1024),
                   mem_low_water_bytes=int(
                       a.mem_low_water_mb * 1024 * 1024),
                   mem_trace=a.mem_trace)
    if not a.no_warmup:
        secs = app.warmup()
        print(f"goleft-tpu-torch serve: warmup {secs:.2f}s",
              file=sys.stderr)
    if a.warmup:
        # replayed BEFORE the port binds: readiness means "warm",
        # not just "up"
        from ..serve.warmstart import warm_start

        counts = warm_start(a.warmup, top_k=a.warmup_top_k,
                            device=app.device)
        print(f"goleft-tpu-torch serve: warmstart {counts['warmed']} "
              f"replayed, {counts['skipped']} skipped, "
              f"{counts['failed']} failed in "
              f"{counts['seconds']:.2f}s", file=sys.stderr)
    httpd = make_server(app, a.host, a.port)
    host, port = httpd.server_address[:2]
    print(f"goleft-tpu-torch serve: listening on http://{host}:{port}",
          flush=True)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())

    def _dump_flight(*_):
        # SIGUSR1: the post-incident grab — dump the flight ring
        # without disturbing the daemon (json of already-built trees)
        try:
            path = app.flight.dump(a.flight_dir)
            print(f"goleft-tpu-torch serve: flight recorder dumped to "
                  f"{path}", file=sys.stderr, flush=True)
        except OSError as e:
            print(f"goleft-tpu-torch serve: flight dump failed: {e}",
                  file=sys.stderr, flush=True)

    if hasattr(signal, "SIGUSR1"):
        signal.signal(signal.SIGUSR1, _dump_flight)
    t = threading.Thread(target=httpd.serve_forever,
                         kwargs={"poll_interval": 0.1},
                         name="goleft-serve-http")
    t.start()
    stop.wait()
    print("goleft-tpu-torch serve: draining", file=sys.stderr, flush=True)
    app.begin_drain()
    httpd.shutdown()      # stop accepting; serve_forever returns
    t.join()
    httpd.server_close()  # joins in-flight handler threads
    app.close(drain=True)
    if a.warmup_manifest:
        # after close(): every dispatch has finished, the stats table
        # is final — merge-on-update into any manifest already there
        from ..obs.compiles import build_warmup_manifest, \
            save_warmup_manifest

        try:
            save_warmup_manifest(
                a.warmup_manifest,
                build_warmup_manifest(app.compiles.stats()))
            print(f"goleft-tpu-torch serve: warmup manifest written to "
                  f"{a.warmup_manifest}", file=sys.stderr, flush=True)
        except (OSError, ValueError) as e:
            print(f"goleft-tpu-torch serve: warmup manifest write failed: "
                  f"{e}", file=sys.stderr, flush=True)
    print("goleft-tpu-torch serve: drained, bye", file=sys.stderr,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
