"""The serve daemon: a long-running HTTP service over the port's
commands, on the CUDA card.

The counterpart of the JAX package's serve/server.py, with the same
routes and response bytes. Stdlib HTTP (``http.server.
ThreadingHTTPServer``): every request is a JSON POST handled on its own
thread, funneled through the batcher (serve/batcher.py) into coalesced
passes on the hand-written kernels (serve/executors.py). The device is
the card unless the app is built with ``device="cpu"`` (the tests):
without a card ``ServeApp()`` raises ``NoCudaDevice``. Layered on top:

  - session cache: responses for unchanged input files are replayed
    from a bounded :class:`~goleft_tpu.parallel.scheduler.ResultCache`
    without touching the batcher or the device (keys carry
    ``file_key`` identity — size + mtime_ns — so a rewritten BAM
    misses)
  - /healthz: the platform ("gpu" on the card, "cpu" when the app was
    asked for the CPU), the device count and the card's name, and the
    draining flag
  - /metrics: request/response counters, queue depth, the batch-size
    histogram (the coalescing evidence), per-endpoint latency
    percentiles, stage wall-clocks, cache hit rates and the SLO block
    (p99-vs-target ratios, windowed error rate / availability). The
    body is JSON by default; ``?format=prom`` or ``Accept:
    text/plain`` returns the SAME registry snapshot as Prometheus
    text exposition (0.0.4) — no sidecar exporter
  - /debug/flight: the flight recorder's ring — span trees of the
    most recent completed requests and batches (serve/flight.py);
    SIGUSR1 (commands/serve.py) dumps the same ring to a file
  - graceful drain: SIGTERM stops the accept loop, in-flight handler
    threads finish through the batcher, exit 0

Routes:
  POST /v1/depth        {bam, reference|fai, window?, mincov?,
                         maxmeandepth?, mapq?, chrom?, bed?}
  POST /v1/indexcov     {bams: [...], fai, chrom?, excludepatt?}
  POST /v1/cohortdepth  {bams: [...], reference|fai, window?, mapq?,
                         chrom?, bed?, engine?}
  POST /v1/cohortscan   {bams: [...], fai, sex?, chrom?, excludepatt?,
                         extranormalize?, chunk_samples?, checkpoint?}
  POST /v1/pairhmm      {input, candidates?, gap_open?, gap_ext?,
                         f64?}
  POST /v1/map          {fastq, reference, k?, w?, max_occ?,
                         min_support?, band?, window?}
  GET  /healthz         GET /metrics        GET /debug/flight
  GET  /debug/compiles  GET /debug/profile?seconds=N
  GET  /debug/memory
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


from .batcher import (
    ContinuousBatcher, DeadlineExceeded, MicroBatcher, Overloaded,
    PoisonRequest,
)
from .executors import (
    BadRequest, CohortdepthExecutor, CohortscanExecutor, DepthExecutor,
    IndexcovExecutor, MapExecutor, PairhmmExecutor,
)
from .flight import FlightRecorder
from .metrics import ServeMetrics

from ..obs.logging import get_logger

log = get_logger("serve")


class ServeApp:
    """Wiring between the HTTP surface, the batcher, the executors and
    the session cache; independent of any socket so tests (and the
    bench) can drive it in-process."""

    def __init__(self, batch_window_s: float = 0.01,
                 max_batch: int = 16, max_queue: int = 64,
                 default_timeout_s: float = 120.0,
                 cache_dir: str | None = None,
                 cache_max_bytes: int | None = 256 * 1024 * 1024,
                 processes: int = 4, registry=None,
                 flight_records: int = 32,
                 slo_p99_target_s: float = 2.0,
                 slo_window_s: float = 300.0,
                 grace_s: float = 0.05,
                 bisect_isolation: bool = True,
                 watchdog_s: float | None = 300.0,
                 watchdog_requeues: int = 1,
                 breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 30.0,
                 checkpoint_root: str | None = None,
                 batch_mode: str = "continuous",
                 cache_shared: bool = False,
                 profile_hz: float = 0.0,
                 mem_sample_interval_s: float = 0.0,
                 mem_high_water_bytes: int = 0,
                 mem_low_water_bytes: int = 0,
                 mem_trace: bool = False, device=None):
        # the card unless device="cpu": without a card this raises
        # NoCudaDevice, before any thread starts
        from ..device import resolve_device

        self.device = resolve_device(device)
        # registry=None → a private obs.MetricsRegistry (test/app
        # isolation); the serve CLI passes the process-global one so
        # the daemon's counters join the unified namespace
        self.metrics = ServeMetrics(registry=registry)
        self.default_timeout_s = default_timeout_s
        self.slo_p99_target_s = slo_p99_target_s
        self.slo_window_s = slo_window_s
        self.checkpoint_root = checkpoint_root
        # flight recorder: listens on the PROCESS tracer (the serve
        # request/batch traces record there), detached in close()
        from .. import obs

        self.flight = FlightRecorder(max_records=flight_records)
        self._tracer = obs.get_tracer()
        self._tracer.add_listener(self.flight.on_span)
        # sampling profiler (--profile-hz; hz=0 → disabled, no
        # thread) + the compile observatory behind /debug/compiles —
        # both publish into this app's registry/tracer
        from ..obs.compiles import get_tracker
        from ..obs.profiler import SamplingProfiler

        self.compiles = get_tracker()
        self.compiles.backend = "gpu" if self.device.type == "cuda" \
            else "cpu"
        self.profiler = SamplingProfiler(
            hz=profile_hz, registry=self.metrics.registry,
            tracer=self._tracer).start()
        # memory plane (--mem-sample-interval-s; 0 → no thread, but
        # /debug/memory still answers on demand). --mem-high-water-mb
        # arms the pressure controller: while RSS is above the band,
        # POST admissions shed with 503 + retry_after_s until it
        # recovers below the low water mark. Registered process-wide
        # so the prefetch staging pipeline can read the same state.
        from ..obs import memplane as _memplane

        self.memplane = _memplane.MemorySampler(
            interval_s=mem_sample_interval_s,
            registry=self.metrics.registry, tracer=self._tracer,
            high_water_bytes=mem_high_water_bytes,
            low_water_bytes=mem_low_water_bytes,
            trace_top=_memplane.TRACE_TOP_N if mem_trace else 0,
        ).start()
        _memplane.register_controller(self.memplane.pressure)
        dev = self.device
        self.executors = {
            ex.kind: ex for ex in (
                DepthExecutor(processes, self.metrics, dev),
                IndexcovExecutor(max(processes, 8), self.metrics, dev),
                CohortdepthExecutor(processes, self.metrics, dev,
                                    checkpoint_root=checkpoint_root),
                CohortscanExecutor(max(processes, 8), self.metrics, dev,
                                   checkpoint_root=checkpoint_root),
                PairhmmExecutor(processes, self.metrics, dev),
                MapExecutor(processes, self.metrics, dev),
            )
        }
        # per-endpoint circuit breakers: repeated systemic (500-class)
        # failures trip the endpoint open and requests shed with 503
        # before they ever reach the queue/429 cliff; state published
        # as the serve.breaker.state.<kind> gauge (0 closed, 1
        # half-open, 2 open)
        from ..resilience.breaker import CircuitBreaker

        def _make_breaker(kind):
            gauge = self.metrics.registry.gauge(
                f"serve.breaker.state.{kind}")
            gauge.set(0)
            return CircuitBreaker(
                name=f"serve.{kind}",
                failure_threshold=breaker_threshold,
                cooldown_s=breaker_cooldown_s,
                on_state=gauge.set)

        self.breakers = {kind: _make_breaker(kind)
                         for kind in self.executors}
        # cache_shared marks the directory as a FLEET-shared tier
        # (fleet --shared-cache): keys are full content identity and
        # writes are tmp-file + atomic rename, so many workers can
        # share one directory safely by construction — the flag only
        # changes what this worker reports (healthz cache block, the
        # serve.cache.shared gauge), so operators and the smoke can
        # tell a private session cache from the shared tier
        self.cache = None
        self.cache_shared = bool(cache_shared)
        if cache_dir:
            from ..parallel.scheduler import ResultCache

            self.cache = ResultCache(cache_dir,
                                     max_bytes=cache_max_bytes)
            self.metrics.registry.gauge("serve.cache.shared").set(
                1 if self.cache_shared else 0)
        # continuous batching is the default: every dispatch admits
        # whatever compatible work is queued (the in-flight pass is the
        # coalescing horizon); "window" keeps the fixed-window batcher,
        # whose responses the continuous one's equal byte for byte
        if batch_mode not in ("continuous", "window"):
            raise ValueError(
                f"batch_mode must be 'continuous' or 'window' "
                f"(got {batch_mode!r})")
        self.batch_mode = batch_mode
        if batch_mode == "continuous":
            self.batcher = ContinuousBatcher(
                self._run_batch, max_batch=max_batch,
                max_queue=max_queue, metrics=self.metrics,
                grace_s=grace_s, bisect_isolation=bisect_isolation,
                watchdog_s=watchdog_s, max_requeues=watchdog_requeues)
        else:
            self.batcher = MicroBatcher(
                self._run_batch, window_s=batch_window_s,
                max_batch=max_batch, max_queue=max_queue,
                metrics=self.metrics, grace_s=grace_s,
                bisect_isolation=bisect_isolation,
                watchdog_s=watchdog_s, max_requeues=watchdog_requeues)
        # cross-request step dedup: every request lowers its batcher
        # submit into a content-keyed plan Step (dedup=True), so two
        # concurrent identical requests — handler threads really are
        # concurrent, unlike the serialized batch dispatches — share
        # ONE device pass through the process-wide in-flight step
        # table (plan/executor.py InflightSteps); the follower's
        # response is byte-identical because the key is full content
        # identity (the session-cache key: canonical params + every
        # input's file_key)
        from ..plan import Executor as PlanExecutor

        self._request_executor = PlanExecutor()
        # lifecycle flags cross threads: the signal handler / CLI
        # main thread flips draining while every HTTP handler thread
        # reads it, and SIGTERM can race atexit (or a test fixture)
        # into close() — both go through _state_lock
        self._state_lock = threading.Lock()
        self._draining = False
        self._closed = False

    def _run_batch(self, key, payloads):
        return self.executors[key[0]].run(payloads)

    def _cache_key(self, kind: str, req: dict):
        # the FULL canonical request (not just the batching signature)
        # plus every input file's identity: any parameter the executor
        # might read must miss, and a rewritten input — same second,
        # same size — must miss too (file_key carries mtime_ns)
        from ..parallel.scheduler import file_key

        ex = self.executors[kind]
        params = json.dumps(
            {k: v for k, v in req.items() if k != "timeout_s"},
            sort_keys=True)
        files = tuple(file_key(p) for p in ex.cache_files(req))
        return (kind, params, files)

    def handle(self, kind: str, req: dict,
               trace_ctx: tuple[str, int | None] | None = None) \
            -> tuple[int, dict]:
        """One request → (http status, response dict). Runs under its
        own run-scoped trace: every serve request gets a trace id, and
        the spans its handler thread records (cache lookup, batcher
        wait) parent under the request root.

        ``trace_ctx`` is a parsed ``x-goleft-trace`` header (the fleet
        router's — or a traced client's — remote context): the request
        root ADOPTS the remote trace id and records the remote parent
        span id, so the flight ring retains this worker's piece of the
        cross-process trace under the fleet-wide id and the router's
        ``/fleet/trace/<id>`` can stitch it back together."""
        from .. import obs

        tid, remote_parent = trace_ctx if trace_ctx else (None, None)
        t0 = time.perf_counter()
        with obs.trace(f"request.{kind}", kind="serve",
                       trace_id=tid,
                       remote_parent=remote_parent) as root:
            code, body = self._handle(kind, req)
            root.attrs["status"] = code
        # the tenant-scoped outcome window (the federation tier's
        # burn-rate raw material): every answered request lands in its
        # tenant's window with its wall latency
        self.metrics.record_tenant(str(req.get("tenant") or "default"),
                                   code, time.perf_counter() - t0)
        return code, body

    def _handle(self, kind: str, req: dict) -> tuple[int, dict]:
        ex = self.executors.get(kind)
        if ex is None:
            return 404, {"error": f"unknown endpoint {kind!r}"}
        t0 = time.perf_counter()
        self.metrics.inc(f"requests_total.{kind}")
        pressure = self.memplane.pressure
        if pressure.should_shed():
            # memory pressure sheds like a drain, not like an error:
            # admissions are best-effort while RSS sits above the
            # high-water band, and the hint tells a retry-aware
            # client to ride out the hysteresis window
            self.metrics.registry.counter("memory.sheds_total").inc()
            return 503, {
                "error": "server under memory pressure (rss above "
                         f"{pressure.high_water_bytes} bytes)",
                "retry_after_s": pressure.retry_after_s}
        breaker = self.breakers.get(kind)
        if breaker is not None and not breaker.allow():
            # tripped: shed immediately — no queue slot, no device
            # pass, a clear retry hint — instead of piling toward 429
            self.metrics.inc(f"breaker_rejected_total.{kind}")
            return 503, {
                "error": f"circuit breaker open for {kind!r} after "
                         "repeated upstream failures",
                "retry_after_s": round(breaker.retry_after_s(), 3)}
        # the breaker verdict: only a real executed request proves the
        # site up ("success") and only a 500-class failure proves it
        # broken ("failure") — everything else (4xx, shed, deadline,
        # cache hit) carries no verdict but must still release a
        # half-open probe slot
        verdict = None
        try:
            ex.validate(req)
            ckey = self._cache_key(kind, req) if self.cache else None
            if ckey is not None:
                hit = self.cache.get(ckey)
                if hit is not None:
                    self.metrics.observe_latency(
                        kind, time.perf_counter() - t0)
                    return 200, {**hit, "cached": True}
            timeout = float(req.get("timeout_s",
                                    self.default_timeout_s))
            # the request's plan Step: content-keyed (dedup domain),
            # retry=False (the batcher owns retry semantics — this
            # step must propagate Overloaded/Deadline/Poison raw).
            # A failed leader never poisons its followers: they fall
            # back to their own submit (plan/executor.py).
            from ..plan import Step

            # span= makes the step visible in the request's flight
            # tree (the stitched trace's plan-step hop); the batcher
            # captures its context inside this span, so the coalesced
            # batch trace links back to exactly this node
            out = self._request_executor.run_step(Step(
                key=ckey if ckey is not None
                else self._cache_key(kind, req),
                fn=lambda: self.batcher.submit(
                    ex.group_key(req), req, timeout_s=timeout),
                name=f"serve.request.{kind}", retry=False,
                dedup=True, span=f"plan.step.{kind}"))
            result = out.value_or_raise()
            if out.deduped:
                self.metrics.inc(f"request_deduped_total.{kind}")
            verdict = "success"
            if ckey is not None and not out.deduped:
                self.cache.put(ckey, result)
        except BadRequest as e:
            return 400, {"error": str(e)}
        except PoisonRequest as e:
            # isolated by bisection: THIS request's payload is at
            # fault (its siblings already got their results) — the
            # client's 400, never the batch's 500, and never a
            # breaker failure
            return 400, {"error": str(e), "poison": True}
        except Overloaded as e:
            return 429, {"error": str(e)}
        except DeadlineExceeded as e:
            return 504, {"error": str(e)}
        except (Exception, SystemExit) as e:  # noqa: BLE001 —
            # request isolation. SystemExit included: io/bam.py
            # die()s on a corrupt input, which inside a batch is a
            # request failure, never a daemon (or handler-thread)
            # death
            log.exception("serve: %s request failed", kind)
            verdict = "failure"
            return 500, {"error": repr(e)}
        finally:
            if breaker is not None:
                breaker.settle(verdict)
        self.metrics.observe_latency(kind, time.perf_counter() - t0)
        return 200, result

    def healthz(self) -> tuple[int, dict]:
        rec = {"status": "draining" if self.draining else "ok",
               "uptime_s": round(time.time() - self.metrics.started,
                                 1),
               # this process's wall clock, for the poller's clock
               # handshake: the router estimates a per-worker offset
               # (midpoint method) and the trace stitcher rebases
               # cross-host spans with it instead of trusting raw
               # wall clocks
               "now": round(time.time(), 6)}
        if self.cache is not None:
            rec["cache"] = "shared" if self.cache_shared \
                else "private"
        try:
            import torch

            if self.device.type == "cuda":
                rec.update(platform="gpu",
                           devices=torch.cuda.device_count(),
                           device_kind=torch.cuda.get_device_name(
                               self.device))
            else:
                rec.update(platform="cpu", devices=1, device_kind="cpu")
        except Exception as e:  # noqa: BLE001 — health must not crash
            rec.update(status="degraded", error=repr(e))
        code = 503 if self.draining else 200
        return code, rec

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot(
            queue_depth=self.batcher.queue_depth(),
            queue_age_s=self.batcher.queue_age_s(),
            cache_stats=self.cache.stats() if self.cache else None,
            slo=self.metrics.slo_snapshot(
                p99_target_s=self.slo_p99_target_s,
                window_s=self.slo_window_s),
            breakers={k: b.state for k, b in self.breakers.items()},
        )

    def metrics_prometheus(self) -> str:
        """The same metrics state as Prometheus text exposition:
        registry snapshot (SLO gauges refreshed first) plus the two
        live values the JSON body carries outside the registry."""
        from ..obs import prometheus

        self.metrics.slo_snapshot(
            p99_target_s=self.slo_p99_target_s,
            window_s=self.slo_window_s)
        snap = self.metrics.registry.snapshot()
        snap["gauges"]["serve.uptime_s"] = round(
            time.time() - self.metrics.started, 1)
        snap["gauges"]["serve.queue_depth"] = \
            self.batcher.queue_depth()
        snap["gauges"]["serve.queue_age_s"] = round(
            self.batcher.queue_age_s(), 4)
        if self.cache:
            for k, v in self.cache.stats().items():
                if isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    snap["gauges"][f"serve.cache.{k}"] = v
        return prometheus.render(snap)

    def warmup(self) -> float:
        """Load the five kernel libraries (nvcc builds them into
        build/torch/ the first time) and make one batched depth launch
        at B = 1, so that the first request pays neither. On the CPU
        only the launch runs, as its plain version. Returns seconds."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from concurrent.futures import ThreadPoolExecutor

            from ..ops import (depth_kernel, norm_kernel, pairhmm_kernel,
                               rans_kernel, swalign_kernel)

            mods = (depth_kernel, pairhmm_kernel, rans_kernel, norm_kernel,
                    swalign_kernel)
            with ThreadPoolExecutor(len(mods)) as pool:
                list(pool.map(lambda m: m.load_library(), mods))
        from .warmstart import _warm_depth

        _warm_depth({"b": 1, "bucket": 8, "length": 256, "window": 256},
                    self.device)
        return time.perf_counter() - t0

    # ---- lifecycle (cross-thread: lock-guarded) ----

    @property
    def draining(self) -> bool:
        with self._state_lock:
            return self._draining

    def begin_drain(self) -> None:
        """Stop admitting new requests (healthz goes 503, POSTs shed);
        in-flight work keeps running until close()."""
        with self._state_lock:
            self._draining = True

    def close(self, drain: bool = True) -> None:
        """Idempotent UNDER CONCURRENCY: SIGTERM racing atexit (or a
        test fixture racing ServerThread.__exit__) may close twice —
        the _state_lock check-then-act guarantees exactly one caller
        runs the close body (an unguarded `if self._closed` let both
        through). The batcher close/join happens outside the lock: it
        blocks on the dispatcher thread, which must stay free to
        finish items."""
        with self._state_lock:
            self._draining = True
            if self._closed:
                return
            self._closed = True
        self.batcher.close(drain=drain)
        self.profiler.close()
        from ..obs import memplane as _memplane

        self.memplane.close()
        _memplane.unregister_controller(self.memplane.pressure)
        self._tracer.remove_listener(self.flight.on_span)


class _Handler(BaseHTTPRequestHandler):
    # the server instance carries .app (set by make_server)
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route away from stderr spam
        log.debug("%s " + fmt, self.address_string(), *args)

    def _respond(self, code: int, body: dict) -> None:
        self._respond_raw(code, json.dumps(body).encode(),
                          "application/json")

    def _respond_raw(self, code: int, data: bytes,
                     content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        # one request per connection: a lingering keep-alive socket
        # would pin its handler thread and stall the drain join
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(data)
        self.close_connection = True
        self.app.metrics.record_response(code)

    @property
    def app(self) -> ServeApp:
        return self.server.app

    def _wants_prometheus(self, query: dict) -> bool:
        """``?format=prom`` wins; otherwise Accept negotiation — a
        client asking for text/plain (and not json) is a Prometheus
        scraper. The JSON body stays the default (and byte-stable)."""
        fmt = query.get("format", [""])[0]
        if fmt:
            return fmt in ("prom", "prometheus")
        accept = self.headers.get("Accept", "")
        return "text/plain" in accept and "json" not in accept

    def do_GET(self):  # noqa: N802 — http.server contract
        u = urlparse(self.path)
        if u.path == "/healthz":
            code, body = self.app.healthz()
            self._respond(code, body)
        elif u.path == "/metrics":
            if self._wants_prometheus(parse_qs(u.query)):
                from ..obs.prometheus import CONTENT_TYPE

                self._respond_raw(
                    200, self.app.metrics_prometheus().encode(),
                    CONTENT_TYPE)
            else:
                self._respond(200, self.app.metrics_snapshot())
        elif u.path == "/debug/flight":
            q = parse_qs(u.query)
            try:
                n = int(q["n"][0]) if "n" in q else None
            except ValueError:
                self._respond(400, {"error": "n must be an integer"})
                return
            trace_id = q["trace_id"][0] if "trace_id" in q else None
            kind = q["kind"][0] if "kind" in q else None
            self._respond(200, self.app.flight.to_dict(
                n, trace_id=trace_id, kind=kind))
        elif u.path == "/debug/compiles":
            self._respond(200, self.app.compiles.to_doc())
        elif u.path == "/debug/profile":
            q = parse_qs(u.query)
            try:
                seconds = float(q["seconds"][0]) \
                    if "seconds" in q else 1.0
            except ValueError:
                self._respond(
                    400, {"error": "seconds must be a number"})
                return
            # collect-then-respond: this handler thread sleeps the
            # window (clamped to MAX_WINDOW_S inside collect) while
            # the sampler keeps running, then ships the delta
            self._respond(200, self.app.profiler.collect(seconds))
        elif u.path == "/debug/memory":
            self._respond(200, self.app.memplane.snapshot())
        else:
            self._respond(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802 — http.server contract
        if not self.path.startswith("/v1/"):
            self._respond(404, {"error": f"no route {self.path}"})
            return
        kind = self.path[len("/v1/"):].strip("/")
        if self.app.draining:
            # carry a retry hint: a drain is a WINDOW (restart,
            # scale-down, fleet resize), not a verdict — a
            # retry-aware client (serve/client.py retries>0) rides
            # it out instead of failing the request
            self._respond(503, {"error": "server is draining",
                                "retry_after_s": 1.0})
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(req, dict):
                raise ValueError("request body must be a JSON object")
        except ValueError as e:
            self._respond(400, {"error": f"bad JSON body: {e}"})
            return
        from ..obs.fleetplane import TRACE_HEADER, parse_trace_header

        code, body = self.app.handle(
            kind, req,
            trace_ctx=parse_trace_header(
                self.headers.get(TRACE_HEADER)))
        self._respond(code, body)


#: the listen backlog of the port's HTTP servers (serve, the fleet router,
#: the federation): socketserver's default of 5 resets the connections of
#: a burst of concurrent clients that arrives while the accept loop waits
LISTEN_BACKLOG = 128


class _Server(ThreadingHTTPServer):
    # join in-flight handler threads on server_close(): the drain path
    # must let queued work finish, not orphan it mid-response
    daemon_threads = False
    block_on_close = True
    allow_reuse_address = True
    request_queue_size = LISTEN_BACKLOG


def make_server(app: ServeApp, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind (port 0 → ephemeral; read ``server_address`` for the
    actual port). Caller runs ``serve_forever`` / ``shutdown``."""
    srv = _Server((host, port), _Handler)
    srv.app = app
    return srv


class ServerThread:
    """In-process server harness: the tests' and bench's entry.

    with ServerThread(app) as base_url: ...  # "http://127.0.0.1:PORT"
    """

    def __init__(self, app: ServeApp, host: str = "127.0.0.1",
                 port: int = 0):
        self.app = app
        self.httpd = make_server(app, host, port)
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name="goleft-serve-http")

    @property
    def base_url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def __enter__(self) -> str:
        self._thread.start()
        return self.base_url

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self._thread.join(timeout=30.0)
        self.httpd.server_close()
        self.app.close()
        return False
