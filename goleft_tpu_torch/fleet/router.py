"""File-affinity router: one thin process in front of N serve workers.
The port's copy of the JAX package's fleet/router.py, with the same wire
(routes, headers, ring placement, bodies), so it fronts port and
reference workers alike.

Pure stdlib (urllib + http.server), deliberately ignorant of torch and
the workloads — the router never decodes an input or touches a device,
so it stays cheap enough to front many workers. What it DOES know:

  - **affinity** (:class:`HashRing`): requests route by consistent
    hash of their input files' ``file_key`` (path + size + mtime_ns),
    so the same file keeps landing on the same worker — that worker's
    ResultCache replays it and its kernels stay warm for the
    geometries that file produces. Consistent hashing means adding or
    losing a worker remaps only the keys that worker owned, not the
    whole fleet's cache locality.
  - **health**: a background poller hits each worker's ``/healthz``
    (and ``/metrics``) every ``poll_interval_s``; a worker that fails
    ``down_after`` consecutive polls (or reports draining) stops
    receiving traffic until it recovers.
  - **per-site breaker import**: the poller reads each worker's
    ``breakers`` block from ``/metrics``. A worker whose ``pairhmm``
    breaker is open is excluded from pairhmm candidates ONLY — its
    depth/indexcov/cohortdepth traffic keeps landing there. The same
    worker 503 (a breaker answer carrying ``retry_after_s``) is also
    handled reactively: the request is re-routed to the next ring
    candidate immediately, before the next poll could notice.
  - **retry on worker death**: a connection-level failure (refused,
    reset mid-flight — a SIGKILLed worker) marks the worker down and
    retries the request on the next ring candidate
    (``fleet.retries_total``). Safe because every workload here is a
    deterministic read-only computation; the worker answers or it
    doesn't.
  - **admission** (:mod:`~goleft_tpu_torch.fleet.admission`): per-tenant
    token-bucket quotas (429 + ``retry_after_s``) and fair,
    deadline-aware forwarding slots run BEFORE any bytes are
    forwarded. An optional availability shed (``shed_below``) drops
    best-effort traffic (priority > 0) with 503 while the fleet's
    polled SLO availability is under the threshold.

``redirect=True`` answers ``307 Temporary Redirect`` with the chosen
worker's URL instead of proxying the body — for clients that can
follow redirects (serve/client.py does), this takes the router out of
the data path entirely.

Routes: ``POST /v1/<kind>`` (proxied), ``GET /healthz`` (fleet
summary), ``GET /metrics`` (router registry snapshot + per-worker
state), ``POST /fleet/plan`` (debug: the candidate order a body would
route to, no forwarding).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import urllib.error
import urllib.request
from bisect import bisect_right
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import obs
from ..obs.fleetplane import (
    TRACE_HEADER, format_trace_header, merge_worker_metrics,
    parse_trace_header, perfetto_export, poll_jitter_frac,
    rollup_registry_snapshot, stitch_trace,
)
from ..obs.logging import get_logger
from ..obs.metrics import MetricsRegistry
from ..serve.server import LISTEN_BACKLOG
from .admission import (
    FairScheduler, QuotaExceeded, QuotaTable, SchedulerTimeout,
)

log = get_logger("fleet.router")

def _file_key(path: str) -> tuple:
    """(abspath, size, mtime_ns) — the SAME definition as
    ``parallel.scheduler.file_key`` (pinned by tests/test_fleet.py),
    duplicated here because importing it drags the whole
    ``goleft_tpu_torch.parallel`` package into the router process, whose entire point is staying a cheap torch-free
    forwarder. Remote URLs route through
    ``io.remote.routing_file_key`` (torch-free, parity-pinned — on
    success it returns the SAME (url, length, etag) identity as
    ``remote_file_key``, keeping fleet and worker affinity aligned),
    whose probe gets ONE attempt under a tight routing timeout with
    failures negative-cached: a slow object store must not stall the
    request path for the full fetch retry budget."""
    import os

    if "://" in path:
        from ..io import remote

        if remote.is_remote(path):
            return remote.routing_file_key(path)
    st = os.stat(path)
    return (os.path.abspath(path), st.st_size, st.st_mtime_ns)


#: request field naming the files whose identity is the affinity key
AFFINITY_FIELDS = {
    "depth": ("bam",),
    "indexcov": ("bams",),
    "cohortdepth": ("bams",),
    "cohortscan": ("bams",),
    "pairhmm": ("input",),
    "map": ("fastq",),
}


def request_affinity_key(kind: str, req: dict) -> str:
    """The ring key for one request: every input file's content
    identity, in order. Falls back to the raw path when the file
    cannot be stat'd (routing must not 500 a request validation will
    400) and to the canonical body when the request names no file.
    Shared by the fleet router (worker affinity) and the federation
    tier (fleet affinity) — the SAME key at both levels is what keeps
    a file's whole serving path (fleet, worker, caches, kernels) warm."""
    paths: list[str] = []
    for field in AFFINITY_FIELDS.get(kind, ()):
        v = req.get(field)
        if isinstance(v, str):
            paths.append(v)
        elif isinstance(v, (list, tuple)):
            paths.extend(p for p in v if isinstance(p, str))
    if not paths:
        return kind + ":" + json.dumps(
            {k: v for k, v in sorted(req.items())
             if k not in ("tenant", "priority", "timeout_s")},
            sort_keys=True, default=str)
    parts = []
    for p in paths:
        try:
            parts.append(repr(_file_key(p)))
        except (OSError, ValueError):
            # OSError: unstat'able path / unreachable URL past the
            # fetch retry budget; ValueError: unresolvable scheme —
            # either way the raw path still routes deterministically
            parts.append(p)
    return "|".join(parts)


class HashRing:
    """Consistent hash ring with virtual nodes.

    ``candidates(key)`` returns EVERY node, ordered by ring walk from
    the key's position — element 0 is the affinity home, the rest are
    the deterministic failover order. Adding/removing a node moves
    only ~1/N of the keyspace (the property that keeps worker caches
    warm across fleet resizes).

    Membership changes are **copy-on-write**: ``with_node`` /
    ``without_node`` return a NEW ring sharing nothing mutable, so the
    router can swap its ring reference atomically while handler
    threads keep walking the old one — no lock on the request path,
    and a key's candidate order over the surviving nodes is provably
    identical before and after a resize (each node contributes its own
    hash points and nothing else; removing a node deletes exactly its
    points). Point positions depend only on (node name, vnode index)
    through sha256, so every process that builds a ring from the same
    membership computes the same plan — the cross-process determinism
    the fleet's tests and the supervisor both lean on.
    """

    def __init__(self, nodes: list[str], vnodes: int = 64):
        if not nodes:
            raise ValueError("HashRing needs at least one node")
        self.nodes = list(nodes)
        self.vnodes = vnodes
        self._points: list[tuple[int, str]] = sorted(
            (self._hash(f"{node}#{i}"), node)
            for node in nodes for i in range(vnodes))
        self._keys = [p for p, _ in self._points]

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(
            hashlib.sha256(s.encode()).digest()[:8], "big")

    def candidates(self, key: str) -> list[str]:
        start = bisect_right(self._keys, self._hash(key))
        seen: list[str] = []
        n = len(self._points)
        for i in range(n):
            node = self._points[(start + i) % n][1]
            if node not in seen:
                seen.append(node)
                if len(seen) == len(self.nodes):
                    break
        return seen

    # ---- dynamic membership (copy-on-write) ----

    def with_node(self, node: str) -> "HashRing":
        """A new ring with ``node`` added (idempotent)."""
        if node in self.nodes:
            return self
        return HashRing(self.nodes + [node], vnodes=self.vnodes)

    def without_node(self, node: str) -> "HashRing":
        """A new ring with ``node`` removed. Removing the LAST node
        returns the ring unchanged: an empty ring cannot answer
        ``candidates`` at all, and a fleet that lost every worker
        still wants a deterministic plan for when one returns — the
        pool's eligibility filter (not the ring) is what actually
        stops traffic."""
        if node not in self.nodes or len(self.nodes) == 1:
            return self
        return HashRing([n for n in self.nodes if n != node],
                        vnodes=self.vnodes)

    def ownership(self) -> dict:
        """{node: fraction of the hash space it owns}. The supervisor
        uses this to pick the LEAST-AFFINE scale-down victim: removing
        the smallest owner remaps the fewest keys (and therefore
        invalidates the least private-cache locality)."""
        span = 2.0 ** 64
        owned = {n: 0.0 for n in self.nodes}
        pts = self._points
        for i, (pos, _node) in enumerate(pts):
            # the arc (previous point, this point] belongs to the node
            # AT this point (bisect_right walks clockwise to it)
            prev = pts[i - 1][0] if i else pts[-1][0] - span
            owned[pts[i][1]] += (pos - prev) / span
        return owned


class _Worker:
    """Mutable polled state for one worker (lock: the pool's)."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.healthy = True      # optimistic until a poll says otherwise
        self.draining = False
        self.admin_draining = False  # supervisor-imposed (scale-down):
        # the poller must NOT clear it — it reflects an operator/
        # supervisor decision, not the worker's self-reported state
        self.inflight = 0        # forwards currently inside _forward
        self.consecutive_fails = 0
        self.open_breakers: frozenset[str] = frozenset()
        self.availability: float | None = None
        self.clock_offset_s: float | None = None  # estimated wall-
        # clock skew (positive = this worker's clock runs AHEAD of
        # ours), midpoint-of-poll estimate, EWMA-smoothed — the
        # stitcher's cross-host rebase correction
        self.last_poll_s: float | None = None
        self.last_metrics: dict | None = None  # full polled /metrics
        # body — the fleet rollup's raw material (None until a poll
        # lands; cleared never: a stale snapshot beats an empty fleet
        # view during a worker's restart window)
        self.next_poll_at = 0.0  # monotonic; phase-offset per worker


class WorkerPool:
    """Polled worker state + the poller thread."""

    def __init__(self, urls: list[str], poll_interval_s: float = 2.0,
                 down_after: int = 2, timeout_s: float = 5.0,
                 registry: MetricsRegistry | None = None):
        self.workers = {u.rstrip("/"): _Worker(u) for u in urls}
        self.poll_interval_s = poll_interval_s
        self.down_after = down_after
        self.timeout_s = timeout_s
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        for w in self.workers.values():
            self._schedule_first_poll(w)
        self._thread = threading.Thread(
            target=self._poll_loop, daemon=True,
            name="goleft-fleet-poller")

    def _schedule_first_poll(self, w: _Worker) -> None:
        # deterministic hash jitter (the RetryPolicy trick): each
        # worker's scrape phase is offset by a stable fraction of the
        # interval, so N workers spread across it instead of being
        # scraped in one tick burst every poll_interval_s
        w.next_poll_at = time.monotonic() + \
            poll_jitter_frac(w.url) * self.poll_interval_s

    def start(self) -> "WorkerPool":
        self.poll_all()  # synchronous first poll: route on real state
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)

    # ---- polling ----

    def _fetch_json(self, url: str) -> dict:
        req = urllib.request.Request(
            url, headers={"Accept": "application/json"})
        with urllib.request.urlopen(req,
                                    timeout=self.timeout_s) as r:
            return json.loads(r.read().decode())

    def _poll_one(self, w: _Worker) -> None:
        try:
            t0_wall = time.time()
            h = self._fetch_json(w.url + "/healthz")
            t1_wall = time.time()
            m = self._fetch_json(w.url + "/metrics")
        except Exception as e:  # noqa: BLE001 — any poll failure = a miss
            with self._lock:
                w.consecutive_fails += 1
                w.last_poll_s = time.monotonic()
                if w.consecutive_fails >= self.down_after \
                        and w.healthy:
                    w.healthy = False
                    log.warning("fleet: worker %s marked DOWN (%r)",
                                w.url, e)
                    self.registry.counter(
                        "fleet.worker_down_total").inc()
            return
        from ..resilience.breaker import is_shedding

        breakers = frozenset(
            kind for kind, state in (m.get("breakers") or {}).items()
            if is_shedding(state))
        slo = m.get("slo") or {}
        # clock handshake: the worker stamped its wall clock into the
        # healthz body; the midpoint of our request/response wall
        # stamps is the unbiased estimate of when that stamp was taken
        # on OUR clock, so the difference is the worker's skew.
        # EWMA-smoothed: one slow poll (asymmetric network time) must
        # not jerk the stitched timeline around.
        offset = None
        if isinstance(h.get("now"), (int, float)) \
                and not isinstance(h.get("now"), bool):
            offset = float(h["now"]) - (t0_wall + t1_wall) / 2.0
        with self._lock:
            if not w.healthy:
                log.warning("fleet: worker %s recovered", w.url)
            w.consecutive_fails = 0
            w.healthy = h.get("status") == "ok"
            w.draining = h.get("status") == "draining"
            w.open_breakers = breakers
            w.availability = slo.get("availability")
            if offset is not None:
                w.clock_offset_s = offset if w.clock_offset_s is None \
                    else 0.7 * w.clock_offset_s + 0.3 * offset
            w.last_metrics = m
            w.last_poll_s = time.monotonic()

    def poll_all(self) -> None:
        for w in list(self.workers.values()):
            self._poll_one(w)

    def _due_workers(self, now: float) -> list[_Worker]:
        """The workers whose scheduled poll time has arrived — read
        under the pool lock: the supervisor's ``add()`` writes a new
        worker's phase offset concurrently (gtlint lck-foreign-write;
        every ``_Worker`` field access shares the pool lock)."""
        with self._lock:
            return [w for w in self.workers.values()
                    if w.next_poll_at <= now]

    def _advance_schedule(self, w: _Worker) -> None:
        """Step one worker's schedule by an interval (under the pool
        lock — same discipline as :meth:`_due_workers`); a worker that
        fell behind (slow worker, long timeout) is re-phased rather
        than burst-caught-up."""
        with self._lock:
            w.next_poll_at += self.poll_interval_s
            if w.next_poll_at <= time.monotonic():
                w.next_poll_at = time.monotonic() \
                    + self.poll_interval_s

    def _next_poll_due(self, default: float) -> float:
        with self._lock:
            return min((w.next_poll_at
                        for w in self.workers.values()),
                       default=default)

    def _poll_loop(self) -> None:
        # per-worker periodic schedule with the deterministic phase
        # offsets from _schedule_first_poll: the loop wakes for the
        # earliest due worker, polls whatever is due, and sleeps again
        # — never the whole fleet in one burst
        while not self._stop.is_set():
            now = time.monotonic()
            for w in self._due_workers(now):
                self._poll_one(w)
                self._advance_schedule(w)
            nxt = self._next_poll_due(now + self.poll_interval_s)
            wait = min(self.poll_interval_s,
                       max(0.02, nxt - time.monotonic()))
            self._stop.wait(wait)

    def clock_offsets(self) -> dict[str, float]:
        """{url: estimated wall-clock offset seconds} over workers
        with an estimate — the trace stitcher's rebase correction."""
        with self._lock:
            return {u: w.clock_offset_s
                    for u, w in sorted(self.workers.items())
                    if w.clock_offset_s is not None}

    def metrics_by_worker(self) -> dict[str, dict]:
        """{label: last polled /metrics body} over workers that have
        reported at least once — the fleet rollup's input. The label
        is the port (the stable short form the counters already use)."""
        with self._lock:
            items = [(w.url.rsplit(":", 1)[-1], w.last_metrics)
                     for w in self.workers.values()]
        return {label: m for label, m in items if m is not None}

    # ---- dynamic membership (the supervisor's levers) ----

    def add(self, url: str) -> None:
        """Admit a new worker (idempotent). It enters optimistic (the
        supervisor only adds a worker that already announced its URL);
        the next poll replaces optimism with evidence."""
        url = url.rstrip("/")
        with self._lock:
            if url not in self.workers:
                w = self.workers[url] = _Worker(url)
                self._schedule_first_poll(w)

    def remove(self, url: str) -> None:
        """Forget a worker entirely (idempotent) — after its process
        exited or its drain completed. In-flight forwards to it (if
        any) finish on their own; end_forward tolerates the missing
        entry."""
        with self._lock:
            self.workers.pop(url.rstrip("/"), None)

    def set_draining(self, url: str, draining: bool = True) -> None:
        """Administratively drain a worker: it stops receiving NEW
        traffic (``eligible`` excludes it) while in-flight forwards
        run to completion — the scale-down half of drain-before-
        removal."""
        w = self.workers.get(url.rstrip("/"))
        if w is None:
            return
        with self._lock:
            w.admin_draining = draining

    def begin_forward(self, url: str) -> None:
        w = self.workers.get(url.rstrip("/"))
        if w is None:
            return
        with self._lock:
            w.inflight += 1

    def end_forward(self, url: str) -> None:
        w = self.workers.get(url.rstrip("/"))
        if w is None:
            return
        with self._lock:
            w.inflight = max(0, w.inflight - 1)

    def inflight(self, url: str) -> int:
        w = self.workers.get(url.rstrip("/"))
        if w is None:
            return 0
        with self._lock:
            return w.inflight

    # ---- routing state ----

    def mark_failed(self, url: str) -> None:
        """A forward to this worker died at the connection level: take
        it out of rotation NOW (the poller re-admits it when /healthz
        answers again)."""
        w = self.workers.get(url.rstrip("/"))
        if w is None:
            return
        with self._lock:
            if w.healthy:
                log.warning("fleet: worker %s marked DOWN "
                            "(connection failure mid-request)", w.url)
                self.registry.counter("fleet.worker_down_total").inc()
            w.healthy = False
            w.consecutive_fails = max(w.consecutive_fails,
                                      self.down_after)

    def eligible(self, kind: str) -> set[str]:
        """Workers that may serve ``kind`` right now: healthy, not
        draining (self-reported or supervisor-imposed), and without an
        open breaker for that endpoint."""
        with self._lock:
            return {
                u for u, w in self.workers.items()
                if w.healthy and not w.draining
                and not w.admin_draining
                and kind not in w.open_breakers
            }

    def fleet_availability(self) -> float | None:
        """Mean polled SLO availability over healthy workers (None
        until any worker reported one) — the admission shed signal."""
        with self._lock:
            vals = [w.availability for w in self.workers.values()
                    if w.healthy and w.availability is not None]
        return sum(vals) / len(vals) if vals else None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                u: {
                    "healthy": w.healthy,
                    "draining": w.draining,
                    "admin_draining": w.admin_draining,
                    "inflight": w.inflight,
                    "consecutive_fails": w.consecutive_fails,
                    "open_breakers": sorted(w.open_breakers),
                    "availability": w.availability,
                }
                for u, w in sorted(self.workers.items())
            }


class RouterApp:
    """Routing + admission logic, independent of any socket (tests
    drive it in-process, commands/fleet.py serves it)."""

    def __init__(self, worker_urls: list[str],
                 quotas: list[str] | None = None,
                 max_inflight: int = 16,
                 aging_rate: float = 0.5,
                 default_timeout_s: float = 120.0,
                 poll_interval_s: float = 2.0,
                 down_after: int = 2,
                 shed_below: float = 0.0,
                 redirect: bool = False,
                 vnodes: int = 64,
                 registry: MetricsRegistry | None = None,
                 error_budget: float = 0.01,
                 flight_records: int = 64,
                 cache_dir: str | None = None,
                 cache_secret: str | None = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.ring = HashRing(worker_urls, vnodes=vnodes)
        self.pool = WorkerPool(worker_urls,
                               poll_interval_s=poll_interval_s,
                               down_after=down_after,
                               registry=self.registry)
        self.quotas = QuotaTable(quotas)
        self.scheduler = FairScheduler(max_inflight=max_inflight,
                                       aging_rate=aging_rate)
        self.default_timeout_s = default_timeout_s
        self.shed_below = shed_below
        self.redirect = redirect
        self.error_budget = error_budget
        self.started = time.time()
        # set by Supervisor.bind(); the router itself never calls it
        self.supervisor = None
        # the router's own flight ring: fleet.request.* trees (root +
        # per-attempt forward spans) retained by trace id — the
        # router-process half of every stitched /fleet/trace answer.
        # serve/flight.py is stdlib-only, so the router stays torch-free.
        from ..serve.flight import FlightRecorder

        self.flight = FlightRecorder(max_records=flight_records)
        self._tracer = obs.get_tracer()
        self._tracer.add_listener(self.flight.on_span)
        # the fleet's shared result-cache directory, advertised at
        # GET/PUT /fleet/cache/* for cross-fleet replication (the
        # federation's CacheSync pulls/pushes content-keyed entries).
        # Entries are pickles, so PUT requires an HMAC keyed by the
        # shared fleet secret — without one, pushes are refused
        from .cachesync import fleet_secret

        self.cache_dir = cache_dir
        self.cache_secret = cache_secret if cache_secret is not None \
            else fleet_secret()

    # ---- the cache replication endpoint (fleet/cachesync.py) ----

    _CACHE_NAME_RE = None  # compiled lazily (class attr, shared)

    @classmethod
    def _cache_name_ok(cls, name: str) -> bool:
        """Only ResultCache's own filenames replicate: 32 hex chars +
        ``.pkl`` — content-keyed by construction, and no path
        traversal is expressible in the alphabet."""
        import re as _re

        if cls._CACHE_NAME_RE is None:
            cls._CACHE_NAME_RE = _re.compile(r"^[0-9a-f]{32}\.pkl$")
        return bool(cls._CACHE_NAME_RE.match(name))

    def cache_list(self) -> tuple[int, dict]:
        if not self.cache_dir:
            return 404, {"error": "no shared cache on this fleet"}
        entries = []
        try:
            # gtlint: ok det-unsorted-iter — sorted below
            for name in os.listdir(self.cache_dir):
                if not self._cache_name_ok(name):
                    continue
                try:
                    st = os.stat(os.path.join(self.cache_dir, name))
                except OSError:
                    continue
                entries.append({"name": name, "size": st.st_size})
        except OSError as e:
            return 503, {"error": f"cache dir unreadable: {e}"}
        entries.sort(key=lambda e: e["name"])
        return 200, {"entries": entries}

    def cache_open(self, name: str):
        """(code, file-handle-or-error-dict, size) for one entry —
        the streaming form the HTTP handler uses (the whole entry is
        never buffered in router memory). Entries above the
        replication size cap are refused: nothing that big should
        have replicated in."""
        from .cachesync import MAX_ENTRY_BYTES

        if not self.cache_dir:
            return 404, {"error": "no shared cache on this fleet"}, 0
        if not self._cache_name_ok(name):
            return 400, {"error": f"bad cache entry name {name!r}"}, 0
        path = os.path.join(self.cache_dir, name)
        try:
            size = os.stat(path).st_size
            if size > MAX_ENTRY_BYTES:
                return 413, {"error": f"cache entry {name} exceeds "
                                      f"{MAX_ENTRY_BYTES} bytes"}, 0
            fh = open(path, "rb")
        except FileNotFoundError:
            return 404, {"error": f"no cache entry {name}"}, 0
        except OSError as e:
            return 503, {"error": f"cache read failed: {e}"}, 0
        self.registry.counter("fleet.cache_served_total").inc()
        return 200, fh, size

    def cache_get(self, name: str):
        """(code, bytes-or-error-dict) for one entry's raw bytes —
        the in-process convenience over :meth:`cache_open`."""
        code, body, _size = self.cache_open(name)
        if code != 200:
            return code, body
        with body:
            return 200, body.read()

    def cache_put(self, name: str, body, length: int | None = None,
                  auth: str | None = None) -> tuple[int, dict]:
        """Store one replicated entry. ``body`` is bytes or a
        file-like reader (``length`` required for a reader — the HTTP
        handler streams the request body straight to the tmp file in
        chunks). The write is tmp + atomic rename, so a reader never
        sees a torn entry.

        Entries are pickles, so this endpoint is the fleet's code-
        execution boundary and every push must authenticate: ``auth``
        carries an HMAC-SHA256 over ``name NUL data`` keyed by the
        shared fleet secret. No secret configured ⇒ replication is
        disabled (403). An entry that already exists is NEVER
        overwritten — names are content-keyed, so the push is an
        idempotent no-op (204) — meaning even a leaked signature
        cannot replace an existing result."""
        from .cachesync import (
            CACHE_AUTH_HEADER, MAX_ENTRY_BYTES, entry_hmac,
        )

        reject = self.registry.counter("fleet.cache_put_rejected_total")
        if not self.cache_dir:
            return 404, {"error": "no shared cache on this fleet"}
        if not self._cache_name_ok(name):
            reject.inc()
            return 400, {"error": f"bad cache entry name {name!r}"}
        if isinstance(body, (bytes, bytearray)):
            length = len(body)
        elif length is None:
            reject.inc()
            return 400, {"error": "length required for streamed put"}
        if length > MAX_ENTRY_BYTES:
            reject.inc()
            return 413, {"error": f"cache entry {name} exceeds "
                                  f"{MAX_ENTRY_BYTES} bytes"}
        if not self.cache_secret:
            reject.inc()
            return 403, {"error":
                         "cache replication disabled: no fleet secret "
                         "(set GOLEFT_TPU_FLEET_SECRET)"}
        if auth is None:
            reject.inc()
            return 401, {"error": f"missing {CACHE_AUTH_HEADER}"}
        dest = os.path.join(self.cache_dir, name)
        if os.path.exists(dest):
            # content-keyed: same name ⇒ same bytes — idempotent no-op
            return 204, {}
        mac = entry_hmac(self.cache_secret, name)
        tmp = dest + f".push.{os.getpid()}.tmp"
        try:
            os.makedirs(self.cache_dir, exist_ok=True)
            with open(tmp, "wb") as fh:
                if isinstance(body, (bytes, bytearray)):
                    mac.update(body)
                    fh.write(body)
                else:
                    remaining = length
                    while remaining > 0:
                        chunk = body.read(min(remaining, 1 << 20))
                        if not chunk:
                            raise OSError(
                                f"truncated push body for {name}: "
                                f"{remaining} bytes short")
                        mac.update(chunk)
                        fh.write(chunk)
                        remaining -= len(chunk)
            import hmac as _hmac_mod

            if not _hmac_mod.compare_digest(mac.hexdigest(),
                                            auth.strip().lower()):
                os.unlink(tmp)
                reject.inc()
                return 403, {"error": "bad cache entry signature"}
            os.replace(tmp, dest)
        except OSError as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return 503, {"error": f"cache write failed: {e}"}
        self.registry.counter("fleet.cache_stored_total").inc()
        return 204, {}

    def start(self) -> "RouterApp":
        self.pool.start()
        return self

    def close(self) -> None:
        self.pool.close()
        self._tracer.remove_listener(self.flight.on_span)

    # ---- dynamic membership ----
    #
    # Ring updates are copy-on-write reference swaps (atomic in
    # CPython), pool updates take the pool's lock — handler threads
    # racing a resize see either the old membership or the new one,
    # both internally consistent. A worker present in the ring but
    # absent from eligibility is harmless (it lands in the plan's
    # ineligible tail); the reverse (eligible but not in the ring) is
    # avoided by ordering: add ring-first, remove pool-visibility-first.

    def add_worker(self, url: str) -> None:
        url = url.rstrip("/")
        self.pool.add(url)
        ring = self.ring.with_node(url)
        # prune ghosts: when the LAST worker died, its node stayed on
        # the ring (an empty ring cannot plan) — drop any node the
        # pool no longer knows now that the ring is non-trivial again
        for node in ring.nodes:
            if node != url and node not in self.pool.workers:
                ring = ring.without_node(node)
        self.ring = ring

    def remove_worker(self, url: str) -> None:
        url = url.rstrip("/")
        self.pool.remove(url)
        self.ring = self.ring.without_node(url)

    def drain_worker(self, url: str) -> None:
        """Stop routing NEW traffic to ``url``; in-flight forwards
        finish (``pool.inflight(url)`` reaches 0 when they have)."""
        self.pool.set_draining(url, True)

    # ---- routing ----

    def affinity_key(self, kind: str, req: dict) -> str:
        """The ring key (module-level
        :func:`request_affinity_key`, shared with the federation)."""
        return request_affinity_key(kind, req)

    def plan(self, kind: str, req: dict) -> list[str]:
        """Candidate worker order for this request: the ring walk from
        its affinity key, eligible workers first (affinity preserved
        within each class)."""
        order = self.ring.candidates(self.affinity_key(kind, req))
        ok = self.pool.eligible(kind)
        return [u for u in order if u in ok] \
            + [u for u in order if u not in ok]

    def _forward(self, url: str, kind: str, body: bytes,
                 timeout_s: float,
                 trace: tuple[str, int] | None = None) \
            -> tuple[int, bytes]:
        headers = {"Content-Type": "application/json",
                   "Accept": "application/json"}
        if trace is not None:
            # the cross-process context: this trace's id + the forward
            # span's id, which the worker's request root records as
            # remote_parent — the graft point /fleet/trace stitches on
            headers[TRACE_HEADER] = format_trace_header(*trace)
        req = urllib.request.Request(
            url + "/v1/" + kind, data=body, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def handle_traced(self, kind: str, body: bytes,
                      trace_header: str | None = None) \
            -> tuple[int, dict | bytes, str]:
        """One routed request under a fleet-wide trace → (status,
        response bytes-or-dict, trace_id). The root adopts the
        client's ``x-goleft-trace`` context when one arrived (a traced
        ServeClient), else mints the fleet id itself; either way the
        id is echoed to the client as a response header and every
        forward carries it downstream."""
        parsed = parse_trace_header(trace_header)
        tid, remote_parent = parsed if parsed else (None, None)
        with obs.trace(f"fleet.request.{kind}", kind="serve",
                       trace_id=tid,
                       remote_parent=remote_parent) as root:
            code, payload = self.handle(kind, body)
            root.attrs["status"] = code
            return code, payload, root.trace_id

    def handle(self, kind: str, body: bytes) -> tuple[int, dict | bytes]:
        """One routed request → (status, response bytes-or-dict)."""
        try:
            req = json.loads(body or b"{}")
            if not isinstance(req, dict):
                raise ValueError("request body must be a JSON object")
        except ValueError as e:
            return 400, {"error": f"bad JSON body: {e}"}
        tenant = str(req.get("tenant") or "default")
        priority = int(req.get("priority", 0))
        timeout_s = float(req.get("timeout_s", self.default_timeout_s))
        c = self.registry.counter
        c(f"fleet.requests_total.{kind}").inc()

        # gate 1: per-tenant quota — one tenant's flood 429s only
        # itself, with an honest refill hint
        try:
            self.quotas.check(tenant)
        except QuotaExceeded as e:
            c(f"fleet.quota_rejected_total.{tenant}").inc()
            return 429, {"error": str(e),
                         "retry_after_s": round(e.retry_after_s, 3),
                         "tenant": tenant}

        # gate 2: availability shed — while the fleet is failing its
        # SLO, best-effort traffic (priority > 0) is shed so the
        # remaining capacity serves the interactive class
        if self.shed_below > 0 and priority > 0:
            avail = self.pool.fleet_availability()
            if avail is not None and avail < self.shed_below:
                c("fleet.shed_total").inc()
                return 503, {
                    "error": f"fleet availability {avail:.3f} below "
                             f"{self.shed_below:g}; best-effort "
                             "traffic shed",
                    "retry_after_s": self.pool.poll_interval_s}

        # gate 3: a fair forwarding slot (deadline-aware, aged)
        try:
            waited = self.scheduler.acquire(tenant, priority,
                                            timeout_s=timeout_s)
        except SchedulerTimeout as e:
            c("fleet.scheduler_timeouts_total").inc()
            return 504, {"error": str(e)}
        self.registry.histogram("fleet.queue_wait_s").observe(waited)
        try:
            return self._route(kind, req, body, timeout_s)
        finally:
            self.scheduler.release()

    def _route(self, kind: str, req: dict, body: bytes,
               timeout_s: float) -> tuple[int, dict | bytes]:
        candidates = self.plan(kind, req)
        eligible = self.pool.eligible(kind)
        live = [u for u in candidates if u in eligible]
        if not live:
            self.registry.counter("fleet.no_worker_total").inc()
            return 503, {
                "error": f"no healthy worker for {kind!r} "
                         f"({len(candidates)} known, 0 eligible)",
                "retry_after_s": self.pool.poll_interval_s}
        if self.redirect:
            # hand the client the home worker and get out of the way
            self.registry.counter(
                f"fleet.redirects_total.{kind}").inc()
            return 307, {"location": live[0] + "/v1/" + kind}
        last_err: dict | None = None
        for i, url in enumerate(live):
            if i > 0:
                self.registry.counter("fleet.retries_total").inc()
            wk = url.rsplit(":", 1)[-1]  # port: the stable short label
            self.pool.begin_forward(url)
            try:
                # one span per forward ATTEMPT: its span id rides the
                # trace header, so the worker tree grafts under the
                # attempt that actually served it (a retried request
                # shows the dead-end forward AND the successful one)
                with obs.span(f"fleet.forward.{kind}", url=url,
                              attempt=i) as fsp:
                    status, payload = self._forward(
                        url, kind, body, timeout_s,
                        trace=(fsp.trace_id, fsp.span_id))
                    fsp.attrs["status"] = status
            except Exception as e:  # noqa: BLE001 — connection-level
                # death (refused/reset/timeout): the worker, not the
                # request — eject it and try the next ring candidate
                self.pool.mark_failed(url)
                self.registry.counter(
                    f"fleet.worker_errors_total.{wk}").inc()
                last_err = {"error": f"worker {url} unreachable: "
                                     f"{e!r}"}
                continue
            finally:
                self.pool.end_forward(url)
            if status == 503:
                # the worker is shedding (breaker open / draining):
                # re-route reactively instead of bouncing the client —
                # the poller will import the breaker state for next
                # time
                self.registry.counter(
                    f"fleet.worker_shed_total.{wk}").inc()
                try:
                    last_err = json.loads(payload.decode())
                except ValueError:
                    last_err = {"error": f"worker {url} shed (503)"}
                continue
            self.registry.counter(
                f"fleet.routed_total.{wk}.{kind}").inc()
            if i == 0:
                self.registry.counter(
                    f"fleet.affinity_hits_total.{kind}").inc()
            return status, payload
        return 503, {**(last_err or {"error": "all workers failed"}),
                     "retry_after_s": self.pool.poll_interval_s}

    # ---- operability ----

    def healthz(self) -> tuple[int, dict]:
        snap = self.pool.snapshot()
        n_up = sum(1 for w in snap.values() if w["healthy"])
        body = {
            "status": "ok" if n_up else "degraded",
            "workers": len(snap), "healthy": n_up,
            "uptime_s": round(time.time() - self.started, 1),
            # wall clock for the tier ABOVE this one: the federation
            # poller runs the same midpoint clock handshake against
            # fleet routers that this router runs against workers
            "now": round(time.time(), 6),
        }
        if self.supervisor is not None:
            body["capacity"] = self.supervisor.capacity
            body["quarantined_slots"] = \
                self.supervisor.quarantined_slots
            if body["quarantined_slots"]:
                body["status"] = "degraded" if n_up else body["status"]
        return (200 if n_up else 503), body

    def metrics_snapshot(self) -> dict:
        g = self.registry.gauge
        g("fleet.queue_depth").set(self.scheduler.queue_depth())
        g("fleet.queue_age_s").set(
            round(self.scheduler.queue_age_s(), 4))
        g("fleet.inflight").set(self.scheduler.inflight())
        avail = self.pool.fleet_availability()
        if avail is not None:
            g("fleet.availability").set(round(avail, 6))
        self._rollup()  # refresh fleet.slo.burn_rate.* gauges
        snap = self.registry.snapshot()
        out = {
            "counters": snap["counters"],
            "gauges": snap["gauges"],
            "histograms": snap.get("histograms", {}),
            "workers": self.pool.snapshot(),
        }
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor.snapshot()
            out["fleet.events"] = self.supervisor.events_block()
        return out

    # ---- the fleet observability plane ----

    def _rollup(self) -> dict:
        """Merge the poller's per-worker metrics snapshots
        (obs/fleetplane.py rules) and publish the fleet SLO burn-rate
        gauges into the router registry — so they ride the plain
        /metrics body too, not just /fleet/metrics."""
        merged = merge_worker_metrics(self.pool.metrics_by_worker(),
                                      error_budget=self.error_budget)
        g = self.registry.gauge
        slo = merged["slo"]
        g("fleet.slo.error_rate").set(slo["error_rate"])
        g("fleet.slo.burn_rate_max").set(slo["burn_rate_max"])
        for ep, r in slo["burn_rate"].items():
            g(f"fleet.slo.burn_rate.{ep}").set(r)
        for tenant, rec in (slo.get("tenants") or {}).items():
            g(f"fleet.slo.tenant.burn_rate.{tenant}").set(
                rec["burn_rate"])
        return merged

    def fleet_burn_rate(self) -> float:
        """Worst per-endpoint SLO burn rate across the fleet right now
        (>1.0 = burning budget faster than earning it) — the
        supervisor autoscaler's scale-up signal beyond queue age."""
        return self._rollup()["slo"]["burn_rate_max"]

    def fleet_metrics(self) -> dict:
        """The ``GET /fleet/metrics`` JSON body: the full rollup plus
        the router's own registry snapshot alongside (two layers, one
        document — worker evidence and router evidence never mix
        namespaces)."""
        merged = self._rollup()
        merged["router"] = self.registry.snapshot()
        return merged

    def fleet_metrics_prometheus(self) -> str:
        """The same rollup as Prometheus text exposition: the merged
        worker registry flattened (fleet.worker.*, fleet.slo.*) plus
        the router's own registry — one scrape target for the whole
        fleet."""
        from ..obs import prometheus

        merged = self._rollup()
        flat = rollup_registry_snapshot(merged)
        router_snap = self.registry.snapshot()
        for group in ("counters", "gauges", "histograms"):
            flat[group].update(router_snap.get(group, {}))
        return prometheus.render(flat)

    def fleet_trace(self, trace_id: str) -> tuple[int, dict]:
        """``GET /fleet/trace/<id>``: pull every worker's flight
        records for ``trace_id`` (the ``?trace_id=`` filter), stitch
        them under this router's own record, and attach the Perfetto
        export. 404 only when NO process holds the trace (evicted
        rings or a never-seen id)."""
        from urllib.parse import quote

        own = self.flight.snapshot(trace_id=trace_id)
        worker_records: dict[str, list] = {}
        for url in sorted(self.pool.workers):
            try:
                d = self.pool._fetch_json(
                    url + "/debug/flight?trace_id="
                    + quote(trace_id))
                worker_records[url] = d.get("records") or []
            except Exception:  # noqa: BLE001 — a dead worker cannot
                # veto the stitched view of everyone else's spans
                worker_records[url] = []
        stitched = stitch_trace(trace_id, own, worker_records,
                                clock_offsets=self.pool
                                .clock_offsets())
        if stitched is None:
            return 404, {
                "error": f"no flight record for trace {trace_id!r} "
                         "in the router or any worker (rings are "
                         "bounded — the trace may have been evicted)"}
        stitched["perfetto"] = perfetto_export(trace_id, stitched)
        return 200, stitched

    def fleet_profile(self, seconds: float) -> dict:
        """``GET /fleet/profile?seconds=N``: collect every worker's
        ``/debug/profile`` window IN PARALLEL (the windows must
        overlap — serial collection would profile N disjoint
        intervals) and merge stack-wise: each merged counter is the
        exact arithmetic sum of the workers' counters, the
        metrics-rollup discipline. A dead or profiling-disabled
        worker cannot veto the rest — it is reported per-worker and
        counted (``fleet.profile.worker_errors_total``)."""
        from urllib.parse import quote

        from ..obs.profiler import MAX_WINDOW_S, merge_profiles

        seconds = max(0.0, min(float(seconds), MAX_WINDOW_S))
        self.registry.counter("fleet.profile.requests_total").inc()
        urls = sorted(self.pool.workers)
        bodies: list[dict | None] = [None] * len(urls)
        errors: dict[str, str] = {}

        def fetch(i: int, url: str) -> None:
            # a dedicated request, NOT pool._fetch_json: the worker
            # intentionally sleeps the whole window before answering,
            # which would blow the pool's short poll timeout
            req = urllib.request.Request(
                url + f"/debug/profile?seconds={quote(str(seconds))}",
                headers={"Accept": "application/json"})
            try:
                with urllib.request.urlopen(
                        req, timeout=seconds + 10.0) as r:
                    bodies[i] = json.loads(r.read().decode())
            except Exception as e:  # noqa: BLE001 — per-worker fault
                errors[url] = str(e)

        threads: list[threading.Thread] = []
        for i, url in enumerate(urls):
            t = threading.Thread(target=fetch, args=(i, url),
                                 name=f"goleft-fleet-profile-{i}")
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=seconds + 30.0)
        if errors:
            self.registry.counter(
                "fleet.profile.worker_errors_total").inc(len(errors))
        merged = merge_profiles([b for b in bodies if b is not None])
        merged["seconds"] = seconds
        merged["per_worker"] = {
            url: ({"error": errors[url]} if url in errors else {
                "samples_total":
                    int((bodies[i] or {}).get("samples_total") or 0),
                "stacks": len((bodies[i] or {}).get("stacks") or {}),
                "enabled":
                    bool((bodies[i] or {}).get("enabled")),
            })
            for i, url in enumerate(urls)
        }
        return merged

    def fleet_compiles(self) -> dict:
        """``GET /fleet/compiles``: every worker's compile observatory
        merged into one fleet-wide warmup manifest (merge-on-update
        semantics — per-signature tallies sum across workers)."""
        from ..obs.compiles import (
            WARMUP_SCHEMA, merge_warmup_docs, validate_warmup_manifest,
        )

        manifests = []
        per_worker: dict[str, dict] = {}
        for url in sorted(self.pool.workers):
            try:
                d = self.pool._fetch_json(url + "/debug/compiles")
                m = {"schema": WARMUP_SCHEMA,
                     "signatures": d.get("signatures") or []}
                validate_warmup_manifest(m)
                manifests.append(m)
                per_worker[url] = {
                    "events_total": int(d.get("events_total") or 0),
                    "compiles_total":
                        int(d.get("compiles_total") or 0),
                    "signatures": len(m["signatures"]),
                }
            except Exception as e:  # noqa: BLE001 — per-worker fault
                per_worker[url] = {"error": str(e)}
        merged = merge_warmup_docs(*manifests) if manifests \
            else {"schema": WARMUP_SCHEMA, "signatures": []}
        merged["per_worker"] = per_worker
        return merged

    def fleet_memory(self) -> dict:
        """``GET /fleet/memory``: every worker's ``/debug/memory``
        merged — counters as EXACT arithmetic sums of the worker
        bodies (pinned by test, JSON and prom encodings both),
        gauges as per-worker {min, max, sum}, device family bytes
        summed family-wise. Collection is instant (each worker
        answers from current state, no window to overlap), so the
        serial /fleet/compiles pattern is right here; a dead worker
        is reported per-worker and counted
        (``fleet.memory.worker_errors_total``) but cannot veto the
        merge."""
        from ..obs.memplane import merge_memory

        bodies: list[dict] = []
        per_worker: dict[str, dict] = {}
        n_err = 0
        for url in sorted(self.pool.workers):
            try:
                d = self.pool._fetch_json(url + "/debug/memory")
                bodies.append(d)
                per_worker[url] = {
                    "rss_bytes": int((d.get("host") or {})
                                     .get("rss_bytes") or 0),
                    "device_live_bytes":
                        int((d.get("device") or {})
                            .get("total_bytes") or 0),
                    "pressure": (d.get("pressure") or {})
                    .get("state") or "?",
                    "enabled": bool(d.get("enabled")),
                }
            except Exception as e:  # noqa: BLE001 — per-worker fault
                per_worker[url] = {"error": str(e)}
                n_err += 1
        if n_err:
            self.registry.counter(
                "fleet.memory.worker_errors_total").inc(n_err)
        merged = merge_memory(bodies)
        merged["per_worker"] = per_worker
        return merged

    def fleet_memory_prometheus(self) -> str:
        """The same merged document as Prometheus text exposition:
        counter sums ride verbatim (``memory_*_total`` lines ARE the
        exact worker sums), gauges flatten to ``_min/_max/_sum``
        series."""
        from ..obs import prometheus
        from ..obs.memplane import flatten_merged

        return prometheus.render(flatten_merged(self.fleet_memory()))


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        log.debug("%s " + fmt, self.address_string(), *args)

    @property
    def app(self) -> RouterApp:
        return self.server.app

    def _respond_json(self, code: int, body: dict,
                      extra_headers: dict | None = None) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(data)
        self.close_connection = True

    def _respond_raw(self, code: int, data: bytes,
                     extra_headers: dict | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(data)
        self.close_connection = True

    def do_GET(self):  # noqa: N802 — http.server contract
        from urllib.parse import parse_qs, unquote, urlparse

        u = urlparse(self.path)
        if u.path == "/healthz":
            code, body = self.app.healthz()
            self._respond_json(code, body)
        elif u.path == "/fleet/metrics":
            q = parse_qs(u.query)
            fmt = q.get("format", [""])[0]
            accept = self.headers.get("Accept", "")
            if fmt in ("prom", "prometheus") or (
                    not fmt and "text/plain" in accept
                    and "json" not in accept):
                from ..obs.prometheus import CONTENT_TYPE

                data = self.app.fleet_metrics_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(data)
                self.close_connection = True
            else:
                self._respond_json(200, self.app.fleet_metrics())
        elif u.path.startswith("/fleet/trace/"):
            trace_id = unquote(u.path[len("/fleet/trace/"):])
            code, body = self.app.fleet_trace(trace_id)
            self._respond_json(code, body)
        elif u.path == "/fleet/profile":
            q = parse_qs(u.query)
            try:
                seconds = float(q["seconds"][0]) \
                    if "seconds" in q else 1.0
            except ValueError:
                self._respond_json(
                    400, {"error": "seconds must be a number"})
                return
            self._respond_json(200, self.app.fleet_profile(seconds))
        elif u.path == "/fleet/compiles":
            self._respond_json(200, self.app.fleet_compiles())
        elif u.path == "/fleet/memory":
            q = parse_qs(u.query)
            fmt = q.get("format", [""])[0]
            accept = self.headers.get("Accept", "")
            if fmt in ("prom", "prometheus") or (
                    not fmt and "text/plain" in accept
                    and "json" not in accept):
                from ..obs.prometheus import CONTENT_TYPE

                data = self.app.fleet_memory_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(data)
                self.close_connection = True
            else:
                self._respond_json(200, self.app.fleet_memory())
        elif u.path == "/fleet/cache/" or u.path == "/fleet/cache":
            code, body = self.app.cache_list()
            self._respond_json(code, body)
        elif u.path.startswith("/fleet/cache/"):
            name = unquote(u.path[len("/fleet/cache/"):])
            code, body, size = self.app.cache_open(name)
            if code == 200:
                # stream the entry file in chunks — the router never
                # holds a whole (up to MAX_ENTRY_BYTES) entry in memory
                self.send_response(code)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(size))
                self.send_header("Connection", "close")
                self.end_headers()
                with body:
                    while True:
                        chunk = body.read(1 << 20)
                        if not chunk:
                            break
                        self.wfile.write(chunk)
                self.close_connection = True
            else:
                self._respond_json(code, body)
        elif u.path == "/metrics":
            self._respond_json(200, self.app.metrics_snapshot())
        else:
            self._respond_json(404,
                               {"error": f"no route {self.path}"})

    def do_PUT(self):  # noqa: N802 — http.server contract
        from urllib.parse import unquote, urlparse

        from .cachesync import CACHE_AUTH_HEADER, MAX_ENTRY_BYTES

        u = urlparse(self.path)
        if not u.path.startswith("/fleet/cache/"):
            self._respond_json(404,
                               {"error": f"no route {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            self._respond_json(400, {"error": "bad Content-Length"})
            self.close_connection = True
            return
        if n > MAX_ENTRY_BYTES:
            # refuse BEFORE reading: an oversized push must not
            # buffer (or even transit) on the torch-free router
            self._respond_json(
                413, {"error": f"entry exceeds {MAX_ENTRY_BYTES} "
                               "bytes"})
            self.close_connection = True
            return
        name = unquote(u.path[len("/fleet/cache/"):])
        code, body = self.app.cache_put(
            name, self.rfile, length=n,
            auth=self.headers.get(CACHE_AUTH_HEADER))
        if code == 204:
            self.send_response(204)
            self.send_header("Content-Length", "0")
            self.send_header("Connection", "close")
            self.end_headers()
            self.close_connection = True
        else:
            self._respond_json(code, body)

    def do_POST(self):  # noqa: N802 — http.server contract
        n = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(n)
        if self.path == "/fleet/plan":
            try:
                req = json.loads(body or b"{}")
                kind = req.pop("kind")
            except (ValueError, KeyError):
                self._respond_json(
                    400, {"error": "want a JSON object with 'kind'"})
                return
            self._respond_json(
                200, {"candidates": self.app.plan(kind, req)})
            return
        if not self.path.startswith("/v1/"):
            self._respond_json(404,
                               {"error": f"no route {self.path}"})
            return
        kind = self.path[len("/v1/"):].strip("/")
        code, payload, trace_id = self.app.handle_traced(
            kind, body, self.headers.get(TRACE_HEADER))
        # echo the fleet trace id (minted here when the client sent
        # none) so ANY client can follow up with
        # `goleft-tpu-torch trace <id> --router URL`
        trace_hdr = {TRACE_HEADER: trace_id}
        if code == 307:
            # redirect mode: Location + a JSON body naming it (for
            # clients that refuse to follow)
            self._respond_json(code, payload,
                               extra_headers={
                                   "Location": payload["location"],
                                   **trace_hdr})
        elif isinstance(payload, bytes):
            self._respond_raw(code, payload, extra_headers=trace_hdr)
        else:
            self._respond_json(code, payload,
                               extra_headers=trace_hdr)


class _RouterServer(ThreadingHTTPServer):
    daemon_threads = False
    block_on_close = True
    allow_reuse_address = True
    request_queue_size = LISTEN_BACKLOG


def make_router_server(app: RouterApp, host: str = "127.0.0.1",
                       port: int = 0) -> ThreadingHTTPServer:
    srv = _RouterServer((host, port), _RouterHandler)
    srv.app = app
    return srv


class RouterThread:
    """In-process router harness (the tests):
    ``with RouterThread(app) as url: ...``"""

    def __init__(self, app: RouterApp, host: str = "127.0.0.1",
                 port: int = 0):
        self.app = app
        self.httpd = make_router_server(app, host, port)
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            daemon=True, name="goleft-fleet-http")

    @property
    def base_url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def __enter__(self) -> str:
        self.app.start()
        self._thread.start()
        return self.base_url

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self._thread.join(timeout=30.0)
        self.httpd.server_close()
        self.app.close()
        return False
