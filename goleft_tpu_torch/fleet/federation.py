"""Federation tier: one thin process in front of N fleets. The port's
copy of the JAX package's fleet/federation.py.

A single fleet is self-healing and observable, but the fleet's router is still a single point of failure and a single
saturation domain. This module is the next rung up: a stdlib,
torch-free **FederationRouter** that fronts N fleets (each a supervised
``goleft-tpu-torch fleet`` with its own router and workers) the same way a
fleet router fronts N workers — :class:`~goleft_tpu_torch.fleet.router
.HashRing` reused one level up, with the affinity key unchanged
(:func:`~goleft_tpu_torch.fleet.router.request_affinity_key` on input file
identity), so a file's WHOLE serving path — fleet, worker, shared
cache, built kernels — stays warm per fleet. Three robustness
behaviors layer on top:

  - **whole-fleet failover**: a connection-level forward failure or
    ``down_after`` consecutive poll failures marks a fleet DOWN;
    in-flight and new requests retry the next ring candidate
    (byte-identically — every workload is a deterministic content-
    keyed computation, so replay on a sibling fleet is safe by
    construction). A fleet that heals rejoins through a HALF-OPEN
    probe, like the per-endpoint circuit breakers: once its healthz
    answers again it may serve exactly one in-flight request; success
    restores it, failure sends it straight back down. Losing an
    entire fleet (router included) degrades capacity, never
    availability.
  - **saturation spillover**: each fleet's polled ``/fleet/metrics``
    ``slo.burn_rate_max`` (the fleet rollup gauge) is the routing
    signal. A fleet burning past ``spill_threshold`` stops receiving
    NEW affinity keys — keys already homed there keep landing (cache
    warmth is the point of affinity) until it recovers or trips
    fully. Spilled keys are tagged with their ring home so they
    MIGRATE back the moment the home fleet is up and under threshold
    (``federation.spill_migrations_total``).
  - **tenant-scoped overload isolation as a contract**: the
    federation computes per-tenant burn rates — its own windowed
    per-tenant outcomes (latency vs the p99 target; 5xx and 429
    outcomes against the error budget) merged with the per-tenant
    ``slo.tenants`` blocks the fleets roll up from their workers —
    published as ``federation.tenant.burn_rate.<tenant>`` gauges in
    BOTH /metrics encodings. A tenant whose burn rate breaches
    ``tenant_burn_threshold`` has its BEST-EFFORT traffic
    (``priority > 0``) shed with 429 + an honest ``retry_after_s``
    (when the breaching outcomes age out of the window), while every
    other tenant's traffic is untouched — isolation by contract, not
    by side effect.

Cross-FLEET tracing composes the fleet's graft rules: the federation
opens ``federation.request.*`` / per-attempt ``federation.forward.*``
spans, forwards ``x-goleft-trace`` with the forward span id, and
``GET /fleet/trace/<id>`` pulls each fleet's own stitched document
and grafts it under the forward that carried it
(:func:`~goleft_tpu_torch.obs.fleetplane.stitch_federation`) — a federation
hop is one more ``remote_parent`` level, and ``goleft-tpu-torch trace``
renders client → federation → fleet router → worker as one tree. The
poller runs the same midpoint clock handshake against fleet routers
that fleet routers run against workers.

Routes mirror the fleet router so every existing client works
unchanged: ``POST /v1/<kind>``, ``GET /healthz``, ``GET /metrics``
(JSON default, ``?format=prom`` Prometheus), ``GET /fleet/trace/<id>``
(the federation-wide stitched trace), ``POST /fleet/plan`` (debug:
the candidate FLEET order for a body).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import obs
from ..obs.fleetplane import (
    TRACE_HEADER, format_trace_header, merge_tenant_slos,
    parse_trace_header, perfetto_export, poll_jitter_frac,
    stitch_federation,
)
from ..obs.logging import get_logger
from ..obs.metrics import MetricsRegistry
from ..serve.server import LISTEN_BACKLOG
from .admission import QuotaExceeded
from .router import HashRing, request_affinity_key

log = get_logger("fleet.federation")

#: fleet states (the half-open probe machine, breaker-shaped)
UP = "up"
DOWN = "down"
PROBE = "probe"

#: most affinity keys tracked for home/spill bookkeeping; beyond this
#: the least-recently-routed key is forgotten (it re-resolves from the
#: ring on its next request, which is exactly the cold behavior)
MAX_TRACKED_KEYS = 8192


class TenantSLOTracker:
    """Per-tenant outcome windows at the federation tier.

    Each FORWARDED request lands in its tenant's bounded window as
    (timestamp, burned, latency). "Burned" means 5xx or 429 — a
    throttled tenant is spending its own budget, which is the signal
    tenant-scoped shedding isolates on. Federation-shed responses are
    deliberately NOT recorded: feeding the shed's own 429s back into
    the burn rate would latch the shed open forever.

    ``snapshot()`` returns the same per-tenant shape workers publish
    (``window_requests``/``error_rate``/``p99_latency_ratio``), so the
    federation's own evidence merges with the fleets' rollups through
    one code path (:func:`~goleft_tpu_torch.obs.fleetplane
    .merge_tenant_slos`)."""

    def __init__(self, window_s: float = 300.0,
                 p99_target_s: float = 2.0, max_tenants: int = 64,
                 maxlen: int = 1024, clock=time.monotonic):
        self.window_s = window_s
        self.p99_target_s = p99_target_s
        self.max_tenants = max_tenants
        self.maxlen = maxlen
        self._clock = clock
        self._lock = threading.Lock()
        self._outcomes: dict[str, deque] = {}

    def record(self, tenant: str, code: int,
               seconds: float | None = None) -> None:
        burned = code >= 500 or code == 429
        with self._lock:
            dq = self._outcomes.get(tenant)
            if dq is None:
                while len(self._outcomes) >= self.max_tenants:
                    stale = min(
                        self._outcomes,
                        key=lambda t: self._outcomes[t][-1][0]
                        if self._outcomes[t] else 0.0)
                    del self._outcomes[stale]
                dq = self._outcomes[tenant] = deque(
                    maxlen=self.maxlen)
            dq.append((self._clock(), burned, seconds))

    def snapshot(self) -> dict:
        now = self._clock()
        with self._lock:
            items = [(t, list(dq))
                     for t, dq in self._outcomes.items()]
        out: dict = {}
        for tenant, rows in sorted(items):
            recent = [(burned, sec) for ts, burned, sec in rows
                      if now - ts <= self.window_s]
            if not recent:
                continue
            n = len(recent)
            errs = sum(1 for burned, _ in recent if burned)
            rec = {"window_requests": n,
                   "error_rate": round(errs / n, 6)}
            lats = [s for _, s in recent if s is not None]
            if lats and self.p99_target_s > 0:
                from ..utils.profiling import percentiles

                rec["p99_latency_ratio"] = round(
                    percentiles(lats)["p99"] / self.p99_target_s, 4)
            out[tenant] = rec
        return out

    def burn_clear_s(self, tenant: str) -> float:
        """Seconds until this tenant's OLDEST burned outcome ages out
        of the window — the honest half of a shed's retry_after_s
        (the burn rate cannot improve before the evidence expires)."""
        now = self._clock()
        with self._lock:
            rows = list(self._outcomes.get(tenant) or ())
        burned_ts = [ts for ts, burned, _ in rows
                     if burned and now - ts <= self.window_s]
        if not burned_ts:
            return 0.0
        return max(0.0, self.window_s - (now - min(burned_ts)))


class _Fleet:
    """Mutable polled state for one fleet (lock: the pool's)."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.state = UP          # optimistic until a poll says no
        self.probing = False     # one in-flight half-open probe
        self.consecutive_fails = 0
        self.healthy_workers = 0
        self.burn_rate: float | None = None   # slo.burn_rate_max
        self.saturated = False   # burn_rate > spill_threshold
        self.tenants: dict = {}  # the fleet rollup's slo.tenants
        self.last_metrics: dict | None = None
        self.clock_offset_s: float | None = None
        self.last_poll_s: float | None = None
        self.next_poll_at = 0.0


class FleetPool:
    """Polled fleet state + the poller thread (the WorkerPool pattern
    one level up: healthz for liveness, /fleet/metrics for the burn
    and tenant signals, deterministic per-fleet scrape phase)."""

    def __init__(self, urls: list[str], poll_interval_s: float = 2.0,
                 down_after: int = 2, timeout_s: float = 5.0,
                 spill_threshold: float = 0.0,
                 spill_recover: float | None = None,
                 registry: MetricsRegistry | None = None):
        self.fleets = {u.rstrip("/"): _Fleet(u) for u in urls}
        self.poll_interval_s = poll_interval_s
        self.down_after = down_after
        self.timeout_s = timeout_s
        self.spill_threshold = spill_threshold
        # two-sided spill hysteresis (the autoscaler's pattern): spill
        # when burn rises past spill_threshold, return home only once
        # it falls to/below spill_recover — a burn rate flapping in
        # the (recover, threshold] band keeps its current placement
        # instead of thrashing key migration. Default = threshold,
        # which reproduces the historical single-threshold behavior.
        self.spill_recover = spill_threshold \
            if spill_recover is None else min(spill_recover,
                                              spill_threshold)
        # called with the fleet URL after a half-open probe succeeds
        # (outside the pool lock) — the federation wires cache
        # replication's rejoin warm-up here
        self.on_rejoin = None
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        for f in self.fleets.values():
            self._schedule_first_poll(f)
        self._thread = threading.Thread(
            target=self._poll_loop, daemon=True,
            name="goleft-federation-poller")

    def _schedule_first_poll(self, f: _Fleet) -> None:
        f.next_poll_at = time.monotonic() + \
            poll_jitter_frac(f.url) * self.poll_interval_s

    def start(self) -> "FleetPool":
        self.poll_all()
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

    def _poll_one(self, f: _Fleet) -> None:
        try:
            t0_wall = time.time()
            h = self._fetch_json(f.url + "/healthz")
            t1_wall = time.time()
            m = self._fetch_json(f.url + "/fleet/metrics")
        except Exception as e:  # noqa: BLE001 — any poll failure
            # (refused, reset, timeout, a 503-degraded fleet with zero
            # healthy workers) is a miss
            with self._lock:
                f.consecutive_fails += 1
                f.last_poll_s = time.monotonic()
                if f.consecutive_fails >= self.down_after \
                        and f.state != DOWN:
                    f.state = DOWN
                    f.probing = False
                    log.warning("federation: fleet %s marked DOWN "
                                "(%r)", f.url, e)
                    self.registry.counter(
                        "federation.fleet_down_total").inc()
            return
        slo = m.get("slo") or {}
        burn = slo.get("burn_rate_max")
        offset = None
        if isinstance(h.get("now"), (int, float)) \
                and not isinstance(h.get("now"), bool):
            offset = float(h["now"]) - (t0_wall + t1_wall) / 2.0
        with self._lock:
            f.consecutive_fails = 0
            if f.state == DOWN:
                # half-open: healthz answers again, but the keyspace
                # does not flood back — the next forwarded request is
                # the single probe that decides
                f.state = PROBE
                f.probing = False
                log.warning("federation: fleet %s healthz recovered "
                            "— half-open probe", f.url)
                self.registry.counter(
                    "federation.fleet_probe_total").inc()
            f.healthy_workers = int(h.get("healthy") or 0)
            f.burn_rate = burn if isinstance(burn, (int, float)) \
                else None
            if self.spill_threshold <= 0 or f.burn_rate is None:
                f.saturated = False
            elif f.burn_rate > self.spill_threshold:
                f.saturated = True
            elif f.burn_rate <= self.spill_recover:
                f.saturated = False
            # else: inside the (recover, threshold] band — hold the
            # previous saturation verdict (hysteresis, no thrash)
            f.tenants = slo.get("tenants") or {}
            if offset is not None:
                f.clock_offset_s = offset if f.clock_offset_s is None \
                    else 0.7 * f.clock_offset_s + 0.3 * offset
            f.last_metrics = m
            f.last_poll_s = time.monotonic()

    def poll_all(self) -> None:
        for f in list(self.fleets.values()):
            self._poll_one(f)

    def _due_fleets(self, now: float) -> list[_Fleet]:
        """Schedule reads under the pool lock — the same ``_Worker``
        discipline WorkerPool follows (gtlint lck-foreign-write): the
        fleet set is static today, but the field contract is "lock:
        the pool's" and the poller must not be the one exception."""
        with self._lock:
            return [f for f in self.fleets.values()
                    if f.next_poll_at <= now]

    def _advance_schedule(self, f: _Fleet) -> None:
        with self._lock:
            f.next_poll_at += self.poll_interval_s
            if f.next_poll_at <= time.monotonic():
                f.next_poll_at = time.monotonic() \
                    + self.poll_interval_s

    def _next_poll_due(self, default: float) -> float:
        with self._lock:
            return min((f.next_poll_at
                        for f in self.fleets.values()),
                       default=default)

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            for f in self._due_fleets(now):
                self._poll_one(f)
                self._advance_schedule(f)
            nxt = self._next_poll_due(now + self.poll_interval_s)
            wait = min(self.poll_interval_s,
                       max(0.02, nxt - time.monotonic()))
            self._stop.wait(wait)

    # ---- forward outcomes (the half-open machine's verdicts) ----

    def mark_failed(self, url: str) -> None:
        """A forward died at the connection level: the fleet's router
        is gone (or unreachable) — take the whole fleet out NOW."""
        f = self.fleets.get(url.rstrip("/"))
        if f is None:
            return
        with self._lock:
            if f.state != DOWN:
                log.warning("federation: fleet %s marked DOWN "
                            "(connection failure mid-request)", f.url)
                self.registry.counter(
                    "federation.fleet_down_total").inc()
            f.state = DOWN
            f.probing = False
            f.consecutive_fails = max(f.consecutive_fails,
                                      self.down_after)

    def try_begin_forward(self, url: str) -> bool:
        """May a forward to this fleet proceed right now? UP: always.
        PROBE: exactly one in-flight probe at a time (the breaker's
        half-open discipline). DOWN: never."""
        f = self.fleets.get(url.rstrip("/"))
        if f is None:
            return False
        with self._lock:
            if f.state == UP:
                return True
            if f.state == PROBE and not f.probing:
                f.probing = True
                return True
            return False

    def settle_forward(self, url: str, ok: bool) -> None:
        """Deliver a forward's outcome to a probing fleet: any HTTP
        answer proves the fleet router alive (``ok=True`` — even a
        503 is an ANSWER; per-request retry handles its content), a
        connection failure went through :meth:`mark_failed`."""
        f = self.fleets.get(url.rstrip("/"))
        if f is None:
            return
        rejoined = False
        with self._lock:
            if f.state != PROBE:
                return
            f.probing = False
            if ok:
                f.state = UP
                rejoined = True
                log.warning("federation: fleet %s probe succeeded — "
                            "rejoined", f.url)
                self.registry.counter(
                    "federation.fleet_rejoin_total").inc()
        if rejoined and self.on_rejoin is not None:
            # outside the lock — and the hook itself must return
            # promptly: settle_forward runs on live request threads
            # as well as the poller, so a warm-up that does network
            # I/O has to happen on its own thread (sync_soon)
            try:
                self.on_rejoin(f.url)
            except Exception as e:  # noqa: BLE001 — hook is best-effort
                log.warning("federation: on_rejoin hook failed for "
                            "%s: %s", f.url, e)

    # ---- routing state ----

    def eligible(self) -> set[str]:
        """Fleets a request may be forwarded to right now (UP, plus
        PROBE fleets — the forward gate enforces the single-probe
        discipline)."""
        with self._lock:
            return {u for u, f in self.fleets.items()
                    if f.state in (UP, PROBE)}

    def spill_targets(self) -> set[str]:
        """Fleets that may receive NEW affinity keys: fully up and
        under the spill threshold (a probing fleet earns its keyspace
        back before it earns new keys)."""
        with self._lock:
            return {u for u, f in self.fleets.items()
                    if f.state == UP and not f.saturated}

    def saturated_fleets(self) -> set[str]:
        with self._lock:
            return {u for u, f in self.fleets.items() if f.saturated}

    def clock_offsets(self) -> dict[str, float]:
        with self._lock:
            return {u: f.clock_offset_s
                    for u, f in sorted(self.fleets.items())
                    if f.clock_offset_s is not None}

    def tenant_blocks(self) -> list[dict]:
        """Each live fleet's rolled-up ``slo.tenants`` block — the
        downstream half of the federation's tenant burn evidence."""
        with self._lock:
            return [dict(f.tenants) for _, f in
                    sorted(self.fleets.items()) if f.tenants]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                u: {
                    "state": f.state,
                    "healthy_workers": f.healthy_workers,
                    "burn_rate": f.burn_rate,
                    "saturated": f.saturated,
                    "consecutive_fails": f.consecutive_fails,
                    "clock_offset_s": (
                        round(f.clock_offset_s, 6)
                        if f.clock_offset_s is not None else None),
                }
                for u, f in sorted(self.fleets.items())
            }


class FederationRouter:
    """Routing + tenant-isolation logic over N fleets, independent of
    any socket (tests drive it in-process,
    commands/federation.py serves it)."""

    def __init__(self, fleet_urls: list[str],
                 poll_interval_s: float = 2.0,
                 down_after: int = 2,
                 default_timeout_s: float = 120.0,
                 spill_threshold: float = 0.0,
                 spill_recover: float | None = None,
                 tenant_burn_threshold: float = 0.0,
                 tenant_shed_min_requests: int = 4,
                 error_budget: float = 0.01,
                 slo_p99_target_s: float = 2.0,
                 slo_window_s: float = 300.0,
                 vnodes: int = 64,
                 registry: MetricsRegistry | None = None,
                 flight_records: int = 64,
                 quotas: list[str] | None = None,
                 cache_sync_interval_s: float = 0.0):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.ring = HashRing(fleet_urls, vnodes=vnodes)
        self.pool = FleetPool(fleet_urls,
                              poll_interval_s=poll_interval_s,
                              down_after=down_after,
                              spill_threshold=spill_threshold,
                              spill_recover=spill_recover,
                              registry=self.registry)
        self.default_timeout_s = default_timeout_s
        self.spill_threshold = spill_threshold
        # federation-level admission: the fleet tier's token-bucket
        # table lifted to the front door, so a flooding tenant is
        # refused in ONE place instead of burning N fleets' budgets
        from .admission import QuotaTable

        self.quotas = QuotaTable(quotas)
        # cross-fleet cache replication (anti-entropy rounds over the
        # UP fleets + an immediate warm-up on half-open rejoin).
        # sync_soon, not sync_now: the hook fires from settle_forward
        # on a live request thread — an inline round (every
        # list/pull/push under its network timeout) would block that
        # client for the round's whole duration
        from .cachesync import CacheSync

        self.cache_sync = CacheSync(
            lambda: sorted(self.pool.eligible()),
            interval_s=cache_sync_interval_s,
            registry=self.registry)
        self.pool.on_rejoin = \
            lambda url: self.cache_sync.sync_soon("rejoin")
        self.tenant_burn_threshold = tenant_burn_threshold
        self.tenant_shed_min_requests = tenant_shed_min_requests
        self.error_budget = error_budget
        self.tenants = TenantSLOTracker(window_s=slo_window_s,
                                        p99_target_s=slo_p99_target_s)
        self.started = time.time()
        # affinity bookkeeping: where each key currently lands
        # (_homes) and, for keys routed away from a saturated home,
        # the ring home they migrate back to (_spilled ⊆ _homes keys)
        self._affinity_lock = threading.Lock()
        self._homes: OrderedDict[str, str] = OrderedDict()
        self._spilled: dict[str, str] = {}
        # the federation's own flight ring: federation.request.* trees
        # (root + per-attempt forward spans) — the top layer of every
        # stitched cross-fleet trace
        from ..serve.flight import FlightRecorder

        self.flight = FlightRecorder(max_records=flight_records)
        self._tracer = obs.get_tracer()
        self._tracer.add_listener(self.flight.on_span)

    def start(self) -> "FederationRouter":
        self.pool.start()
        self.cache_sync.start()
        return self

    def close(self) -> None:
        self.cache_sync.close()
        self.pool.close()
        self._tracer.remove_listener(self.flight.on_span)

    # ---- affinity + spillover ----

    def affinity_key(self, kind: str, req: dict) -> str:
        return request_affinity_key(kind, req)

    def _remember_home(self, key: str, url: str) -> None:
        # caller holds _affinity_lock
        self._homes[key] = url
        self._homes.move_to_end(key)
        while len(self._homes) > MAX_TRACKED_KEYS:
            old, _ = self._homes.popitem(last=False)
            self._spilled.pop(old, None)

    def resolve_target(self, kind: str, key: str) -> str:
        """The fleet this key should land on RIGHT NOW, applying the
        spillover contract: existing keys keep their home while it
        stands (even saturated — cache warmth), new keys avoid
        saturated fleets, spilled keys migrate home the moment the
        home recovers. Failover past the choice is the caller's
        per-request retry walk; it never rewrites the home."""
        order = self.ring.candidates(key)
        ring_home = order[0]
        spill_ok = self.pool.spill_targets()
        c = self.registry.counter
        with self._affinity_lock:
            origin = self._spilled.get(key)
            if origin is not None:
                if origin in spill_ok:
                    # the home fleet recovered: reclaim its key
                    del self._spilled[key]
                    self._remember_home(key, origin)
                    c("federation.spill_migrations_total").inc()
                    return origin
                cur = self._homes.get(key)
                if cur is not None:
                    self._homes.move_to_end(key)
                    return cur
            cur = self._homes.get(key)
            if cur is not None:
                self._homes.move_to_end(key)
                return cur
            # a NEW key: ring home unless it is saturated and a
            # non-saturated candidate exists to spill to
            if self.spill_threshold > 0 \
                    and ring_home not in spill_ok:
                target = next((u for u in order if u in spill_ok),
                              None)
                if target is not None and target != ring_home \
                        and ring_home in self.pool.eligible():
                    # spill only AROUND a saturated-but-alive home; a
                    # DOWN home is plain failover, not a spill
                    self._spilled[key] = ring_home
                    self._remember_home(key, target)
                    c("federation.spills_total").inc()
                    return target
            self._remember_home(key, ring_home)
            return ring_home

    def plan(self, kind: str, req: dict) -> list[str]:
        """Candidate FLEET order for this request: the spill-aware
        target first, then the ring walk (eligible fleets before
        ineligible, affinity preserved within each class)."""
        key = self.affinity_key(kind, req)
        order = self.ring.candidates(key)
        target = self.resolve_target(kind, key)
        rest = [u for u in order if u != target]
        ok = self.pool.eligible()
        return [target] \
            + [u for u in rest if u in ok] \
            + [u for u in rest if u not in ok]

    # ---- tenant-scoped burn ----

    def tenant_burn_rates(self) -> dict:
        """Per-tenant burn across the federation: the federation's own
        windowed outcomes merged with every fleet's rolled-up
        ``slo.tenants`` block, burn =
        ``max(p99_ratio, error_rate / error_budget)``. Publishes the
        ``federation.tenant.burn_rate.<tenant>`` gauges (the contract
        surface the shed decision — and the acceptance test — read)."""
        merged = merge_tenant_slos(
            [self.tenants.snapshot()] + self.pool.tenant_blocks(),
            self.error_budget)
        g = self.registry.gauge
        for tenant, rec in merged.items():
            g(f"federation.tenant.burn_rate.{tenant}").set(
                rec["burn_rate"])
        return merged

    def _maybe_shed_tenant(self, tenant: str, priority: int) \
            -> dict | None:
        """The tenant-isolation gate: shed this request (a 429 body)
        iff its tenant's burn rate breaches the threshold, the tenant
        has enough windowed evidence, and the request is best-effort
        (priority > 0 — interactive traffic is never shed here)."""
        if self.tenant_burn_threshold <= 0 or priority <= 0:
            return None
        rec = self.tenant_burn_rates().get(tenant)
        if rec is None \
                or rec["burn_rate"] <= self.tenant_burn_threshold \
                or rec["window_requests"] \
                < self.tenant_shed_min_requests:
            return None
        self.registry.counter(
            f"federation.tenant_shed_total.{tenant}").inc()
        retry_after = min(30.0, max(
            1.0, self.tenants.burn_clear_s(tenant)))
        return {
            "error": f"tenant {tenant!r} burn rate "
                     f"{rec['burn_rate']:g} exceeds "
                     f"{self.tenant_burn_threshold:g}; best-effort "
                     "traffic shed until the breaching window ages "
                     "out",
            "tenant": tenant,
            "shed": "tenant-burn",
            "burn_rate": rec["burn_rate"],
            "retry_after_s": round(retry_after, 3),
        }

    # ---- request handling ----

    def handle_traced(self, kind: str, body: bytes,
                      trace_header: str | None = None) \
            -> tuple[int, dict | bytes, str]:
        parsed = parse_trace_header(trace_header)
        tid, remote_parent = parsed if parsed else (None, None)
        with obs.trace(f"federation.request.{kind}", kind="serve",
                       trace_id=tid,
                       remote_parent=remote_parent) as root:
            code, payload = self.handle(kind, body)
            root.attrs["status"] = code
            return code, payload, root.trace_id

    def handle(self, kind: str, body: bytes) \
            -> tuple[int, dict | bytes]:
        try:
            req = json.loads(body or b"{}")
            if not isinstance(req, dict):
                raise ValueError("request body must be a JSON object")
        except ValueError as e:
            return 400, {"error": f"bad JSON body: {e}"}
        tenant = str(req.get("tenant") or "default")
        priority = int(req.get("priority", 0))
        timeout_s = float(req.get("timeout_s",
                                  self.default_timeout_s))
        self.registry.counter(
            f"federation.requests_total.{kind}").inc()
        try:
            self.quotas.check(tenant)
        except QuotaExceeded as e:
            # admission rejections mirror tenant sheds: honest
            # retry_after_s, and NOT recorded in the SLO tracker — a
            # refused request burned no fleet budget
            self.registry.counter(
                f"federation.admission_rejected_total.{tenant}").inc()
            return 429, {"error": f"tenant {tenant!r} over quota",
                         "shed": "admission",
                         "tenant": tenant,
                         "retry_after_s": e.retry_after_s}
        shed = self._maybe_shed_tenant(tenant, priority)
        if shed is not None:
            # NOT recorded in the tracker: the shed's own 429s must
            # not feed the burn rate that caused them
            return 429, shed
        t0 = time.perf_counter()
        code, payload = self._route(kind, req, body, timeout_s)
        self.tenants.record(tenant, code,
                            time.perf_counter() - t0)
        return code, payload

    def _forward(self, url: str, kind: str, body: bytes,
                 timeout_s: float,
                 trace: tuple[str, int] | None = None) \
            -> tuple[int, bytes]:
        headers = {"Content-Type": "application/json",
                   "Accept": "application/json"}
        if trace is not None:
            headers[TRACE_HEADER] = format_trace_header(*trace)
        req = urllib.request.Request(
            url + "/v1/" + kind, data=body, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def _route(self, kind: str, req: dict, body: bytes,
               timeout_s: float) -> tuple[int, dict | bytes]:
        candidates = self.plan(kind, req)
        eligible = self.pool.eligible()
        live = [u for u in candidates if u in eligible]
        c = self.registry.counter
        if not live:
            c("federation.no_fleet_total").inc()
            return 503, {
                "error": f"no live fleet for {kind!r} "
                         f"({len(candidates)} known, 0 eligible)",
                "retry_after_s": self.pool.poll_interval_s}
        last_err: dict | None = None
        attempts = 0
        for url in live:
            if not self.pool.try_begin_forward(url):
                # a probing fleet already has its one probe in flight
                continue
            if attempts > 0:
                c("federation.retries_total").inc()
            attempts += 1
            fl = url.rsplit(":", 1)[-1]  # port: stable short label
            try:
                with obs.span(f"federation.forward.{kind}", url=url,
                              attempt=attempts - 1) as fsp:
                    status, payload = self._forward(
                        url, kind, body, timeout_s,
                        trace=(fsp.trace_id, fsp.span_id))
                    fsp.attrs["status"] = status
            except Exception as e:  # noqa: BLE001 — connection-level
                # death: the FLEET (its router), not the request —
                # eject the whole fleet and walk to the next ring
                # candidate; content-keyed steps make the replay
                # byte-identical by construction
                self.pool.mark_failed(url)
                c(f"federation.fleet_errors_total.{fl}").inc()
                last_err = {"error": f"fleet {url} unreachable: "
                                     f"{e!r}"}
                continue
            self.pool.settle_forward(url, ok=True)
            if status == 503:
                # the fleet answered but cannot serve (no healthy
                # worker, shedding): spill this request reactively
                c(f"federation.fleet_shed_total.{fl}").inc()
                try:
                    last_err = json.loads(payload.decode())
                except ValueError:
                    last_err = {"error": f"fleet {url} shed (503)"}
                continue
            c(f"federation.routed_total.{fl}.{kind}").inc()
            if url == candidates[0]:
                c(f"federation.affinity_hits_total.{kind}").inc()
            return status, payload
        return 503, {**(last_err
                        or {"error": "all fleets failed"}),
                     "retry_after_s": self.pool.poll_interval_s}

    # ---- operability ----

    def healthz(self) -> tuple[int, dict]:
        snap = self.pool.snapshot()
        n_up = sum(1 for f in snap.values() if f["state"] == UP)
        n_live = sum(1 for f in snap.values()
                     if f["state"] in (UP, PROBE))
        body = {
            "status": "ok" if n_up == len(snap) and snap
            else ("degraded" if n_live else "down"),
            "fleets": len(snap),
            "fleets_up": n_up,
            "uptime_s": round(time.time() - self.started, 1),
            "now": round(time.time(), 6),
        }
        return (200 if n_live else 503), body

    def metrics_snapshot(self) -> dict:
        self._refresh_gauges()
        snap = self.registry.snapshot()
        return {
            "counters": snap["counters"],
            "gauges": snap["gauges"],
            "histograms": snap.get("histograms", {}),
            "fleets": self.pool.snapshot(),
            "tenants": self.tenant_burn_rates(),
        }

    def metrics_prometheus(self) -> str:
        """The same registry state as Prometheus text exposition —
        the ``federation.tenant.burn_rate.<tenant>`` gauges ride both
        encodings (the acceptance surface)."""
        from ..obs import prometheus

        self._refresh_gauges()
        return prometheus.render(self.registry.snapshot())

    def _refresh_gauges(self) -> None:
        g = self.registry.gauge
        snap = self.pool.snapshot()
        g("federation.fleets").set(len(snap))
        g("federation.fleets_up").set(
            sum(1 for f in snap.values() if f["state"] == UP))
        for url, rec in snap.items():
            fl = url.rsplit(":", 1)[-1]
            if isinstance(rec["burn_rate"], (int, float)):
                g(f"federation.fleet.burn_rate.{fl}").set(
                    rec["burn_rate"])
            g(f"federation.fleet.saturated.{fl}").set(
                1 if rec["saturated"] else 0)
        with self._affinity_lock:
            g("federation.spilled_keys").set(len(self._spilled))
            g("federation.tracked_keys").set(len(self._homes))
        self.tenant_burn_rates()

    # ---- cross-fleet trace stitching ----

    def fleet_trace(self, trace_id: str) -> tuple[int, dict]:
        """``GET /fleet/trace/<id>`` one level up: every fleet's own
        stitched document grafted under the federation's forward
        spans, with the Perfetto export attached. 404 only when NO
        tier holds the trace."""
        from urllib.parse import quote

        own = self.flight.snapshot(trace_id=trace_id)
        fleet_docs: dict[str, dict | None] = {}
        for url in sorted(self.pool.fleets):
            try:
                fleet_docs[url] = self.pool._fetch_json(
                    url + "/fleet/trace/" + quote(trace_id))
            except Exception:  # noqa: BLE001 — a dead fleet (or a
                # 404 from one that never saw the trace) cannot veto
                # the stitched view of the others
                fleet_docs[url] = None
        stitched = stitch_federation(
            trace_id, own, fleet_docs,
            clock_offsets=self.pool.clock_offsets())
        if stitched is None:
            return 404, {
                "error": f"no flight record for trace {trace_id!r} "
                         "in the federation or any fleet (rings are "
                         "bounded — the trace may have been "
                         "evicted)"}
        stitched["perfetto"] = perfetto_export(trace_id, stitched)
        return 200, stitched

    def fleet_profile(self, seconds: float) -> dict:
        """``GET /fleet/profile`` one level up: each fleet's merged
        rollup collected IN PARALLEL (overlapping windows, same as
        the fleet router over its workers) and merged stack-wise —
        exact sums compose across tiers."""
        from urllib.parse import quote

        from ..obs.profiler import MAX_WINDOW_S, merge_profiles

        seconds = max(0.0, min(float(seconds), MAX_WINDOW_S))
        urls = sorted(self.pool.fleets)
        bodies: list[dict | None] = [None] * len(urls)
        errors: dict[str, str] = {}

        def fetch(i: int, url: str) -> None:
            req = urllib.request.Request(
                url + f"/fleet/profile?seconds={quote(str(seconds))}",
                headers={"Accept": "application/json"})
            try:
                with urllib.request.urlopen(
                        req, timeout=seconds + 20.0) as r:
                    bodies[i] = json.loads(r.read().decode())
            except Exception as e:  # noqa: BLE001 — per-fleet fault
                errors[url] = str(e)

        threads: list[threading.Thread] = []
        for i, url in enumerate(urls):
            t = threading.Thread(target=fetch, args=(i, url),
                                 name=f"goleft-fed-profile-{i}")
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=seconds + 40.0)
        merged = merge_profiles([b for b in bodies if b is not None])
        merged["seconds"] = seconds
        merged["per_fleet"] = {
            url: ({"error": errors[url]} if url in errors else {
                "samples_total":
                    int((bodies[i] or {}).get("samples_total") or 0),
                "stacks": len((bodies[i] or {}).get("stacks") or {}),
            })
            for i, url in enumerate(urls)
        }
        return merged

    def fleet_memory(self) -> dict:
        """``GET /fleet/memory`` one level up: each fleet's merged
        memory document combined tier-wise (counter sums stay exact,
        gauge aggregates compose min/max/sum) — the federation's
        numbers equal a flat merge over every worker. Instant
        collection, so serial fetch like the fleet router's."""
        from ..obs.memplane import merge_merged_memory

        bodies: list[dict] = []
        per_fleet: dict[str, dict] = {}
        for url in sorted(self.pool.fleets):
            try:
                d = self.pool._fetch_json(url + "/fleet/memory")
                bodies.append(d)
                per_fleet[url] = {
                    "workers": int(d.get("workers") or 0),
                    "workers_in_pressure":
                        int(d.get("workers_in_pressure") or 0),
                    "enabled": bool(d.get("enabled")),
                }
            except Exception as e:  # noqa: BLE001 — per-fleet fault
                per_fleet[url] = {"error": str(e)}
        merged = merge_merged_memory(bodies)
        merged["per_fleet"] = per_fleet
        return merged


class _FederationHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        log.debug("%s " + fmt, self.address_string(), *args)

    @property
    def app(self) -> FederationRouter:
        return self.server.app

    def _respond_json(self, code: int, body: dict,
                      extra_headers: dict | None = None) -> None:
        self._respond_raw(code, json.dumps(body).encode(),
                          extra_headers=extra_headers)

    def _respond_raw(self, code: int, data: bytes,
                     content_type: str = "application/json",
                     extra_headers: dict | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
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
        elif u.path == "/metrics":
            q = parse_qs(u.query)
            fmt = q.get("format", [""])[0]
            accept = self.headers.get("Accept", "")
            if fmt in ("prom", "prometheus") or (
                    not fmt and "text/plain" in accept
                    and "json" not in accept):
                from ..obs.prometheus import CONTENT_TYPE

                self._respond_raw(
                    200, self.app.metrics_prometheus().encode(),
                    content_type=CONTENT_TYPE)
            else:
                self._respond_json(200, self.app.metrics_snapshot())
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
        elif u.path == "/fleet/memory":
            q = parse_qs(u.query)
            fmt = q.get("format", [""])[0]
            accept = self.headers.get("Accept", "")
            if fmt in ("prom", "prometheus") or (
                    not fmt and "text/plain" in accept
                    and "json" not in accept):
                from ..obs import prometheus
                from ..obs.memplane import flatten_merged
                from ..obs.prometheus import CONTENT_TYPE

                self._respond_raw(
                    200, prometheus.render(flatten_merged(
                        self.app.fleet_memory())).encode(),
                    content_type=CONTENT_TYPE)
            else:
                self._respond_json(200, self.app.fleet_memory())
        else:
            self._respond_json(404,
                               {"error": f"no route {self.path}"})

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
        trace_hdr = {TRACE_HEADER: trace_id}
        if isinstance(payload, bytes):
            self._respond_raw(code, payload,
                              extra_headers=trace_hdr)
        else:
            self._respond_json(code, payload,
                               extra_headers=trace_hdr)


class _FederationServer(ThreadingHTTPServer):
    daemon_threads = False
    block_on_close = True
    allow_reuse_address = True
    request_queue_size = LISTEN_BACKLOG


def make_federation_server(app: FederationRouter,
                           host: str = "127.0.0.1",
                           port: int = 0) -> ThreadingHTTPServer:
    srv = _FederationServer((host, port), _FederationHandler)
    srv.app = app
    return srv


class FederationThread:
    """In-process federation harness (tests):
    ``with FederationThread(app) as url: ...``"""

    def __init__(self, app: FederationRouter,
                 host: str = "127.0.0.1", port: int = 0):
        self.app = app
        self.httpd = make_federation_server(app, host, port)
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            daemon=True, name="goleft-federation-http")

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
