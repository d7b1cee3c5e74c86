"""Service observability: the serve facade over the unified registry.

One :class:`ServeMetrics` instance is shared by the HTTP handlers, the
micro-batcher and the executors; ``snapshot()`` is the /metrics
response body, and it is generated SOLELY from the unified metrics
registry (:mod:`goleft_tpu_torch.obs.metrics`) plus the shared StageTimer —
the daemon no longer keeps bespoke counter dicts. Instruments live
under the ``serve.`` prefix, so a daemon handed the process-global
registry (commands/serve.py does) publishes its counters into the same
namespace the CLI pipelines and the prefetch/caching layers populate,
while tests constructing :class:`~goleft_tpu_torch.serve.server.ServeApp`
directly get a private registry and stay isolated.

Stage wall-clocks (decode/compute/format per batch) ride the same
``utils.profiling.StageTimer`` the CLI pipelines use, whose totals and
counts are all it keeps, so a long-lived daemon's state stays bounded.
A copy of the JAX package's serve/metrics.py.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..obs.metrics import MetricsRegistry
from ..utils.profiling import StageTimer

_PREFIX = "serve."
_BATCH = "serve.batch_size."
_LATENCY = "serve.latency_s."
_SLO = "serve.slo."


class ServeMetrics:
    def __init__(self, max_latencies: int = 4096,
                 registry: MetricsRegistry | None = None,
                 outcome_window: int = 4096):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._max_latencies = max_latencies
        self.timer = StageTimer()
        self.started = time.time()
        # (monotonic ts, was_error) per response — the availability
        # window's raw material (bounded; a counter can't answer
        # "over the last five minutes")
        self._outcomes: deque = deque(maxlen=outcome_window)
        self._outcomes_lock = threading.Lock()
        # per-TENANT outcome windows: (monotonic ts, burned, seconds)
        # per response, keyed by the request's tenant label — the raw
        # material of the tenant-scoped burn rates the federation tier
        # sheds on. Tenant count is bounded (an attacker-chosen label
        # must not grow a dict forever): the stalest tenant is evicted
        # when a new label would exceed the cap.
        self._tenant_outcomes: dict[str, deque] = {}
        self._max_tenants = 64
        self._tenant_window = min(outcome_window, 1024)

    def inc(self, name: str, n: int = 1) -> None:
        self.registry.counter(_PREFIX + name).inc(n)

    def record_response(self, code: int) -> None:
        """Every HTTP response: the per-code counter (as always) plus
        the timestamped outcome the SLO window is computed from. 5xx
        is an error burning the availability budget; 4xx is the
        client's problem and 2xx/3xx are successes."""
        self.inc(f"responses_total.{code}")
        with self._outcomes_lock:
            self._outcomes.append((time.monotonic(), code >= 500))

    def record_tenant(self, tenant: str, code: int,
                      seconds: float | None = None) -> None:
        """One response attributed to a tenant: the per-tenant counter
        pair plus the timestamped outcome its burn rate is computed
        from. A tenant "burns" on 5xx AND on 429 — a throttled tenant
        is spending its own budget, which is exactly the signal the
        federation's tenant-scoped shed isolates on (a 4xx other than
        429 stays the client's problem, as in the fleet-wide SLO)."""
        burned = code >= 500 or code == 429
        with self._outcomes_lock:
            dq = self._tenant_outcomes.get(tenant)
            if dq is None:
                while len(self._tenant_outcomes) >= self._max_tenants:
                    stale = min(
                        self._tenant_outcomes,
                        key=lambda t: self._tenant_outcomes[t][-1][0]
                        if self._tenant_outcomes[t] else 0.0)
                    del self._tenant_outcomes[stale]
                dq = self._tenant_outcomes[tenant] = deque(
                    maxlen=self._tenant_window)
            dq.append((time.monotonic(), burned, seconds))
        self.inc(f"tenant.requests_total.{tenant}")
        if burned:
            self.inc(f"tenant.burned_total.{tenant}")

    def tenant_slo(self, p99_target_s: float = 2.0,
                   window_s: float = 300.0) -> dict:
        """{tenant: {window_requests, error_rate,
        p99_latency_ratio?}} over the outcome window — the per-tenant
        dimension of the /metrics ``slo`` block. Rates here are
        RAW: burn rates (rate / error budget vs p99 ratio) are
        computed by the tier that owns the budget (the fleet rollup
        and the federation), not per worker."""
        now = time.monotonic()
        with self._outcomes_lock:
            items = [(t, list(dq))
                     for t, dq in self._tenant_outcomes.items()]
        out: dict = {}
        for tenant, rows in sorted(items):
            recent = [(burned, sec) for ts, burned, sec in rows
                      if now - ts <= window_s]
            if not recent:
                continue
            n = len(recent)
            errs = sum(1 for burned, _ in recent if burned)
            rec = {"window_requests": n,
                   "error_rate": round(errs / n, 6)}
            lats = [s for _, s in recent if s is not None]
            if lats and p99_target_s > 0:
                from ..utils.profiling import percentiles

                rec["p99_latency_ratio"] = round(
                    percentiles(lats)["p99"] / p99_target_s, 4)
            out[tenant] = rec
        return out

    def slo_snapshot(self, p99_target_s: float = 2.0,
                     window_s: float = 300.0) -> dict:
        """Compute the SLO gauges and publish them into the registry
        (``serve.slo.*`` — visible to /metrics in both encodings and
        to any --metrics-out manifest snapshot of this process).

        Pull-based: computed at scrape time from state the serve path
        already records, so idle daemons pay nothing.

          - ``p99_latency_ratio.<endpoint>``: windowed p99 / target
            (>1 = violating)
          - ``error_rate``: 5xx fraction of responses in the window
          - ``availability``: 1 - error_rate (1.0 while idle: no
            traffic is not an outage)
        """
        now = time.monotonic()
        with self._outcomes_lock:
            recent = [err for ts, err in self._outcomes
                      if now - ts <= window_s]
        total = len(recent)
        errors = sum(recent)
        error_rate = (errors / total) if total else 0.0
        availability = 1.0 - error_rate
        ratios = {}
        for ep, summ in self.registry.histograms(_LATENCY).items():
            p99 = summ.get("p99")
            if p99 is not None and p99_target_s > 0:
                ratios[ep] = round(p99 / p99_target_s, 4)
        g = self.registry.gauge
        g(_SLO + "error_rate").set(round(error_rate, 6))
        g(_SLO + "availability").set(round(availability, 6))
        g(_SLO + "window_requests").set(total)
        for ep, r in ratios.items():
            g(f"{_SLO}p99_latency_ratio.{ep}").set(r)
        return {
            "p99_target_s": p99_target_s,
            "window_s": window_s,
            "window_requests": total,
            "error_rate": round(error_rate, 6),
            "availability": round(availability, 6),
            "p99_latency_ratio": ratios,
            "tenants": self.tenant_slo(p99_target_s=p99_target_s,
                                       window_s=window_s),
        }

    def observe_batch(self, size: int) -> None:
        self.registry.counter(_PREFIX + "batches_total").inc()
        self.registry.counter(
            _PREFIX + "batched_requests_total").inc(size)
        self.registry.counter(f"{_BATCH}{size}").inc()

    def observe_latency(self, endpoint: str, seconds: float) -> None:
        self.registry.histogram(_LATENCY + endpoint,
                                self._max_latencies).observe(seconds)

    def snapshot(self, queue_depth: int | None = None,
                 cache_stats: dict | None = None,
                 slo: dict | None = None,
                 breakers: dict | None = None,
                 queue_age_s: float | None = None) -> dict:
        counters = {
            n: v for n, v in self.registry.counters(_PREFIX).items()
            if not n.startswith("batch_size.")
            and not n.startswith("latency_s.")
        }
        hist = {
            str(size): v for size, v in sorted(
                (int(n), v)
                for n, v in self.registry.counters(_BATCH).items())
        }
        out = {
            "uptime_s": round(time.time() - self.started, 1),
            "counters": counters,
            "batch_size_hist": hist,
            "latency_s": self.registry.histograms(_LATENCY),
            # the bounded raw windows behind those summaries: the
            # fleet rollup concatenates them for EXACT merged
            # quantiles (summaries alone only permit a count-weighted
            # approximation)
            "latency_windows": self.registry.histogram_windows(
                _LATENCY),
            "stage_seconds": self.timer.as_dict(),
            "stage_spans_dropped": self.timer.spans_dropped,
        }
        if queue_depth is not None:
            out["queue_depth"] = queue_depth
        if queue_age_s is not None:
            # oldest-waiter age: the backlog-pressure signal the fleet
            # router's admission layer sheds on
            out["queue_age_s"] = round(queue_age_s, 4)
        if cache_stats is not None:
            out["cache"] = cache_stats
        if slo is not None:
            out["slo"] = slo
        if breakers is not None:
            out["breakers"] = breakers
        return out
