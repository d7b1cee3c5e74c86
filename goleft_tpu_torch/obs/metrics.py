"""Process-wide metrics registry: counters, gauges and histograms, the
counterpart of the JAX package's obs/metrics.py.

One :data:`REGISTRY` is shared by the process: the commands' counters
(``pairhmm.*``, ``decode.*``, ``depth.*``, ``resilience.*``,
``result_cache.*``, ``checkpoint.*``, ``fetch.*``), and the serve
daemon's request counters, gauges and latency histograms when the
daemon is handed it (``serve``; tests give each app a private registry).
Histograms share :func:`goleft_tpu_torch.utils.profiling.percentiles`,
so a latency summary means the same in /metrics and the run manifest.

``snapshot()`` sorts every name and rounds consistently, so two
snapshots of the same state serialise to the same JSON.
"""

from __future__ import annotations

import threading
from collections import deque


class Counter:
    """Monotonic int counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def max(self, v: float) -> None:
        """Keep the high-water mark (queue depths, batch widths)."""
        with self._lock:
            if v > self._value:
                self._value = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Bounded observation buffer summarized via the shared
    ``percentiles`` (p50/p95/p99/max). ``count`` tracks ALL
    observations ever seen; only the last ``maxlen`` contribute to the
    percentile estimate (a long-lived daemon must not grow
    per-request state)."""

    __slots__ = ("name", "_vals", "_count", "_sum", "_lock")

    def __init__(self, name: str, maxlen: int = 4096):
        self.name = name
        self._vals: deque = deque(maxlen=maxlen)
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._vals.append(float(v))
            self._count += 1
            self._sum += float(v)

    def summary(self) -> dict:
        from ..utils.profiling import percentiles

        with self._lock:
            vals = list(self._vals)
            count, total = self._count, self._sum
        out = percentiles(vals)
        out["count"] = count  # all-time, not just the window
        if vals:
            out["sum"] = round(total, 4)
        return out

    def window(self) -> list[float]:
        """The bounded raw observation window (most recent ``maxlen``
        values, oldest first) — what the fleet rollup concatenates to
        compute EXACT merged quantiles instead of the count-weighted
        approximation summaries force on it. Rounded to µs-ish
        precision so shipping a window over /metrics stays cheap."""
        with self._lock:
            vals = list(self._vals)
        return [round(v, 6) for v in vals]


class MetricsRegistry:
    """Thread-safe name → instrument registry (get-or-create)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str, maxlen: int = 4096) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name, maxlen)
            return h

    def counters(self, prefix: str = "") -> dict[str, int]:
        """{name: value} for counters under ``prefix`` (sorted, the
        prefix stripped) — how ServeMetrics renders its legacy keys."""
        with self._lock:
            items = list(self._counters.items())
        return {n[len(prefix):]: c.value
                for n, c in sorted(items) if n.startswith(prefix)}

    def histograms(self, prefix: str = "") -> dict[str, dict]:
        with self._lock:
            items = list(self._hists.items())
        return {n[len(prefix):]: h.summary()
                for n, h in sorted(items) if n.startswith(prefix)}

    def histogram_windows(self, prefix: str = "") -> dict[str, list]:
        """{name: bounded raw window} per histogram under ``prefix`` —
        the worker-side half of the fleet's exact-quantile merge."""
        with self._lock:
            items = list(self._hists.items())
        return {n[len(prefix):]: h.window()
                for n, h in sorted(items) if n.startswith(prefix)}

    def snapshot(self) -> dict:
        """Deterministic full snapshot: sorted names, stable rounding.
        Zero-valued instruments are included — existence is evidence
        (a counter at 0 says the path was instrumented and idle)."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._hists.items())
        return {
            "counters": {n: c.value for n, c in counters},
            "gauges": {n: round(g.value, 4) for n, g in gauges},
            "histograms": {n: h.summary() for n, h in hists},
        }

    def reset(self) -> None:
        """Drop every instrument (tests only)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


#: the process-wide registry (CLI pipelines, prefetch, caches, serve
#: daemon); tests and embedded apps may construct private ones
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
