"""Process-wide counters: the counterpart of the JAX package's
obs/metrics.py, trimmed to monotonic counters (no gauges, no
histograms): ``pairhmm.*``, ``decode.*``, ``depth.*``, ``resilience.*``,
``result_cache.*``, ``checkpoint.*``, ``fetch.*`` and the rest.

One :data:`REGISTRY` is shared by the whole process; ``snapshot()``
sorts names so two snapshots of the same state serialise to the same
JSON.
"""

from __future__ import annotations

import threading


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


class MetricsRegistry:
    """Thread-safe name → counter registry (get-or-create)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def snapshot(self) -> dict:
        """{"counters": {name: value}} sorted by name; zero-valued
        counters included (a counter at 0 says the path was idle)."""
        with self._lock:
            counters = sorted(self._counters.items())
        return {"counters": {n: c.value for n, c in counters}}


#: the process-wide registry
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
