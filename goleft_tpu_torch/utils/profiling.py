"""Per-stage wall clocks: the counterpart of the JAX package's
utils/profiling.py::StageTimer.

Every ``stage`` use accumulates into the timer's own totals and into the
process-wide totals that the ``spans`` block of the CLI's
``--metrics-out`` run manifest carries (obs/manifest.py).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

_process_lock = threading.Lock()
_process_totals: dict[str, float] = defaultdict(float)
_process_calls: dict[str, int] = defaultdict(int)


def process_spans() -> dict[str, dict]:
    """{stage: {"seconds", "calls"}} over every StageTimer of this
    process: the run manifest's ``spans`` shape."""
    with _process_lock:
        return {name: {"seconds": secs, "calls": _process_calls[name]}
                for name, secs in _process_totals.items()}


class StageTimer:
    """Accumulating wall-clock timers keyed by stage name; thread-safe
    (shard workers record concurrently)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1
            with _process_lock:
                _process_totals[name] += dt
                _process_calls[name] += 1

    def report(self) -> str:
        return "\n".join(
            f"{name:<24} {self.totals[name]:8.3f}s "
            f"({self.counts[name]} calls)"
            for name in sorted(self.totals, key=self.totals.get,
                               reverse=True))
