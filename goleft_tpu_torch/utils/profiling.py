"""Per-stage wall clocks and the profiler trace: the counterpart of the
JAX package's utils/profiling.py (``StageTimer``, ``trace``).

Every ``stage`` use accumulates into the timer's own totals and into the
process-wide totals that the ``spans`` block of the CLI's
``--metrics-out`` run manifest carries (obs/manifest.py), and records
the same interval as a span on the process tracer (obs/tracing.py), so
a ``--trace-out`` timeline shows the stages ``--profile`` logs as
totals, under the caller's span and on the thread that ran them.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

from ..obs import get_logger, get_tracer

log = get_logger("profile")

_process_lock = threading.Lock()
_process_totals: dict[str, float] = defaultdict(float)
_process_calls: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """``torch.profiler`` over the block (CPU and, where a card is
    visible, CUDA activities), its Chrome trace written into
    ``trace_dir`` as ``trace.json``: the counterpart of
    ``jax.profiler.trace``. A no-op when ``trace_dir`` is falsy."""
    if not trace_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


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
        with get_tracer().span(name, category="stage"):
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

    def log_report(self) -> None:
        for line in self.report().splitlines():
            log.info("%s", line)
