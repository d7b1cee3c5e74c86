"""Run-scoped hierarchical tracing: the counterpart of the JAX package's
obs/tracing.py, trimmed to what the CLI's ``--trace-out`` needs (no
completed-span listeners, no memory probe, no profiler hooks).

Every CLI invocation runs under a *trace*: a string id grouping the
spans that invocation caused, on every thread it touched. A *span* is
one named wall-clock interval with attributes and a parent: the CLI's
``run.<command>`` root parents the shard and stage spans, and a stage
parents the ``device.<kernel>`` spans its launches record.

- Recording is cheap (one perf_counter pair and one lock-guarded
  append), so the StageTimer of utils/profiling.py mirrors every stage
  here unconditionally.
- Spans cross threads: the ambient context is thread-local but
  portable (:meth:`Tracer.capture` / :meth:`Tracer.attach`), so a
  shard pool's spans parent under the submitting thread's span.
- The buffer is a ring: the oldest spans drop first and
  ``spans_dropped`` counts them.
- Export is Chrome trace-event JSON (the ``traceEvents`` array), which
  Perfetto and chrome://tracing load, as ``torch.profiler``'s own
  traces do.

Stdlib only: device attributes are the caller's business
(obs/__init__.py's device spans).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

# perf_counter gives monotonic durations; the offset maps them onto the
# epoch so exported timestamps line up across processes
_EPOCH_OFFSET = time.time() - time.perf_counter()


@dataclass
class Span:
    """One finished (or in-flight) named interval."""

    name: str
    span_id: int
    parent_id: int | None
    trace_id: str
    t0: float  # perf_counter seconds
    t1: float | None = None
    attrs: dict = field(default_factory=dict)
    thread_id: int = 0
    thread_name: str = ""
    category: str = ""

    def duration(self) -> float:
        return (self.t1 if self.t1 is not None
                else time.perf_counter()) - self.t0


class _Context(threading.local):
    """Per-thread ambient state: the active trace id and span stack."""

    def __init__(self):
        self.trace_id: str | None = None
        self.stack: list[Span] = []


@dataclass(frozen=True)
class SpanContext:
    """A portable snapshot of (trace, parent span): what a worker thread
    attaches to record on behalf of the thread that captured it."""

    trace_id: str | None
    parent_id: int | None


class Tracer:
    """Process-wide span recorder with a bounded ring buffer.

    One instance (:data:`TRACER`) serves the process; tests may build
    private ones. Every method is thread-safe; the ambient context
    (current trace and span stack) is thread-local.
    """

    def __init__(self, max_spans: int = 100_000):
        self._spans: deque[Span] = deque(maxlen=max_spans)
        self.spans_dropped = 0
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._trace_ids = itertools.count(1)
        self._ctx = _Context()
        # --trace-out turns on the fenced device spans of obs.dispatch:
        # off by default, so the launches stay asynchronous when nobody
        # is looking
        self.device_events = False

    # ---- trace scoping ----

    def new_trace_id(self, kind: str = "run") -> str:
        return f"{kind}-{os.getpid()}-{next(self._trace_ids)}"

    @contextlib.contextmanager
    def trace(self, name: str, kind: str = "run",
              trace_id: str | None = None, **attrs):
        """Run-scoped root: sets this thread's trace id (a fresh one, or
        ``trace_id``) and opens the root span; yields the root
        :class:`Span`."""
        prev = self._ctx.trace_id
        self._ctx.trace_id = trace_id if trace_id \
            else self.new_trace_id(kind)
        try:
            with self.span(name, **attrs) as root:
                yield root
        finally:
            self._ctx.trace_id = prev

    # ---- span recording ----

    def _new_span(self, name: str, category: str, attrs: dict,
                  t0: float, t1: float | None = None) -> Span:
        th = threading.current_thread()
        parent = self._ctx.stack[-1] if self._ctx.stack else None
        return Span(
            name=name,
            span_id=next(self._ids),
            parent_id=parent.span_id if parent is not None else None,
            trace_id=self._ctx.trace_id or f"proc-{os.getpid()}",
            t0=t0, t1=t1,
            attrs=dict(attrs) if attrs else {},
            thread_id=th.ident or 0,
            thread_name=th.name,
            category=category,
        )

    def _append(self, sp: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.spans_dropped += 1
            self._spans.append(sp)

    @contextlib.contextmanager
    def span(self, name: str, category: str = "", **attrs):
        """Open a child of this thread's innermost open span (or a root
        when the stack is empty)."""
        sp = self._new_span(name, category, attrs, time.perf_counter())
        self._ctx.stack.append(sp)
        try:
            yield sp
        finally:
            sp.t1 = time.perf_counter()
            self._ctx.stack.pop()
            self._append(sp)

    def record_span(self, name: str, t0: float, t1: float,
                    category: str = "", **attrs) -> Span:
        """Record an already-measured [t0, t1] perf_counter interval as
        a completed span, parented to this thread's innermost open
        span."""
        sp = self._new_span(name, category, attrs, t0, t1)
        self._append(sp)
        return sp

    # ---- cross-thread propagation ----

    def capture(self) -> SpanContext:
        """Snapshot this thread's (trace, innermost span) for a worker
        thread to attach."""
        parent = self._ctx.stack[-1] if self._ctx.stack else None
        return SpanContext(
            trace_id=self._ctx.trace_id,
            parent_id=parent.span_id if parent is not None else None)

    @contextlib.contextmanager
    def attach(self, ctx: SpanContext | None):
        """Adopt a captured context on the current thread: spans opened
        inside parent under ``ctx`` (a placeholder stack entry carries
        the foreign parent id and is never recorded)."""
        if ctx is None:
            yield
            return
        prev_trace = self._ctx.trace_id
        pushed = False
        if ctx.trace_id is not None:
            self._ctx.trace_id = ctx.trace_id
        if ctx.parent_id is not None and not self._ctx.stack:
            self._ctx.stack.append(Span(
                name="<attached>", span_id=ctx.parent_id,
                parent_id=None,
                trace_id=ctx.trace_id or f"proc-{os.getpid()}",
                t0=time.perf_counter()))
            pushed = True
        try:
            yield
        finally:
            if pushed:
                self._ctx.stack.pop()
            self._ctx.trace_id = prev_trace

    # ---- inspection / export ----

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.spans_dropped = 0

    def summary(self, trace_id: str | None = None) -> dict:
        """{name: {seconds, calls}} totals over the buffered spans (the
        run manifest's ``spans`` shape)."""
        out: dict[str, dict] = {}
        for sp in self.snapshot():
            if trace_id is not None and sp.trace_id != trace_id:
                continue
            rec = out.setdefault(sp.name, {"seconds": 0.0, "calls": 0})
            rec["seconds"] += sp.duration()
            rec["calls"] += 1
        return {k: {"seconds": round(v["seconds"], 4),
                    "calls": v["calls"]}
                for k, v in sorted(out.items())}

    def to_chrome_trace(self, trace_id: str | None = None,
                        epoch_offset: float | None = None) -> dict:
        """The Chrome trace-event JSON object: spans as ``ph: "X"``
        complete events (ts/dur in microseconds, attributes in
        ``args``), ``thread_name`` metadata per thread, and a
        ``spans_dropped`` metadata event so a truncated trace says so.
        ``trace_id`` filters to one invocation's spans."""
        off = _EPOCH_OFFSET if epoch_offset is None else epoch_offset
        pid = os.getpid()
        events = []
        threads: dict[int, str] = {}
        for sp in self.snapshot():
            if trace_id is not None and sp.trace_id != trace_id:
                continue
            threads.setdefault(sp.thread_id, sp.thread_name)
            args = {"trace_id": sp.trace_id, "span_id": sp.span_id}
            if sp.parent_id is not None:
                args["parent_id"] = sp.parent_id
            args.update(sp.attrs)
            events.append({
                "name": sp.name,
                "cat": sp.category or "span",
                "ph": "X",
                "ts": round((sp.t0 + off) * 1e6, 3),
                "dur": round(sp.duration() * 1e6, 3),
                "pid": pid,
                "tid": sp.thread_id,
                "args": args,
            })
        events.sort(key=lambda e: e["ts"])
        meta = [{
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": nm or f"thread-{tid}"},
        } for tid, nm in sorted(threads.items())]
        meta.append({
            "name": "spans_dropped", "ph": "M", "pid": pid, "tid": 0,
            "args": {"spans_dropped": self.spans_dropped},
        })
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "goleft-tpu-torch obs",
                          "spans_dropped": self.spans_dropped},
        }

    def write_chrome_trace(self, path: str,
                           trace_id: str | None = None) -> None:
        """Write :meth:`to_chrome_trace` to ``path`` atomically."""
        doc = self.to_chrome_trace(trace_id=trace_id)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp, path)


#: the process-wide tracer every module records into
TRACER = Tracer()


def get_tracer() -> Tracer:
    return TRACER
