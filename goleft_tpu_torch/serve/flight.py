"""The serve flight recorder: last-N request/batch span trees, always on.

A long-lived daemon's worst debugging story is "the slow request
already happened": by the time someone attaches a profiler, the
evidence is gone. The flight recorder keeps it — a bounded ring of the
most recent COMPLETED request (``request.<kind>``) and batch
(``batch.<kind>``) traces, each stored as a small JSON span tree. It
costs nothing beyond the tracing the serve path already does
(obs/tracing.py): a listener on the process tracer buckets each
finished span by trace id and finalizes the bucket into a tree when
its root span closes. No extra clocks, no sampling decisions, no
periodic thread.

Exposure:

  - ``GET /debug/flight`` returns the ring newest-first (the live
    "what just happened" view)
  - SIGUSR1 (wired in commands/serve.py) dumps the ring to a
    timestamped JSON file — the post-incident artifact you grab
    before restarting

Bounds: the ring holds ``max_records`` trees (dropped-oldest counted);
an in-flight trace buffers at most ``max_spans_per_trace`` spans
(further spans counted in the tree's ``spans_dropped``), and at most
``max_open_traces`` traces buffer concurrently — a trace whose root
never closes (leaked by a crashed thread) is evicted, never leaked.
"""

from __future__ import annotations

import datetime
import itertools
import json
import os
import threading
from collections import OrderedDict, deque

from ..obs.tracing import _EPOCH_OFFSET, Span

#: trace-id prefixes the recorder watches — ``serve-<pid>-N`` roots
#: from ServeApp.handle and ``serve-batch-<pid>-N`` from the batcher's
#: dispatcher (obs kind strings; everything else is CLI traffic)
WATCH_PREFIXES = ("serve-",)


def _node(sp: Span, t0_root: float) -> dict:
    rec = {
        "name": sp.name,
        "category": sp.category or "span",
        "span_id": sp.span_id,  # the stitcher's graft anchor: batch
        # trees link back to the plan-step span that submitted them
        "start_ms": round((sp.t0 - t0_root) * 1e3, 3),
        "duration_ms": round(sp.duration() * 1e3, 3),
        "thread": sp.thread_name or str(sp.thread_id),
        "children": [],
    }
    if sp.attrs:
        rec["attrs"] = dict(sp.attrs)
    return rec


def build_tree(spans: list[Span]) -> dict:
    """Parent-linked tree from one trace's completed spans. The root
    (parent_id None) becomes the record; orphans whose parent was
    dropped from the buffer attach under the root so nothing recorded
    is silently lost."""
    root_sp = next((s for s in spans if s.parent_id is None),
                   spans[0])
    nodes = {s.span_id: _node(s, root_sp.t0) for s in spans}
    root = nodes[root_sp.span_id]
    for s in spans:
        if s.span_id == root_sp.span_id:
            continue
        parent = nodes.get(s.parent_id) if s.parent_id else None
        (parent or root)["children"].append(nodes[s.span_id])
    for n in nodes.values():
        n["children"].sort(key=lambda c: c["start_ms"])
    root["trace_id"] = root_sp.trace_id
    root["pid"] = os.getpid()  # the stitched export's process track
    root["ts"] = datetime.datetime.fromtimestamp(
        root_sp.t0 + _EPOCH_OFFSET,
        datetime.timezone.utc).isoformat(timespec="milliseconds")
    root["span_count"] = len(spans)
    return root


class FlightRecorder:
    def __init__(self, max_records: int = 32,
                 max_spans_per_trace: int = 512,
                 max_open_traces: int = 64):
        self.max_records = max_records
        self.max_spans_per_trace = max_spans_per_trace
        self.max_open_traces = max_open_traces
        self._records: deque[dict] = deque(maxlen=max_records)
        self._open: OrderedDict[str, list] = OrderedDict()
        self._overflow: dict[str, int] = {}
        self.records_dropped = 0
        self._dump_seq = itertools.count(1)
        self._lock = threading.Lock()

    # the tracer listener: called once per COMPLETED span, any thread
    def on_span(self, sp: Span) -> None:
        if not sp.trace_id.startswith(WATCH_PREFIXES):
            return
        with self._lock:
            bucket = self._open.get(sp.trace_id)
            if bucket is None:
                bucket = self._open[sp.trace_id] = []
                while len(self._open) > self.max_open_traces:
                    # oldest in-flight trace never rooted — evict
                    stale_id, _ = self._open.popitem(last=False)
                    self._overflow.pop(stale_id, None)
            # the root is always kept (the tree is built around it),
            # even when the per-trace buffer already overflowed
            if (len(bucket) < self.max_spans_per_trace
                    or sp.parent_id is None):
                bucket.append(sp)
            else:
                self._overflow[sp.trace_id] = \
                    self._overflow.get(sp.trace_id, 0) + 1
            if sp.parent_id is not None:
                return
            # root closed (roots always close last): finalize
            spans = self._open.pop(sp.trace_id)
            dropped = self._overflow.pop(sp.trace_id, 0)
            tree = build_tree(spans)
            if dropped:
                tree["spans_dropped"] = dropped
            if len(self._records) == self._records.maxlen:
                self.records_dropped += 1
            self._records.append(tree)

    @staticmethod
    def _matches(rec: dict, trace_id: str | None,
                 kind: str | None) -> bool:
        if trace_id is not None:
            # a batch tree runs under its OWN trace but links back to
            # the request trace that anchored it (parent_trace) — a
            # trace_id query returns both, which is exactly what the
            # fleet stitcher pulls per worker
            if rec.get("trace_id") != trace_id and \
                    (rec.get("attrs") or {}).get("parent_trace") \
                    != trace_id:
                return False
        if kind is not None:
            # root names are request.<kind> / batch.<kind>
            if rec.get("name", "").partition(".")[2] != kind:
                return False
        return True

    def snapshot(self, n: int | None = None,
                 trace_id: str | None = None,
                 kind: str | None = None) -> list[dict]:
        """Newest-first copy of the ring; ``trace_id``/``kind`` filter
        (applied BEFORE ``n`` truncates, so a filtered query still
        sees the whole ring)."""
        with self._lock:
            out = list(self._records)[::-1]
        if trace_id is not None or kind is not None:
            out = [r for r in out
                   if self._matches(r, trace_id, kind)]
        return out[:n] if n is not None else out

    def to_dict(self, n: int | None = None,
                trace_id: str | None = None,
                kind: str | None = None) -> dict:
        recs = self.snapshot(n, trace_id=trace_id, kind=kind)
        return {
            "records": recs,
            "count": len(recs),
            "max_records": self.max_records,
            "records_dropped": self.records_dropped,
        }

    def dump(self, directory: str = ".",
             prefix: str = "goleft-serve-flight") -> str:
        """Write the ring to ``<dir>/<prefix>-<utc ts>-<seq>.json``
        (atomic); returns the path. The SIGUSR1 handler's body.

        The monotonic per-recorder sequence makes the name unique even
        when two dumps land inside one timestamp granule (two SIGUSR1s
        in quick succession used to overwrite each other — the second
        dump silently destroyed the first incident's evidence)."""
        ts = datetime.datetime.now(datetime.timezone.utc) \
            .strftime("%Y%m%dT%H%M%S")
        path = os.path.join(
            directory, f"{prefix}-{ts}-{next(self._dump_seq):03d}.json")
        doc = {
            "ts": datetime.datetime.now(datetime.timezone.utc)
            .isoformat(timespec="seconds"),
            **self.to_dict(),
        }
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1)
            fh.write("\n")
        os.replace(tmp, path)
        return path
