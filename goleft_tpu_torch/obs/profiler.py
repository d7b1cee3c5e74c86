"""Stdlib-only sampling profiler: where the host CPU time goes.

Span boundaries say a worker spent 1.8s in ``host-decode``; they
cannot say whether that was inflate, CRC, numpy windowing or lock
wait. This sampler fills that gap without a single dependency:
``sys._current_frames()`` at a fixed rate on a supervised background
thread, every thread's stack collapsed to the flamegraph-standard
semicolon form (root first, frames keyed ``module:func:line``) and
aggregated into a bounded counter table.

Design points:

  - **off by default** (``hz=0``): a profiler nobody asked for costs
    literally nothing — no thread, no samples;
  - **bounded**: the distinct-stack table caps at ``max_stacks``;
    beyond it new stacks are dropped and counted
    (``profiler.stacks_dropped_total``) rather than growing a
    long-lived daemon — the hot stacks a flamegraph is for are by
    definition already in the table;
  - **deterministic aggregation**: the frame key is
    ``module:func:line`` — no addresses, no ids — so two samples of
    the same code point always merge, across threads and (at the
    fleet rollup) across processes;
  - **cheap**: per-(code, line) key strings are memoized, so steady-
    state sampling is a dict walk — the pinned overhead test bounds
    100 Hz at <= 2% of wall on the depth pipeline;
  - **trace-linked**: a sample taken while a thread is inside a
    traced request (``Tracer.active_traces()``) tags that trace id,
    so a flamegraph window can be tied back to its stitched trace;
  - **supervised**: the sampler thread is joined by :meth:`close`
    (the thr-unjoined contract every serve daemon thread follows).

The worker surface is ``GET /debug/profile?seconds=N`` — a collect-
then-respond window over the continuously-sampling table (delta of
two snapshots) — and the router merges windows stack-wise at
``GET /fleet/profile`` (:func:`merge_profiles`: exact arithmetic
sums).

A copy of the JAX package's obs/profiler.py, which imports no JAX.
"""

from __future__ import annotations

import sys
import threading
import time

from .metrics import get_registry

#: response/document schema for /debug/profile and /fleet/profile
PROFILE_SCHEMA = "goleft-tpu.profile/1"

#: hard ceiling on one collect window (the HTTP surface clamps to it:
#: a typo'd ?seconds= must not pin a handler thread for an hour)
MAX_WINDOW_S = 120.0

#: bounded memo: (code object, lineno) -> "module:func:line". Cleared
#: wholesale past the cap — code objects are long-lived, the memo is
#: what makes steady-state sampling a dict walk
_KEY_MEMO_CAP = 8192

#: frames deeper than this are truncated with a sentinel — a runaway
#: recursion must not make one sample O(recursion limit)
MAX_DEPTH = 64


def collapse_frame(frame, memo: dict | None = None,
                   max_depth: int = MAX_DEPTH) -> str:
    """One thread's stack as the collapsed-flamegraph line body:
    root-first ``module:func:line`` frames joined by ``;``."""
    parts: list[str] = []
    depth = 0
    while frame is not None and depth < max_depth:
        code = frame.f_code
        lineno = frame.f_lineno
        key = None
        mk = (code, lineno)
        if memo is not None:
            key = memo.get(mk)
        if key is None:
            mod = frame.f_globals.get("__name__", "?")
            key = f"{mod}:{code.co_name}:{lineno}"
            if memo is not None:
                if len(memo) >= _KEY_MEMO_CAP:
                    memo.clear()
                memo[mk] = key
        parts.append(key)
        frame = frame.f_back
        depth += 1
    if frame is not None:
        parts.append("~truncated~")
    parts.reverse()
    return ";".join(parts)


class SamplingProfiler:
    """Background wall-clock sampler over ``sys._current_frames()``.

    ``clock`` and ``frames_provider`` are injectable (tests pin the
    collapsed output and the table bounds deterministically without a
    real thread); production uses the defaults. ``registry=None``
    publishes into the process registry."""

    def __init__(self, hz: float = 0.0, max_stacks: int = 4096,
                 registry=None, tracer=None, clock=None,
                 frames_provider=None):
        if hz < 0:
            raise ValueError(f"profile hz must be >= 0 (got {hz})")
        self.hz = float(hz)
        self.max_stacks = int(max_stacks)
        self._registry = registry
        self._tracer = tracer
        self._clock = clock if clock is not None else time.monotonic
        self._frames = frames_provider \
            if frames_provider is not None else sys._current_frames
        self._lock = threading.Lock()
        self._stacks: dict[str, int] = {}
        self._trace_ids: dict[str, int] = {}
        self._samples_total = 0
        self._stacks_dropped = 0
        self._memo: dict = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _reg(self):
        return self._registry if self._registry is not None \
            else get_registry()

    @property
    def enabled(self) -> bool:
        return self.hz > 0

    # ---- lifecycle ----

    def start(self) -> "SamplingProfiler":
        """Spawn the sampler thread (no-op when disabled). Daemon +
        joined-on-close: it must never block interpreter exit, and
        close() joins it so drain leaves no thread mutating the
        table."""
        if not self.enabled or self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="goleft-profiler")
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop and join the sampler (idempotent)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _run(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            self._sample_once()

    # ---- sampling ----

    def _sample_once(self) -> int:
        """Take one sample of every thread but our own; returns the
        number of stacks recorded (the overhead test drives this
        directly)."""
        me = threading.get_ident()
        frames = self._frames()
        active = {}
        if self._tracer is not None:
            active = self._tracer.active_traces()
        collapsed = []
        for tid, frame in frames.items():
            if tid == me:
                continue
            collapsed.append((collapse_frame(frame, self._memo),
                              active.get(tid)))
        dropped = 0
        with self._lock:
            self._samples_total += 1
            for stack, trace_id in collapsed:
                cnt = self._stacks.get(stack)
                if cnt is None:
                    if len(self._stacks) >= self.max_stacks:
                        dropped += 1
                        continue
                    self._stacks[stack] = 1
                else:
                    self._stacks[stack] = cnt + 1
                if trace_id is not None \
                        and len(self._trace_ids) < 256:
                    self._trace_ids[trace_id] = \
                        self._trace_ids.get(trace_id, 0) + 1
            self._stacks_dropped += dropped
        reg = self._reg()
        reg.counter("profiler.samples_total").inc()
        if dropped:
            reg.counter("profiler.stacks_dropped_total").inc(dropped)
        return len(collapsed)

    # ---- snapshots / windows ----

    def snapshot(self) -> dict:
        """The cumulative table (sorted stacks: deterministic
        serialization, same discipline as the metrics registry)."""
        with self._lock:
            stacks = dict(sorted(self._stacks.items()))
            traces = dict(sorted(self._trace_ids.items()))
            return {
                "schema": PROFILE_SCHEMA,
                "enabled": self.enabled,
                "hz": self.hz,
                "samples_total": self._samples_total,
                "stacks_dropped": self._stacks_dropped,
                "stacks": stacks,
                "trace_ids": traces,
            }

    def collect(self, seconds: float) -> dict:
        """Collect-then-respond: the delta the window accumulated —
        what ``GET /debug/profile?seconds=N`` returns. Disabled
        profiler -> an honest empty document (enabled: false), never
        an error: the fleet rollup must merge mixed fleets."""
        seconds = max(0.0, min(float(seconds), MAX_WINDOW_S))
        if not self.enabled:
            return self.snapshot()
        before = self.snapshot()
        deadline = self._clock() + seconds
        while self._clock() < deadline:
            if self._stop.wait(min(0.05, seconds)):
                break
        after = self.snapshot()
        return diff_profiles(before, after)


def diff_profiles(before: dict, after: dict) -> dict:
    """after - before, stack-wise (a window over the cumulative
    table). Counts are clamped at zero defensively — the table only
    grows, so a negative delta would mean a reset mid-window."""
    stacks = {}
    for k, v in after["stacks"].items():
        d = v - before["stacks"].get(k, 0)
        if d > 0:
            stacks[k] = d
    traces = {}
    for k, v in after["trace_ids"].items():
        d = v - before["trace_ids"].get(k, 0)
        if d > 0:
            traces[k] = d
    return {
        "schema": PROFILE_SCHEMA,
        "enabled": after["enabled"],
        "hz": after["hz"],
        "samples_total": max(
            0, after["samples_total"] - before["samples_total"]),
        "stacks_dropped": max(
            0, after["stacks_dropped"] - before["stacks_dropped"]),
        "stacks": dict(sorted(stacks.items())),
        "trace_ids": dict(sorted(traces.items())),
    }


def merge_profiles(bodies: list[dict]) -> dict:
    """Stack-wise counter merge across workers: exact arithmetic sums
    (equal to the sum of the inputs), sample/drop totals summed, trace ids
    unioned. ``per_worker`` is the caller's to attach."""
    stacks: dict[str, int] = {}
    traces: dict[str, int] = {}
    samples = dropped = 0
    hz = 0.0
    enabled = False
    for b in bodies:
        if not isinstance(b, dict) or "stacks" not in b:
            continue
        enabled = enabled or bool(b.get("enabled"))
        hz = max(hz, float(b.get("hz") or 0.0))
        samples += int(b.get("samples_total") or 0)
        dropped += int(b.get("stacks_dropped") or 0)
        for k, v in b["stacks"].items():
            stacks[k] = stacks.get(k, 0) + int(v)
        for k, v in (b.get("trace_ids") or {}).items():
            traces[k] = traces.get(k, 0) + int(v)
    return {
        "schema": PROFILE_SCHEMA,
        "enabled": enabled,
        "hz": hz,
        "samples_total": samples,
        "stacks_dropped": dropped,
        "stacks": dict(sorted(stacks.items())),
        "trace_ids": dict(sorted(traces.items())),
    }


def to_collapsed(doc: dict) -> str:
    """The flamegraph-compatible collapsed text form: one
    ``stack count`` line per distinct stack, sorted — feed it
    straight to flamegraph.pl / speedscope / inferno."""
    lines = [f"{stack} {count}"
             for stack, count in sorted(doc["stacks"].items())]
    return "\n".join(lines) + ("\n" if lines else "")
