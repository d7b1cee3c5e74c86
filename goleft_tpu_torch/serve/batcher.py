"""Request micro-batcher: coalesce concurrent requests into one pass.

Requests arrive on HTTP handler threads; each ``submit`` enqueues a
work item and blocks until its batch executes. A single dispatcher
thread anchors a batch on the oldest queued item, then keeps pulling
compatible items (same group key — same endpoint + parameter/geometry
signature) until the batching window closes or the batch is full, and
runs ``run_batch(key, payloads)`` once for all of them. Dispatches are
serialized by construction — concurrency lives in the batch width,
not in competing device passes.

Bounds and failure behavior:

  - admission control: ``submit`` raises :class:`Overloaded` when the
    queue already holds ``max_queue`` items (the server maps it to
    HTTP 429) — a burst beyond capacity degrades loudly instead of
    growing an unbounded backlog
  - per-request deadline: an item still queued past its deadline is
    failed with :class:`DeadlineExceeded` (HTTP 504) at batch-
    formation time — expired items never ride into a wasted device
    pass; once its batch starts executing a request runs to
    completion. ``grace_s`` is how long past its deadline a waiter
    lets a STARTED batch deliver (execution time is the executor's
    business, not the queue's)
  - poison isolation (``bisect_isolation``): a failed multi-request
    pass is bisected — each half re-dispatched — until the failure is
    narrowed to the request(s) that actually cause it. An isolated
    permanent failure with succeeding siblings fails alone as
    :class:`PoisonRequest` (HTTP 400) while its neighbors get their
    byte-identical results; a pass where *nobody* survives keeps the
    original error (systemic — the server's circuit breaker's
    business)
  - hung-dispatch watchdog (``watchdog_s``): each pass runs on an
    expendable worker thread; a pass exceeding the budget is
    abandoned (its eventual results discarded) and its items re-queued
    at the FRONT once (``max_requeues``), then failed with
    :class:`WatchdogTimeout` (HTTP 504) — a wedged device pass costs
    one budget, not the whole dispatcher
  - drain: ``close(drain=True)`` stops admission and lets the
    dispatcher finish everything already queued — the SIGTERM path
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, Sequence


class Overloaded(RuntimeError):
    """Queue full (or draining) — the caller should shed load (429)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before its batch executed (504)."""


class WatchdogTimeout(DeadlineExceeded):
    """The request's dispatch hung past the watchdog budget even after
    a re-queue (504) — the device pass was abandoned, not wedged on."""


class PoisonRequest(RuntimeError):
    """This request's payload permanently fails the executor while its
    batch siblings succeed — isolated by bisection, the server maps it
    to HTTP 400 so one bad request cannot 500 its neighbors."""

    def __init__(self, cause: BaseException):
        super().__init__(f"request poisoned its batch: {cause!r}")
        self.cause = cause


@dataclass(eq=False)  # identity semantics: deque remove/in must not
class _Item:          # compare payloads
    seq: int
    key: Hashable
    payload: Any
    deadline: float  # time.monotonic() when the item expires
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: BaseException | None = None
    requeues: int = 0
    enqueued: float = 0.0  # time.monotonic() at admission
    ctx: Any = None  # submitter's SpanContext: the batch trace links
    #                  back to the anchor's request trace through it

    def finish(self, result=None, error=None) -> None:
        self.result = result
        self.error = error
        self.done.set()


class MicroBatcher:
    """``run_batch(key, payloads) -> results`` (one result per payload,
    in order) executed over coalesced same-key batches."""

    def __init__(self, run_batch: Callable[[Hashable, Sequence], list],
                 window_s: float = 0.01, max_batch: int = 16,
                 max_queue: int = 64, metrics=None,
                 grace_s: float = 0.05,
                 bisect_isolation: bool = True,
                 classify: Callable[[BaseException], str] | None = None,
                 watchdog_s: float | None = None,
                 max_requeues: int = 1):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 (got {max_batch})")
        if grace_s <= 0:
            raise ValueError(f"grace_s must be > 0 (got {grace_s})")
        self._run_batch = run_batch
        self.window_s = window_s
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.metrics = metrics
        self.grace_s = grace_s
        self.bisect_isolation = bisect_isolation
        self.watchdog_s = watchdog_s
        self.max_requeues = max_requeues
        if classify is None:
            # transient-vs-permanent table shared with the retry layer
            from ..resilience.policy import DEFAULT_POLICY

            classify = DEFAULT_POLICY.classify
        self._classify = classify
        self._q: deque[_Item] = deque()
        self._cond = threading.Condition()
        self._seq = itertools.count()
        self._accepting = True
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="goleft-serve-batcher")
        self._thread.start()

    # ---- producer side (handler threads) ----

    def submit(self, key: Hashable, payload, timeout_s: float = 120.0):
        """Block until the item's batch ran; return its result or
        re-raise its error. ``timeout_s`` is the full request deadline
        (queue wait + execution)."""
        from .. import obs

        deadline = time.monotonic() + timeout_s
        ctx = obs.capture()  # outside the lock: a thread-local read
        with self._cond:
            if not self._accepting:
                raise Overloaded("server is draining")
            if len(self._q) >= self.max_queue:
                if self.metrics is not None:
                    self.metrics.inc("rejected_total")
                raise Overloaded(
                    f"queue full ({self.max_queue} requests pending)")
            item = _Item(next(self._seq), key, payload, deadline,
                         enqueued=time.monotonic(), ctx=ctx)
            self._q.append(item)
            self._cond.notify_all()
        # wait past the deadline by the grace period: if the batch
        # STARTED in time it should be allowed to deliver
        while not item.done.wait(timeout=max(
                self.grace_s, deadline - time.monotonic()
                + self.grace_s)):
            with self._cond:
                if item in self._q and time.monotonic() > deadline:
                    # still queued and expired — withdraw it ourselves
                    self._q.remove(item)
                    item.finish(error=DeadlineExceeded(
                        f"request expired after {timeout_s:g}s in queue"))
                    break
        if item.error is not None:
            raise item.error
        return item.result

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._q)

    # ---- consumer side (the one dispatcher thread) ----

    def _purge_expired(self, now: float) -> None:
        """Fail every queued item whose deadline already passed (holds
        the lock): expired work must never ride into a device pass."""
        expired = [it for it in self._q if it.deadline < now]
        for it in expired:
            self._q.remove(it)
            it.finish(error=DeadlineExceeded(
                "request expired in queue"))
            if self.metrics is not None:
                self.metrics.inc("deadline_timeouts_total")

    def _take_batch(self) -> list[_Item] | None:
        """Anchor on the oldest live item, then collect same-key items
        until the window closes or the batch fills. Returns None when
        stopping with an empty queue."""
        with self._cond:
            while True:
                self._purge_expired(time.monotonic())
                if self._q:
                    break
                if self._stopped:
                    return None
                self._cond.wait(timeout=0.1)
            anchor = self._q.popleft()
            batch = [anchor]
            window_end = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                self._purge_expired(time.monotonic())
                matched = [it for it in self._q if it.key == anchor.key]
                for it in matched[: self.max_batch - len(batch)]:
                    self._q.remove(it)
                    batch.append(it)
                remaining = window_end - time.monotonic()
                if remaining <= 0 or len(batch) >= self.max_batch:
                    break
                if self._stopped and not self._q:
                    break  # draining: nothing more can arrive
                self._cond.wait(timeout=remaining)
        return batch

    def _run_tree(self, key, items: list[_Item],
                  abandoned: threading.Event | None):
        """One coalesced pass; on failure bisect to isolate. Returns
        [(item, value_or_error, is_error)] covering every item."""
        from .. import obs

        try:
            kind = key[0] if isinstance(key, tuple) and key else key
            # the batch runs under its OWN trace (it may serve many
            # requests), but records which request trace anchored it:
            # parent_trace/parent_span name the anchor's plan-step
            # span, the link the fleet stitcher grafts the batch tree
            # back under (obs/fleetplane.py)
            link = {}
            ctx = items[0].ctx
            if ctx is not None and ctx.trace_id is not None:
                link["parent_trace"] = ctx.trace_id
                if ctx.parent_id is not None:
                    link["parent_span"] = ctx.parent_id
            with obs.trace(f"batch.{kind}", kind="serve-batch",
                           batch=len(items), **link):
                results = self._run_batch(
                    key, [it.payload for it in items])
            if len(results) != len(items):
                raise RuntimeError(
                    f"executor returned {len(results)} results for "
                    f"a batch of {len(items)}")
        except BaseException as e:  # noqa: BLE001 — batch isolation
            if len(items) == 1 or not self.bisect_isolation \
                    or (abandoned is not None and abandoned.is_set()):
                return [(it, e, True) for it in items]
            # bisect: re-dispatch each half so a poison request fails
            # alone and its neighbors still get their (deterministic,
            # byte-identical) results
            if self.metrics is not None:
                self.metrics.inc("bisect_splits_total")
            mid = len(items) // 2
            return self._run_tree(key, items[:mid], abandoned) + \
                self._run_tree(key, items[mid:], abandoned)
        return [(it, res, False) for it, res in zip(items, results)]

    def _dispatch_batch(self, key, items: list[_Item],
                        abandoned: threading.Event | None = None) \
            -> None:
        """Run the pass (with isolation) and finish every item. An
        isolated permanent failure among succeeding siblings is a
        poison request; a pass with zero survivors keeps its original
        (systemic) error."""
        outcomes = self._run_tree(key, items, abandoned)
        n_ok = sum(1 for _, _, is_err in outcomes if not is_err)
        for it, val, is_err in outcomes:
            # finishing must be atomic with the watchdog's
            # abandon+requeue decision (which holds the cond): an item
            # is either finished HERE or re-queued THERE, never both.
            # An unlocked abandoned-check raced the watchdog — the
            # worker could finish an item the watchdog had already
            # re-queued, double-dispatching it (one wasted device
            # pass, and the late pass overwrote the waiter's result).
            with self._cond:
                if abandoned is not None and abandoned.is_set():
                    return  # the watchdog owns these items now
                if not is_err:
                    it.finish(result=val)
                elif n_ok > 0 and self._classify(val) == "permanent":
                    if self.metrics is not None:
                        self.metrics.inc("poison_total")
                    it.finish(error=PoisonRequest(val))
                else:
                    it.finish(error=val)

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            if self.metrics is not None:
                self.metrics.observe_batch(len(batch))
            key = batch[0].key
            if self.watchdog_s is None:
                self._dispatch_batch(key, batch)
                continue
            # watchdog: the pass runs on an expendable worker; a hang
            # is abandoned and the items re-queued instead of wedging
            # this (the only) dispatcher thread
            abandoned = threading.Event()
            worker = threading.Thread(
                target=self._dispatch_batch, args=(key, batch,
                                                   abandoned),
                daemon=True, name="goleft-serve-dispatch")
            worker.start()
            worker.join(self.watchdog_s)
            if not worker.is_alive():
                continue
            if self.metrics is not None:
                self.metrics.inc("watchdog_requeues_total")
            with self._cond:
                # the abandon flag flips under the SAME cond the
                # worker finishes under: after this block no straggler
                # can deliver into a re-queued item
                abandoned.set()
                for it in reversed(batch):
                    if it.done.is_set():
                        continue  # finished before the abandon flag
                    it.requeues += 1
                    if it.requeues > self.max_requeues:
                        it.finish(error=WatchdogTimeout(
                            f"dispatch exceeded the {self.watchdog_s:g}s "
                            f"watchdog budget {it.requeues} times"))
                    else:
                        # front of the queue: they are the oldest work
                        self._q.appendleft(it)
                self._cond.notify_all()

    # ---- lifecycle ----

    def queue_age_s(self) -> float:
        """Seconds the OLDEST queued item has been waiting (0 when
        empty) — the admission layer's backlog-pressure signal: a
        growing queue age means dispatches are not keeping up."""
        with self._cond:
            if not self._q:
                return 0.0
            oldest = min(it.enqueued for it in self._q)
            return max(0.0, time.monotonic() - oldest)

    def close(self, drain: bool = True) -> None:
        """Stop admission; with ``drain`` finish queued work first,
        else fail everything still queued. Idempotent."""
        with self._cond:
            self._accepting = False
            if not drain:
                while self._q:
                    self._q.popleft().finish(
                        error=Overloaded("server shutting down"))
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=60.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ContinuousBatcher(MicroBatcher):
    """Continuous batching: no fixed coalescing window.

    The window batcher holds every batch anchor for ``window_s`` hoping
    compatible requests arrive — a latency tax paid by EVERY request,
    sized by hand against dispatch costs. Continuous batching
    drops the wait entirely: a dispatch forms from whatever compatible
    work is queued *right now* and leaves immediately. Coalescing still
    happens — better, under load — because dispatches are serialized on
    the one dispatcher thread: every request that arrives while pass N
    occupies the device joins the batch for pass N+1. The previous
    pass's duration is the coalescing horizon, which self-sizes to the
    actual dispatch cost instead of a static knob:

      - idle service: a lone request dispatches with zero added
        latency (the window batcher charged it ``window_s``)
      - loaded service: arrivals during an in-flight pass accumulate
        and ride the next dispatch — max_batch-wide passes under
        saturation, exactly when batching pays

    Everything else — admission bound (429), deadlines (504), poison
    bisection, the hung-dispatch watchdog, drain — is inherited
    unchanged from :class:`MicroBatcher`; only batch *formation*
    differs, and the executors are batch-composition-invariant, so
    responses are byte-identical between the two batchers.
    """

    def __init__(self, run_batch: Callable[[Hashable, Sequence], list],
                 max_batch: int = 16, max_queue: int = 64,
                 metrics=None, grace_s: float = 0.05,
                 bisect_isolation: bool = True,
                 classify: Callable[[BaseException], str] | None = None,
                 watchdog_s: float | None = None,
                 max_requeues: int = 1, **_ignored_window):
        # window_s=0.0 documents intent; _take_batch below never
        # consults it (an accidental window_s kwarg is swallowed so
        # callers can switch batchers without re-plumbing)
        super().__init__(run_batch, window_s=0.0, max_batch=max_batch,
                         max_queue=max_queue, metrics=metrics,
                         grace_s=grace_s,
                         bisect_isolation=bisect_isolation,
                         classify=classify, watchdog_s=watchdog_s,
                         max_requeues=max_requeues)

    def _take_batch(self) -> list[_Item] | None:
        """Anchor on the oldest live item and sweep every compatible
        item already queued — no wait, no window. Returns None when
        stopping with an empty queue."""
        with self._cond:
            while True:
                self._purge_expired(time.monotonic())
                if self._q:
                    break
                if self._stopped:
                    return None
                self._cond.wait(timeout=0.1)
            anchor = self._q.popleft()
            batch = [anchor]
            matched = [it for it in self._q if it.key == anchor.key]
            for it in matched[: self.max_batch - 1]:
                self._q.remove(it)
                batch.append(it)
        return batch
