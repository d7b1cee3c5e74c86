"""The Step executor: quarantine × checkpoint × cache × retry × fault
site × span × in-flight dedup. The counterpart of the JAX package's
plan/executor.py: ``Executor.run_step`` and ``run``, the in-flight step
table (:class:`InflightSteps`) and ``run_device_step``, the serve
executors' dispatch boundary.

The composition order is the reference's:
  1. quarantine short-circuit (an already-quarantined key degrades to
     its fallback with zero work);
  2. checkpoint resume (every checkpoint key committed → ``restore``,
     with no fault site, no retry and no ``fn``; the store counts it in
     ``checkpoint.shards_resumed_total``);
  3. result-cache lookup for a ``cacheable`` step (a cache I/O failure
     never fails the step: ``result_cache.io_errors_total``);
  4. the attempt loop under the RetryPolicy: each attempt fires the
     step's fault-injection site, then runs ``fn`` inside the step's span
     (a stage of utils/profiling.py); ``retry=False`` runs one attempt
     raw;
  5. on exhaustion: quarantine + fallback when the step carries a
     quarantine identity and the executor a quarantine, else the failure
     lands in the outcome;
  6. cache put, then checkpoint commit (one journal commit per step).

A step with ``dedup=True`` runs steps 4-5 through the in-flight table: a
concurrent step of the same key waits for the running one and shares
its value (a failure is never shared: the follower then computes).
"""

from __future__ import annotations

import contextlib
import threading

from ..obs import get_registry
from ..resilience import faults
from ..resilience.policy import DEFAULT_POLICY, RetriesExhausted
from ..utils.profiling import StageTimer
from .core import Step, StepOutcome

#: the timer every step span records into (the process totals of
#: utils/profiling.py carry them to the ``--metrics-out`` manifest)
SPANS = StageTimer()


class _InflightEntry:
    __slots__ = ("event", "outcome")

    def __init__(self):
        self.event = threading.Event()
        self.outcome: StepOutcome | None = None


class InflightSteps:
    """The in-flight step table: two concurrent steps with the same key
    and ``dedup=True`` share one execution. The first is the leader and
    computes; a later one is a follower and waits for the leader's
    outcome. A follower whose leader failed (or outlasted
    ``DEDUP_WAIT_S``) computes itself."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: dict = {}

    def join(self, key) -> tuple[_InflightEntry, bool]:
        """(entry, is_leader); the leader must :meth:`settle` it."""
        with self._lock:
            entry = self._inflight.get(key)
            if entry is None:
                entry = self._inflight[key] = _InflightEntry()
                return entry, True
            return entry, False

    def settle(self, key, entry: _InflightEntry,
               outcome: StepOutcome | None) -> None:
        with self._lock:
            # only our own entry: a follower that timed out and led
            # again must keep its fresh entry
            if self._inflight.get(key) is entry:
                del self._inflight[key]
        entry.outcome = outcome
        entry.event.set()

    def depth(self) -> int:
        with self._lock:
            return len(self._inflight)


#: the process-wide in-flight table
INFLIGHT = InflightSteps()

#: how long a follower waits for its leader before computing itself
DEDUP_WAIT_S = 600.0


class Executor:
    """Runs Steps under a retry policy (default: retry once) and,
    optionally, a quarantine, a checkpoint store and a result cache;
    each engages exactly when its object is given."""

    def __init__(self, quarantine=None, checkpoint=None, cache=None,
                 policy=None, inflight: InflightSteps | None = None):
        self.quarantine = quarantine
        self.checkpoint = checkpoint
        self.cache = cache
        self.policy = policy if policy is not None else DEFAULT_POLICY
        self.inflight = inflight if inflight is not None else INFLIGHT

    def run_step(self, step: Step) -> StepOutcome:
        q = self.quarantine
        if q is not None and step.quarantine_key is not None \
                and step.quarantine_key in q:
            return StepOutcome(
                step.key, value=step.fallback() if step.fallback else None)

        ck = self.checkpoint
        ck_keys = step.ck_keys() if ck is not None else []
        if step.resumable and ck_keys and all(ck.has(k) for k in ck_keys):
            vals = [ck.get(k) for k in ck_keys]
            value = step.restore(vals) if step.restore is not None \
                else vals[0] if step.checkpoint_key is not None else vals
            return StepOutcome(step.key, value=value)

        reg = get_registry()
        cached = self.cache is not None and step.cacheable
        if cached:
            try:
                hit = self.cache.get(step.key)
            except Exception:  # noqa: BLE001 — a cache never fails a step
                reg.counter("result_cache.io_errors_total").inc()
                hit = None
            if hit is not None:
                return StepOutcome(step.key, value=hit)

        def attempt():
            if step.site:
                faults.maybe_fail(step.site, step.key)
            if step.span is None:
                span = contextlib.nullcontext()
            elif step.device:
                from .. import obs

                span = obs.device_span(step.span, **step.attrs)
            else:
                span = SPANS.stage(step.span)
            with span:
                return step.fn()

        def compute() -> StepOutcome:
            if not step.retry:
                return StepOutcome(step.key, value=attempt())
            try:
                value, attempts = self.policy.call(step.key, attempt)
            except RetriesExhausted as rx:
                if q is not None and step.quarantine_key is not None:
                    q.add(step.quarantine_key, step.quarantine_name,
                          step.quarantine_source, rx.cause, rx.attempts,
                          rx.classification)
                    return StepOutcome(
                        step.key, attempts=rx.attempts,
                        classification=rx.classification, quarantined=True,
                        value=step.fallback() if step.fallback else None)
                return StepOutcome(step.key, error=rx.cause,
                                   retries_exhausted=rx,
                                   attempts=rx.attempts,
                                   classification=rx.classification)
            return StepOutcome(step.key, value=value, attempts=attempts)

        outcome = self._run_deduped(step, compute, reg) if step.dedup \
            else compute()
        if outcome.error is not None or outcome.deduped \
                or outcome.quarantined:
            # persistence is the leader's, and a failure's is nothing
            return outcome

        if cached:
            try:
                self.cache.put(step.key, outcome.value)
            except Exception:  # noqa: BLE001 — a cache never fails a step
                reg.counter("result_cache.io_errors_total").inc()
        if ck_keys:
            items = step.commit(outcome.value) if step.commit is not None \
                else [(ck_keys[0], outcome.value)]
            ck.put_many(items)
        return outcome

    def _run_deduped(self, step: Step, compute, reg) -> StepOutcome:
        """Leader or follower through the in-flight table; an exception
        out of the leader's ``compute()`` still settles the entry."""
        entry, leader = self.inflight.join(step.key)
        if leader:
            outcome = None
            try:
                outcome = compute()
            finally:
                self.inflight.settle(step.key, entry, outcome)
            return outcome
        reg.counter("plan.steps_deduped_total").inc()
        shared = entry.outcome if entry.event.wait(DEDUP_WAIT_S) else None
        if shared is not None and shared.error is None \
                and not shared.quarantined:
            return StepOutcome(step.key, value=shared.value, deduped=True)
        reg.counter("plan.dedup_fallbacks_total").inc()
        return compute()

    def run(self, step: Step):
        """run_step, raising the failure (the exhausted attempt's
        original cause) instead of returning it."""
        return self.run_step(step).value_or_raise()


def run_device_step(name: str, fn, *, key=None, metrics=None,
                    policy=None, retry: bool = True, dedup: bool = False,
                    count_passes: bool = False, signature=None, **attrs):
    """One serve device dispatch as a Step: the ``compute`` stage of
    ``metrics`` and a device span named ``name`` (with ``attrs``), the
    ``device`` fault site fired per attempt, retried under the policy
    (a ``KernelFault`` is not retried: the batcher and the breaker take
    it). ``signature`` (the launch geometry) goes to the compile
    observatory, whose first sight of it is the family's first launch;
    the memory plane attributes the dispatch's device bytes to the
    family. ``count_passes`` counts ``device_passes_total`` for an
    executed (not deduped) step. Raises the failure."""
    from ..obs.compiles import TRACKER, family_of_dispatch
    from ..obs.memplane import TRACKER as MEMORY

    family = family_of_dispatch(name)

    def staged():
        cm = metrics.timer.stage("compute") if metrics is not None \
            else contextlib.nullcontext()
        with cm, TRACKER.observe(family, signature=signature,
                                 trigger=name), MEMORY.observe(family):
            return fn()

    ex = Executor(policy=policy)
    out = ex.run_step(Step(key=key if key is not None else (name,),
                           fn=staged, site="device", retry=retry,
                           dedup=dedup, span=name, device=True,
                           attrs=attrs))
    if count_passes and metrics is not None and not out.deduped \
            and out.error is None:
        metrics.inc("device_passes_total")
    return out.value_or_raise()
