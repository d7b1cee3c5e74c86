"""The Step executor: quarantine × checkpoint × cache × retry × fault
site × span. The counterpart of the JAX package's plan/executor.py,
trimmed to ``Executor.run_step`` and ``run`` (no in-flight dedup: that
is serve's).

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
"""

from __future__ import annotations

import contextlib

from ..obs import get_registry
from ..resilience import faults
from ..resilience.policy import DEFAULT_POLICY, RetriesExhausted
from ..utils.profiling import StageTimer
from .core import Step, StepOutcome

#: the timer every step span records into (the process totals of
#: utils/profiling.py carry them to the ``--metrics-out`` manifest)
SPANS = StageTimer()


class Executor:
    """Runs Steps under a retry policy (default: retry once) and,
    optionally, a quarantine, a checkpoint store and a result cache;
    each engages exactly when its object is given."""

    def __init__(self, quarantine=None, checkpoint=None, cache=None,
                 policy=None):
        self.quarantine = quarantine
        self.checkpoint = checkpoint
        self.cache = cache
        self.policy = policy if policy is not None else DEFAULT_POLICY

    def run_step(self, step: Step) -> StepOutcome:
        q = self.quarantine
        if q is not None and step.quarantine_key is not None \
                and step.quarantine_key in q:
            return StepOutcome(
                step.key, value=step.fallback() if step.fallback else None)

        ck = self.checkpoint
        ck_keys = step.ck_keys() if ck is not None else []
        if ck_keys and all(ck.has(k) for k in ck_keys):
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
            span = SPANS.stage(step.span) if step.span \
                else contextlib.nullcontext()
            with span:
                return step.fn()

        if not step.retry:
            outcome = StepOutcome(step.key, value=attempt())
        else:
            try:
                value, attempts = self.policy.call(step.key, attempt)
            except RetriesExhausted as rx:
                if q is not None and step.quarantine_key is not None:
                    q.add(step.quarantine_key, step.quarantine_name,
                          step.quarantine_source, rx.cause, rx.attempts,
                          rx.classification)
                    return StepOutcome(
                        step.key, attempts=rx.attempts,
                        classification=rx.classification,
                        value=step.fallback() if step.fallback else None)
                return StepOutcome(step.key, error=rx.cause,
                                   retries_exhausted=rx,
                                   attempts=rx.attempts,
                                   classification=rx.classification)
            outcome = StepOutcome(step.key, value=value,
                                  attempts=attempts)

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

    def run(self, step: Step):
        """run_step, raising the failure (the exhausted attempt's
        original cause) instead of returning it."""
        return self.run_step(step).value_or_raise()
