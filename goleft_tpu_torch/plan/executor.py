"""The Step executor: quarantine × retry × fault site × span. The
counterpart of the JAX package's plan/executor.py, trimmed to
``Executor.run_step`` and ``run``; checkpoint, cache and dedup are not
ported.

The composition order is the reference's:
  1. quarantine short-circuit (an already-quarantined key degrades to
     its fallback with zero work);
  2. the attempt loop under the RetryPolicy: each attempt fires the
     step's fault-injection site, then runs ``fn`` inside the step's span
     (a stage of utils/profiling.py);
  3. on exhaustion: quarantine + fallback when the step carries a
     quarantine identity and the executor a quarantine, else the failure
     lands in the outcome.
"""

from __future__ import annotations

import contextlib

from ..resilience import faults
from ..resilience.policy import DEFAULT_POLICY, RetriesExhausted
from ..utils.profiling import StageTimer
from .core import Step, StepOutcome

#: the timer every step span records into (the process totals of
#: utils/profiling.py carry them to the ``--metrics-out`` manifest)
SPANS = StageTimer()


class Executor:
    """Runs Steps under the default retry policy and, optionally, a
    quarantine."""

    policy = DEFAULT_POLICY

    def __init__(self, quarantine=None):
        self.quarantine = quarantine

    def run_step(self, step: Step) -> StepOutcome:
        q = self.quarantine
        if q is not None and step.quarantine_key is not None \
                and step.quarantine_key in q:
            return StepOutcome(
                step.key, value=step.fallback() if step.fallback else None)

        def attempt():
            if step.site:
                faults.maybe_fail(step.site, step.key)
            span = SPANS.stage(step.span) if step.span \
                else contextlib.nullcontext()
            with span:
                return step.fn()

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
        return StepOutcome(step.key, value=value, attempts=attempts)

    def run(self, step: Step):
        """run_step, raising the failure (the exhausted attempt's
        original cause) instead of returning it."""
        return self.run_step(step).value_or_raise()
