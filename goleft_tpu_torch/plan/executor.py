"""The Step executor: retry × fault site. The counterpart of the JAX
package's plan/executor.py, trimmed to ``Executor.run_step`` with
retries; quarantine, checkpoint, cache, dedup and spans are not ported
(the pair-HMM path quarantines at the caller, from the outcome).

Each attempt fires the step's fault-injection site, then runs ``fn``;
the attempts run under the RetryPolicy.
"""

from __future__ import annotations

from ..resilience import faults
from ..resilience.policy import DEFAULT_POLICY, RetriesExhausted
from .core import Step, StepOutcome


class Executor:
    """Runs Steps under the default retry policy."""

    policy = DEFAULT_POLICY

    def run_step(self, step: Step) -> StepOutcome:
        def attempt():
            if step.site:
                faults.maybe_fail(step.site, step.key)
            return step.fn()

        try:
            value, attempts = self.policy.call(step.key, attempt)
        except RetriesExhausted as rx:
            return StepOutcome(step.key, error=rx.cause,
                               retries_exhausted=rx,
                               attempts=rx.attempts,
                               classification=rx.classification)
        return StepOutcome(step.key, value=value, attempts=attempts)
