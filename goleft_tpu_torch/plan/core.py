"""Plan/Step data model: the counterpart of the JAX package's
plan/core.py, trimmed to what the pair-HMM bucket dispatch and the
cohort path use.

A :class:`Step` is one content-keyed unit of work: a thunk, its key
(the retry policy's jitter seed and the fault site's logged key), its
fault-injection site, the span its attempts are timed under, and
optionally a quarantine identity with a fallback. It never executes
itself; the :class:`~goleft_tpu_torch.plan.executor.Executor` runs it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class Step:
    """One content-keyed unit of work.

    ``span``: a stage name the attempts are timed under (the
    ``--metrics-out`` manifest's ``spans``), with ``attrs``
    describing the work. ``quarantine_key`` opts the step into graceful
    degradation: a step of an already-quarantined key short-circuits to
    ``fallback()``, and a step that fails permanently quarantines its key
    and degrades to ``fallback()`` instead of raising (cohortdepth's
    per-sample contract)."""

    key: tuple
    fn: Callable[[], Any]
    site: str | None = None
    span: str | None = None
    attrs: dict = field(default_factory=dict)
    quarantine_key: Any = None
    quarantine_name: str = ""
    quarantine_source: str = ""
    fallback: Callable[[], Any] | None = None


@dataclass
class StepOutcome:
    """What running one Step produced. The executor does not raise for
    policy-managed failures: the caller reads ``error`` (or calls
    :meth:`value_or_raise`)."""

    key: tuple
    value: Any = None
    error: BaseException | None = None
    retries_exhausted: BaseException | None = None  # the RetriesExhausted
    attempts: int = 1
    classification: str = ""

    def value_or_raise(self):
        if self.error is not None:
            raise self.error
        return self.value
