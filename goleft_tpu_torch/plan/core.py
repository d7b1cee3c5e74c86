"""Plan/Step data model: the counterpart of the JAX package's
plan/core.py, trimmed to what the pair-HMM bucket dispatch uses.

A :class:`Step` is one content-keyed unit of work: a thunk, its key
(the retry policy's jitter seed and the fault site's logged key) and
its fault-injection site. It never executes itself; the
:class:`~goleft_tpu_torch.plan.executor.Executor` runs it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class Step:
    """One content-keyed unit of work."""

    key: tuple
    fn: Callable[[], Any]
    site: str | None = None


@dataclass
class StepOutcome:
    """What running one Step produced. The executor does not raise for
    policy-managed failures: the caller reads ``error``."""

    key: tuple
    value: Any = None
    error: BaseException | None = None
    retries_exhausted: BaseException | None = None  # the RetriesExhausted
    attempts: int = 1
    classification: str = ""
