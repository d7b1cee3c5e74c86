"""Plan/Step data model: the counterpart of the JAX package's
plan/core.py, trimmed to what the depth scheduler, the pair-HMM bucket
dispatch, the cohort path and the remote fetches use.

A :class:`Step` is one content-keyed unit of work: a thunk, its key
(the retry policy's jitter seed, the fault site's logged key, the result
cache's key), its fault-injection site, the span its attempts are timed
under, optionally checkpoint keys with restore/commit adapters, and
optionally a quarantine identity with a fallback. It never executes
itself; the :class:`~goleft_tpu_torch.plan.executor.Executor` runs it,
so the composition order is defined in one place.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Sequence


@dataclass
class Step:
    """One content-keyed unit of work.

    ``span``: a stage name the attempts are timed under (the
    ``--metrics-out`` manifest's ``spans``), with ``attrs`` describing
    the work. ``cacheable`` looks the value up in (and puts it into) the
    executor's result cache under ``key``.

    ``checkpoint_key``/``checkpoint_keys`` make the step resumable: a
    step whose every key is committed in the executor's store is
    *restored* (``restore(values)``; default: the single value) with no
    fault site, no retry and no ``fn``. After a fresh compute,
    ``commit`` maps the value to ``(key, block)`` pairs persisted in ONE
    journal commit (default: ``[(checkpoint_key, value)]``).

    ``quarantine_key`` opts the step into graceful degradation: a step
    of an already-quarantined key short-circuits to ``fallback()``, and
    a step that fails permanently quarantines its key and degrades to
    ``fallback()`` instead of raising (cohortdepth's per-sample
    contract).

    ``resumable=False`` keeps the commit but never restores: a step
    whose value threads into the next (the chunked cohort's carry) is
    resumed by its caller.

    ``retry=False`` runs ``fn`` outside the retry policy (errors
    propagate raw) but keeps the fault site and the checkpoint: the
    cohort's region steps, whose inner work carries its own per-sample
    policy.

    ``dedup=True`` joins the executor's in-flight step table: a
    concurrent step with the same key shares the running execution
    instead of starting its own (serve's identical concurrent
    requests). Only for keys that are full content identity. ``device``
    times the attempts under a device span (``obs.device_span``)
    instead of a stage."""

    key: tuple
    fn: Callable[[], Any]
    name: str = ""
    site: str | None = None
    retry: bool = True
    resumable: bool = True
    cacheable: bool = False
    checkpoint_key: tuple | None = None
    checkpoint_keys: Sequence[tuple] | None = None
    restore: Callable[[list], Any] | None = None
    commit: Callable[[Any], Sequence[tuple]] | None = None
    span: str | None = None
    attrs: dict = field(default_factory=dict)
    dedup: bool = False
    device: bool = False
    quarantine_key: Any = None
    quarantine_name: str = ""
    quarantine_source: str = ""
    fallback: Callable[[], Any] | None = None

    def ck_keys(self) -> list[tuple]:
        """The step's checkpoint keys as a list."""
        if self.checkpoint_keys is not None:
            return list(self.checkpoint_keys)
        if self.checkpoint_key is not None:
            return [self.checkpoint_key]
        return []


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
    deduped: bool = False  # the value of a concurrent execution
    quarantined: bool = False  # the fallback of a quarantined key

    def value_or_raise(self):
        if self.error is not None:
            raise self.error
        return self.value
