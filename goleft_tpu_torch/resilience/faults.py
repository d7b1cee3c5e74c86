"""Deterministic fault injection: the counterpart of the JAX package's
resilience/faults.py, trimmed to the exception-raising effects.

A fault plan is a list of clauses, installed with :func:`install` or
read once from ``GOLEFT_TPU_FAULTS`` (a subprocess run sets the env
var):

    spec   := clause (";" clause)*
    clause := site ":" part (":" part)*
    part   := "after=" N      fire exactly at the Nth invocation
            | "every=" N      fire at every Nth invocation
            | "times=" N      cap total firings of this clause
            | "transient" | "permanent"   (default transient)

The instrumented site of the port is ``pairhmm``: the pair-HMM
forward's per-bucket dispatch (ops/pairhmm.py). ``transient`` raises
:class:`InjectedFault` (retried by the RetryPolicy), ``permanent``
raises :class:`InjectedPermanentFault` (not re-attempted). Firing
depends only on the clause and the per-site invocation index, and
``install()`` resets the counters, so the same spec fires the same
faults every run.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

from ..obs import get_logger, get_registry

ENV_VAR = "GOLEFT_TPU_FAULTS"

log = get_logger("resilience.faults")


class InjectedFault(Exception):
    """A deterministically injected *transient* failure."""

    def __init__(self, site: str, index: int, clause: str = ""):
        super().__init__(
            f"injected fault at site {site!r} (invocation {index}"
            f"{', clause ' + clause if clause else ''})")
        self.site = site
        self.index = index


class InjectedPermanentFault(InjectedFault):
    """A deterministically injected *permanent* failure."""


@dataclass
class FaultClause:
    site: str
    kind: str = "transient"  # transient | permanent
    after: int | None = None
    every: int | None = None
    times: int | None = None
    spec: str = ""
    fired: int = field(default=0, compare=False)

    def should_fire(self, index: int) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if self.after is not None and index == self.after:
            return True
        return self.every is not None and index % self.every == 0


def parse_faults(spec: str) -> list[FaultClause]:
    """Parse a fault spec (grammar in the module docstring); raises
    ValueError with the offending clause on anything malformed."""
    clauses: list[FaultClause] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"fault clause {raw!r}: need site:trigger (e.g. "
                "pairhmm:after=3:transient)")
        c = FaultClause(site=parts[0].strip(), spec=raw)
        for part in parts[1:]:
            part = part.strip()
            key, _, val = part.partition("=")
            try:
                if key == "after":
                    c.after = int(val)
                elif key == "every":
                    c.every = int(val)
                elif key == "times":
                    c.times = int(val)
                elif part in ("transient", "permanent"):
                    c.kind = part
                else:
                    raise ValueError(f"unknown part {part!r}")
            except ValueError as e:
                raise ValueError(
                    f"fault clause {raw!r}: {e}") from None
        if c.after is None and c.every is None:
            raise ValueError(
                f"fault clause {raw!r}: needs one of after=/every=")
        if c.after and c.every:
            raise ValueError(
                f"fault clause {raw!r}: after= and every= are exclusive")
        clauses.append(c)
    if not clauses:
        raise ValueError(f"empty fault spec: {spec!r}")
    return clauses


class FaultPlan:
    """Parsed clauses + per-site invocation counters (thread-safe)."""

    def __init__(self, clauses: list[FaultClause]):
        self.clauses = clauses
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def check(self, site: str, key=None) -> None:
        with self._lock:
            index = self._counts.get(site, 0) + 1
            self._counts[site] = index
            fire = None
            for c in self.clauses:
                if c.site == site and c.should_fire(index):
                    c.fired += 1
                    fire = c
                    break
        if fire is None:
            return
        get_registry().counter("resilience.faults_injected_total").inc()
        get_registry().counter(
            f"resilience.faults_injected.{site}_total").inc()
        log.warning("injected %s fault at site %s invocation %d "
                    "(key %r)", fire.kind, site, index, key)
        if fire.kind == "permanent":
            raise InjectedPermanentFault(site, index, fire.spec)
        raise InjectedFault(site, index, fire.spec)


_UNINIT = object()
_PLAN: FaultPlan | None | object = _UNINIT
_PLAN_LOCK = threading.Lock()


def install(spec: str | None) -> FaultPlan | None:
    """Install (or with None/"" clear) the process fault plan."""
    global _PLAN
    with _PLAN_LOCK:
        _PLAN = FaultPlan(parse_faults(spec)) if spec else None
        return _PLAN


def get_plan() -> FaultPlan | None:
    """The active plan: an installed one, else ``GOLEFT_TPU_FAULTS``
    read once at first use."""
    global _PLAN
    if _PLAN is _UNINIT:
        with _PLAN_LOCK:
            if _PLAN is _UNINIT:
                env = os.environ.get(ENV_VAR)
                _PLAN = FaultPlan(parse_faults(env)) if env else None
    return _PLAN  # type: ignore[return-value]


def maybe_fail(site: str, key=None) -> None:
    """The hook instrumented call sites invoke; a near-free no-op when
    no plan is active."""
    plan = get_plan()
    if plan is not None:
        plan.check(site, key)
