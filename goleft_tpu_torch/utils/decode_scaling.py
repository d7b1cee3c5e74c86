"""Decode-pool sizing: ``effective_cores`` and ``auto_processes``, copied
from the JAX package's utils/decode_scaling.py (its scaling measurement
is not ported)."""

from __future__ import annotations

import os


def effective_cores() -> int:
    """Affinity/cgroup-aware core count (a container pinned to 1 CPU on
    a 64-core host must count as 1)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover - non-Linux
        return os.cpu_count() or 1


def auto_processes(cap: int = 8) -> int:
    """Affinity-aware default worker count for decode pools: one per
    effective core, capped. On a 1-core host this is 1, which routes
    the cohort engine onto its serial path (no thread churn)."""
    return max(1, min(cap, effective_cores()))
