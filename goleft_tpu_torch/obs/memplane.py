"""Memory plane of the port: the chunk auto-sizing that ``cohortscan
--chunk-samples 0`` consumes, copied from the JAX package's
obs/memplane.py. The rest of that module (the process sampler, device
attribution per dispatch family, the fleet roll-up) is not ported yet."""

from __future__ import annotations


def auto_chunk_samples(per_sample_bytes: int, budget_bytes: int,
                       n_samples: int, minimum: int = 8,
                       maximum: int = 4096) -> int:
    """Size a cohort chunk so one chunk's matrices fit the budget:
    ``budget / per_sample`` clamped to [minimum, min(maximum,
    n_samples)]. A zero/unknown per-sample measurement falls back to
    the maximum (no evidence → no constraint)."""
    if per_sample_bytes <= 0 or budget_bytes <= 0:
        return min(maximum, max(minimum, n_samples))
    fit = budget_bytes // per_sample_bytes
    return int(max(minimum, min(maximum, n_samples, fit)))
