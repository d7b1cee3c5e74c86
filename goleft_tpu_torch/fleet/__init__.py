"""Multi-worker serve fleet: affinity router + admission control. The
port's copy of the JAX package's fleet/ package, in front of the port's
``serve`` workers on the card; no module here imports torch.

The serve daemon (goleft_tpu_torch/serve/) is one process — correct and
hardened, but structurally capped at single-process throughput. The
fleet layer scales it horizontally without touching the workers:

  - :mod:`~goleft_tpu_torch.fleet.router`: a thin stdlib HTTP router in
    front of N ``goleft-tpu-torch serve`` workers. Requests route by
    file-identity affinity (consistent hash on the inputs' ``file_key``)
    so each worker's ResultCache and warm kernels keep seeing the
    same files; workers are health-checked via ``/healthz`` and their
    per-endpoint circuit-breaker state is imported from ``/metrics``,
    so a worker with (say) ``pairhmm`` tripped sheds only pairhmm
    traffic while its depth traffic keeps landing there.
  - :mod:`~goleft_tpu_torch.fleet.admission`: admission control in front of
    the workers' 429 cliff — per-tenant token-bucket quotas (429 +
    ``retry_after_s`` on exhaustion) and deadline-aware, starvation-free
    priority/fairness scheduling of the forwarding slots.
  - :mod:`~goleft_tpu_torch.fleet.supervisor`: the self-healing layer — it
    OWNS the serve subprocesses: worker death and hangs are detected
    and restarted with the resilience backoff, crash-looping slots
    are quarantined (cohortdepth's manifest/exit-3 contract), the
    fleet scales elastically between ``--min-workers`` and
    ``--max-workers`` against the router's queue-age signal, and
    ``--shared-cache`` puts one content-keyed ResultCache tier behind
    every worker so restarts and ring resizes replay instead of
    recompute.
  - :mod:`~goleft_tpu_torch.fleet.cachesync` and
    :mod:`~goleft_tpu_torch.fleet.federation`: the tier above, one
    router in front of N fleets, with whole-fleet failover and
    HMAC'd cache replication between the fleets.

``goleft-tpu-torch fleet`` (commands/fleet.py) spawns the workers and runs
the router; ``goleft-tpu-torch federation`` (commands/federation.py)
fronts fleets. The wire is the reference's (docs/fleet.md).
"""

from .admission import (  # noqa: F401
    FairScheduler, QuotaExceeded, QuotaTable, SchedulerTimeout,
    TokenBucket,
)
from .router import HashRing, RouterApp, WorkerPool  # noqa: F401
from .supervisor import (  # noqa: F401
    Supervisor, WorkerSlot, WorkerSpawnError,
)
