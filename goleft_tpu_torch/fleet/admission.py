"""Admission control for the fleet router: quotas + fair scheduling.
The port's copy of the JAX package's fleet/admission.py.

Two independent gates run in front of request forwarding, both built
to degrade loudly BEFORE the workers' own 429 cliff:

  - **per-tenant token buckets** (:class:`QuotaTable`): each tenant
    (the ``tenant`` request field, default ``"default"``) owns a
    bucket refilling at ``rate`` tokens/s up to ``burst``. An empty
    bucket rejects with :class:`QuotaExceeded` carrying an honest
    ``retry_after_s`` (when the next token lands) — one tenant's flood
    burns only its own bucket, every other tenant's traffic is
    untouched.
  - **fair forwarding slots** (:class:`FairScheduler`): at most
    ``max_inflight`` requests forward concurrently; waiters are
    granted slots in priority order with AGING — a waiter's effective
    priority improves by ``aging_rate`` per queued second, so a
    steady stream of high-priority arrivals can delay but never
    starve a low-priority request (starvation-freedom by
    construction: age grows without bound, priority values do not).
    Waiting is deadline-aware: a waiter whose deadline passes fails
    with :class:`SchedulerTimeout` instead of holding a ghost place
    in line.

Priorities are small ints, LOWER = more urgent (0 = interactive
default, larger = batch/best-effort). Deterministic under test: both
classes take an injectable ``clock``.
"""

from __future__ import annotations

import threading
import time


class QuotaExceeded(RuntimeError):
    """Tenant bucket empty — shed with 429 + retry_after_s."""

    def __init__(self, tenant: str, retry_after_s: float):
        super().__init__(
            f"tenant {tenant!r} exceeded its request quota; retry in "
            f"{retry_after_s:.2f}s")
        self.tenant = tenant
        self.retry_after_s = retry_after_s


class SchedulerTimeout(RuntimeError):
    """Deadline passed while waiting for a forwarding slot (504)."""


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s, capacity ``burst``.

    ``take()`` is non-blocking: (True, 0.0) on success, else
    (False, seconds_until_next_token) — the router turns the latter
    into a 429 with a retry hint instead of queueing denied work.
    Thread-safe.
    """

    def __init__(self, rate: float, burst: float,
                 clock=time.monotonic):
        if rate <= 0 or burst < 1:
            raise ValueError(
                f"need rate > 0 and burst >= 1 (got {rate}, {burst})")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._stamp = clock()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._tokens = min(self.burst, self._tokens
                           + (now - self._stamp) * self.rate)
        self._stamp = now

    def take(self, n: float = 1.0) -> tuple[bool, float]:
        with self._lock:
            now = self._clock()
            self._refill(now)
            if self._tokens >= n:
                self._tokens -= n
                return True, 0.0
            return False, (n - self._tokens) / self.rate


class QuotaTable:
    """Per-tenant buckets from ``tenant=rate:burst`` specs.

    The ``*`` spec is the default every unlisted tenant gets its OWN
    bucket from (lazily — tenants are isolated, not pooled). With no
    ``*`` spec, unlisted tenants are unmetered (admission is opt-in).
    """

    def __init__(self, specs: list[str] | None = None,
                 clock=time.monotonic):
        self._clock = clock
        self._defs: dict[str, tuple[float, float]] = {}
        self._buckets: dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        for spec in specs or []:
            tenant, _, rb = spec.partition("=")
            tenant = tenant.strip()
            rate, _, burst = rb.partition(":")
            if not tenant or not rate:
                raise ValueError(
                    f"quota spec {spec!r}: want tenant=rate[:burst]")
            try:
                r = float(rate)
                b = float(burst) if burst else max(1.0, r)
            except ValueError:
                raise ValueError(
                    f"quota spec {spec!r}: rate/burst must be "
                    "numbers") from None
            TokenBucket(r, b, clock)  # validate bounds loudly, now
            self._defs[tenant] = (r, b)

    def check(self, tenant: str | None) -> None:
        """Take one token for this tenant or raise
        :class:`QuotaExceeded`; a no-op for unmetered tenants."""
        tenant = tenant or "default"
        definition = self._defs.get(tenant, self._defs.get("*"))
        if definition is None:
            return
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = TokenBucket(
                    *definition, clock=self._clock)
        ok, retry_after = bucket.take()
        if not ok:
            raise QuotaExceeded(tenant, retry_after)

    @property
    def metered(self) -> bool:
        return bool(self._defs)


class _Waiter:
    __slots__ = ("tenant", "priority", "deadline", "arrived", "seq")

    def __init__(self, tenant, priority, deadline, arrived, seq):
        self.tenant = tenant
        self.priority = priority
        self.deadline = deadline
        self.arrived = arrived
        self.seq = seq


class FairScheduler:
    """Bounded forwarding slots granted in aged-priority order.

    ``acquire`` blocks until a slot is granted (returns the queue-wait
    seconds, the router's queue-age signal) or the deadline passes
    (:class:`SchedulerTimeout`). Grant order among waiters:
    ``priority - age * aging_rate`` ascending, FIFO within ties — so
    urgency wins now and patience wins eventually.
    """

    def __init__(self, max_inflight: int = 8,
                 aging_rate: float = 0.5, clock=time.monotonic):
        if max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1 (got {max_inflight})")
        self.max_inflight = max_inflight
        self.aging_rate = float(aging_rate)
        self._clock = clock
        self._cond = threading.Condition()
        self._inflight = 0
        self._seq = 0
        self._waiters: list[_Waiter] = []

    def _rank(self, w: _Waiter, now: float) -> tuple:
        return (w.priority - (now - w.arrived) * self.aging_rate,
                w.seq)

    def _best(self, now: float) -> _Waiter | None:
        live = [w for w in self._waiters if w.deadline > now]
        return min(live, key=lambda w: self._rank(w, now)) \
            if live else None

    def acquire(self, tenant: str = "default", priority: int = 0,
                timeout_s: float = 30.0) -> float:
        """Block until granted a slot; returns seconds waited."""
        with self._cond:
            now = self._clock()
            me = _Waiter(tenant, int(priority), now + timeout_s, now,
                         self._seq)
            self._seq += 1
            if self._inflight < self.max_inflight \
                    and not self._waiters:
                self._inflight += 1
                return 0.0
            self._waiters.append(me)
            try:
                while True:
                    now = self._clock()
                    if now >= me.deadline:
                        raise SchedulerTimeout(
                            f"no forwarding slot within "
                            f"{timeout_s:g}s (priority {priority}, "
                            f"{len(self._waiters)} waiting)")
                    if self._inflight < self.max_inflight \
                            and self._best(now) is me:
                        self._inflight += 1
                        return now - me.arrived
                    self._cond.wait(timeout=min(
                        0.05, max(0.0, me.deadline - now)) or 0.05)
            finally:
                self._waiters.remove(me)
                self._cond.notify_all()

    def release(self) -> None:
        with self._cond:
            self._inflight = max(0, self._inflight - 1)
            self._cond.notify_all()

    # ---- observability ----

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._waiters)

    def queue_age_s(self) -> float:
        """Age of the OLDEST waiter (0 when nobody waits) — the
        backlog-pressure gauge (``fleet.queue_age_s``)."""
        with self._cond:
            if not self._waiters:
                return 0.0
            now = self._clock()
            return max(now - w.arrived for w in self._waiters)

    def inflight(self) -> int:
        with self._cond:
            return self._inflight
