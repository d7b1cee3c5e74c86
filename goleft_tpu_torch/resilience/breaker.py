"""Per-site circuit breaker: shed load before the failure pile-up.

A site (a serve endpoint, a device dispatch path) that is failing
*systemically* — the device wedged, a dependency gone — keeps burning
queue slots, batch passes and client timeouts on requests that cannot
succeed. The breaker turns that into fast, honest shedding:

  - **closed** (state 0): traffic flows; ``failure_threshold``
    CONSECUTIVE failures trip it
  - **open** (state 2): ``allow()`` is False — callers shed
    immediately (the serve daemon maps this to HTTP 503 with a
    retry-after hint) instead of queueing up to the 429 cliff
  - **half-open** (state 1): after ``cooldown_s`` one probe call is
    let through; success closes the breaker, failure re-opens it for
    another cooldown

Classification is the caller's business: record only failures that
indicate the *site* is broken (the serve daemon records 500-class
executor failures; a poison request isolated to its sender, a 400, a
deadline are not the site's fault and never trip it).

Thread-safe; ``on_state(state_value)`` fires on every transition so
the owner can publish a gauge (``serve.breaker.state.<kind>``).
Deterministic under test: inject ``clock``.
"""

from __future__ import annotations

import threading
import time

from ..obs import get_logger

log = get_logger("resilience.breaker")

CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}

#: state names that mean "stop sending this site traffic" — the
#: contract the fleet router's breaker import reads out of a worker's
#: /metrics ``breakers`` block. Half-open is NOT shedding: the worker
#: itself admits exactly one probe, and starving it of traffic would
#: keep the breaker open forever from the router's point of view.
SHEDDING_STATES = frozenset({_NAMES[OPEN]})


def is_shedding(state_name: str) -> bool:
    """Should a router treat a site reporting ``state_name`` as
    closed for business? (The one place the name strings published in
    /metrics are interpreted outside this module.)"""
    return state_name in SHEDDING_STATES


class CircuitBreaker:
    def __init__(self, name: str = "", failure_threshold: int = 5,
                 cooldown_s: float = 30.0, on_state=None,
                 clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._on_state = on_state
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probing = False
        self.trips = 0  # lifetime trip count (observability)

    # ---- state machine ----

    def _set_state(self, state: int) -> None:
        # caller holds the lock
        if state == self._state:
            return
        self._state = state
        log.warning("circuit breaker %s → %s", self.name or "?",
                    _NAMES[state])
        if self._on_state is not None:
            try:
                self._on_state(state)
            except Exception:  # noqa: BLE001 — gauges must not break flow
                pass

    def allow(self) -> bool:
        """May a call proceed right now? In half-open exactly ONE
        caller gets True (the probe) until its verdict arrives."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.cooldown_s:
                    return False
                self._set_state(HALF_OPEN)
                self._probing = True
                return True
            # half-open: one probe in flight at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probing = False
            self._set_state(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probing = False
            if self._state == HALF_OPEN:
                # the probe failed: straight back to open
                self._opened_at = self._clock()
                self._set_state(OPEN)
                return
            self._consecutive_failures += 1
            if self._state == CLOSED and \
                    self._consecutive_failures >= self.failure_threshold:
                self.trips += 1
                self._opened_at = self._clock()
                self._set_state(OPEN)

    def settle(self, verdict: str | None) -> None:
        """Deliver a call's outcome: ``"success"`` / ``"failure"`` /
        None (no verdict about the site — a 4xx, a shed, a deadline —
        which must still release a half-open probe slot so the next
        candidate can try)."""
        if verdict == "success":
            self.record_success()
        elif verdict == "failure":
            self.record_failure()
        else:
            with self._lock:
                self._probing = False

    # ---- observability ----

    @property
    def state(self) -> str:
        with self._lock:
            return _NAMES[self._state]

    @property
    def state_value(self) -> int:
        with self._lock:
            return self._state

    def retry_after_s(self) -> float:
        """Seconds until the next probe is allowed (0 when not open)."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self.cooldown_s
                       - (self._clock() - self._opened_at))
