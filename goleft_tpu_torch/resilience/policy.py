"""Retry policy, error classification and quarantine: the counterpart of
the JAX package's resilience/policy.py, trimmed to what the pair-HMM
path uses.

- :meth:`RetryPolicy.classify`: transient failures (timeouts, OS
  errors, injected transients) are retried; permanent ones (bad input,
  type errors, injected permanents) fail fast.
- :meth:`RetryPolicy.backoff_s`: exponential backoff scaled by a
  deterministic hash-of-(key, attempt) jitter in [0.5, 1.0).
- A :class:`~goleft_tpu_torch.device.KernelFault` (a kernel that did not
  build, launch or finish) is neither retried nor classified: it passes
  through, so a broken card or toolchain fails the run with its own
  error instead of quarantining every bucket.
- :class:`Quarantine`: the windows of a permanently failing bucket, or
  the samples of a cohort, are set aside so the rest of the run
  completes (exit 3).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass

from ..device import KernelFault
from ..obs import get_logger, get_registry
from .faults import InjectedFault, InjectedPermanentFault

log = get_logger("resilience.policy")

#: deterministic failures: retrying cannot change the outcome; any
#: other Exception (timeouts, OS errors, the unknown) is transient
PERMANENT_TYPES = (
    FileNotFoundError, PermissionError, IsADirectoryError,
    NotADirectoryError, ValueError, TypeError, KeyError, IndexError,
    AttributeError, ZeroDivisionError, AssertionError,
    NotImplementedError, EOFError, UnicodeError,
)


class RetriesExhausted(RuntimeError):
    """A task failed past its retry budget (or permanently); carries the
    original exception, the attempt count and the classification."""

    def __init__(self, key, cause: BaseException, attempts: int,
                 classification: str):
        super().__init__(
            f"task {key!r} failed after {attempts} attempt(s) "
            f"({classification}): {cause!r}")
        self.key = key
        self.cause = cause
        self.attempts = attempts
        self.classification = classification


@dataclass(frozen=True)
class RetryPolicy:
    """Retry budget + backoff schedule + error classification.
    ``retries`` counts re-attempts (1: up to 2 attempts in all);
    ``deadline_s`` bounds one task's attempts and backoffs in wall
    clock (the remote fetches' budget)."""

    retries: int = 1
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    deadline_s: float | None = None

    def classify(self, exc: BaseException) -> str:
        """'transient' (retry) or 'permanent' (fail fast)."""
        if isinstance(exc, InjectedPermanentFault):
            return "permanent"
        if isinstance(exc, InjectedFault):
            return "transient"
        if isinstance(exc, SystemExit):
            return "permanent"
        if isinstance(exc, PERMANENT_TYPES):
            return "permanent"
        # an idempotent bucket is cheap to run once more
        return "transient"

    def backoff_s(self, key, attempt: int) -> float:
        """Delay before re-attempt ``attempt + 1`` (attempt is
        1-based)."""
        raw = min(self.max_delay_s,
                  self.base_delay_s * (2.0 ** (attempt - 1)))
        h = hashlib.sha256(
            f"0:{key!r}:{attempt}".encode()).digest()
        return raw * (0.5 + int.from_bytes(h[:8], "big") / 2.0 ** 65)

    def call(self, key, thunk):
        """Run ``thunk()`` under this policy → ``(value, attempts)``;
        raises :class:`RetriesExhausted` (the original exception chained
        as ``cause``) when the budget is spent or the failure is
        permanent. Only ``Exception`` is handled, and a KernelFault
        is raised as it is."""
        attempt = 0
        t0 = time.monotonic()
        while True:
            attempt += 1
            try:
                return thunk(), attempt
            except KernelFault:
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                cls = self.classify(e)
                if cls == "permanent" or attempt > self.retries:
                    raise RetriesExhausted(key, e, attempt, cls) from e
                delay = self.backoff_s(key, attempt)
                if self.deadline_s is not None and (
                        time.monotonic() - t0 + delay >= self.deadline_s):
                    raise RetriesExhausted(key, e, attempt,
                                           "deadline") from e
                get_registry().counter("resilience.retries_total").inc()
                log.debug("retrying %r after %s (attempt %d, backoff "
                          "%.3fs)", key, e, attempt, delay)
                if delay > 0:
                    time.sleep(delay)


#: retry once with a short backoff
DEFAULT_POLICY = RetryPolicy()


class Quarantine:
    """Inputs isolated after a permanent failure; the run completes
    without them. Thread-safe; ``add`` is idempotent per key. Entries
    record the display name, the source, the error, the attempts, the
    classification and the phase."""

    def __init__(self):
        self._entries: dict = {}
        self._lock = threading.Lock()

    def add(self, key, name: str, source: str, error: BaseException,
            attempts: int = 1, classification: str = "permanent",
            phase: str = "decode") -> bool:
        with self._lock:
            if key in self._entries:
                return False
            self._entries[key] = {
                "sample": name,
                "source": source,
                "error": repr(error),
                "attempts": attempts,
                "classification": classification,
                "phase": phase,
            }
        get_registry().counter("resilience.quarantined_total").inc()
        log.warning("quarantined %s (%s, phase=%s): %r", name, source,
                    phase, error)
        return True

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __bool__(self) -> bool:
        return len(self) > 0

    @property
    def names(self) -> list[str]:
        with self._lock:
            return sorted(e["sample"] for e in self._entries.values())

    def summary(self) -> dict:
        """{'quarantined': [entry...]} sorted by name then source."""
        with self._lock:
            return {"quarantined": sorted(
                self._entries.values(),
                key=lambda e: (e["sample"], e["source"]))}

    def exit_summary(self) -> str:
        """The CLI's stderr epilogue for a degraded run: one line, then
        one line per entry with its effect ('open' failures drop the
        sample's column, others zero-fill its remaining shards)."""
        entries = self.summary()["quarantined"]
        lines = [f"resilience: {len(entries)} sample(s) quarantined — "
                 "run completed degraded without them (exit 3)"]
        for e in entries:
            effect = ("column dropped" if e["phase"] == "open"
                      else "remaining shards zero-filled")
            lines.append(
                f"  {e['sample']} ({e['source']}): {e['error']} "
                f"[{e['classification']}, {e['attempts']} attempt(s), "
                f"{effect}]")
        return "\n".join(lines)

    def write(self, path: str) -> None:
        """Atomic JSON quarantine manifest."""
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(self.summary(), fh, indent=1, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)
