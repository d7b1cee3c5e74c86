"""Structured fleet event journal: lifecycle transitions, durable. The
port's copy of the JAX package's obs/events.py, with the same schema, so
either package reads a journal the other wrote.

The supervisor's state machine (spawn, death, backoff, hang-kill,
quarantine, scale up/down, drain) is the fleet's incident narrative.
This module writes it as an fsync'd append-only ``events.jsonl`` with
the checkpoint journal's durability protocol (one JSON object per line,
flush + fsync per append, torn-tail-tolerant replay via
:func:`~goleft_tpu_torch.resilience.checkpoint.iter_journal_lines`), so
the sequence of events survives a SIGKILLed supervisor and is
replayable after restart: a torn final line, the only artifact a crash
mid-append can leave, is skipped, and everything before it is intact.

One record per event, schema-stable (``goleft-tpu.fleet-event/1``)::

    {"schema": "goleft-tpu.fleet-event/1", "t": <epoch seconds>,
     "ts": "<UTC ISO8601>", "type": "<spawn|death|backoff|hang_kill|
     quarantine|scale_up|scale_down|drain|restart>",
     "slot": <int|null>, "worker": "<url|null>", "pid": <int|null>,
     "trace_id": "<id|null>", ...free-form detail fields}

Query via :func:`read_events` (the ``goleft-tpu-torch fleet events`` body)
with ``--since/--slot/--type`` filters; the router surfaces a bounded
``fleet.events`` block (per-type counts + the most recent events) in
its ``/metrics`` body.
"""

from __future__ import annotations

import datetime
import json
import os
import threading
import time
from collections import deque

SCHEMA = "goleft-tpu.fleet-event/1"

#: the canonical journal filename under a fleet's state directory
EVENTS_NAME = "events.jsonl"

#: event types the supervisor emits (free-form types are allowed —
#: the reader filters by string equality — but these are the contract)
EVENT_TYPES = ("spawn", "restart", "death", "backoff", "hang_kill",
               "quarantine", "scale_up", "scale_down", "drain",
               "spawn_failure", "stop", "memory_recycle")


class EventJournal:
    """Append-only, fsync-per-append event sink.

    Opens in append mode — a restarted supervisor CONTINUES the same
    journal (the whole point: the incident narrative spans restarts).
    A torn tail left by a crash is the reader's business
    (:func:`read_events` tolerates it); appends after one are fine —
    each record is its own line, so one garbled line never corrupts
    its neighbors. Thread-safe; close() is idempotent.
    """

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._fh = open(path, "a")
        # a torn tail has no trailing newline: start our first append
        # on a fresh line so the reader sees ONE garbled line, not a
        # torn fragment fused to a valid record
        if self._fh.tell() > 0:
            with open(path, "rb") as rf:
                rf.seek(-1, os.SEEK_END)
                if rf.read(1) != b"\n":
                    self._fh.write("\n")
        self._lock = threading.Lock()

    def append(self, type: str, *, slot: int | None = None,
               worker: str | None = None, pid: int | None = None,
               trace_id: str | None = None, **detail) -> dict:
        """Durably append one event; returns the record written."""
        now = time.time()
        rec = {
            "schema": SCHEMA,
            "t": round(now, 3),
            "ts": datetime.datetime.fromtimestamp(
                now, datetime.timezone.utc)
            .isoformat(timespec="milliseconds"),
            "type": type,
            "slot": slot,
            "worker": worker,
            "pid": pid,
            "trace_id": trace_id,
        }
        rec.update(detail)
        line = json.dumps(rec, sort_keys=True) + "\n"
        with self._lock:
            if self._fh.closed:
                return rec  # racing a close(): drop, never crash
            self._fh.write(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())
        return rec

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_events(path: str, since: float | None = None,
                slot: int | None = None,
                type: str | None = None) -> list[dict]:
    """Replay ``events.jsonl`` (torn tail tolerated — the checkpoint
    journal's reader), filtered: ``since`` is an epoch-seconds lower
    bound on ``t``, ``slot``/``type`` match exactly. Records come
    back in journal (= chronological) order."""
    from ..resilience.checkpoint import iter_journal_lines

    out = []
    # stop_on_torn=False: a restarted supervisor appends PAST the torn
    # line its predecessor's crash left — skip the fragment, keep the
    # rest of the narrative
    for rec in iter_journal_lines(path, stop_on_torn=False):
        if not isinstance(rec, dict):
            continue
        if since is not None and (rec.get("t") or 0) < since:
            continue
        if slot is not None and rec.get("slot") != slot:
            continue
        if type is not None and rec.get("type") != type:
            continue
        out.append(rec)
    return out


def parse_since(value: str) -> float:
    """``--since`` grammar: epoch seconds (``1723400000``), a relative
    window (``30s``/``15m``/``2h``/``1d`` ago), or an ISO8601 stamp —
    returns the epoch-seconds lower bound."""
    value = value.strip()
    if value and value[-1] in "smhd":
        try:
            n = float(value[:-1])
        except ValueError:
            raise ValueError(f"bad --since window: {value!r}")
        mult = {"s": 1, "m": 60, "h": 3600, "d": 86400}[value[-1]]
        return time.time() - n * mult
    try:
        return float(value)
    except ValueError:
        pass
    try:
        dt = datetime.datetime.fromisoformat(value)
    except ValueError:
        raise ValueError(
            f"bad --since value: {value!r} (want epoch seconds, "
            "a relative window like 15m, or ISO8601)")
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return dt.timestamp()


class EventLog:
    """The supervisor-facing fan-out: every event goes to the durable
    journal (when configured), a bounded in-memory recent ring (the
    router's ``fleet.events`` /metrics block) and per-type counters in
    the metrics registry (``fleet.events_total.<type>``)."""

    def __init__(self, journal: EventJournal | None = None,
                 registry=None, recent: int = 64):
        self.journal = journal
        self.registry = registry
        self._recent: deque[dict] = deque(maxlen=recent)
        self._lock = threading.Lock()

    def emit(self, type: str, **fields) -> None:
        if self.journal is not None:
            rec = self.journal.append(type, **fields)
        else:
            rec = {"schema": SCHEMA, "t": round(time.time(), 3),
                   "type": type, **fields}
        if self.registry is not None:
            self.registry.counter(f"fleet.events_total.{type}").inc()
        with self._lock:
            self._recent.append(rec)

    def block(self) -> dict:
        """The ``fleet.events`` /metrics block: per-type counts over
        this process's lifetime + the newest events (newest first)."""
        with self._lock:
            recent = list(self._recent)[::-1]
        counts: dict[str, int] = {}
        for r in recent:
            counts[r.get("type", "?")] = \
                counts.get(r.get("type", "?"), 0) + 1
        return {
            "journal": self.journal.path if self.journal else None,
            "recent": recent[:16],
            "recent_counts": dict(sorted(counts.items())),
        }

    def close(self) -> None:
        if self.journal is not None:
            self.journal.close()
