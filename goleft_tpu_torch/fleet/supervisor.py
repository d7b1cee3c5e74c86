"""Fleet supervisor: worker lifecycle, crash-loop quarantine, scaling.
The port's copy of the JAX package's fleet/supervisor.py; its workers
are ``python -m goleft_tpu_torch serve`` processes, each on the card.

The router survives a dead worker by routing AROUND it, but the
fleet's capacity then decays monotonically — a SIGKILLed or hung
worker stays dead until an operator intervenes. This module is the
self-healing layer: it OWNS the serve subprocesses (the spawn loop
that used to live in commands/fleet.py) and keeps the fleet at its
declared capacity without operator action.

Per worker slot, a small state machine::

    spawning ──► healthy ──► hung ────┐
       ▲            │                 │ SIGKILL
       │            │ process exit    ▼
       │            └───────────► restarting ──► quarantined
       │                              │            (parked)
       └──────── backoff elapsed ◄────┘
    healthy ──► draining ──► stopped          (scale-down only)

  - **death** (``proc.poll()`` returns): the slot restarts with the
    resilience layer's exponential backoff + deterministic jitter
    (:meth:`~goleft_tpu_torch.resilience.policy.RetryPolicy.backoff_s` — the
    SAME schedule cohort shard retries use), non-blocking: the
    supervise loop stores ``next_attempt_at`` instead of sleeping, so
    one slot's backoff never delays another slot's health checks.
  - **hang** (``/healthz`` timeout ``hang_after`` times in a row —
    a SIGSTOPped or wedged worker accepts connections but never
    answers): the worker is SIGKILLed and takes the death path.
  - **crash loop** (``crash_limit`` deaths inside ``crash_window_s``):
    the slot is PARKED — recorded in a
    :class:`~goleft_tpu_torch.resilience.policy.Quarantine` (the same
    manifest/exit-code contract cohortdepth uses for quarantined
    samples: the fleet completes degraded, exits 3, and the manifest
    names what was lost and why) — instead of burning CPU respawning
    a worker that cannot live.
  - **elastic scaling**: within ``[min_workers, max_workers]``, a
    control loop compares the router's ``fleet.queue_age_s`` against
    ``target_queue_age_s``. Backlog above target scales UP (spawn +
    ring add); a queue that stays empty AND idle for
    ``scale_down_idle_ticks`` consecutive ticks scales DOWN — the
    hysteresis that keeps one bursty second from flapping the fleet —
    and every scale event starts a ``scale_cooldown_s`` quiet period.
    Scale-down picks the LEAST-AFFINE worker (smallest
    :meth:`~goleft_tpu_torch.fleet.router.HashRing.ownership` share — the
    removal that remaps the fewest keys), drains it (no new traffic,
    in-flight forwards run to completion, bounded by
    ``drain_timeout_s``), removes it from the ring, then SIGTERMs it.

Membership changes go through :meth:`RouterApp.add_worker` /
``remove_worker`` — copy-on-write ring swaps, so supervision never
perturbs the candidate order of surviving workers (the byte-identity
contract chip_smoke.py's fleet phase pins).

With ``shared_cache`` set, every spawned worker gets
``--cache <dir> --cache-shared``: one content-keyed ResultCache
directory behind the whole fleet. Safe across workers by construction
— keys are full content identity (canonical params + every input's
``file_key``) and writes are tmp-file + atomic rename — so a restart
or a ring resize REPLAYS a previously computed response instead of
recomputing it on a cold private cache.

Metrics (the router's registry, so they ride ``GET /metrics``):
``fleet.restarts_total``, ``fleet.slot_quarantines``,
``fleet.scale_events`` (+ ``fleet.scale_up_total`` /
``fleet.scale_down_total``), ``fleet.hangs_total``,
``fleet.spawn_failures_total``, and the ``fleet.capacity`` gauge
(serving slots right now).

Like the router, this module must stay torch-free: the supervisor runs
in the router process (tests/test_torch_isolation.py pins the import
graph).
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

from ..obs.events import EventJournal, EventLog
from ..obs.logging import get_logger
from ..obs.metrics import MetricsRegistry
from ..resilience.policy import Quarantine, RetryPolicy

log = get_logger("fleet.supervisor")

#: slot states (the docs/fleet.md state machine)
SPAWNING = "spawning"
HEALTHY = "healthy"
HUNG = "hung"
RESTARTING = "restarting"
QUARANTINED = "quarantined"
DRAINING = "draining"
STOPPED = "stopped"


class WorkerSpawnError(RuntimeError):
    """A worker failed to start (exec failure, died before announcing,
    or never printed its URL within ``spawn_timeout_s``)."""


def read_announce(child, timeout_s: float) -> str | None:
    """The ``listening on URL`` line from a child's stdout, or None if
    the child never prints one within ``timeout_s`` (hung interpreter,
    import crash, wedged warmup). The read happens on a daemon thread
    because a pipe readline cannot be interrupted — on timeout the
    caller kills the child, which unblocks (and ends) the reader."""
    box: dict = {}

    def _read():
        try:
            box["line"] = child.stdout.readline()
        except Exception as e:  # noqa: BLE001 — reported via box
            box["error"] = e

    t = threading.Thread(target=_read, daemon=True,
                         name="goleft-fleet-announce")
    t.start()
    t.join(timeout=timeout_s)
    line = box.get("line") or ""
    if "listening on " not in line:
        return None
    return line.rsplit("listening on ", 1)[1].strip()


class WorkerSlot:
    """One supervised worker position. The slot survives its workers:
    processes come and go (restarts, scale events); the slot carries
    the lifecycle state and the crash history."""

    def __init__(self, index: int):
        self.index = index
        self.state = SPAWNING
        self.proc: subprocess.Popen | None = None
        self.url: str | None = None
        self.restarts = 0               # successful respawns
        self.deaths: list[float] = []   # monotonic stamps, windowed
        self.health_misses = 0
        self.next_attempt_at = 0.0      # backoff gate (monotonic)
        self.reason: str | None = None  # why quarantined/stopped

    def to_dict(self) -> dict:
        return {
            "index": self.index,
            "state": self.state,
            "url": self.url,
            "pid": self.proc.pid if self.proc else None,
            "restarts": self.restarts,
            "recent_deaths": len(self.deaths),
            "reason": self.reason,
        }


class Supervisor:
    """Owns the serve subprocesses behind a :class:`RouterApp`.

    Usage (commands/fleet.py)::

        sup = Supervisor(worker_args=[...], min_workers=1,
                         max_workers=4, registry=registry)
        urls = sup.spawn_initial(2)   # cleans up after itself on
                                      # failure, raises WorkerSpawnError
        app = RouterApp(urls, registry=registry)
        sup.bind(app)
        app.start(); sup.start()
        ...
        sup.close(); app.close()

    ``spawn_fn(index) -> (Popen, url)`` is injectable so tests can
    supervise cheap torch-free stub processes; the default spawns
    ``goleft-tpu-torch serve --port 0`` workers.
    """

    def __init__(self, *, worker_args: list[str] | None = None,
                 env: dict | None = None,
                 spawn_fn=None,
                 min_workers: int = 1,
                 max_workers: int | None = None,
                 registry: MetricsRegistry | None = None,
                 interval_s: float = 1.0,
                 hang_timeout_s: float = 5.0,
                 hang_after: int = 2,
                 crash_limit: int = 5,
                 crash_window_s: float = 300.0,
                 restart_backoff: RetryPolicy | None = None,
                 target_queue_age_s: float = 0.0,
                 scale_cooldown_s: float = 30.0,
                 scale_down_idle_ticks: int = 5,
                 drain_timeout_s: float = 30.0,
                 spawn_timeout_s: float = 120.0,
                 shared_cache: str | None = None,
                 queue_age_fn=None,
                 events_journal: str | None = None,
                 burn_threshold: float = 0.0,
                 burn_rate_fn=None,
                 mem_recycle_bytes: int = 0):
        if min_workers < 1:
            raise ValueError(
                f"min_workers must be >= 1 (got {min_workers})")
        if max_workers is not None and max_workers < min_workers:
            raise ValueError(
                f"max_workers {max_workers} < min_workers "
                f"{min_workers}")
        self.worker_args = list(worker_args or [])
        self.env = env
        self.shared_cache = shared_cache
        if shared_cache:
            import os

            os.makedirs(shared_cache, exist_ok=True)
            self.worker_args += ["--cache", shared_cache,
                                 "--cache-shared"]
        self._spawn_fn = spawn_fn or self._spawn_serve
        self.min_workers = min_workers
        self.max_workers = max_workers if max_workers is not None \
            else min_workers
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.interval_s = interval_s
        self.hang_timeout_s = hang_timeout_s
        self.hang_after = hang_after
        self.crash_limit = crash_limit
        self.crash_window_s = crash_window_s
        # backoff only — classification never runs here (a dead
        # process carries no exception); retries is irrelevant because
        # quarantine, not the policy budget, bounds respawns
        self.backoff = restart_backoff if restart_backoff is not None \
            else RetryPolicy(base_delay_s=0.1, max_delay_s=5.0)
        self.target_queue_age_s = target_queue_age_s
        self.scale_cooldown_s = scale_cooldown_s
        self.scale_down_idle_ticks = scale_down_idle_ticks
        self.drain_timeout_s = drain_timeout_s
        self.spawn_timeout_s = spawn_timeout_s
        self.queue_age_fn = queue_age_fn
        # SLO-burn autoscale signal (the fleet plane's second trigger
        # beyond queue age): scale up while the polled fleet burn rate
        # exceeds burn_threshold (>1.0 = budget burning faster than it
        # earns; 0 disables). burn_rate_fn defaults to the bound
        # router's fleet_burn_rate at bind() time.
        self.burn_threshold = burn_threshold
        self.burn_rate_fn = burn_rate_fn
        # the memory hard cap (--mem-recycle-mb; 0 disables): a
        # healthy worker whose /debug/memory RSS exceeds it is
        # drained and recycled DELIBERATELY — before the kernel OOM
        # killer picks a victim — and the recycle does not count
        # toward the crash window (it is maintenance, not a death)
        self.mem_recycle_bytes = int(mem_recycle_bytes)
        # the structured event journal: every lifecycle transition,
        # fsync'd per append (obs/events.py — the checkpoint journal's
        # durability protocol), plus the bounded in-memory ring the
        # router's /metrics `fleet.events` block serves
        self.events = EventLog(
            EventJournal(events_journal) if events_journal else None,
            registry=self.registry)
        self.quarantine = Quarantine()
        self.app = None
        self._slots: list[WorkerSlot] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # gtlint: ok thr-daemon-io — the loop's only fsync sink is the
        # events journal, whose READERS skip torn tails by contract
        # (obs/events.py: iter_journal_lines stop_on_torn=False, the
        # restart-continuation design); close() joins this
        # thread, so only a hard kill can tear — exactly the case the
        # format survives. daemon=True stays: a crashed operator path
        # that never reaches close() must not hang process exit.
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="goleft-fleet-supervisor")
        self._last_scale = 0.0
        self._idle_ticks = 0

    # ---- spawning ----

    def _spawn_serve(self, index: int):
        """Default spawn: one ``goleft-tpu-torch serve`` child on an
        ephemeral port (the loop commands/fleet.py used to own)."""
        child = subprocess.Popen(
            [sys.executable, "-m", "goleft_tpu_torch", "serve", "--port",
             "0", *self.worker_args],
            stdout=subprocess.PIPE, text=True, env=self.env)
        url = read_announce(child, self.spawn_timeout_s)
        if url is None:
            child.kill()
            child.wait(timeout=10)
            if child.stdout is not None:
                child.stdout.close()
            raise WorkerSpawnError(
                f"worker {index} did not announce its URL within "
                f"{self.spawn_timeout_s:g}s")
        return child, url

    def _try_spawn(self, slot: WorkerSlot) -> bool:
        try:
            proc, url = self._spawn_fn(slot.index)
        except Exception as e:  # noqa: BLE001 — spawn failure is a
            # slot event (counted toward the crash window), never a
            # supervisor death
            self.registry.counter("fleet.spawn_failures_total").inc()
            self.events.emit("spawn_failure", slot=slot.index,
                             error=repr(e))
            log.warning("fleet: slot %d spawn failed: %r",
                        slot.index, e)
            return False
        slot.proc = proc
        slot.url = url.rstrip("/")
        slot.health_misses = 0
        self.events.emit("spawn", slot=slot.index, worker=slot.url,
                         pid=proc.pid)
        return True

    def spawn_initial(self, n: int) -> list[str]:
        """Spawn the first ``n`` workers. If worker i of n fails, every
        already-spawned child is killed before the error propagates —
        a failed ``goleft-tpu-torch fleet`` start must not leave orphan
        daemons behind."""
        n = max(self.min_workers, min(n, self.max_workers))
        slots: list[WorkerSlot] = []
        try:
            for i in range(n):
                slot = WorkerSlot(i)
                if not self._try_spawn(slot):
                    raise WorkerSpawnError(
                        f"worker {i} of {n} failed to spawn")
                slot.state = HEALTHY
                slots.append(slot)
        except BaseException:
            for s in slots:
                self._terminate(s, sig_kill=True)
            raise
        with self._lock:
            self._slots = slots
        self._update_capacity()
        return [s.url for s in slots]

    # ---- wiring + lifecycle ----

    def bind(self, app) -> "Supervisor":
        """Attach the RouterApp whose membership this supervisor
        drives (and whose scheduler + fleet rollup provide the
        autoscale signals: queue age AND SLO burn rate)."""
        self.app = app
        app.supervisor = self
        if self.queue_age_fn is None:
            self.queue_age_fn = app.scheduler.queue_age_s
        if self.burn_rate_fn is None and self.burn_threshold > 0:
            self.burn_rate_fn = app.fleet_burn_rate
        return self

    def events_block(self) -> dict:
        """The router /metrics ``fleet.events`` block."""
        return self.events.block()

    def start(self) -> "Supervisor":
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop supervising, then stop every worker: SIGTERM (the
        serve daemon drains in-flight work on it), bounded wait,
        SIGKILL stragglers."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=30.0)
        for slot in self.slots():
            self._terminate(slot)
            if slot.state not in (QUARANTINED,):
                slot.state = STOPPED
        self._update_capacity()
        self.events.emit("stop", detailed_reason="supervisor close")
        self.events.close()

    def _terminate(self, slot: WorkerSlot,
                   sig_kill: bool = False) -> None:
        proc = slot.proc
        if proc is None:
            return
        if proc.poll() is None:
            if sig_kill:
                proc.kill()
            else:
                proc.terminate()
            try:
                proc.wait(timeout=self.drain_timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        if proc.stdout is not None:
            proc.stdout.close()

    # ---- introspection ----

    def slots(self) -> list[WorkerSlot]:
        with self._lock:
            return list(self._slots)

    @property
    def capacity(self) -> int:
        """Slots currently serving traffic."""
        return sum(1 for s in self.slots() if s.state == HEALTHY)

    @property
    def quarantined_slots(self) -> int:
        return sum(1 for s in self.slots()
                   if s.state == QUARANTINED)

    def snapshot(self) -> dict:
        return {
            "slots": [s.to_dict() for s in self.slots()],
            "capacity": self.capacity,
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "autoscale": self.target_queue_age_s > 0,
        }

    def _update_capacity(self) -> None:
        self.registry.gauge("fleet.capacity").set(self.capacity)

    # ---- the supervise loop ----

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the supervisor must
                # outlive any single bad tick (a worker dying mid-
                # check raises from urllib/psutil-ish paths); the
                # failure is logged, the next tick re-inspects
                log.exception("fleet: supervisor tick failed")

    def tick(self) -> None:
        """One supervision pass (public so tests can drive the state
        machine deterministically without racing the wall-clock
        loop)."""
        now = time.monotonic()
        for slot in self.slots():
            if slot.state == HEALTHY:
                self._check_slot(slot, now)
            elif slot.state == RESTARTING \
                    and now >= slot.next_attempt_at:
                self._restart(slot, now)
        self._evaluate_scaling(now)

    def _check_slot(self, slot: WorkerSlot, now: float) -> None:
        proc = slot.proc
        if proc is None or proc.poll() is not None:
            rc = proc.returncode if proc is not None else None
            log.warning("fleet: slot %d worker %s exited (rc=%s)",
                        slot.index, slot.url, rc)
            self._on_death(slot, now, f"process exit rc={rc}")
            return
        if self._healthz_ok(slot):
            slot.health_misses = 0
            self._check_memory(slot, now)
            return
        slot.health_misses += 1
        if slot.health_misses < self.hang_after:
            return
        # hung: accepts connections but never answers (SIGSTOP, a
        # wedged dispatcher, a deadlocked handler pool). SIGKILL —
        # SIGTERM would need the process to be scheduled to matter —
        # and recycle through the death path.
        slot.state = HUNG
        self.registry.counter("fleet.hangs_total").inc()
        self.events.emit("hang_kill", slot=slot.index,
                         worker=slot.url,
                         pid=proc.pid if proc else None,
                         misses=slot.health_misses)
        log.warning("fleet: slot %d worker %s hung (%d healthz "
                    "timeouts) — SIGKILL + recycle", slot.index,
                    slot.url, slot.health_misses)
        proc.kill()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        self._on_death(slot, now, "hung (healthz timeout)")

    def _worker_rss(self, slot: WorkerSlot) -> int | None:
        """The worker's current RSS from ``/debug/memory`` (always
        answers, sampler thread or not), or None on any failure —
        a worker too wedged to report memory is the hang path's
        business, not the recycler's."""
        try:
            req = urllib.request.Request(
                slot.url + "/debug/memory",
                headers={"Accept": "application/json"})
            with urllib.request.urlopen(
                    req, timeout=self.hang_timeout_s) as r:
                d = json.loads(r.read().decode())
            return int((d.get("host") or {}).get("rss_bytes") or 0)
        except Exception:  # noqa: BLE001 — no verdict, no recycle
            return None

    def _check_memory(self, slot: WorkerSlot, now: float) -> None:
        if self.mem_recycle_bytes <= 0:
            return
        rss = self._worker_rss(slot)
        if rss is None or rss <= self.mem_recycle_bytes:
            return
        self._recycle_for_memory(slot, rss, now)

    def _recycle_for_memory(self, slot: WorkerSlot, rss_bytes: int,
                            now: float) -> None:
        """Drain-and-recycle a worker past the memory hard cap: the
        scale-down drain choreography (no new traffic, in-flight
        forwards finish, ring removal, SIGTERM so the worker's own
        drain runs) followed by an immediate respawn through the
        restart path. Emits ``memory_recycle`` to the fsync'd event
        journal; deliberately NOT a death — the crash window stays
        untouched, a leaky worker must not quarantine its slot."""
        url = slot.url
        slot.state = DRAINING
        self.registry.counter("memory.recycles_total").inc()
        self.events.emit(
            "memory_recycle", slot=slot.index, worker=url,
            pid=slot.proc.pid if slot.proc else None,
            rss_bytes=rss_bytes, cap_bytes=self.mem_recycle_bytes)
        log.warning(
            "fleet: slot %d worker %s rss %d bytes exceeds the "
            "%d-byte recycle cap — drain + recycle", slot.index,
            url, rss_bytes, self.mem_recycle_bytes)
        if self.app is not None:
            self.app.drain_worker(url)
            deadline = time.monotonic() + self.drain_timeout_s
            while self.app.pool.inflight(url) > 0 \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            self.app.remove_worker(url)
        self._terminate(slot)
        slot.state = RESTARTING
        slot.next_attempt_at = now  # no backoff: planned maintenance
        self._update_capacity()

    def _healthz_ok(self, slot: WorkerSlot) -> bool:
        try:
            req = urllib.request.Request(
                slot.url + "/healthz",
                headers={"Accept": "application/json"})
            with urllib.request.urlopen(
                    req, timeout=self.hang_timeout_s) as r:
                json.loads(r.read().decode())
            return True
        except Exception:  # noqa: BLE001 — any failure is a miss;
            # the distinction that matters (dead vs hung) is made by
            # proc.poll() above, not by the error shape
            return False

    def _on_death(self, slot: WorkerSlot, now: float,
                  why: str) -> None:
        if self.app is not None and slot.url:
            self.app.remove_worker(slot.url)
        if slot.proc is not None and slot.proc.stdout is not None:
            slot.proc.stdout.close()
        slot.deaths.append(now)
        slot.deaths = [t for t in slot.deaths
                       if now - t <= self.crash_window_s]
        self.events.emit(
            "death", slot=slot.index, worker=slot.url,
            pid=slot.proc.pid if slot.proc else None, why=why,
            deaths_in_window=len(slot.deaths))
        if len(slot.deaths) >= self.crash_limit:
            self._quarantine_slot(slot, why)
            return
        slot.state = RESTARTING
        # non-blocking backoff: the resilience schedule (exponential
        # + deterministic jitter), gated by next_attempt_at so other
        # slots keep getting checked while this one waits
        delay = self.backoff.backoff_s(("fleet-slot", slot.index),
                                       len(slot.deaths))
        slot.next_attempt_at = now + delay
        self.events.emit("backoff", slot=slot.index,
                         delay_s=round(delay, 3),
                         attempt=len(slot.deaths))
        log.warning("fleet: slot %d restarting in %.2fs (%s; death "
                    "%d/%d in window)", slot.index, delay, why,
                    len(slot.deaths), self.crash_limit)
        self._update_capacity()

    def _restart(self, slot: WorkerSlot, now: float) -> None:
        if not self._try_spawn(slot):
            # a failed spawn is another death in the window: a worker
            # that cannot even start is the purest crash loop
            self._on_death(slot, time.monotonic(), "spawn failed")
            return
        slot.state = HEALTHY
        slot.restarts += 1
        self.registry.counter("fleet.restarts_total").inc()
        self.events.emit(
            "restart", slot=slot.index, worker=slot.url,
            pid=slot.proc.pid if slot.proc else None,
            restart=slot.restarts)
        if self.app is not None:
            self.app.add_worker(slot.url)
        log.warning("fleet: slot %d restored at %s (restart #%d)",
                    slot.index, slot.url, slot.restarts)
        self._update_capacity()

    def _quarantine_slot(self, slot: WorkerSlot, why: str) -> None:
        slot.state = QUARANTINED
        slot.reason = (f"crash loop: {len(slot.deaths)} deaths in "
                       f"{self.crash_window_s:g}s ({why})")
        slot.proc = None
        self.registry.counter("fleet.slot_quarantines").inc()
        self.events.emit("quarantine", slot=slot.index,
                         worker=slot.url, reason=slot.reason)
        self.quarantine.add(
            ("fleet-slot", slot.index), f"slot{slot.index}",
            slot.url or "<never started>",
            RuntimeError(slot.reason),
            attempts=len(slot.deaths),
            classification="crash-loop", phase="serve")
        log.error("fleet: slot %d QUARANTINED (%s) — fleet continues "
                  "degraded at capacity %d", slot.index, slot.reason,
                  self.capacity)
        self._update_capacity()

    # ---- elastic scaling ----

    def _evaluate_scaling(self, now: float) -> None:
        age = None
        if self.target_queue_age_s > 0 \
                and self.queue_age_fn is not None:
            age = self.queue_age_fn()
            if age > self.target_queue_age_s:
                self._idle_ticks = 0
                if self.capacity < self.max_workers \
                        and now - self._last_scale \
                        >= self.scale_cooldown_s:
                    self.scale_up(
                        reason=f"queue_age {age:.2f}s > target "
                               f"{self.target_queue_age_s:g}s")
                return
        # second trigger, independent of backlog: the fleet SLO burn
        # rate (obs/fleetplane.py rollup). Errors and p99 blowups burn
        # budget WITHOUT aging the queue — a half-broken fleet answers
        # fast — so queue age alone would never scale it. A breach
        # also resets the idle count: a burning fleet is not idle.
        if self.burn_threshold > 0 and self.burn_rate_fn is not None:
            burn = self.burn_rate_fn()
            if burn > self.burn_threshold:
                self._idle_ticks = 0
                if self.capacity < self.max_workers \
                        and now - self._last_scale \
                        >= self.scale_cooldown_s:
                    self.scale_up(
                        reason=f"slo burn_rate {burn:.2f} > "
                               f"{self.burn_threshold:g} "
                               "(queue age below target)")
                return
        if age is None:
            return
        idle = age == 0.0
        if self.app is not None:
            idle = idle and self.app.scheduler.queue_depth() == 0 \
                and self.app.scheduler.inflight() == 0
        if not idle:
            self._idle_ticks = 0
            return
        self._idle_ticks += 1
        if self._idle_ticks >= self.scale_down_idle_ticks \
                and self.capacity > self.min_workers \
                and now - self._last_scale >= self.scale_cooldown_s:
            self.scale_down(reason=f"idle {self._idle_ticks} ticks")

    def _record_scale(self, direction: str, reason: str) -> None:
        self._last_scale = time.monotonic()
        self._idle_ticks = 0
        self.registry.counter("fleet.scale_events").inc()
        self.registry.counter(f"fleet.scale_{direction}_total").inc()
        log.warning("fleet: scale %s (%s) — capacity now %d",
                    direction, reason, self.capacity)

    def scale_up(self, reason: str = "manual") -> str | None:
        """Spawn one more worker and admit it to the ring. Returns its
        URL, or None if at max capacity / the spawn failed."""
        if self.capacity >= self.max_workers:
            return None
        with self._lock:
            index = (max((s.index for s in self._slots), default=-1)
                     + 1)
            slot = WorkerSlot(index)
            self._slots.append(slot)
        if not self._try_spawn(slot):
            slot.state = STOPPED
            slot.reason = "scale-up spawn failed"
            return None
        slot.state = HEALTHY
        if self.app is not None:
            self.app.add_worker(slot.url)
        self._record_scale("up", reason)
        self.events.emit("scale_up", slot=slot.index,
                         worker=slot.url, reason=reason,
                         capacity=self.capacity)
        self._update_capacity()
        return slot.url

    def pick_scale_down_victim(self) -> WorkerSlot | None:
        """The least-affine serving slot: smallest hash-space share
        (fewest keys remapped by its removal); deterministic
        tie-break by URL."""
        serving = {s.url: s for s in self.slots()
                   if s.state == HEALTHY and s.url}
        if not serving:
            return None
        if self.app is None:
            return serving[sorted(serving)[-1]]
        owned = self.app.ring.ownership()
        url = min(sorted(serving),
                  key=lambda u: owned.get(u, 0.0))
        return serving[url]

    def scale_down(self, reason: str = "manual") -> str | None:
        """Drain and retire the least-affine worker: no new traffic,
        in-flight forwards run to completion (bounded by
        ``drain_timeout_s``), ring removal, SIGTERM (the worker's own
        drain finishes anything the router handed it), reap. Returns
        the retired URL, or None if at min capacity."""
        if self.capacity <= self.min_workers:
            return None
        slot = self.pick_scale_down_victim()
        if slot is None:
            return None
        slot.state = DRAINING
        url = slot.url
        self.events.emit("drain", slot=slot.index, worker=url,
                         reason=reason)
        if self.app is not None:
            self.app.drain_worker(url)
            deadline = time.monotonic() + self.drain_timeout_s
            while self.app.pool.inflight(url) > 0 \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            self.app.remove_worker(url)
        self._terminate(slot)
        slot.state = STOPPED
        slot.reason = f"scaled down ({reason})"
        self._record_scale("down", reason)
        self.events.emit("scale_down", slot=slot.index, worker=url,
                         reason=reason, capacity=self.capacity)
        self._update_capacity()
        return url
