"""Cross-fleet shared-cache replication (the warm-failover tier). The
port's copy of the JAX package's fleet/cachesync.py: the same endpoint,
auth header and secret variable, so port and reference fleets replicate
into each other.

The federation makes whole-fleet failover *available*; this module
makes it *cheap*. Each fleet advertises its shared result-cache
directory over the router's ``/fleet/cache`` endpoint (list entries,
fetch one, accept a push); :class:`CacheSync`, running on the
federation process, runs anti-entropy rounds over the UP fleets:
every entry any fleet holds is pushed to every fleet missing it. When
the home fleet dies, the survivor already holds its content-keyed
results — failover is cache replay, not recompute (a worker that
replays answers with ``serve_device_passes_total == 0``). A
half-open rejoin kicks off an immediate round on a background thread
(the federation wires ``FleetPool.on_rejoin`` to
:meth:`CacheSync.sync_soon` — the hook fires inside a live request's
``settle_forward``, so the warm-up must never run inline), re-warming
a healed fleet while it serves.

Safety argument (why replication cannot corrupt results):

  - pushes are **authenticated**: cache entries are pickles, so an
    unauthenticated PUT endpoint would hand code execution to anyone
    who can reach the router port. Every push carries an HMAC-SHA256
    over ``name NUL data`` keyed by the shared fleet secret
    (``GOLEFT_TPU_FLEET_SECRET``); a router without the secret
    refuses pushes outright — replication is strictly opt-in;
  - existing entries are **never overwritten**: names are
    content-keyed (a ResultCache filename is
    ``sha256(repr(key))[:32] + ".pkl"`` where the key pins every
    input's content identity, ``file_key``/``remote_file_key``, plus
    the canonical parameters), so "same name" means "same bytes" and
    a replayed or duplicate push is an idempotent no-op;
  - writes are **atomic** (tmp + ``os.replace`` on the receiving
    router), so readers never observe a torn entry;
  - the name alphabet (32 hex chars + ``.pkl``) is validated on both
    ends — no traversal, and nothing that is not a ResultCache entry
    replicates;
  - entries above :data:`MAX_ENTRY_BYTES` are refused server-side
    (413 before the body is read), so a misbehaving peer cannot
    exhaust the torch-free router's memory.

Replication is best-effort by design: a failed pull/push is counted
(``cachesync.errors_total``) and retried on the next round; the cache
is an optimization tier and correctness never depends on it.
"""

from __future__ import annotations

import hmac as _hmac
import os
import threading
import urllib.error
import urllib.request

from ..obs.logging import get_logger

log = get_logger("fleet.cachesync")

#: header carrying the push's HMAC (hex) — see :func:`entry_hmac`
CACHE_AUTH_HEADER = "X-Goleft-Cache-Auth"


def fleet_secret() -> str | None:
    """The shared fleet secret (``GOLEFT_TPU_FLEET_SECRET``), or None
    when replication is disabled."""
    return os.environ.get("GOLEFT_TPU_FLEET_SECRET") or None


def entry_hmac(secret: str, name: str) -> "_hmac.HMAC":
    """A fresh HMAC-SHA256 over ``name NUL data`` keyed by the fleet
    secret; callers ``update()`` with the entry bytes (streamed or
    whole) and compare hexdigests with ``compare_digest``."""
    return _hmac.new(secret.encode(), name.encode() + b"\x00",
                     "sha256")

#: don't replicate entries bigger than this (a runaway pickle should
#: not saturate the control plane); env-free constant — the cap is a
#: safety valve, not a tuning knob
MAX_ENTRY_BYTES = 256 << 20


class CacheSync:
    """Anti-entropy replication over the fleets' cache endpoints.

    ``fleet_urls`` is a callable returning the base URLs to sync
    across (the federation passes its UP set, so a DOWN fleet is
    never waited on). One round: list every fleet's entries, compute
    the union, pull each missing entry from a holder, push it to each
    fleet that lacks it.
    """

    def __init__(self, fleet_urls, interval_s: float = 5.0,
                 registry=None, timeout_s: float = 30.0,
                 secret: str | None = None):
        self.fleet_urls = fleet_urls
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.secret = secret if secret is not None else fleet_secret()
        self._registry = registry
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._warned_no_secret = False

    # ---- registry plumbing (works with or without metrics) ----

    def _inc(self, name: str, n: int = 1) -> None:
        if self._registry is not None:
            self._registry.counter(name).inc(n)

    # ---- HTTP plumbing (stdlib, no retries: next round retries) ----

    def _get(self, url: str):
        req = urllib.request.Request(url)
        with urllib.request.urlopen(req,
                                    timeout=self.timeout_s) as r:
            return r.read()

    def _put(self, url: str, name: str, data: bytes) -> None:
        mac = entry_hmac(self.secret, name)
        mac.update(data)
        req = urllib.request.Request(
            url, data=data, method="PUT",
            headers={CACHE_AUTH_HEADER: mac.hexdigest()})
        with urllib.request.urlopen(req,
                                    timeout=self.timeout_s) as r:
            r.read()

    def _list(self, fleet: str) -> set | None:
        import json

        try:
            body = json.loads(self._get(
                fleet.rstrip("/") + "/fleet/cache/").decode())
            return {e["name"] for e in body.get("entries", ())
                    if e.get("size", 0) <= MAX_ENTRY_BYTES}
        except Exception as e:  # noqa: BLE001 — best-effort tier
            log.debug("cache list failed for %s: %s", fleet, e)
            self._inc("cachesync.errors_total")
            return None

    # ---- the round ----

    def sync_now(self, reason: str = "interval") -> dict:
        """One anti-entropy round; returns a summary dict (the tests'
        observable). Serialized under a lock — a rejoin-triggered
        round never interleaves with the timer's."""
        with self._lock:
            return self._sync_locked(reason)

    def sync_soon(self, reason: str = "rejoin") -> threading.Thread:
        """Run one round on a background daemon thread and return it
        (tests join it). This is what event hooks wire up — a full
        round lists/pulls/pushes every entry across every fleet under
        per-call network timeouts, so running it synchronously from
        ``FleetPool.settle_forward`` would stall the live client
        request that triggered the rejoin."""
        def _run():
            try:
                self.sync_now(reason)
            except Exception as e:  # noqa: BLE001 — hook must not raise
                log.warning("cachesync %s round failed: %s", reason, e)
                self._inc("cachesync.errors_total")

        t = threading.Thread(target=_run, name="cachesync-" + reason,
                             daemon=True)
        t.start()
        return t

    def _sync_locked(self, reason: str) -> dict:
        fleets = [u.rstrip("/") for u in self.fleet_urls()]
        summary = {"reason": reason, "fleets": len(fleets),
                   "replicated": 0, "bytes": 0, "errors": 0}
        self._inc("cachesync.rounds_total")
        if reason == "rejoin":
            self._inc("cachesync.rejoin_syncs_total")
        if self.secret is None:
            # pushes would be refused (403) without the shared
            # secret — don't burn pulls on rounds that cannot land
            if not self._warned_no_secret:
                self._warned_no_secret = True
                log.warning(
                    "cachesync: no fleet secret configured (set "
                    "GOLEFT_TPU_FLEET_SECRET on every fleet and the "
                    "federation) — cache replication is disabled")
            summary["disabled"] = True
            return summary
        if len(fleets) < 2:
            return summary
        have: dict = {}
        for f in fleets:
            names = self._list(f)
            if names is not None:
                have[f] = names
        if len(have) < 2:
            summary["errors"] = 1
            return summary
        union: set = set()
        for names in have.values():
            union |= names
        for name in sorted(union):
            holders = [f for f, names in have.items() if name in names]
            missing = [f for f in have if name not in have[f]]
            if not holders or not missing:
                continue
            data = None
            for h in holders:
                try:
                    data = self._get(
                        h + "/fleet/cache/" + name)
                    break
                except Exception as e:  # noqa: BLE001 — try next holder
                    log.debug("cache pull %s from %s failed: %s",
                              name, h, e)
                    self._inc("cachesync.errors_total")
                    summary["errors"] += 1
            if data is None:
                continue
            for m in missing:
                try:
                    self._put(m + "/fleet/cache/" + name, name, data)
                    self._inc("cachesync.entries_replicated_total")
                    self._inc("cachesync.bytes_replicated_total",
                              len(data))
                    summary["replicated"] += 1
                    summary["bytes"] += len(data)
                except Exception as e:  # noqa: BLE001 — next round retries
                    log.debug("cache push %s to %s failed: %s",
                              name, m, e)
                    self._inc("cachesync.errors_total")
                    summary["errors"] += 1
        if summary["replicated"]:
            log.info("cachesync (%s): replicated %d entr%s / %d "
                     "bytes across %d fleets", reason,
                     summary["replicated"],
                     "y" if summary["replicated"] == 1 else "ies",
                     summary["bytes"], len(have))
        return summary

    # ---- lifecycle ----

    def start(self) -> "CacheSync":
        if self.interval_s <= 0:
            return self  # sync_now-only mode (rejoin hook still works)
        self._thread = threading.Thread(
            target=self._loop, name="cachesync", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.sync_now("interval")
            except Exception as e:  # noqa: BLE001 — the loop survives
                log.warning("cachesync round failed: %s", e)
                self._inc("cachesync.errors_total")

    def poke(self) -> None:
        """Wake the timer loop early (tests)."""
        self._wake.set()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
