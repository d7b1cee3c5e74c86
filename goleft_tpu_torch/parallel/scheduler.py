"""Host shard scheduler: ordered thread-pool execution with retries and
an optional on-disk result cache.

The counterpart of ``ShardResult``, ``ResultCache``, ``file_key`` and
``run_sharded`` in the JAX package's parallel/scheduler.py, which follow
the reference's gargs pool with ``Options{Retries: 1, Ordered}``
(goleft depth/depth.go:392-399): each shard runs as a plan Step at the
``shard`` fault site under the retry policy (retried once unless its
failure is permanent), failures come back as ``.error`` while the other
shards keep running, and results are consumed in task order with at
most ``max_in_flight`` shards submitted ahead of the consumer. With a
``ResultCache`` (``depth --cache``) a shard whose key is cached is
replayed from disk without running. ``max_bytes`` bounds the cache
(serve's session cache) with mtime-LRU eviction by one elected sweeper
a directory, as in the JAX package; keys and pickles are the JAX
package's, so a cache directory either package wrote replays under the
other.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import os
import pickle
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Sequence

from .. import obs
from ..obs import get_registry
from ..plan.core import Step
from ..plan.executor import Executor
from ..resilience import faults
from ..resilience.policy import RetryPolicy


@dataclass
class ShardResult:
    key: tuple
    value: Any = None
    error: BaseException | None = None
    attempts: int = 1


#: the eviction lease file's name under a cache directory
EVICT_LEASE = ".evict.lease"


class ResultCache:
    """Pickle-per-key cache under a directory.

    Keys hash by ``repr`` (sha256, 32 hex digits) to ``<hash>.pkl``;
    writes are a tmp file + atomic ``os.replace``, so concurrent get/put
    from many threads are safe. ``hits``/``misses`` count lookups, as do
    the ``result_cache.*`` counters. A corrupt entry counts as a miss and
    is removed, so the next put heals it.

    ``max_bytes`` bounds the directory with mtime-LRU eviction: a hit
    touches its entry, and after a ``put`` the oldest entries go until
    the directory fits. One consumer of a directory sweeps: a lease file
    (``.evict.lease``, created with O_EXCL) names it, the others skip the
    scan, and a lease older than ``lease_ttl_s`` is taken over by atomic
    rename (``cache.evict_lease_steals_total``; sweeps run:
    ``cache.evict_sweeps_total``).
    """

    def __init__(self, directory: str, max_bytes: int | None = None,
                 lease_ttl_s: float = 30.0):
        self.dir = directory
        self.max_bytes = max_bytes
        self.lease_ttl_s = lease_ttl_s
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()
        # pid + instance id: distinct per consumer even when several
        # caches in ONE process share a directory (tests do)
        self._lease_token = f"{os.getpid()}.{id(self):x}"
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: tuple) -> str:
        h = hashlib.sha256(repr(key).encode()).hexdigest()[:32]
        return os.path.join(self.dir, h + ".pkl")

    def get(self, key: tuple):
        p = self._path(key)
        faults.maybe_fail("cache", key)
        try:
            with open(p, "rb") as fh:
                val = pickle.load(fh)
        except FileNotFoundError:
            with self._lock:
                self.misses += 1
            get_registry().counter("result_cache.misses_total").inc()
            return None
        except Exception:  # noqa: BLE001 — a garbled entry is a miss
            try:
                os.remove(p)
            except OSError:
                pass
            get_registry().counter("result_cache.corrupt_total").inc()
            with self._lock:
                self.misses += 1
            get_registry().counter("result_cache.misses_total").inc()
            return None
        try:
            os.utime(p)  # LRU touch: a hit is recent use
        except OSError:
            pass  # evicted/replaced underneath us — the value is fine
        with self._lock:
            self.hits += 1
        get_registry().counter("result_cache.hits_total").inc()
        return val

    def put(self, key: tuple, value) -> None:
        p = self._path(key)
        tmp = p + f".{os.getpid()}.{threading.get_ident()}.tmp"
        faults.maybe_fail("cache", key)
        try:
            with open(tmp, "wb") as fh:
                pickle.dump(value, fh)
            os.replace(tmp, p)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        if self.max_bytes is not None:
            self._evict()

    def _acquire_sweep_lease(self) -> bool:
        """May THIS consumer run the eviction sweep right now?

        True for the lease holder (created or renewed); False when
        another consumer holds a live lease (skip the scan — the
        holder sweeps for everyone). A stale lease (older than
        ``lease_ttl_s``) is stolen via atomic rename."""
        path = os.path.join(self.dir, EVICT_LEASE)
        reg = get_registry()
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            pass
        except OSError:
            return False  # unwritable dir: never fail a put over it
        else:
            try:
                os.write(fd, self._lease_token.encode())
            finally:
                os.close(fd)
            return True
        try:
            with open(path) as fh:
                owner = fh.read().strip()
            st = os.stat(path)
        except OSError:
            # the lease vanished or is being replaced under us: skip
            # this sweep, the next put re-contends
            return False
        if owner == self._lease_token:
            try:
                os.utime(path)  # renew: a live holder keeps the seat
            except OSError:
                pass
            return True
        if time.time() - st.st_mtime <= self.lease_ttl_s:
            return False
        # stale: the holder stopped sweeping (crashed worker, removed
        # slot) — take the seat over atomically
        tmp = path + f".{self._lease_token}.tmp"
        try:
            with open(tmp, "w") as fh:
                fh.write(self._lease_token)
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        reg.counter("cache.evict_lease_steals_total").inc()
        return True

    def _evict(self) -> None:
        if not self._acquire_sweep_lease():
            return
        get_registry().counter("cache.evict_sweeps_total").inc()
        entries = []
        try:
            # the eviction order is sorted(entries) below
            names = os.listdir(self.dir)
        except OSError:
            return
        for n in names:
            if not n.endswith(".pkl"):
                continue
            try:
                st = os.stat(os.path.join(self.dir, n))
            except OSError:
                continue  # concurrent eviction/replace
            entries.append((st.st_mtime_ns, st.st_size, n))
        total = sum(s for _, s, _ in entries)
        evictions = get_registry().counter(
            "result_cache.evictions_total")
        for _, size, name in sorted(entries):
            if total <= self.max_bytes:
                break
            try:
                os.remove(os.path.join(self.dir, name))
            except OSError:
                continue
            total -= size
            evictions.inc()

    def stats(self) -> dict:
        """{hits, misses, entries, bytes} snapshot (entries/bytes scan
        the directory; cheap at cache-bound entry counts)."""
        n = b = 0
        try:
            for name in os.listdir(self.dir):
                if not name.endswith(".pkl"):
                    continue
                try:
                    b += os.stat(os.path.join(self.dir, name)).st_size
                    n += 1
                except OSError:
                    continue
        except OSError:
            pass
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": n, "bytes": b}


def file_key(path: str) -> tuple:
    """A file's content identity for cache and checkpoint keys:
    ``(abspath, size, mtime_ns)``; a remote URL's is ``(url, length,
    etag-token)`` (io/remote.py), the same shape, so an object rewrite
    changes the key as an mtime bump does."""
    if "://" in path:
        from ..io import remote

        if remote.is_remote(path):
            return remote.remote_file_key(path)
    st = os.stat(path)
    return (os.path.abspath(path), st.st_size, st.st_mtime_ns)


def run_sharded(
    tasks: Sequence[tuple] | Iterable[tuple],
    fn: Callable[..., Any],
    processes: int = 4,
    retries: int = 1,
    cache: ResultCache | None = None,
    max_in_flight: int | None = None,
) -> Iterable[ShardResult]:
    """Run fn(*task) per task on a thread pool; yield ShardResults in
    task order. Each task is a Step keyed by ``tuple(task)`` at the
    ``shard`` fault site (looked up in and put into ``cache`` when one
    is given). Failed shards come back with ``.error`` set and the rest
    keep running (the reference's max-exit-code behavior). The workers'
    spans parent under the calling thread's span."""
    pex = Executor(cache=cache, policy=RetryPolicy(retries=retries))
    span_ctx = obs.capture()

    def attempt(task) -> ShardResult:
        key = tuple(task)
        with obs.attach(span_ctx):
            out = pex.run_step(Step(key=key, fn=lambda: fn(*task),
                                    site="shard",
                                    cacheable=cache is not None))
        return ShardResult(key, out.value, error=out.error,
                           attempts=out.attempts)

    if max_in_flight is None:
        max_in_flight = 2 * max(processes, 1)
    max_in_flight = max(max_in_flight, 1)
    task_iter = iter(tasks)
    with cf.ThreadPoolExecutor(max_workers=max(processes, 1)) as ex:
        pending: deque = deque()

        def top_up():
            while len(pending) < max_in_flight:
                try:
                    t = next(task_iter)
                except StopIteration:
                    return
                pending.append(ex.submit(attempt, t))

        top_up()
        while pending:
            res = pending.popleft().result()
            top_up()
            yield res
