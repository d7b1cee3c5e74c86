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
replayed from disk without running. The cache's size bound and
eviction (serve's, in the JAX package) are not ported: no command of
the port bounds or shares a cache directory.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import os
import pickle
import threading
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


class ResultCache:
    """Pickle-per-key cache under a directory.

    Keys hash by ``repr`` (sha256, 32 hex digits) to ``<hash>.pkl``;
    writes are a tmp file + atomic ``os.replace``, so concurrent get/put
    from many threads are safe. ``hits``/``misses`` count lookups, as do
    the ``result_cache.*`` counters. A corrupt entry counts as a miss and
    is removed, so the next put heals it.
    """

    def __init__(self, directory: str):
        self.dir = directory
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: tuple) -> str:
        h = hashlib.sha256(repr(key).encode()).hexdigest()[:32]
        return os.path.join(self.dir, h + ".pkl")

    def _miss(self) -> None:
        with self._lock:
            self.misses += 1
        get_registry().counter("result_cache.misses_total").inc()

    def get(self, key: tuple):
        p = self._path(key)
        faults.maybe_fail("cache", key)
        try:
            with open(p, "rb") as fh:
                val = pickle.load(fh)
        except FileNotFoundError:
            self._miss()
            return None
        except Exception:  # noqa: BLE001 — a garbled entry is a miss
            try:
                os.remove(p)
            except OSError:
                pass
            get_registry().counter("result_cache.corrupt_total").inc()
            self._miss()
            return None
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
