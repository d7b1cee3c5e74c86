"""Host shard scheduler: ordered thread-pool execution with retries.

The counterpart of ``ShardResult`` and ``run_sharded`` in the JAX
package's parallel/scheduler.py, which follow the reference's gargs pool
with ``Options{Retries: 1, Ordered}`` (goleft depth/depth.go:392-399):
each shard is retried once unless its failure is permanent (bad input
fails the same way again), failures come back as ``.error`` while the
other shards keep running, and results are consumed in task order with
at most ``max_in_flight`` shards submitted ahead of the consumer. The
result cache (``--cache``) is not ported yet.
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Sequence

#: deterministic failures: retrying cannot change the outcome
PERMANENT_TYPES = (
    FileNotFoundError, PermissionError, IsADirectoryError,
    NotADirectoryError, ValueError, TypeError, KeyError, IndexError,
    AttributeError, ZeroDivisionError, AssertionError,
    NotImplementedError, EOFError, UnicodeError,
)


@dataclass
class ShardResult:
    key: tuple
    value: Any = None
    error: BaseException | None = None
    attempts: int = 1


def _attempt(fn, task, retries: int, backoff_s: float) -> ShardResult:
    key = tuple(task)
    attempt = 0
    while True:
        attempt += 1
        try:
            return ShardResult(key, fn(*task), attempts=attempt)
        except Exception as e:  # noqa: BLE001 — classified below
            if isinstance(e, PERMANENT_TYPES) or attempt > retries:
                return ShardResult(key, error=e, attempts=attempt)
            time.sleep(backoff_s * attempt)


def run_sharded(
    tasks: Sequence[tuple] | Iterable[tuple],
    fn: Callable[..., Any],
    processes: int = 4,
    retries: int = 1,
    max_in_flight: int | None = None,
    backoff_s: float = 0.05,
) -> Iterable[ShardResult]:
    """Run fn(*task) per task on a thread pool; yield ShardResults in
    task order. Failed shards come back with ``.error`` set and the rest
    keep running (the reference's max-exit-code behavior)."""
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
                pending.append(ex.submit(_attempt, fn, t, retries,
                                         backoff_s))

        top_up()
        while pending:
            res = pending.popleft().result()
            top_up()
            yield res
