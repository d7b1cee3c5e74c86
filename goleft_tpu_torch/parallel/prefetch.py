"""Async prefetch and staging: the counterpart of the JAX package's
parallel/prefetch.py, trimmed to what the cohort path uses.

- :class:`ChunkPrefetcher`: a bounded, ordered producer/consumer over a
  sequence of chunk descriptors. ``produce(meta)`` runs on worker
  threads up to ``depth`` chunks ahead of the consumer; chunks come back strictly in submission order; a worker's
  exception surfaces at its chunk's position as
  :class:`PrefetchWorkerError`, after every earlier chunk; closing (or
  abandoning iteration) cancels queued work. ``depth=0`` is the caller's
  serial path, so this class runs only with depth >= 1.
- :func:`stage_block_arrays`: the compressed-wire staging of
  ``--decode-device`` through pinned host buffers.

Span propagation and the memory-pressure clamp of the reference are not
ported.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from .. import obs
from ..obs import get_registry


class PrefetchCancelled(Exception):
    """Raised inside workers when the prefetcher was closed mid-run."""


class PrefetchWorkerError(RuntimeError):
    """A producer failed; re-raised at the chunk's ordered position."""

    def __init__(self, index: int, meta, cause: BaseException):
        super().__init__(
            f"prefetch worker failed on chunk {index} ({meta!r}): "
            f"{cause!r}")
        self.index = index
        self.meta = meta
        self.cause = cause


@dataclass
class StagedChunk:
    """One chunk, produced."""

    index: int
    meta: Any
    value: Any


class ChunkPrefetcher:
    """Bounded ordered producer/consumer over chunk descriptors; use as a
    context manager (or call :meth:`close`)."""

    def __init__(self, chunks: Sequence | Iterable,
                 produce: Callable[[Any], Any],
                 depth: int, processes: int):
        if depth < 1:
            raise ValueError(
                f"prefetch depth must be >= 1 (got {depth}); depth 0 "
                "is the caller's serial path")
        self._meta = iter(enumerate(chunks))
        self._produce = produce
        self.depth = depth
        self._ex = cf.ThreadPoolExecutor(
            max_workers=max(1, min(processes, depth)),
            thread_name_prefix="goleft-prefetch")
        self._pending: deque = deque()  # (index, meta, future), ordered
        self._cancelled = threading.Event()
        self._closed = False
        reg = get_registry()
        self._c_chunks = reg.counter("prefetch.chunks_total")
        self._c_staged = reg.counter("prefetch.bytes_staged_total")
        # producer spans parent under the constructing thread's span
        self._span_ctx = obs.capture()

    def _run_one(self, index: int, meta):
        if self._cancelled.is_set():
            raise PrefetchCancelled(index)
        with obs.attach(self._span_ctx):
            value = self._produce(meta)
        self._c_staged.inc(int(getattr(value, "nbytes", 0)))
        self._c_chunks.inc()
        return value

    def _top_up(self) -> None:
        while len(self._pending) < self.depth:
            try:
                index, meta = next(self._meta)
            except StopIteration:
                break
            self._pending.append(
                (index, meta, self._ex.submit(self._run_one, index, meta)))

    def __iter__(self):
        try:
            self._top_up()
            while self._pending:
                index, meta, fut = self._pending.popleft()
                try:
                    value = fut.result()
                except (PrefetchCancelled, cf.CancelledError):
                    return
                except Exception as e:  # noqa: BLE001 — ordered rethrow
                    raise PrefetchWorkerError(index, meta, e) from e
                # refill BEFORE handing the chunk over, so later chunks
                # decode while the consumer computes
                self._top_up()
                yield StagedChunk(index, meta, value)
        finally:
            self.close()

    def close(self) -> None:
        """Cancel outstanding work and release the pool (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._cancelled.set()
        for _, _, fut in self._pending:
            fut.cancel()
        self._pending.clear()
        self._ex.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def stage_block_arrays(host_arrays: dict, device) -> dict:
    """Stage one group of host arrays to ``device``, counted.

    The compressed-wire staging step of ``--decode-device``
    (ops/rans_device.py): the dict holds a launch group's still-compressed
    payloads, back to back (each rounded up to 16 bytes), plus their
    table arrays, so ``prefetch.bytes_staged_total`` /
    ``prefetch.bytes_transferred_total`` count those bytes. On a
    CUDA device each array goes through a pinned host buffer and a
    ``non_blocking`` copy on the current stream (ops/rans_device.py runs
    it under the calling thread's own stream). PyTorch's pinned-memory
    allocator records an event on the stream current at the copy and
    hands the buffer out again only after that event, so a buffer is
    not reused before the copy on its own stream has run."""
    device = torch.device(device)
    out = {}
    for k, a in host_arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    nbytes = sum(int(a.nbytes) for a in host_arrays.values())
    reg = get_registry()
    reg.counter("prefetch.bytes_staged_total").inc(nbytes)
    reg.counter("prefetch.bytes_transferred_total").inc(nbytes)
    return out
