"""Async prefetch and staging: the counterpart of the JAX package's
parallel/prefetch.py.

- :class:`ChunkPrefetcher`: a bounded, ordered producer/consumer over a
  sequence of chunk descriptors. ``produce(meta)`` (then
  ``transfer(value, meta)``, when given: the host-to-device copy) runs
  on worker threads up to ``depth`` chunks ahead of the consumer, under
  the consumer's span; chunks come back strictly in submission order; a
  worker's exception surfaces at its chunk's position as
  :class:`PrefetchWorkerError`, after every earlier chunk; closing (or
  abandoning iteration) cancels queued work. While a memory-pressure
  controller of the process is tripped (obs/memplane.py), staging
  clamps to one chunk in flight. ``depth=0`` is the caller's serial
  path, so this class runs only with depth >= 1.
- :func:`stage_block_arrays`: the compressed-wire staging of
  ``--decode-device`` through pinned host buffers.
- :func:`run_prefetched_cohort`: the chunked cohort step of
  parallel/cohort_pipeline.py fed through the prefetcher, with its
  ``decode``/``stage``/``transfer``/``compute`` spans and the resume of
  a checkpointed prefix of chunks.
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
from ..utils.decode_scaling import auto_processes


def _nbytes(value) -> int:
    """Bytes of a staged or transferred chunk value (tuples of arrays or
    tensors); 0 for opaque values."""
    if isinstance(value, (tuple, list)):
        return sum(_nbytes(a) for a in value)
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return int(getattr(value, "nbytes", 0) or 0)


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
                 depth: int = 2,
                 transfer: Callable[[Any, Any], Any] | None = None,
                 processes: int | None = None):
        if depth < 1:
            raise ValueError(
                f"prefetch depth must be >= 1 (got {depth}); depth 0 "
                "is the caller's serial path")
        self._meta = iter(enumerate(chunks))
        self._produce = produce
        self._transfer = transfer
        self.depth = depth
        if processes is None:
            processes = auto_processes()
        self._ex = cf.ThreadPoolExecutor(
            max_workers=max(1, min(processes, depth)),
            thread_name_prefix="goleft-prefetch")
        self._pending: deque = deque()  # (index, meta, future), ordered
        self._cancelled = threading.Event()
        self._closed = False
        reg = get_registry()
        self._c_chunks = reg.counter("prefetch.chunks_total")
        self._c_staged = reg.counter("prefetch.bytes_staged_total")
        self._c_xfer = reg.counter("prefetch.bytes_transferred_total")
        self._g_depth = reg.gauge("prefetch.queue_depth")
        # producer spans parent under the constructing thread's span
        self._span_ctx = obs.capture()

    def _run_one(self, index: int, meta):
        if self._cancelled.is_set():
            raise PrefetchCancelled(index)
        with obs.attach(self._span_ctx):
            value = self._produce(meta)
            self._c_staged.inc(_nbytes(value))
            if self._transfer is not None \
                    and not self._cancelled.is_set():
                value = self._transfer(value, meta)
                self._c_xfer.inc(_nbytes(value))
        self._c_chunks.inc()
        return value

    def _top_up(self) -> None:
        # memory backpressure: while an armed pressure controller of this
        # process is tripped, stage one chunk at a time
        from ..obs.memplane import under_pressure

        depth = 1 if under_pressure() else self.depth
        while len(self._pending) < depth:
            try:
                index, meta = next(self._meta)
            except StopIteration:
                break
            self._pending.append(
                (index, meta, self._ex.submit(self._run_one, index, meta)))
        self._g_depth.set(len(self._pending))

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


def _pack_chunk(starts, ends, keep, n_seq: int, shard_len: int):
    """Stage one chunk: partition endpoint arrays for the (data, seq)
    layout and pad the per-shard width to a power-of-two bucket, so that
    chunks of similar occupancy share a workspace layout."""
    from ..ops.coverage import bucket_size
    from .sharded_coverage import partition_segments

    seg_s, seg_e, kp = partition_segments(starts, ends, keep, n_seq,
                                          shard_len)
    per = seg_s.shape[1] // n_seq
    b = bucket_size(per, minimum=64)
    if b != per:
        seg_s, seg_e, kp = partition_segments(starts, ends, keep,
                                              n_seq, shard_len,
                                              pad_to=b)
    return seg_s, seg_e, kp


def run_prefetched_cohort(mesh, shard_len: int, window: int,
                          chunks: Sequence, decode_chunk,
                          n_samples: int,
                          prefetch_depth: int = 2,
                          carry_mode: str = "all_gather",
                          timer=None, processes: int | None = None,
                          keep_depth: bool = True,
                          checkpoint=None):
    """The chunked cohort path through the staging pipeline, on every
    rank of ``mesh``.

    ``chunks`` is an ordered list of chunk descriptors; each covers the
    next ``mesh.shape['seq'] * shard_len`` genome positions.
    ``decode_chunk(desc) → (starts, ends, keep)`` returns (S, n) int32
    CHUNK-RELATIVE segment endpoint arrays (every rank decodes the same
    global arrays, the JAX package's contract); the producer partitions
    them (:func:`_pack_chunk`) and copies this rank's block to its
    device. Per-stage spans land in ``timer`` (decode / stage / transfer
    / compute).

    ``prefetch_depth=0`` runs the same code strictly serially. Returns
    dict(depth?, wmeans, lambdas, cn, carry), global host arrays: depth
    (concatenated across chunks; omitted when ``keep_depth`` is False,
    and then no per-base array leaves the card), window means, the EM
    outputs and the final carry, bitwise those of
    :func:`~.cohort_pipeline.build_cohort_step` fed the same segments.

    ``checkpoint`` (a resilience CheckpointStore of this process)
    persists each consumed chunk's global (depth slice, wsums, carry)
    after its compute; because the carry threads chunk to chunk, resume
    restores the longest committed prefix of chunks (decode, stage,
    transfer and compute all skipped), re-seeds the carry from its last
    chunk and runs the rest. Keys bind the run geometry (shard_len,
    window, carry_mode, n_samples, keep_depth) and each chunk's
    descriptor.
    """
    from ..plan import Executor as PlanExecutor, Step
    from ..utils.profiling import StageTimer
    from .cohort_pipeline import build_chunked_cohort_step

    timer = timer if timer is not None else StageTimer()
    n_seq = mesh.shape["seq"]
    chunk_fn, finalize_fn, cov = build_chunked_cohort_step(
        mesh, shard_len, window, carry_mode=carry_mode)
    dev = mesh.device

    def produce(desc):
        with timer.stage("decode"):
            starts, ends, keep = decode_chunk(desc)
        with timer.stage("stage"):
            return _pack_chunk(starts, ends, keep, n_seq, shard_len)

    def transfer(value, desc):
        with timer.stage("transfer"):
            return cov.put(*value)

    def rank_rows(arr):
        """This rank's samples of a global (S, ...) array."""
        rows = arr.shape[0] // mesh.shape["data"]
        return arr[mesh.data_index * rows:(mesh.data_index + 1) * rows]

    def global_carry(c):
        return np.concatenate([p.numpy() for p in mesh.data_gather(c)])

    rows = n_samples // mesh.shape["data"]
    carry = torch.zeros(rows, dtype=torch.int32, device=dev)
    depth_parts: list[np.ndarray] = []
    wsums_parts = []

    def _chunk_key(i, desc):
        return ("prefetched_cohort", shard_len, window, carry_mode,
                n_samples, keep_depth, i, repr(desc))

    done_prefix = 0
    if checkpoint is not None:
        # the carry threads chunk to chunk, so only a contiguous
        # committed PREFIX is resumable
        for i, desc in enumerate(chunks):
            rec = checkpoint.get(_chunk_key(i, desc))
            if rec is None:
                break
            if keep_depth:
                depth_parts.append(rec["depth"])
            wsums_parts.append(torch.from_numpy(
                np.ascontiguousarray(cov.block(rec["wsums"]))).to(dev))
            carry = torch.from_numpy(
                np.ascontiguousarray(rank_rows(rec["carry"]))).to(dev)
            done_prefix = i + 1

    pex = PlanExecutor(checkpoint=checkpoint)

    def consume(staged: StagedChunk):
        """One chunk's compute and commit as a plan Step, not resumable
        on its own (the carry threads chunk to chunk: resume is the
        prefix scan above); the Step owns the atomic commit and the
        'shard' fault site."""
        i = staged.index + done_prefix

        def fn():
            nonlocal carry
            with timer.stage("compute"):
                depth, wsums, carry = chunk_fn(staged.value, carry)
                if keep_depth:
                    depth_parts.append(cov.assemble_rows(depth))
                wsums_parts.append(wsums)
            return wsums, carry

        def commit(res):
            wsums, carry2 = res
            rec = {"wsums": cov.assemble_rows(wsums),
                   "carry": global_carry(carry2)}
            if keep_depth:
                rec["depth"] = depth_parts[-1]
            return [(_chunk_key(i, staged.meta), rec)]

        pex.run(Step(
            key=("prefetched_cohort", i), fn=fn, site="shard",
            retry=False, resumable=False,
            checkpoint_key=(_chunk_key(i, staged.meta)
                            if checkpoint is not None else None),
            commit=commit))

    todo = list(chunks)[done_prefix:]
    if prefetch_depth < 1:
        for i, desc in enumerate(todo):
            consume(StagedChunk(i, desc, transfer(produce(desc), desc)))
    else:
        with ChunkPrefetcher(todo, produce, depth=prefetch_depth,
                             transfer=transfer,
                             processes=processes) as pf:
            for staged in pf:
                consume(staged)

    with timer.stage("compute"):
        out = dict(finalize_fn(wsums_parts))
    out["carry"] = global_carry(carry)
    if keep_depth:
        out["depth"] = np.concatenate(depth_parts, axis=1)
    return out
