"""The process world and its (data, seq) mesh: the counterpart of the JAX
package's parallel/mesh.py.

The JAX package lays the devices of a ``jax.distributed`` world out as a
2-D ``Mesh``: ``data`` (samples) by ``seq`` (genome position). Here each
process of a ``torch.distributed`` world is one rank of that grid, on
one card (``cuda:{local rank % cards}``) or, when the caller asks for
it, the CPU. The collectives run on the Gloo backend over host tensors:
what crosses between ranks is small (a carry of S int32, window means,
the cohort matrix), and NCCL refuses two ranks of one communicator on
the same card, which is how a one-card host runs a world of two.

- :func:`init_distributed` reads the JAX package's variables
  (``GOLEFT_TPU_COORDINATOR``, ``GOLEFT_TPU_NUM_PROCESSES``,
  ``GOLEFT_TPU_PROCESS_ID``) and joins the world; without the
  coordinator it does nothing and imports no torch, so the dispatcher
  calls it for every command.
- :func:`world` is (size, rank) of the initialized process group. It
  raises when ``GOLEFT_TPU_NUM_PROCESSES`` asks for a world that is not
  up: nothing quietly runs a world of one.
- :func:`make_mesh` builds a :class:`Mesh` over the world: rank r at
  (r // seq, r % seq), the JAX package's reshape, with one Gloo group
  per seq row and one per data column.

Every collective diverts fd 1 to stderr while it runs (Gloo may print to
stdout, where process 0 writes its matrix).
"""

from __future__ import annotations

import atexit
import contextlib
import os
import sys

import numpy as np


def best_grid(n: int, prefer_seq: int | None = None) -> tuple[int, int]:
    """(data, seq) grid for n devices; seq gets the larger factor since
    genome length dwarfs cohort size."""
    if prefer_seq:
        if n % prefer_seq:
            raise ValueError(f"{prefer_seq} does not divide {n}")
        return n // prefer_seq, prefer_seq
    best = (1, n)
    for d in range(1, int(np.sqrt(n)) + 1):
        if n % d == 0:
            best = (d, n // d)
    return best


@contextlib.contextmanager
def stdout_to_stderr():
    """Divert fd 1 to stderr (fd-level: catches native prints too)."""
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        os.dup2(2, 1)
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


_distributed_up = False


def _asked_processes() -> int:
    return int(os.environ.get("GOLEFT_TPU_NUM_PROCESSES", "1") or 1)


def init_distributed() -> None:
    """Join the world named by ``GOLEFT_TPU_COORDINATOR`` (host:port of
    rank 0's rendezvous), ``GOLEFT_TPU_NUM_PROCESSES`` and
    ``GOLEFT_TPU_PROCESS_ID`` on the Gloo backend. Idempotent; a no-op
    (importing no torch) without the coordinator; a failed rendezvous
    raises."""
    global _distributed_up

    addr = os.environ.get("GOLEFT_TPU_COORDINATOR")
    if not addr or _distributed_up:
        return
    import torch.distributed as dist

    with stdout_to_stderr():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{addr}",
            world_size=_asked_processes(),
            rank=int(os.environ.get("GOLEFT_TPU_PROCESS_ID", "0")))
    _distributed_up = True
    atexit.register(_leave_world)


def _leave_world() -> None:
    """Tear the process group down while the interpreter is alive: left
    to the exit's static destructors, Gloo can abort the process."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple[int, int]:
    """(size, rank) of the initialized process group, after
    :func:`init_distributed`; (1, 0) when no world was asked for."""
    init_distributed()
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    if _asked_processes() > 1:
        raise ValueError(
            f"GOLEFT_TPU_NUM_PROCESSES={_asked_processes()} asks for a "
            "world of processes, and none is up: set "
            "GOLEFT_TPU_COORDINATOR and GOLEFT_TPU_PROCESS_ID")
    return 1, 0


def rank_device(device=None, rank: int | None = None):
    """The device of this process: ``device`` when the caller names one
    (``"cpu"``, ``"cuda:1"``), else ``cuda:{world rank % cards}``. Raises
    :class:`~goleft_tpu_torch.errors.NoCudaDevice` without a card."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)  # raises without a card
    if device is not None or dev.type != "cuda":
        return dev
    if rank is None:
        rank = world()[1]
    return torch.device("cuda", rank % torch.cuda.device_count())


def _host(t):
    return t.detach().to("cpu").contiguous()


def all_gather(t, group=None, size: int | None = None) -> list:
    """Every rank's ``t`` (same shape and dtype on each), in group order,
    as host tensors; a group of one gathers nothing."""
    import torch
    import torch.distributed as dist

    t = _host(t)
    size = dist.get_world_size(group) if size is None else size
    if size == 1:
        return [t]
    out = [torch.empty_like(t) for _ in range(size)]
    with stdout_to_stderr():
        dist.all_gather(out, t, group=group)
    return out


def barrier() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        with stdout_to_stderr():
            dist.barrier()


class Mesh:
    """One rank's view of the (data, seq) grid of the world.

    ``shape`` maps the axis names to sizes, as the JAX mesh's does;
    ``data_index``/``seq_index`` place this rank; ``device`` is where its
    blocks live. ``seq_group``/``data_group`` are the Gloo groups of its
    seq row and data column (None in a world of one)."""

    def __init__(self, data: int, seq: int, rank: int, device,
                 seq_group=None, data_group=None):
        self.shape = {"data": data, "seq": seq}
        self.size = data * seq
        self.rank = rank
        self.data_index, self.seq_index = divmod(rank, seq)
        self.device = device
        self.seq_group = seq_group
        self.data_group = data_group

    def seq_rank(self, q: int) -> int:
        """The world rank at seq position ``q`` of this rank's row."""
        return self.data_index * self.shape["seq"] + q

    def seq_gather(self, t) -> list:
        """``t`` of every rank of this seq row, in seq order (host)."""
        return all_gather(t, self.seq_group, self.shape["seq"])

    def data_gather(self, t) -> list:
        """``t`` of every rank of this data column, in data order."""
        return all_gather(t, self.data_group, self.shape["data"])

    def world_gather(self, t) -> list:
        """``t`` of every rank, in rank order."""
        return all_gather(t, None, self.size)

    def seq_broadcast(self, t, q: int):
        """Seq position ``q``'s ``t`` on every rank of the row (host)."""
        import torch.distributed as dist

        t = _host(t)
        if self.shape["seq"] > 1:
            with stdout_to_stderr():
                dist.broadcast(t, src=self.seq_rank(q),
                               group=self.seq_group)
        return t

    def seq_shift(self, t, k: int):
        """Send ``t`` to seq position ``seq_index + k`` and receive the
        ``t`` of ``seq_index - k`` (None at positions < k): one step of
        the carry's doubling scan, as send/recv pairs."""
        import torch
        import torch.distributed as dist

        t = _host(t)
        q, n = self.seq_index, self.shape["seq"]
        reqs, got = [], None
        with stdout_to_stderr():
            if q + k < n:
                reqs.append(dist.isend(t, dst=self.seq_rank(q + k),
                                       group=self.seq_group))
            if q >= k:
                got = torch.empty_like(t)
                reqs.append(dist.irecv(got, src=self.seq_rank(q - k),
                                       group=self.seq_group))
            for r in reqs:
                r.wait()
        return got


def make_mesh(n_devices: int | None = None,
              prefer_seq: int | None = None, device=None) -> Mesh:
    """The world's (data, seq) mesh from :func:`best_grid`; a world of
    one is a 1 x 1 mesh. ``n_devices`` must be the world's size (a rank
    is a process); ``device`` as :func:`rank_device`. Every rank calls
    this, in the same order as its other group creations."""
    size, rank = world()
    n = n_devices or size
    if n != size:
        raise ValueError(f"a mesh of {n} ranks in a world of {size} "
                         "processes")
    d, s = best_grid(n, prefer_seq)
    dev = rank_device(device, rank)
    if size == 1:
        return Mesh(d, s, rank, dev)
    import torch.distributed as dist

    rows = [dist.new_group([r * s + j for j in range(s)], backend="gloo")
            for r in range(d)]
    cols = [dist.new_group([r * s + j for r in range(d)], backend="gloo")
            for j in range(s)]
    return Mesh(d, s, rank, dev, rows[rank // s], cols[rank % s])
