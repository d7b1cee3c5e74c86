"""Sequence-parallel coverage over the ranks of a mesh: the counterpart of
the JAX package's parallel/sharded_coverage.py.

The genome axis is cut into ``n_seq`` shards of ``shard_len`` bases, one
a seq rank; samples split over the data ranks. Each rank runs its local
step on the hand-written depth kernel (csrc/depth_kernel.cu through
``ops/depth_kernel.py::fused_depth_batch``: the int32 wire with its keep
mask, all the rank's samples in one launch, dense depth): endpoints of
this shard only, so a read that starts in a shard to the left adds its
-1 here and nothing else, and the local depth is negative until the
carry is added. The carry, the exclusive prefix of the shard totals to
the left, goes over the seq row's Gloo group: one ``all_gather``, or the
JAX package's Hillis-Steele doubling as send/recv pairs. Then

    depth = local depth + carry,  wsums = local wsums + carry * window

the second in float32 as the JAX package's chunked step adds its carry:
exact while window sums stay below 2^24, the bound the JAX package's own
float32 window sums rely on. On the CPU the local step is the kernel's
plain version.

Layout contract (the JAX package's): every rank passes the same global
endpoint arrays, partitioned per seq shard by :func:`partition_segments`
(S, n_seq * per); a rank takes its data rows and its shard's columns.
"""

from __future__ import annotations

import numpy as np

#: the cap of the local step: none (the JAX package's sharded depth
#: clips nothing)
NO_CAP = 2**31 - 1


class ShardedDepth:
    """``fn(seg_s, seg_e, keep)`` of :func:`sharded_depth_fn`, with its
    stages apart: :meth:`put` (this rank's block of the global arrays,
    onto its device), :meth:`local` (the kernel, then the carry) and
    :meth:`assemble` (the global arrays on every rank)."""

    def __init__(self, mesh, shard_len: int, window: int,
                 carry_mode: str = "all_gather"):
        if shard_len % window:
            raise ValueError("shard_len must be a multiple of window")
        if carry_mode not in ("all_gather", "scan"):
            raise ValueError(f"unknown carry_mode {carry_mode!r}")
        self.mesh = mesh
        self.shard_len = shard_len
        self.window = window
        self.carry_mode = carry_mode
        self.n_seq = mesh.shape["seq"]

    def block(self, arr):
        """This rank's block of a global (S, n_seq * k) array: its data
        rows, its seq shard's columns."""
        d, q = self.mesh.data_index, self.mesh.seq_index
        n_data = self.mesh.shape["data"]
        S, width = arr.shape
        if S % n_data or width % self.n_seq:
            raise ValueError(f"a ({S}, {width}) array does not split "
                             f"over a {n_data} x {self.n_seq} mesh")
        rows, cols = S // n_data, width // self.n_seq
        return arr[d * rows:(d + 1) * rows, q * cols:(q + 1) * cols]

    def put(self, seg_s, seg_e, keep):
        """The rank's blocks of the global int32 endpoint arrays and keep
        mask as contiguous tensors on the rank's device (from pinned
        host memory, asynchronously, on a card)."""
        import torch

        dev = self.mesh.device
        out = []
        for a, dt in ((seg_s, np.int32), (seg_e, np.int32),
                      (keep, np.bool_)):
            t = torch.from_numpy(np.ascontiguousarray(
                self.block(np.asarray(a)), dtype=dt))
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            out.append(t)
        return tuple(out)

    def carry(self, totals):
        """The exclusive prefix of the seq row's shard totals (host
        int32, one per local sample)."""
        import torch

        q = self.mesh.seq_index
        if self.carry_mode == "all_gather":
            parts = self.mesh.seq_gather(totals)
            carry = torch.zeros_like(parts[0])
            for p in parts[:q]:
                carry += p
            return carry
        acc = totals.to("cpu").clone()
        k = 1
        while k < self.n_seq:
            got = self.mesh.seq_shift(acc, k)
            if got is not None:
                acc += got
            k *= 2
        return acc - totals.to("cpu")

    def local(self, seg_s, seg_e, keep):
        """(depth (rows, shard_len) int32, wsums (rows, shard_len //
        window) float32) of this rank's samples over its shard, carry
        added, on its device."""
        import torch

        from ..ops.depth_kernel import fused_depth_batch

        rows, per = seg_s.shape
        lo = self.mesh.seq_index * self.shard_len
        offsets = [i * per for i in range(rows + 1)]
        sums, _, _, depth = fused_depth_batch(
            seg_s.reshape(-1), seg_e.reshape(-1), offsets, lo, lo,
            lo + self.shard_len, NO_CAP, 1, 0, self.shard_len, self.window,
            keep=keep.reshape(-1), dense=True)
        carry = self.carry(depth[:, -1]).to(depth.device)
        depth = depth + carry[:, None]
        wsums = sums + (carry.to(torch.float32) * self.window)[:, None]
        return depth, wsums

    def __call__(self, seg_s, seg_e, keep):
        return self.local(*self.put(seg_s, seg_e, keep))

    def assemble_rows(self, blk) -> np.ndarray:
        """A per-rank (rows, k) block → the global (S, n_seq * k) host
        array, on every rank."""
        parts = self.mesh.world_gather(blk)
        n_data = self.mesh.shape["data"]
        return np.concatenate([
            np.concatenate([parts[d * self.n_seq + q].numpy()
                            for q in range(self.n_seq)], axis=1)
            for d in range(n_data)], axis=0)

    def assemble(self, depth, wsums):
        """(global depth (S, n_seq * shard_len), global wsums) on every
        rank, as host numpy."""
        return self.assemble_rows(depth), self.assemble_rows(wsums)


def sharded_depth_fn(mesh, shard_len: int, window: int,
                     carry_mode: str = "all_gather") -> ShardedDepth:
    """The (samples x genome) coverage function over ``mesh``:
    ``fn(seg_s, seg_e, keep)`` with global (S, n_seq * per) int32
    endpoints and bool keep (:func:`partition_segments`) → this rank's
    (depth (S / n_data, shard_len) int32, wsums (S / n_data, shard_len /
    window) float32) on its device; ``fn.assemble(depth, wsums)`` gives
    the global arrays. ``carry_mode``: "all_gather" (one gather of the
    seq row's totals) or "scan" (log2(n_seq) send/recv doubling
    steps)."""
    return ShardedDepth(mesh, shard_len, window, carry_mode)


def partition_segments(seg_start, seg_end, keep, n_seq: int,
                       shard_len: int, pad_to: int | None = None):
    """Host-side endpoint partitioning for the sharded kernel.

    Each segment's +1 endpoint goes to the shard containing its start and
    its −1 endpoint to the shard containing its end; an endpoint at or
    past the sharded extent is dropped (its effect is identical to
    clipping at the global end). Returns (seg_s, seg_e, keep) arrays of
    shape (S, n_seq * per_shard) laid out shard-major for P("data","seq").
    """
    S = seg_start.shape[0]
    L = n_seq * shard_len

    # Semantics: half-open on the same side for starts and ends — an end
    # exactly at a shard's lo belongs to THAT shard as a −1 at local
    # position 0 (putting it at the previous shard's top slot would drop
    # it from that shard's total and over-carry every shard to the
    # right). Endpoints at or past the sharded extent are dropped
    # (identical effect to clipping at the global end).
    #
    # Vectorized in two passes. The common case — position-sorted
    # endpoints — takes a searchsorted fast path with no division,
    # bincount, or gather.

    def analyze(vals):
        """→ (vals_in_range, per_shard_counts, shard_ids_or_None)."""
        n = len(vals)
        sorted_ = n < 2 or bool(vals[0] <= vals[-1]) and bool(
            np.all(vals[:-1] <= vals[1:])
        )
        if sorted_:
            lo = int(np.searchsorted(vals, 0))
            hi = int(np.searchsorted(vals, L))
            vals = vals[lo:hi]  # view, no copy
            bounds = np.arange(1, n_seq, dtype=np.int64) * shard_len
            off = np.searchsorted(vals, bounds)
            counts = np.diff(np.concatenate(([0], off, [len(vals)])))
            return vals, counts, None
        vals = vals[(vals >= 0) & (vals < L)]
        q = vals.astype(np.int64) // shard_len
        return vals, np.bincount(q, minlength=n_seq), q

    def place(out_b, vals, counts, q):
        """Scatter vals into (shard, rank) slots of one sample row."""
        if not len(vals):
            return
        if q is None:  # sorted: flat slot = i + (shard*per − shard_off)
            off = np.cumsum(counts[:-1])
            base = np.arange(n_seq, dtype=np.int64) * per
            base[1:] -= off
            flat = np.arange(len(vals), dtype=np.int64) + \
                np.repeat(base, counts)
        else:
            off = np.zeros(n_seq, dtype=np.int64)
            np.cumsum(counts[:-1], out=off[1:])
            order = None
            if np.any(q[:-1] > q[1:]):
                order = np.argsort(q, kind="stable")
                vals, q = vals[order], q[order]
            rank = np.arange(len(q)) - off[q]
            flat = q * per + rank
        out_b.reshape(-1)[flat] = vals

    rows = []
    per = pad_to or 0
    for b in range(S):
        kk = keep[b]
        if kk.all():
            ss, ee = seg_start[b], seg_end[b]
        else:
            ss, ee = seg_start[b][kk], seg_end[b][kk]
        ss, cs, qs = analyze(ss)
        ee, ce, qe = analyze(ee)
        rows.append((ss, cs, qs, ee, ce, qe))
        if len(ss) or len(ee):
            per = max(per, int(np.maximum(cs, ce).max()))
    per = max(per, 1)

    # unused slots hold the shard's top (the kernel's clip slot: no
    # effect); starts and ends balance independently per cell. Only the
    # padding tails are filled — the scatter covers everything else.
    seg_s = np.empty((S, n_seq, per), dtype=np.int32)
    seg_e = np.empty((S, n_seq, per), dtype=np.int32)
    hi = ((np.arange(n_seq) + 1) * np.int64(shard_len)).astype(np.int32)
    kp = np.zeros((S, n_seq, per), dtype=bool)
    ar = np.arange(per)
    for b in range(S):
        ss, cs, qs, ee, ce, qe = rows[b]
        place(seg_s[b], ss, cs, qs)
        place(seg_e[b], ee, ce, qe)
        for q in range(n_seq):
            seg_s[b, q, cs[q]:] = hi[q]
            seg_e[b, q, ce[q]:] = hi[q]
        kp[b] = ar[None, :] < np.maximum(cs, ce)[:, None]
    return (
        seg_s.reshape(S, n_seq * per),
        seg_e.reshape(S, n_seq * per),
        kp.reshape(S, n_seq * per),
    )
