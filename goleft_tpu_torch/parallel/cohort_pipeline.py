"""The end-to-end cohort step over a mesh: sharded coverage → scaled
depth → batched EM copy number, the counterpart of the JAX package's
parallel/cohort_pipeline.py.

The genome axis is split over the seq ranks and the samples over the
data ranks (parallel/sharded_coverage.py, on the depth kernel). The
normalisation needs each sample's median over the whole genome, so the
window means go over the seq row's Gloo group first; the EM then runs on
the window axis split over the seq ranks (the JAX package's
P("seq", "data")), with every sample of its windows, and its λ and CN
are gathered back to every rank.

Normalisation: round-half-up in float32, as the JAX package's step
rounds its float32 window means, then each sample scaled to its median
and the cohort's median of medians in float64, and the port's float64 EM
(models/emdepth.py), as ``cnv`` runs it. The JAX package's step runs its
EM in float32, so λ agrees with it to float32 rounding; the window means
and depth are exact. The EM runs in ``EM_CHUNK``-window chunks padded
with ones, so every call has the same shape whatever the world's size:
λ and CN are bitwise the same across worlds.
"""

from __future__ import annotations

import numpy as np

from .sharded_coverage import sharded_depth_fn


def _em_padded(wm: np.ndarray, device):
    """(λ (B, 9) f64, CN (B, S) int8) of the (B, S) float64 windows, in
    EM_CHUNK-row chunks padded with ones on ``device``."""
    import torch

    from ..commands.emdepth_cmd import EM_CHUNK
    from ..models import emdepth as em

    B, S = wm.shape
    lam = np.empty((B, em.N_LAMBDA), np.float64)
    cn = np.empty((B, S), np.int8)
    for lo in range(0, B, EM_CHUNK):
        c = wm[lo:lo + EM_CHUNK]
        n = len(c)
        if n < EM_CHUNK:
            c = np.concatenate([c, np.ones((EM_CHUNK - n, S))])
        t = torch.from_numpy(np.ascontiguousarray(c)).to(device)
        lam_t = em.em_depth_batch(t)
        lam[lo:lo + n] = lam_t[:n].cpu().numpy()
        cn[lo:lo + n] = em.cn_batch(lam_t, t)[:n].cpu().numpy()
    return lam, cn


def _seq_row(mesh, blk) -> np.ndarray:
    """A rank's (rows, k) block → its data row's (rows, n_seq * k) host
    array, seq shards side by side."""
    return np.concatenate([p.numpy() for p in mesh.seq_gather(blk)],
                          axis=1)


def _data_col(mesh, arr: np.ndarray) -> np.ndarray:
    """A (rows, ...) host array of each data rank → (S, ...) of the seq
    column, data rows stacked."""
    import torch

    return np.concatenate([p.numpy() for p in mesh.data_gather(
        torch.from_numpy(np.ascontiguousarray(arr)))], axis=0)


def _normalize_and_em(mesh, wmeans_row: np.ndarray):
    """(λ (n_win, 9), CN (n_win, S)) on every rank, from this data row's
    (rows, n_win) float32 window means over the whole genome."""
    import torch

    vals = np.floor(wmeans_row + np.float32(0.5)).astype(np.float64)
    med = np.median(vals, axis=1)  # per-sample global median
    med[med == 0] = 1.0
    medmed = float(np.median(_data_col(mesh, med)))
    scaled = vals / med[:, None] * medmed
    # EM layout: this seq rank's windows, every sample
    n_win, n_seq, q = scaled.shape[1], mesh.shape["seq"], mesh.seq_index
    per = -(-n_win // n_seq)
    lo, hi = min(q * per, n_win), min((q + 1) * per, n_win)
    wm = _data_col(mesh, scaled[:, lo:hi]).T  # (hi - lo, S)
    lam, cn = _em_padded(wm, mesh.device)
    # equal shapes for the gather: pad each rank's slice to ``per``
    pad = per - (hi - lo)
    lam_p = torch.from_numpy(np.pad(lam, ((0, pad), (0, 0))))
    cn_p = torch.from_numpy(np.pad(cn, ((0, pad), (0, 0))))
    lams = [t.numpy() for t in mesh.seq_gather(lam_p)]
    cns = [t.numpy() for t in mesh.seq_gather(cn_p)]
    return (np.concatenate(lams)[:n_win], np.concatenate(cns)[:n_win])


def build_cohort_step(mesh, shard_len: int, window: int,
                      carry_mode: str = "all_gather"):
    """``step(seg_s, seg_e, keep)`` (global (S, n_seq * per) arrays, as
    :func:`~.sharded_coverage.partition_segments` lays them out) →
    dict(depth (S, n_seq * shard_len) int32, wmeans (S, n_win) float32,
    lambdas (n_win, 9) float64, cn (n_win, S) int8), global host arrays
    on every rank. ``carry_mode`` as in sharded_depth_fn."""
    coverage = sharded_depth_fn(mesh, shard_len, window,
                                carry_mode=carry_mode)

    def step(seg_s, seg_e, keep):
        depth, wsums = coverage(seg_s, seg_e, keep)
        wmeans_row = _seq_row(mesh, wsums) / np.float32(window)
        lambdas, cn = _normalize_and_em(mesh, wmeans_row)
        return {
            "depth": coverage.assemble_rows(depth),
            "wmeans": _data_col(mesh, wmeans_row),
            "lambdas": lambdas,
            "cn": cn,
        }

    return step


def build_chunked_cohort_step(mesh, shard_len: int, window: int,
                              carry_mode: str = "all_gather"):
    """Chunked variant of :func:`build_cohort_step` for the prefetch
    staging pipeline (parallel/prefetch.py): the genome is fed as a
    sequence of chunks of ``n_seq * shard_len`` positions.

    Returns ``(chunk_fn, finalize_fn, coverage)``:

      - ``chunk_fn(blocks, carry) → (depth, wsums, carry')`` runs the
        sharded coverage on one chunk (``blocks``: this rank's
        chunk-relative endpoint blocks on its device, from
        ``coverage.put``) and adds ``carry``, the (rows,) int32 running
        depth at the chunk boundary of this rank's samples, to depth and
        (as carry * window, in float32) to the window sums: a segment
        straddling a chunk boundary adds its +1 to one chunk and its -1
        to the next, as across shards. ``carry'`` is the depth at the
        chunk's last base, which the last seq rank holds and broadcasts
        over the seq row.
      - ``finalize_fn(wsums_parts)`` takes this rank's per-chunk window
        sums and runs the normalisation and EM over the whole extent →
        dict(wmeans, lambdas, cn), global host arrays.
    """
    coverage = sharded_depth_fn(mesh, shard_len, window,
                                carry_mode=carry_mode)
    last = mesh.shape["seq"] - 1

    def chunk_fn(blocks, carry):
        import torch

        depth, wsums = coverage.local(*blocks)
        depth = depth + carry[:, None]
        wsums = wsums + (carry.to(torch.float32) * window)[:, None]
        carry2 = mesh.seq_broadcast(depth[:, -1], last).to(depth.device)
        return depth, wsums, carry2

    def finalize_fn(wsums_parts):
        row = np.concatenate([_seq_row(mesh, w) for w in wsums_parts],
                             axis=1)
        wmeans_row = row / np.float32(window)
        lambdas, cn = _normalize_and_em(mesh, wmeans_row)
        return {"wmeans": _data_col(mesh, wmeans_row), "lambdas": lambdas,
                "cn": cn}

    return chunk_fn, finalize_fn, coverage
