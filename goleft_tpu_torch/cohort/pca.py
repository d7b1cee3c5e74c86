"""Chunked PCA over sample chunks: the counterpart of the JAX package's
cohort/pca.py.

``ops.indexcov_ops.pca_project`` (the small-cohort oracle) runs one SVD
over the full (samples × autosome-bins) matrix, which is exactly the
matrix the cohort plane refuses to materialize. This module computes the
same projection by block power iteration on the Gram operator: every
touch of the data is a chunk-local matrix product

    partial = Cᵀ (C Q)        (C = centered chunk, Q the iterate)

summed across chunks, so peak memory is O(chunk × bins) + O(bins × k).
Each product runs on ``device`` (the card unless the caller asks for the
CPU) as a float64 ``torch.matmul``: the H100 has IEEE float64, so the
card accumulates in float64 as the reference does on CPU/x64 (the TPU
ran it in float32; utils/dtypes.py made the same choice for the EM).
The seeded start, the QR, the Rayleigh–Ritz rotation and the sign
pinning stay host numpy, as in the reference.

The Gram step splits a chunk's rows over ``devices`` (every visible
card unless the caller names a device or a list), padded with mean rows
(their centred contribution is zero), as the reference's ``shard_map`` +
``psum`` does; the partial products add on the first device in device
order. That changes the float64 summation order, so the components
agree with one device's to the PCA tolerances, not bit for bit. On a
one-card host it is one Gram step a chunk, as before.

Semantics match the oracle: column-center for the decomposition,
project the *raw* matrix onto the top-k right singular vectors, report
variance fractions against the TOTAL variance ‖C‖²_F/(n-1). Power
iteration is iterative, so the projection agrees with the oracle to a
tolerance, not byte for byte: ``cohortscan`` uses the oracle up to
``PCA_EXACT_MAX`` samples and this path above it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_devices

#: the accumulation type of every product, on the card and on the CPU
ACC = torch.float64


def _check_dims(n_samples: int, k: int) -> None:
    if n_samples < 2:
        raise ValueError(
            f"pca: need at least 2 samples, got {n_samples} — a "
            "single-sample cohort has no cross-sample variance")
    if k > n_samples:
        raise ValueError(
            f"pca: k={k} components exceed n_samples={n_samples}; "
            "pass k <= n_samples")


def _chunk_stats(chunk: torch.Tensor):
    """(float64 column sums, squared Frobenius norm) of one raw chunk:
    the pass-0 moments behind the mean and the total variance."""
    c = chunk.to(ACC)
    return c.sum(dim=0), (c * c).sum()


def _chunk_w(chunk: torch.Tensor, mean: torch.Tensor, q: torch.Tensor):
    """One centred chunk times the iterate, C Q, in float64."""
    c = chunk.to(ACC) - mean.to(ACC)[None, :]
    return torch.matmul(c, q.to(ACC))


def _chunk_gram(chunk: torch.Tensor, mean: torch.Tensor, q: torch.Tensor):
    """One chunk's contribution Cᵀ(CQ) to the Gram–iterate product."""
    c = chunk.to(ACC) - mean.to(ACC)[None, :]
    return torch.matmul(c.T, torch.matmul(c, q.to(ACC)))


class ShardedPCA:
    """Fitted chunked PCA: top-k right singular directions + variance
    fractions, with a per-chunk projection (never the full matrix)."""

    def __init__(self, components: np.ndarray, frac: np.ndarray,
                 mean: np.ndarray, iters: int):
        self.components_ = components  # (n_bins, k) f32
        self.frac_ = frac              # (k,) f32
        self.mean_ = mean
        self.iters_ = iters

    def project(self, chunk: np.ndarray) -> np.ndarray:
        """Raw-matrix projection of one sample chunk — the oracle's
        ``x @ vt[:k].T`` semantics (indexcov.go:773-807)."""
        x = np.asarray(chunk, np.float32)
        return np.asarray(x @ self.components_, np.float32)


def _split_gram(chunk: torch.Tensor, means, qs, devs) -> torch.Tensor:
    """Cᵀ(CQ) of one chunk (on the first device) with its rows split over
    ``devs`` (padded with mean rows to a multiple of their count), the
    partials summed on the first device in device order; ``means`` and
    ``qs`` hold the mean and the iterate on each device. One device: one
    product."""
    pad = (-chunk.shape[0]) % len(devs)
    if pad:
        chunk = torch.cat([chunk, means[0].expand(pad, -1)])
    parts = torch.tensor_split(chunk, len(devs))
    g = _chunk_gram(parts[0], means[0], qs[0])
    for p, m, q, d in zip(parts[1:], means[1:], qs[1:], devs[1:]):
        g += _chunk_gram(p.to(d), m, q).to(devs[0])
    return g


def sharded_pca(chunks_fn, k: int = 5, *, iters: int = 32,
                seed: int = 1, device=None, devices=None) -> ShardedPCA:
    """Fit top-k principal directions by chunked block power iteration.

    ``chunks_fn`` is a zero-arg callable yielding the sample chunks
    (each (chunk, n_bins) float32, all the same width) in cohort order;
    it is called ``iters + 2`` times, so chunks should be cheap to
    re-materialize (the scan engine mmap-reads its spill files). Each
    chunk goes to the first device once a pass (its rows split over
    ``devices`` in the Gram step: :func:`resolve_devices`).
    """
    devs = resolve_devices(devices, device)
    dev = devs[0]

    def chunks():
        for chunk in chunks_fn():
            yield torch.from_numpy(
                np.ascontiguousarray(chunk, np.float32)).to(dev)

    # ---- pass 0: mean + total variance ----
    n = 0
    col_sum = None
    sumsq = 0.0
    n_bins = None
    for chunk in chunks():
        if n_bins is None:
            n_bins = chunk.shape[1]
            col_sum = np.zeros(n_bins, np.float64)
        s, ss = _chunk_stats(chunk)
        col_sum += s.cpu().numpy()
        sumsq += float(ss)
        n += chunk.shape[0]
    if n_bins is None:
        raise ValueError("pca: empty cohort")
    _check_dims(n, k)
    k_eff = min(k, n, n_bins)
    mean = (col_sum / n).astype(np.float64)
    # ‖C‖²_F = Σ‖x‖² − n‖mean‖² (f64 throughout: catastrophic
    # cancellation here would poison every variance fraction)
    total_var = max(sumsq - n * float(mean @ mean), 0.0) \
        / max(n - 1, 1)

    mean32 = mean.astype(np.float32)
    means = [torch.from_numpy(mean32).to(d) for d in devs]
    mean_t = means[0]

    # ---- block power iteration on the Gram operator ----
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(
        rng.standard_normal((n_bins, k_eff)).astype(np.float64))[0]
    q = q.astype(np.float32)
    for _ in range(iters):
        qs = [torch.from_numpy(q).to(d) for d in devs]
        acc = torch.zeros((n_bins, k_eff), dtype=ACC, device=dev)
        for chunk in chunks():
            acc += _split_gram(chunk, means, qs, devs)
        q = np.linalg.qr(acc.cpu().numpy())[0].astype(np.float32)

    # ---- Rayleigh–Ritz rotation inside the converged subspace ----
    q_t = torch.from_numpy(q).to(dev)
    g = np.zeros((k_eff, k_eff), np.float64)
    for chunk in chunks():
        w = _chunk_w(chunk, mean_t, q_t).cpu().numpy()
        g += w.T @ w
    evals, evecs = np.linalg.eigh(g)  # ascending
    order = np.argsort(evals)[::-1]
    evals = np.maximum(evals[order], 0.0)
    comp = (q.astype(np.float64) @ evecs[:, order]).astype(np.float32)
    # deterministic sign: largest-|loading| entry of each component
    # positive (SVD signs are arbitrary; pin them so re-runs and
    # resumes agree)
    for i in range(comp.shape[1]):
        j = int(np.argmax(np.abs(comp[:, i])))
        if comp[j, i] < 0:
            comp[:, i] = -comp[:, i]
    vars_ = evals / max(n - 1, 1)
    frac = (vars_ / total_var if total_var > 0
            else np.zeros_like(vars_)).astype(np.float32)
    return ShardedPCA(comp, frac[:k_eff], mean32, iters)
