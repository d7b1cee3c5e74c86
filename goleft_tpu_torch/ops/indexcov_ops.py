"""indexcov numerics: normalization, ROC, bin counters, copy number, PCA.

The counterpart of the JAX package's ops/indexcov_ops.py. The per-bin
work over a padded (samples × bins) float32 matrix per chromosome runs as
PyTorch ops on the matrix's device (a dozen launches per chromosome); the
cross-sample normalisation scan is the ``indexcov_norm`` kernel
(cohort/streaming.py, ops/norm_kernel.py). The integer-exact per-sample
median and the depth scaling stay on the host in numpy, copied as they
are (indexcov/indexcov.go:104-151).

Reference semantics reproduced:
  - median size per tile: sort sizes, cap at the 98th percentile, take the
    value where the capped cumsum first exceeds total/2
    (indexcov/indexcov.go:104-124)
  - NormalizedDepth: float32 size/median, capped at 50000 (":129-151")
  - CountsAtDepth: slot = trunc(d * (70 * float32(2/3)) + 0.5) clipped to
    [0, 70) (":153-177"); the multiply and the add are two ops, each
    rounded to float32
  - CountsROC: reverse cumulative counts / total (":181-193")
  - counter: in = depth in (0.85, 1.15); low < 0.15; hi > 1.15; bins missing
    past a sample's end count as out+low (":1050-1078")
  - GetCN: drop zero bins; if >30% of all bins are (nonzero) < 0.02 also
    drop those; CN = Ploidy * sorted[0.4*len] (":957-991")
  - cross-sample normalization + 7-tap smoothing (":549-597")
"""

from __future__ import annotations

import numpy as np
import torch

SLOTS = 70
SLOTS_MID = 2.0 / 3.0
MAX_CN = 8.0
PLOIDY = 2
DEPTH_CAP = 50000.0


def median_size_per_tile(sizes: list[np.ndarray]) -> float:
    """Host, int64-exact (indexcov/indexcov.go:96-124)."""
    flat = np.concatenate([np.asarray(s, dtype=np.int64) for s in sizes]) \
        if sizes else np.zeros(0, dtype=np.int64)
    if flat.size < 1:
        raise ValueError("indexcov: no usable chromosomes in index")
    flat = np.sort(flat)
    n98 = flat[int(0.98 * len(flat))]
    capped = np.minimum(flat, n98)
    cumsum = np.cumsum(capped)
    total = int(cumsum[-1])
    idx = int(np.searchsorted(cumsum, total // 2, side="right"))
    idx = min(idx, len(flat) - 1)
    return float(flat[idx])


def normalized_depth(sizes: np.ndarray, median: float) -> np.ndarray:
    """float32 scaled depth, capped at 50000 (indexcov.go:129-151)."""
    if median == 0:
        return np.zeros(0, dtype=np.float32)
    d = (np.asarray(sizes, dtype=np.float64) / median).astype(np.float32)
    return np.minimum(d, np.float32(DEPTH_CAP))


_SCALE = np.float32(SLOTS * np.float32(SLOTS_MID))  # 46.666668 in f32


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on ``like``'s device: every comparison and
    product below runs in float32, as the reference's weak-typed
    constants do."""
    return torch.tensor(np.float32(v), dtype=torch.float32,
                        device=like.device)


def counts_at_depth(depths: torch.Tensor, valid: torch.Tensor
                    ) -> torch.Tensor:
    """(n_samples, n_bins) → (n_samples, SLOTS) int32 histogram."""
    scaled = depths * _f32(_SCALE, depths)
    idx = torch.clamp((scaled + _f32(0.5, depths)).to(torch.int32), 0,
                      SLOTS - 1)
    idx = torch.where(valid, idx, SLOTS)  # dropped slot for padding
    hist = torch.zeros(depths.shape[0], SLOTS + 1, dtype=torch.int32,
                       device=depths.device)
    hist.scatter_add_(1, idx.long(), torch.ones_like(idx))
    return hist[:, :SLOTS]


def counts_roc(counts: torch.Tensor) -> torch.Tensor:
    """Reverse-cumulative proportion (indexcov.go:181-193). counts:
    (..., SLOTS)."""
    totals = torch.cumsum(counts.flip(-1), dim=-1,
                          dtype=torch.int32).flip(-1)
    return totals.to(torch.float32) / totals[..., :1].to(torch.float32)


def bin_counters(depths: torch.Tensor, valid: torch.Tensor,
                 longest: int) -> dict:
    """Per-sample in/out/low/hi counts (indexcov.go:1050-1078).

    ``longest`` is the bin count of the longest sample for this chromosome;
    missing tail bins count as out+low.
    """
    d = depths
    lo85, hi115 = _f32(0.85, d), _f32(1.15, d)
    inside = valid & (d >= lo85) & (d <= hi115)
    out = valid & ((d < lo85) | (d > hi115))
    hi = valid & (d > hi115)
    low = valid & (d < _f32(0.15, d))
    n_valid = valid.sum(dim=-1)
    tail = torch.clamp(longest - n_valid, min=0)
    return {
        "in": inside.sum(dim=-1).to(torch.int32),
        "out": (out.sum(dim=-1) + tail).to(torch.int32),
        "hi": hi.sum(dim=-1).to(torch.int32),
        "low": (low.sum(dim=-1) + tail).to(torch.int32),
    }


def get_cn(depths: torch.Tensor, valid: torch.Tensor,
           ploidy: int = PLOIDY) -> torch.Tensor:
    """Per-sample copy number of one chromosome (indexcov.go:957-991).

    depths: (n_samples, n_bins) padded; valid masks real bins.
    """
    d = depths
    nz = valid & (d != 0)
    k = nz.sum(dim=-1)
    lows = (nz & (d < _f32(0.02, d))).sum(dim=-1)
    n_total = valid.sum(dim=-1)
    p_lo = lows.to(torch.float32) / torch.clamp(n_total, min=1).to(
        torch.float32)
    # ascending sort of nonzero values; invalid/zero → +inf tail
    vals = torch.sort(torch.where(nz, d, _f32(np.inf, d)), dim=-1).values
    base = torch.where(p_lo > _f32(0.3, d), lows, 0)
    m = k - base
    # reference index: int(float64(m)*0.4) — exactly (2m)//5 for every
    # representable m, in integers as the reference computes it
    idx = torch.clamp(base + (m * 2) // 5, 0, d.shape[1] - 1)
    picked = vals.gather(1, idx[:, None])[:, 0]
    med = torch.where(m > 0, _f32(ploidy, d) * picked, _f32(0.0, d))
    return torch.where(k > 0, med, _f32(-0.1, d))


def normalize_across_samples(depths, lengths, device=None):
    """Cross-sample normalization + 7-tap smoothing (indexcov.go:549-597).

    Column j is divided by the cohort mean of its 3-bin neighborhood —
    where columns < j were already normalized+smoothed — then smoothed with
    a 7-tap window mixing processed (j-3..j) and still-raw (j+1..j+3)/m
    values. Lowers onto the two passes of cohort/streaming.py: the host
    f64 per-length-class statistics (``NormStats``) yield the per-bin
    cohort scalars, then one ``indexcov_norm`` launch applies them.

    depths: (n_samples, n_bins) float32 host array, zero-padded (pass 1
    reads it on the host); lengths: per-sample bin counts. Returns the
    processed depths as a tensor on ``device`` (the card unless the
    caller asks for the CPU); under 5 samples the input comes back
    unchanged.
    """
    from ..cohort.streaming import NormStats, apply_normalization
    from ..device import resolve_device

    n_samples, n_bins = depths.shape
    if n_samples < 5:
        return depths
    dev = resolve_device(device)
    d_host = np.asarray(depths, dtype=np.float32)
    lengths_np = np.asarray(lengths, dtype=np.int64)
    stats = NormStats()
    stats.accumulate(d_host, lengths_np)
    m, skip = stats.finalize(n_bins)
    return apply_normalization(
        torch.from_numpy(d_host).to(dev),
        torch.from_numpy(lengths_np.astype(np.int32)).to(dev),
        torch.from_numpy(m).to(dev), torch.from_numpy(skip).to(dev))


def quantize_depths(
    depths: np.ndarray, bug_compat_u8: bool = False
) -> np.ndarray:
    """PCA input quantization.

    The reference computes ``uint8(65535/MaxCN*dp+0.5)`` (indexcov.go:698)
    — a uint16-scale value truncated into a uint8, which wraps mod 256 for
    nearly all depths. We default to a non-wrapping uint16 quantization
    (documented divergence: same intent, no wraparound); set
    ``bug_compat_u8`` to reproduce the wrapped values exactly.
    """
    d = np.minimum(np.asarray(depths, dtype=np.float32), np.float32(MAX_CN))
    q = (np.float32(65535.0 / MAX_CN) * d + np.float32(0.5))
    if bug_compat_u8:
        return q.astype(np.uint16).astype(np.uint8)
    return q.astype(np.uint16)


def pca_project(mat, k: int = 5, device=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Principal-component projection (indexcov.go:773-807).

    gonum's stat.PC column-centers the matrix for the SVD; the reference
    then projects the *raw* matrix onto the top-k right singular vectors.
    Returns (proj (n, k), variance fractions (k,)) as float32 tensors on
    ``device`` (the card unless the caller asks for the CPU). The SVD is
    the library's
    (``torch.linalg.svd``, as ``jnp.linalg.svd`` is in the reference) and
    the projection a float32 ``torch.matmul``; the signs of the singular
    vectors are taken as they come.

    Degenerate requests fail here with a clear error instead of a
    backend-dependent solver failure: ``k`` may not exceed the sample
    count, and a single-sample cohort has no cross-sample variance.
    """
    n_samples = int(mat.shape[0])
    if n_samples < 2:
        raise ValueError(
            f"pca: need at least 2 samples, got {n_samples} — a "
            "single-sample cohort has no cross-sample variance")
    if k > n_samples:
        raise ValueError(
            f"pca: k={k} components exceed n_samples={n_samples}; "
            "pass k <= n_samples (indexcov clamps to min(5, n_samples))")
    from ..device import resolve_device

    x = torch.from_numpy(np.asarray(mat, dtype=np.float32)).to(
        resolve_device(device))
    centered = x - x.mean(dim=0, keepdim=True)
    _, s, vh = torch.linalg.svd(centered, full_matrices=False)
    vars_ = (s * s) / float(max(n_samples - 1, 1))
    frac = vars_ / vars_.sum()
    proj = torch.matmul(x, vh[:k].T)
    return proj, frac[:k]


def chrom_qc(depths: torch.Tensor, valid: torch.Tensor,
             longest: int) -> torch.Tensor:
    """One per-chromosome QC pass returning ONE packed f32 vector on the
    inputs' device: [rocs (S·SLOTS)] [in|out|hi|low (4·S)] [cn (S)], so
    the host fetches it in one copy. All counters are integers well under
    2**24, so the f32 packing is exact.
    """
    counts = counts_at_depth(depths, valid)
    rocs = counts_roc(counts)
    cnt = bin_counters(depths, valid, longest)
    cn = get_cn(depths, valid)
    return torch.cat([
        rocs.reshape(-1),
        cnt["in"].to(torch.float32),
        cnt["out"].to(torch.float32),
        cnt["hi"].to(torch.float32),
        cnt["low"].to(torch.float32),
        cn.to(torch.float32),
    ])


def unpack_chrom_qc(packed: np.ndarray, n_samples: int):
    """Host split of chrom_qc's packed vector →
    (rocs (S, SLOTS) f32, counters dict of int64 (S,), cn f32 (S,))."""
    S = n_samples
    rocs = packed[: S * SLOTS].reshape(S, SLOTS)
    off = S * SLOTS
    cnt = {}
    for k in ("in", "out", "hi", "low"):
        cnt[k] = packed[off:off + S].astype(np.int64)
        off += S
    cn = packed[off:off + S]
    return rocs, cnt, cn


def update_slopes(rocs: np.ndarray, scalar: float) -> np.ndarray:
    """Per-sample ROC drop between 1±0.15 scaled depth, chromosome-length
    weighted (indexcov.go:739-750). rocs: (n_samples, SLOTS)."""
    n = 0.1
    ilo = int(0.5 + (SLOTS_MID - n) * SLOTS)
    ihi = int(0.5 + (SLOTS_MID + n) * SLOTS)
    return (rocs[:, ilo] - rocs[:, ihi]) * np.float32(scalar)
