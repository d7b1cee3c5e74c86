"""dcnv: depth-matrix normalization — scalers, GC debiasers, SVD.

The counterpart of the JAX package's models/dcnv.py: the scalers, the
debiasers and the sample medians are its host numpy, copied; only the
SVD debias runs on a device, as ``torch.linalg.svd`` (the reference's is
``jnp.linalg.svd``), on the card unless the caller asks for the CPU.

Rebuild of the reference's prototype dcnv stack (dcnv/dcnv.go,
dcnv/debiaser/debiaser.go, dcnv/scalers/scalers.go) as matrix ops:

  - Scalers (Scale/UnScale round-trip): ZScore per row, Row/Col centering,
    Log2 (log2(1+d) then median column-centering) — scalers.go:25-164
  - GeneralDebiaser: argsort rows by a covariate (GC), divide each sample
    column by its moving median in the sorted order, unsort —
    debiaser.go:56-123. The moving-median alignment replicates the
    reference's push sequence (window median trails by (w-1)/2+1).
  - ChunkDebiaser: bucket rows by covariate span, divide by per-bucket
    nonzero median — debiaser.go:125-171
  - SVD debias: zero leading components with variance% ≥ MinVariancePct —
    debiaser.go:173-199 (the reference's extractSVD passes nil matrices
    and would panic (":202-209"); ours is functional)
  - SampleMedians: 65th percentile of each sample's nonzero depths,
    dcnv.go:108-125

Matrix orientation matches the reference: rows = sites, cols = samples.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from ..device import resolve_device


class ZScore:
    """Per-row z-score (scalers.go:25-56)."""

    def scale(self, a: np.ndarray) -> np.ndarray:
        self.means = a.mean(axis=1, keepdims=True)
        self.sds = a.std(axis=1, ddof=1, keepdims=True)
        return (a - self.means) / self.sds

    def unscale(self, a: np.ndarray) -> np.ndarray:
        return np.maximum(0, a * self.sds + self.means)


class RowCentered:
    def __init__(self, centerer=np.mean):
        self.centerer = centerer

    def scale(self, a):
        self.centers = np.apply_along_axis(self.centerer, 1, a)[:, None]
        return a - self.centers

    def unscale(self, a):
        return a + self.centers


class ColCentered:
    def __init__(self, centerer=np.mean):
        self.centerer = centerer

    def scale(self, a):
        self.centers = np.apply_along_axis(self.centerer, 0, a)[None, :]
        return a - self.centers

    def unscale(self, a):
        return a + self.centers


def _gmedian(v):
    """sorted-middle median, as the reference's gmean (scalers.go:125-130)."""
    s = np.sort(v)
    return s[len(s) // 2]


class Log2:
    """log2(1+d) then median column-centering (scalers.go:133-164)."""

    def __init__(self):
        self.cc = ColCentered(_gmedian)

    def scale(self, a):
        return self.cc.scale(np.log2(1 + a))

    def unscale(self, a):
        return np.power(2.0, self.cc.unscale(a))


class _MovingMedian:
    """Median of the last `window` pushed values (JaderDias/movingmedian
    semantics: even counts average the middle pair)."""

    def __init__(self, window: int):
        self.window = window
        self.queue: list[float] = []
        self.sorted: list[float] = []

    def push(self, v: float) -> None:
        self.queue.append(v)
        bisect.insort(self.sorted, v)
        if len(self.queue) > self.window:
            old = self.queue.pop(0)
            del self.sorted[bisect.bisect_left(self.sorted, old)]

    def median(self) -> float:
        s = self.sorted
        n = len(s)
        if n == 0:
            return 0.0
        if n % 2 == 1:
            return s[n // 2]
        return 0.5 * (s[n // 2 - 1] + s[n // 2])


class GeneralDebiaser:
    """Sort rows by covariate, moving-median divide, unsort
    (debiaser.go:56-123)."""

    def __init__(self, vals: np.ndarray, window: int = 65):
        self.vals = np.asarray(vals, dtype=np.float64)
        self.window = window
        self.order: np.ndarray | None = None

    def sort(self, a: np.ndarray) -> np.ndarray:
        self.order = np.argsort(self.vals, kind="stable")
        self.vals = self.vals[self.order]
        return a[self.order]

    def unsort(self, a: np.ndarray) -> np.ndarray:
        if self.order is None:
            raise RuntimeError("unsort: must call sort first")
        inv = np.empty_like(self.order)
        inv[self.order] = np.arange(len(self.order))
        self.vals = self.vals[inv]
        return a[inv]

    def debias(self, a: np.ndarray) -> np.ndarray:
        out = a.copy()
        r = a.shape[0]
        mid = (self.window - 1) // 2 + 1
        for s in range(a.shape[1]):
            col = a[:, s]
            mm = _MovingMedian(self.window)
            new = np.empty(r)
            for i in range(min(mid, r)):
                mm.push(col[i])
            for i in range(min(mid, r)):
                new[i] = col[i] / max(mm.median(), 1.0)
            for i in range(mid, max(r - mid, mid)):
                if i + mid < r:
                    mm.push(col[i + mid])
                new[i] = col[i] / max(mm.median(), 1.0)
            for i in range(max(r - mid, mid), r):
                new[i] = col[i] / max(mm.median(), 1.0)
            out[:, s] = new
        return out


class ChunkDebiaser:
    """Bucketed covariate median divide (debiaser.go:125-171).
    Assumes rows sorted by covariate (call sort() first)."""

    def __init__(self, vals: np.ndarray, score_window: float):
        if score_window == 0:
            raise ValueError("must set ChunkDebiaser.score_window")
        self.vals = np.asarray(vals, dtype=np.float64)
        self.score_window = score_window
        self.order = None

    sort = GeneralDebiaser.sort
    unsort = GeneralDebiaser.unsort

    def debias(self, a: np.ndarray) -> np.ndarray:
        out = a.copy()
        slices = [0]
        v0 = self.vals[0]
        for i in range(len(self.vals)):
            if self.vals[i] - v0 > self.score_window:
                v0 = self.vals[i]
                slices.append(i)
        slices.append(len(self.vals))
        for s in range(a.shape[1]):
            col = out[:, s]
            for si, ei in zip(slices, slices[1:]):
                sub = np.sort(col[si:ei])
                k = int(np.searchsorted(sub, 0, side="right"))
                med = sub[min((ei - si - k) // 2, len(sub) - 1)]
                if med > 0:
                    col[si:ei] /= med
        return out


class SVDDebiaser:
    """Zero the leading singular components carrying ≥ min_variance_pct of
    variance (debiaser.go:173-199); the float32 SVD runs on ``device``
    (the card unless ``"cpu"``) through ``torch.linalg.svd``."""

    def __init__(self, min_variance_pct: float = 5.0, max_components: int = 15):
        self.min_variance_pct = min_variance_pct
        self.max_components = max_components

    def debias(self, a: np.ndarray, device=None) -> np.ndarray:
        x = torch.from_numpy(np.asarray(a, dtype=np.float32)).to(
            resolve_device(device))
        u, s, vt = (t.cpu().numpy() for t in
                    torch.linalg.svd(x, full_matrices=False))
        total = s.sum()
        n = 0
        while n < min(self.max_components, len(s)) and \
                100 * s[n] / total > self.min_variance_pct:
            n += 1
        s2 = s.copy()
        s2[:n] = 0
        return np.asarray((u * s2[None, :]) @ vt, dtype=a.dtype)


def sample_medians(depths: np.ndarray) -> np.ndarray:
    """65th percentile of nonzero depths per sample column
    (dcnv.go:108-125)."""
    out = np.zeros(depths.shape[1])
    for s in range(depths.shape[1]):
        col = np.sort(depths[:, s])
        k = int(np.searchsorted(col, 0, side="right"))
        rest = col[k:]
        if len(rest):
            out[s] = rest[int(0.65 * len(rest))]
    return out


def normalize_by_sample_median(depths: np.ndarray) -> np.ndarray:
    meds = sample_medians(depths)
    meds[meds == 0] = 1.0
    return depths / meds[None, :]


def gc_debias_pipeline(depths: np.ndarray, gcs: np.ndarray,
                       window: int = 9) -> np.ndarray:
    """The dcnv composition (dcnv.go:331-339): sort raw depths by GC,
    moving-median debias (window 9), unsort, THEN sample-median normalize.
    Debias must see raw depths — its max(median, 1) floor (debiaser.go:
    111-122) is a no-op on already-normalized ≈1 values."""
    db = GeneralDebiaser(gcs, window=window)
    srt = db.sort(np.asarray(depths, dtype=np.float64))
    deb = db.debias(srt)
    unsorted = db.unsort(deb)
    return normalize_by_sample_median(unsorted)
