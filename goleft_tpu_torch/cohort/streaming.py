"""Streaming cross-sample normalization: exact two-pass form.

A copy of the JAX package's cohort/streaming.py. The monolithic
``normalize_across_samples`` is a scan over the bin axis where bin j's
cohort mean mixes the *already processed* column j-1 — a feedback loop
that looks like it needs the whole cohort resident. It does not. Two
observations make an exact streaming split possible:

1. Given the per-bin scalars ``(m[j], skip[j])``, the finalize step is
   **per-sample elementwise**: each sample's output row depends only on
   its own raw row and the scalar sequence. Elementwise f32 lanes are
   independent of the batch they ride in, so applying the finalize to
   any sample chunk reproduces exactly the rows the monolithic run
   would produce.
2. The scalars themselves depend on the cohort only through *sums over
   samples*, and the smoothing recurrence is linear with branch
   membership decided purely by ``(sample_length, j)``. Summing the
   recurrence over every sample of one length class therefore closes:
   a per-class f64 carry of the last three processed-column sums plus
   per-class raw column sums reproduce the sequence ``(m[j], skip[j])``
   without ever materializing a processed matrix.

:class:`NormStats` is the pass-1 accumulator, host f64 numpy, copied as
it is. Its state is O(classes × bins) — independent of cohort size — and
accumulation is strictly sequential per class, which is what makes it
invariant under any contiguous chunking of the sample axis.

``apply_normalization`` is pass 2: the ``indexcov_norm`` CUDA kernel for
CUDA tensors (ops/norm_kernel.py), its plain PyTorch version for CPU
tensors. It follows the reference's *answer*: the reference's source
divides the 7-tap sum by 7.0, which XLA compiles to a multiply by
float32(1/7), so pass 2 multiplies. ``NormStats.finalize``'s f64 ``/ 7.0``
stays a division, because the reference's pass 1 is numpy and divides.
``ops.indexcov_ops.normalize_across_samples`` lowers onto these same two
passes, so chunked == monolithic is true by construction.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import obs


class NormStats:
    """Chunk-invariant cross-sample normalization statistics.

    Feed sample chunks **in cohort order** via :meth:`accumulate`;
    then :meth:`finalize` yields the per-bin ``(m, skip)`` scalar
    sequences that drive :func:`apply_normalization`. State is one
    f64 raw-column-sum vector and a counter per distinct sample
    length ("length class") — a few KB per chromosome regardless of
    cohort size.
    """

    def __init__(self):
        # length -> [sample_count, f64 raw column sums (length,)]
        self._cls: dict[int, list] = {}
        self.n_samples = 0

    def accumulate(self, depths: np.ndarray, lengths: np.ndarray) -> None:
        """Add one sample chunk. ``depths`` is (chunk, width) f32 with
        zero padding past each sample's ``lengths[i]`` bins."""
        depths = np.asarray(depths)
        lengths = np.asarray(lengths)
        if depths.shape[0] != lengths.shape[0]:
            raise ValueError(
                f"cohort: {depths.shape[0]} depth rows vs "
                f"{lengths.shape[0]} lengths")
        for i in range(len(lengths)):
            ln = int(lengths[i])
            self.n_samples += 1
            if ln <= 0:
                continue
            ent = self._cls.get(ln)
            if ent is None:
                ent = self._cls[ln] = [0, np.zeros(ln, np.float64)]
            ent[0] += 1
            # one sequential f64 add per sample: the accumulation order
            # is the cohort order, never a chunk-shaped reduction tree,
            # so any contiguous chunking yields bit-identical sums
            ent[1] += depths[i, :ln].astype(np.float64)

    def finalize(self, n_bins: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-bin scalars: (m (n_bins,) f32, skip (n_bins,) bool).

        Replays the reference's f64 neighborhood-mean recurrence
        (indexcov.go:549-597) on the class aggregates. Bins past every
        sample's end get ``skip=True`` (the monolithic scan reaches the
        same state: its sample count drops below the 3n-4 floor).
        """
        n_total = self.n_samples
        m_out = np.zeros(n_bins, np.float32)
        skip_out = np.ones(n_bins, bool)
        if not self._cls:
            return m_out, skip_out
        lens = np.array(sorted(self._cls), np.int64)
        cnts = np.array([self._cls[int(ln)][0] for ln in lens], np.float64)
        max_len = int(lens[-1])
        # pad class sums 3 past the longest class: bin j's smoothing
        # reads raw columns j+1..j+3
        rs = np.zeros((len(lens), max_len + 3), np.float64)
        for r, ln in enumerate(lens):
            rs[r, :ln] = self._cls[int(ln)][1]
        carry = np.zeros((len(lens), 3), np.float64)  # Σ out at j-3..j-1
        thresh = 3 * n_total - 4
        for j in range(min(n_bins, max_len)):
            alive = lens > j        # class still has a live column
            has_next = lens > j + 1
            # the padded rows are zero past each class's end, so the
            # raw-sum terms need no masking; the carry does (a class
            # whose last bin was j-1 contributes nothing at j)
            m_sum = float(rs[:, j].sum()) + float(rs[:, j + 1].sum())
            if j > 0:
                m_sum += float(np.where(alive, carry[:, 2], 0.0).sum())
            n1 = float(cnts[alive].sum())
            n = int(n1) + (int(n1) if j > 0 else 0) \
                + int(cnts[has_next].sum())
            m_acc = m_sum / max(n, 1)
            skip = (n < thresh) or (m_acc < 0.1)
            mj = np.float32(m_acc)
            m_out[j] = mj
            skip_out[j] = skip
            if skip:
                out_sum = rs[:, j]
            else:
                # the per-sample finalize divides by the f32-rounded m
                # — mirror that here so the aggregate tracks the lane
                # arithmetic as closely as f64 allows
                m64 = np.float64(mj)
                scaled = rs[:, j] / m64
                smooth = alive & (lens > j + 3) & (j > 2)
                smoothed = (
                    carry[:, 0] + carry[:, 1] + carry[:, 2] + scaled
                    + rs[:, j + 1] / m64 + rs[:, j + 2] / m64
                    + rs[:, j + 3] / m64
                ) / 7.0
                out_sum = np.where(smooth, smoothed, scaled)
            shifted = np.stack([carry[:, 1], carry[:, 2], out_sum], axis=1)
            carry = np.where(alive[:, None], shifted, carry)
        return m_out, skip_out

    def scalars_digest(self, n_bins: int) -> str:
        """Content digest of the finalized scalars — what checkpoint
        keys bind when the QC input is the *normalized* matrix, so a
        cohort-composition change invalidates exactly the shards whose
        normalization actually moved."""
        return scalars_digest(*self.finalize(n_bins))


def scalars_digest(m: np.ndarray, skip: np.ndarray) -> str:
    """The digest :meth:`NormStats.scalars_digest` takes of finalized
    scalars ``(m, skip)``."""
    h = hashlib.sha256()
    h.update(m.tobytes())
    h.update(np.packbits(skip).tobytes())
    return h.hexdigest()[:16]


def apply_normalization(depths: torch.Tensor, lengths: torch.Tensor,
                        m_all: torch.Tensor, skip_all: torch.Tensor
                        ) -> torch.Tensor:
    """Pass-2 finalize: normalize + 7-tap smooth one sample chunk given
    the global per-bin scalars, on the chunk's device.

    Elementwise per sample lane — a chunk's output rows are exactly the
    rows the monolithic run produces for those samples. ``depths`` is
    (chunk, n_bins) float32 with ``n_bins == len(m_all)``; ``lengths``
    int32, ``m_all`` float32, ``skip_all`` bool, each on the depths'
    device. One ``indexcov_norm`` launch on a card (a fenced
    ``device.indexcov_norm`` span under ``--trace-out``)."""
    from ..ops import norm_kernel

    return obs.dispatch("indexcov_norm", norm_kernel.norm_scan,
                        depths.contiguous(), lengths.contiguous(),
                        m_all.contiguous(), skip_all.contiguous())


def normalize_across_samples_chunked(
    chunks: list[tuple[np.ndarray, np.ndarray]], n_bins: int | None = None,
    device=None,
) -> list[np.ndarray]:
    """Convenience wrapper over the two passes for an in-memory list of
    ``(depths_chunk, lengths_chunk)`` pairs in cohort order; pass 2 runs
    on ``device`` (the card unless the caller asks for the CPU).

    Peak memory is O(chunk × bins) beyond the class statistics. Returns
    one processed f32 array per chunk; hstacking them equals the
    monolithic ``normalize_across_samples`` byte-for-byte. Cohorts
    under 5 samples pass through unchanged (the reference's floor).
    """
    from ..device import resolve_device

    dev = resolve_device(device)
    if n_bins is None:
        n_bins = max((np.asarray(d).shape[1] for d, _ in chunks),
                     default=0)
    total = sum(np.asarray(d).shape[0] for d, _ in chunks)
    if total < 5:
        return [np.asarray(d, np.float32) for d, _ in chunks]
    stats = NormStats()
    for depths, lengths in chunks:
        stats.accumulate(_pad_to(np.asarray(depths, np.float32), n_bins),
                         lengths)
    m, skip = stats.finalize(n_bins)
    m_t = torch.from_numpy(m).to(dev)
    skip_t = torch.from_numpy(skip).to(dev)
    out = []
    for depths, lengths in chunks:
        d = _pad_to(np.asarray(depths, np.float32), n_bins)
        out.append(apply_normalization(
            torch.from_numpy(d).to(dev),
            torch.from_numpy(np.asarray(lengths, np.int32)).to(dev),
            m_t, skip_t).cpu().numpy())
    return out


def _pad_to(mat: np.ndarray, n_bins: int) -> np.ndarray:
    """Zero-pad a chunk to the shared bin width (padding columns are
    masked everywhere downstream; outputs at real bins are unaffected
    because the scalars depend only on class data, never on width)."""
    if mat.shape[1] == n_bins:
        return mat
    if mat.shape[1] > n_bins:
        raise ValueError(
            f"cohort: chunk width {mat.shape[1]} exceeds n_bins {n_bins}")
    out = np.zeros((mat.shape[0], n_bins), mat.dtype)
    out[:, :mat.shape[1]] = mat
    return out
