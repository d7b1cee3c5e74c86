"""The port's cross-sample normalisation (goleft_tpu_torch/cohort/
streaming.py, ops/norm_kernel.py's plain version, on the CPU) against the
JAX package's cohort/streaming.py. Inputs are made from a seed with numpy.

- ``NormStats`` (host f64 pass 1, a copy): the per-bin scalars and their
  digest are bitwise the reference's.
- Pass 2, the scan: the port divides the smoothing sum by 7.0f as the
  reference's source writes it; XLA's algebraic simplifier turns that
  division into a multiply by float32(1/7). So the port is held bitwise
  to a numpy transcription of the scan that divides, XLA's output bitwise
  to the same transcription with the multiply, and the two packages to
  each other within ``SCAN_ULPS`` units in the last place (the rounding
  difference feeds back through the three carried outputs).
- The monolithic normalisation equals every chunking {1, 3, n-1, n}
  bitwise; under 5 samples the input comes back; width padding is inert;
  mismatched shapes are rejected.
"""

import numpy as np
import pytest
import torch

from chip_smoke import NORM_EDGES, norm_edge_case
from goleft_tpu.cohort import streaming as jst
from goleft_tpu.ops import indexcov_ops as jops
from goleft_tpu_torch.cohort import streaming as tst
from goleft_tpu_torch.ops import indexcov_ops as tops
from goleft_tpu_torch.ops import norm_kernel as nk

SCAN_ULPS = 8


def _cohort(seed: int, n: int = 11, width: int = 160):
    """A ragged cohort hitting every scalar branch: several length
    classes (a full-length sample, a short one, a sample shorter than the
    smoothing window, an empty one), a low-coverage bin (m < 0.1) and
    sparse tail columns (the 3n - 4 floor)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(width // 3, width + 1, size=n).astype(np.int32)
    lengths[0] = width
    lengths[1] = width // 3
    lengths[2] = 4
    lengths[3] = 0
    depths = rng.random((n, width), dtype=np.float32) * np.float32(2.0)
    depths[:, 5] *= np.float32(1e-4)
    for i, ln in enumerate(lengths):
        depths[i, ln:] = 0.0
    return depths.astype(np.float32), lengths


def _scalars(depths, lengths, n_bins=None):
    st = tst.NormStats()
    st.accumulate(depths, lengths)
    return st.finalize(depths.shape[1] if n_bins is None else n_bins)


def _scan_numpy(depths, lengths, m_all, skip_all, reciprocal: bool):
    """The scan in numpy float32, operation by operation; the smoothing
    sum divided by 7 or (``reciprocal``) multiplied by float32(1/7)."""
    f = np.float32
    n, b = depths.shape
    raw = np.concatenate([depths, np.zeros((n, 3), f)], axis=1)
    out = np.empty_like(depths)
    p0 = p1 = p2 = np.zeros(n, f)
    for j in range(b):
        m = f(m_all[j])
        col = raw[:, j]
        valid = lengths > j
        with np.errstate(divide="ignore", invalid="ignore"):
            scaled = np.where(valid, col / m, col)
            s = p0 + p1
            s = s + p2
            s = s + scaled
            for r in (1, 2, 3):
                s = s + raw[:, j + r] / m
        s = s * f(1.0 / 7.0) if reciprocal else s / f(7.0)
        smooth = valid & (j > 2) & (j < lengths - 3)
        o = np.where(skip_all[j], col, np.where(smooth, s, scaled))
        out[:, j] = o
        p0, p1, p2 = p1, p2, o
    return out


def _plain(depths, lengths, m, skip):
    return nk.apply_normalization_plain(
        torch.from_numpy(depths), torch.from_numpy(lengths),
        torch.from_numpy(m), torch.from_numpy(skip)).numpy()


def _ulps(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_norm_stats_bitwise_jax(seed):
    depths, lengths = _cohort(seed)
    ref = jst.NormStats()
    ref.accumulate(depths, lengths)
    port = tst.NormStats()
    port.accumulate(depths, lengths)
    for n_bins in (depths.shape[1], depths.shape[1] + 7):
        (m, skip), (wm, wskip) = port.finalize(n_bins), ref.finalize(n_bins)
        assert m.dtype == np.float32 and skip.dtype == bool
        assert np.array_equal(m.view(np.uint32), wm.view(np.uint32))
        assert np.array_equal(skip, wskip)
    assert port.scalars_digest(160) == ref.scalars_digest(160)
    assert skip[5] and skip[-1]  # the low bin and the sparse tail


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_scan_is_the_reference_order_and_xla_multiplies(seed):
    depths, lengths = _cohort(seed)
    m, skip = _scalars(depths, lengths)
    got = _plain(depths, lengths, m, skip)
    want = np.asarray(jst.apply_normalization(depths, lengths, m, skip))
    assert np.array_equal(got.view(np.uint32), _scan_numpy(
        depths, lengths, m, skip, reciprocal=False).view(np.uint32))
    assert np.array_equal(want.view(np.uint32), _scan_numpy(
        depths, lengths, m, skip, reciprocal=True).view(np.uint32))
    assert _ulps(got, want).max() <= SCAN_ULPS


def test_normalize_across_samples_matches_jax():
    depths, lengths = _cohort(4, n=9, width=96)
    got = tops.normalize_across_samples(depths, lengths, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    want = np.asarray(jops.normalize_across_samples(depths, lengths))
    assert _ulps(got.numpy(), want).max() <= SCAN_ULPS


@pytest.mark.parametrize("chunk", [1, 3, 10, 11])
def test_chunked_is_bitwise_monolithic(chunk):
    depths, lengths = _cohort(11)
    want = tops.normalize_across_samples(depths, lengths,
                                         device="cpu").numpy()
    chunks = [(depths[lo:lo + chunk], lengths[lo:lo + chunk])
              for lo in range(0, depths.shape[0], chunk)]
    got = tst.normalize_across_samples_chunked(chunks, device="cpu")
    assert len(got) == len(chunks)
    stacked = np.vstack(got)
    assert stacked.dtype == np.float32
    assert np.array_equal(stacked.view(np.uint32), want.view(np.uint32))


def test_under_five_samples_pass_through():
    depths, lengths = _cohort(5, n=4)
    assert tops.normalize_across_samples(depths, lengths) is depths
    out = tst.normalize_across_samples_chunked([(depths, lengths)],
                                               device="cpu")
    assert np.array_equal(out[0], depths)


def test_width_padding_is_inert():
    depths, lengths = _cohort(6)
    b = depths.shape[1]
    want = tops.normalize_across_samples(depths, lengths,
                                         device="cpu").numpy()
    wide = tst._pad_to(depths, b + 37)
    got = tops.normalize_across_samples(wide, lengths, device="cpu").numpy()
    assert np.array_equal(got[:, :b].view(np.uint32), want.view(np.uint32))
    assert not got[:, b:].any()
    # a chunk only as wide as its own longest sample is padded to b
    w = int(lengths[5:].max())
    assert w < b
    chunked = tst.normalize_across_samples_chunked(
        [(depths[:5], lengths[:5]), (depths[5:, :w], lengths[5:])],
        n_bins=b, device="cpu")
    assert np.array_equal(np.vstack(chunked), want)


def test_mismatched_shapes_are_rejected():
    depths, lengths = _cohort(7)
    m, skip = _scalars(depths, lengths)
    d, ln = torch.from_numpy(depths), torch.from_numpy(lengths)
    mt, st = torch.from_numpy(m), torch.from_numpy(skip)
    with pytest.raises(ValueError, match="m_all"):
        nk.norm_scan(d, ln, mt[:-1], st)
    with pytest.raises(ValueError, match="lengths"):
        nk.norm_scan(d, ln[:-1], mt, st)
    with pytest.raises(ValueError, match="skip_all"):
        nk.norm_scan(d, ln, mt, st[1:])
    with pytest.raises(TypeError, match="lengths"):
        nk.norm_scan(d, ln.long(), mt, st)
    with pytest.raises(TypeError, match="depths"):
        nk.norm_scan(d.double(), ln, mt, st)
    with pytest.raises(ValueError, match="contiguous"):
        nk.norm_scan(d.t(), ln, mt, st)
    with pytest.raises(ValueError, match="samples, bins"):
        nk.norm_scan(d[0], ln, mt, st)
    with pytest.raises(ValueError, match="depth rows"):
        tst.NormStats().accumulate(depths, lengths[:-1])
    with pytest.raises(ValueError, match="exceeds n_bins"):
        tst.normalize_across_samples_chunked([(depths, lengths)],
                                             n_bins=10, device="cpu")


def test_plain_scan_counts_no_launch():
    depths, lengths = _cohort(8)
    m, skip = _scalars(depths, lengths)
    before = dict(nk.LAUNCHES)
    out = tst.apply_normalization(
        torch.from_numpy(depths), torch.from_numpy(lengths),
        torch.from_numpy(m), torch.from_numpy(skip))
    assert nk.LAUNCHES == before
    assert np.array_equal(out.numpy(), _plain(depths, lengths, m, skip))


@pytest.mark.parametrize("name", sorted(NORM_EDGES))
def test_chip_smoke_edge_cases_follow_the_reference_order(name):
    """chip_smoke.py's NORM_EDGES (the cases the kernel is held to on the
    card): the plain version bitwise equal to the numpy transcription that
    divides, and to XLA's scan within SCAN_ULPS."""
    depths, lengths, m, skip = norm_edge_case(name)
    got = _plain(np.ascontiguousarray(depths), lengths.astype(np.int32), m,
                 skip)
    want = _scan_numpy(depths, lengths, m, skip, reciprocal=False)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    xla = np.asarray(jst.apply_normalization(depths, lengths, m, skip))
    assert _ulps(got, xla).max() <= SCAN_ULPS
