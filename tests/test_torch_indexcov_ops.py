"""The port's indexcov numerics (goleft_tpu_torch/ops/indexcov_ops.py, on
the CPU) against the JAX package's ops/indexcov_ops.py, with x64 on as
tests/conftest.py sets it. Inputs are made from a seed with numpy.

Tolerances: the histogram, ROC, counters, CN and the packed ``chrom_qc``
vector are bitwise equal (NaN where a sample has no bin, in both). PCA is
held per component up to sign (the SVD's signs are the library's), within
chip_smoke.py's ``PCA_RTOL`` (1e-4) of the largest projection of the
component (float32 SVDs of LAPACK builds and XLA differ in the last
digits), variance fractions within 1e-4.
"""

import numpy as np
import pytest
import torch

from chip_smoke import PCA_RTOL, pcs_up_to_sign
from goleft_tpu.ops import indexcov_ops as jops
from goleft_tpu_torch.ops import indexcov_ops as tops



def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _ragged(seed: int, n: int = 7, width: int = 300, empty_row: bool = True):
    """A ragged (n, width) f32 depth matrix around 1 with planted lows,
    highs, zeros and capped values, its valid mask and lengths; row 1 has
    no bins at all when ``empty_row``."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(width // 2, width + 1, size=n).astype(np.int32)
    lengths[0] = width
    if empty_row:
        lengths[1] = 0
    d = rng.gamma(4, 0.25, size=(n, width)).astype(np.float32)
    d[:, 3] = 0.0
    d[2, 10:40] = 0.01
    d[3, :5] = 60000.0 / 50000
    d[4, 20:25] = 1.15
    d[4, 25:30] = np.float32(0.85)
    valid = np.arange(width)[None, :] < lengths[:, None]
    d = np.where(valid, d, 0.0).astype(np.float32)
    return d, valid, lengths


@pytest.mark.parametrize("case", ["random", "outliers", "skewed", "ties"])
def test_median_size_per_tile_matches_jax(case):
    rng = np.random.default_rng(0)
    sizes = {
        "random": [rng.integers(0, 100000, size=500),
                   rng.integers(0, 100000, size=497)],
        "outliers": [np.r_[[10**9] * 5, rng.integers(0, 9, size=300)]],
        "skewed": [np.array([1] * 90 + [1000] * 10)],
        "ties": [np.full(64, 7), np.full(3, 7)],
    }[case]
    sizes = [np.asarray(s, np.int64) for s in sizes]
    assert tops.median_size_per_tile(sizes) == jops.median_size_per_tile(
        sizes)


def test_median_of_no_sizes_raises():
    with pytest.raises(ValueError, match="no usable chromosomes"):
        tops.median_size_per_tile([])


def test_normalized_depth_matches_jax():
    sizes = np.array([0, 100, 200, 12345, 10**12], np.int64)
    got = tops.normalized_depth(sizes, 123.0)
    assert _same_bits(got, jops.normalized_depth(sizes, 123.0))
    assert got[-1] == 50000.0
    assert tops.normalized_depth(sizes, 0).size == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_counts_at_depth_matches_jax(seed):
    d, valid, _ = _ragged(seed)
    got = tops.counts_at_depth(_t(d), _t(valid)).numpy()
    assert _same_bits(got, np.asarray(jops.counts_at_depth(d, valid)))
    assert got.sum() == valid.sum()


def test_counts_at_depth_slot_edges_match_jax():
    """Depths within 40 ulp of every slot edge, (k - 0.5) / 46.666668.
    The multiply and the add are two float32 ops in the port; a fused
    multiply-add would round once. The slot cannot differ: d*s + 0.5 is
    exact after the product is rounded (its ulp divides 0.5 for products
    in [0.5, 70)), and the product lies in the binade of the sum, so both
    roundings land on the same side of the integer. The reference, the
    port and a two-rounding numpy oracle agree on every edge value."""
    scale = np.float32(tops._SCALE)
    vals = []
    for k in range(1, tops.SLOTS + 1):
        c = np.float32((k - 0.5) / float(scale))
        up = down = c
        vals.append(c)
        for _ in range(40):
            up = np.nextafter(up, np.float32(np.inf))
            down = np.nextafter(down, np.float32(-np.inf))
            vals += [up, down]
    d = np.array(vals, np.float32)[:, None]
    valid = np.ones_like(d, bool)
    got = tops.counts_at_depth(_t(d), _t(valid)).numpy().argmax(axis=1)
    want = np.asarray(jops.counts_at_depth(d, valid)).argmax(axis=1)
    oracle = np.minimum(((d[:, 0] * scale).astype(np.float32)
                         + np.float32(0.5)).astype(np.int32), 69)
    assert np.array_equal(got, want)
    assert np.array_equal(got, oracle)
    assert len(set(oracle.tolist())) == tops.SLOTS


def test_counts_roc_matches_jax_with_an_empty_sample():
    counts = np.zeros((3, tops.SLOTS), np.int32)
    counts[0, 10], counts[0, 50] = 30, 70
    counts[2] = np.arange(tops.SLOTS)
    got = tops.counts_roc(_t(counts)).numpy()
    want = np.asarray(jops.counts_roc(counts))
    assert _same_bits(got, want)
    assert np.isnan(got[1]).all()  # 0/0: "%.2f" prints nan
    assert got[0, 0] == 1.0 and got[0, 51] == 0.0


@pytest.mark.parametrize("seed", [4, 5])
def test_bin_counters_match_jax(seed):
    d, valid, lengths = _ragged(seed)
    longest = int(lengths.max()) + 3  # tail bins count as out + low
    got = tops.bin_counters(_t(d), _t(valid), longest)
    want = jops.bin_counters(d, valid, np.int32(longest))
    for k in ("in", "out", "hi", "low"):
        assert _same_bits(got[k].numpy(), np.asarray(want[k])), k


def test_bin_counters_hand_case():
    d = np.array([[1.0, 0.9, 1.2, 0.1, 0.5, 2.0]], np.float32)
    got = {k: int(v[0]) for k, v in tops.bin_counters(
        _t(d), torch.ones(1, 6, dtype=torch.bool), 8).items()}
    assert got == {"in": 2, "out": 6, "hi": 2, "low": 3}


def test_get_cn_matches_jax():
    rng = np.random.default_rng(2)
    rows = [
        rng.gamma(4, 0.25, size=200).astype(np.float32),
        np.concatenate([np.zeros(50), rng.gamma(2, 0.25, 150)]),
        np.full(200, 0.001),
        np.zeros(200),
        np.r_[np.full(70, 0.01), rng.gamma(4, 0.25, 130)],
    ]
    d = np.stack(rows).astype(np.float32)
    valid = np.ones_like(d, bool)
    valid[4, 180:] = False
    got = tops.get_cn(_t(d), _t(valid)).numpy()
    assert _same_bits(got, np.asarray(jops.get_cn(d, valid)))
    assert got[3] == np.float32(-0.1)


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_chrom_qc_packed_vector_is_bitwise_jax(seed):
    d, valid, lengths = _ragged(seed, empty_row=seed != 8)
    longest = int(lengths.max())
    got = tops.chrom_qc(_t(d), _t(valid), longest).numpy()
    want = np.asarray(jops.chrom_qc(d, valid, np.int32(longest)))
    assert _same_bits(got, want)
    rocs, cnt, cn = tops.unpack_chrom_qc(got, d.shape[0])
    wr, wc, wn = jops.unpack_chrom_qc(want, d.shape[0])
    assert _same_bits(rocs, wr) and _same_bits(cn, wn)
    for k in cnt:
        assert np.array_equal(cnt[k], wc[k])


@pytest.mark.parametrize("k", [2, 5])
def test_pca_project_matches_jax_up_to_sign(k):
    rng = np.random.default_rng(4)
    base = rng.normal(size=(3, 80))
    w = rng.normal(size=(20, 3))
    mat = (np.abs(w @ base + 0.05 * rng.normal(size=(20, 80))) * 9000
           ).astype(np.uint16).astype(np.float32)
    proj, frac = tops.pca_project(mat, k=k, device="cpu")
    wp, wf = jops.pca_project(mat, k=k)
    assert proj.dtype == torch.float32 and proj.shape == (20, k)
    pcs_up_to_sign(proj.numpy(), np.asarray(wp), "pca_project", PCA_RTOL)
    np.testing.assert_allclose(frac.numpy(), np.asarray(wf), rtol=1e-4,
                               atol=1e-6)


def test_pca_project_guards():
    with pytest.raises(ValueError, match="at least 2 samples"):
        tops.pca_project(np.ones((1, 4), np.float32), k=1, device="cpu")
    with pytest.raises(ValueError, match="exceed n_samples"):
        tops.pca_project(np.ones((3, 4), np.float32), k=4, device="cpu")


def test_quantize_and_slopes_match_jax():
    d = np.array([0.0, 1.0, 8.0, 9.0, 0.123], np.float32)
    for compat in (False, True):
        assert _same_bits(tops.quantize_depths(d, compat),
                          jops.quantize_depths(d, compat))
    rocs = np.random.default_rng(9).random((4, tops.SLOTS)).astype(
        np.float32)
    assert _same_bits(tops.update_slopes(rocs, 2.48),
                      jops.update_slopes(rocs, 2.48))


def test_normalize_across_samples_under_five_passes_through():
    d = np.ones((4, 10), np.float32)
    assert tops.normalize_across_samples(d, np.full(4, 10)) is d
