"""The port's chunked PCA (goleft_tpu_torch/cohort/pca.py, on the CPU)
against its exact oracle (``ops.indexcov_ops.pca_project``) and against
the JAX package's ``sharded_pca`` on the same chunks and seed.

Tolerances: against the reference's power iteration, components and
variance fractions within rtol 1e-6 (both accumulate in float64, the
iterate is rounded to float32 each step, so only the products' summation
order differs); against the exact SVD, tests/test_cohort_pca.py's own
(fractions rtol 1e-4, atol 1e-5; projections within 1e-3 of their norm,
up to sign).
"""

import numpy as np
import pytest
import torch

from goleft_tpu.cohort.pca import sharded_pca as jsharded
from goleft_tpu_torch.cohort import pca as tpca
from goleft_tpu_torch.cohort.pca import ShardedPCA, sharded_pca
from goleft_tpu_torch.ops.indexcov_ops import pca_project
from test_cohort_pca import _chunks, _rank_separated


def tsharded(chunks_fn, k=5, **kw):
    return sharded_pca(chunks_fn, k=k, device="cpu", **kw)


# ---------------------------------------------------------- guards

def test_pca_project_rejects_single_sample():
    with pytest.raises(ValueError, match="single-sample"):
        pca_project(np.ones((1, 8), np.float32), k=1, device="cpu")


def test_pca_project_rejects_k_above_n_samples():
    with pytest.raises(ValueError, match="k=5"):
        pca_project(np.ones((3, 8), np.float32), k=5, device="cpu")


def test_sharded_pca_same_guards():
    rng = np.random.default_rng(1)
    one = rng.standard_normal((1, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="single-sample"):
        tsharded(_chunks(one, 1), k=1)
    with pytest.raises(ValueError, match="empty"):
        tsharded(lambda: iter(()), k=2)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="k=5"):
        tsharded(_chunks(x, 2), k=5)


def test_default_device_is_the_card(monkeypatch):
    from goleft_tpu_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((4, 8), np.float32)
    with pytest.raises(device.NoCudaDevice):
        sharded_pca(_chunks(x, 2), k=2)


# --------------------------------------------------- oracle parity

def test_sharded_matches_oracle_on_separated_spectrum():
    rng = np.random.default_rng(42)
    x = _rank_separated(rng, n=60, bins=48, k=4)
    want_proj, want_frac = pca_project(x, k=4, device="cpu")
    fit = tsharded(_chunks(x, 13), k=4, iters=48, seed=3)
    assert isinstance(fit, ShardedPCA)
    np.testing.assert_allclose(fit.frac_, want_frac.numpy(),
                               rtol=1e-4, atol=1e-5)
    got = np.vstack([fit.project(c) for c in _chunks(x, 13)()])
    for j in range(4):
        a, b = got[:, j], want_proj.numpy()[:, j]
        err = min(np.linalg.norm(a - b), np.linalg.norm(a + b))
        assert err <= 1e-3 * np.linalg.norm(b), (j, err)


@pytest.mark.parametrize("case", ["separated", "unstructured", "wide"])
def test_sharded_matches_the_reference(case):
    """The port's power iteration against the JAX package's on the same
    chunks and seed: components, fractions and projections within rtol
    1e-6 (signs pinned alike by both)."""
    rng = np.random.default_rng(7)
    if case == "separated":
        x, size, k, kw = _rank_separated(rng, n=60, bins=48, k=4), 13, \
            4, {"iters": 48, "seed": 3}
    elif case == "unstructured":
        x, size, k, kw = rng.standard_normal((30, 100)).astype(
            np.float32), 7, 5, {}
    else:
        x, size, k, kw = (rng.gamma(3.0, 1.0, (12, 700)) * 1000).astype(
            np.float32), 5, 5, {"seed": 11}
    want = jsharded(_chunks(x, size), k=k, **kw)
    got = tsharded(_chunks(x, size), k=k, **kw)
    np.testing.assert_allclose(got.components_, want.components_,
                               rtol=1e-6, atol=1e-6 * np.abs(
                                   want.components_).max())
    np.testing.assert_allclose(got.frac_, want.frac_, rtol=1e-6)
    np.testing.assert_array_equal(got.mean_, want.mean_)
    pa = np.vstack([got.project(c) for c in _chunks(x, size)()])
    pb = np.vstack([want.project(c) for c in _chunks(x, size)()])
    np.testing.assert_allclose(pa, pb, rtol=1e-6,
                               atol=1e-6 * np.abs(pb).max())


def test_sharded_chunk_size_and_rerun_deterministic():
    rng = np.random.default_rng(9)
    x = _rank_separated(rng, n=30, bins=24, k=3)
    fits = [tsharded(_chunks(x, s), k=3, iters=40, seed=7)
            for s in (5, 30, 5)]
    np.testing.assert_array_equal(fits[0].components_,
                                  fits[2].components_)
    np.testing.assert_allclose(fits[0].components_,
                               fits[1].components_,
                               rtol=5e-4, atol=5e-5)


def test_k_clamps_to_cohort_size():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    fit = tsharded(_chunks(x, 2), k=3, iters=16)
    assert fit.components_.shape == (16, 3)
    assert fit.frac_.shape == (3,)
    narrow = rng.standard_normal((6, 2)).astype(np.float32)
    fit = tsharded(_chunks(narrow, 4), k=5, iters=8)
    assert fit.components_.shape == (2, 2)


def test_chunk_products_accumulate_in_float64():
    """Each chunk's moments and Gram product are float64, as the
    reference's are on CPU/x64, from a float32 chunk."""
    rng = np.random.default_rng(5)
    c = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    mean = c.mean(dim=0)
    q = torch.from_numpy(np.linalg.qr(rng.standard_normal((6, 2)))[0]
                         .astype(np.float32))
    s, ss = tpca._chunk_stats(c)
    g = tpca._chunk_gram(c, mean, q)
    w = tpca._chunk_w(c, mean, q)
    assert s.dtype == ss.dtype == g.dtype == w.dtype == torch.float64
    cc = c.double() - mean.double()
    np.testing.assert_allclose(g.numpy(), (cc.T @ (cc @ q.double()))
                               .numpy(), rtol=1e-12)
    np.testing.assert_allclose(w.numpy(), (cc @ q.double()).numpy(),
                               rtol=1e-12)
