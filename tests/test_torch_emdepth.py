"""The port's EM copy-number caller and cn.mops (goleft_tpu_torch/models/
emdepth.py, models/mops.py, on the CPU) against the JAX package's, with
x64 on as tests/conftest.py sets it.

- EM and CN: the reference's golden vectors, the 20 random oracle windows
  (λ within rtol = atol = 1e-9 of JAX's, the tolerance of
  tests/test_emdepth.py), the 50 x 24 batch (CN equal), S = 1..4 (the
  even-length median's clamped index at S = 2), an all-zero window (the
  λ2 fallback) and a window above λ8 (CN 8).
- The host merge: the ``Same`` golden, the ``Cache`` merge and gap rule
  with the port's and JAX's calls equal.
- ``_batched_em`` in chunks of 16 equal to one batch and to JAX's, with
  one CN pass a chunk and none a window.
- cn.mops: ``aik`` within 1e-9, ``posterior_cn`` equal.
"""

import numpy as np
import pytest
import torch

import oracle_emdepth as oracle
from goleft_tpu.commands import emdepth_cmd as jcmd
from goleft_tpu.models import emdepth as jem
from goleft_tpu.models import mops as jmops
from goleft_tpu_torch.commands import emdepth_cmd as tcmd
from goleft_tpu_torch.device import NoCudaDevice
from goleft_tpu_torch.models import emdepth as tem
from goleft_tpu_torch.models import mops as tmops
from goleft_tpu_torch.utils.dtypes import preferred_float

CPU = "cpu"
TOL = dict(rtol=1e-9, atol=1e-9)

GOLDEN = [
    ([1, 8, 33, 34, 35, 37, 31, 22, 66], [0, 1, 2, 2, 2, 2, 2, 2, 4]),
    ([30, 28, 33, 34, 35, 37, 31, 22, 38], [2] * 9),
    ([296.6, 16.7, 17.0, 3019.2, 14.4, 16.5, 14.2, 26, 7],
     [8, 2, 2, 8, 2, 2, 2, 3, 1]),
]


def _port(d):
    """(λ, CN) of the port on the CPU for a (B, S) float64 matrix."""
    t = torch.from_numpy(np.ascontiguousarray(d, dtype=np.float64))
    lam = tem.em_depth_batch(t)
    return lam.numpy(), tem.cn_batch(lam, t).numpy()


def _jax(d):
    d = np.asarray(d, dtype=np.float64)
    lam = np.asarray(jem.em_depth_batch(d))
    return lam, np.asarray(jem.cn_batch(lam, d))


def test_policy_is_float64_on_cpu_and_card():
    assert preferred_float() is np.float64
    lam, _ = tcmd._batched_em(np.full((3, 4), 30, np.int16), device=CPU)
    assert lam.dtype == np.float64


@pytest.mark.parametrize("dtype", [np.int16, np.float64])
def test_norm_chunk_scales_as_the_host_does(dtype):
    """The chunk scaled in torch equals the JAX package's host scaling
    (numpy ``v / med * medmed``) bit for bit, and the caller's matrix is
    left as it was."""
    rng = np.random.default_rng(3)
    d = rng.poisson(30, size=(40, 9)).astype(dtype)
    d[:, 2] = 0
    keep = d.copy()
    med, medmed = tcmd.sample_medians(d)
    got = tcmd._norm_chunk(d, med, medmed, np.float64, CPU)
    want = jcmd._norm_chunk(d, med, medmed, np.float64)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(d, keep)
    np.testing.assert_array_equal(
        tcmd._norm_chunk(d, None, None, np.float64, CPU).numpy(),
        d.astype(np.float64))


@pytest.mark.parametrize("depths,expected", GOLDEN)
def test_golden_cn(depths, expected):
    lam, cn = _port(np.asarray([depths], dtype=np.float64))
    jlam, jcn = _jax([depths])
    assert list(cn[0]) == expected == list(jcn[0])
    np.testing.assert_allclose(lam, jlam, **TOL)


def test_lambda_matches_oracle_and_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(4, 40))
        d = rng.gamma(5, 6, size=n).astype(np.float64)
        if rng.random() < 0.5:
            d[0] *= 10
        if rng.random() < 0.3:
            d[-1] = 0
        lam, cn = _port(d[None])
        jlam, jcn = _jax(d[None])
        np.testing.assert_allclose(lam[0], oracle.em_depth(d), **TOL)
        np.testing.assert_allclose(lam, jlam, **TOL)
        np.testing.assert_array_equal(cn, jcn)


def test_cn_matches_oracle_and_jax_batch():
    rng = np.random.default_rng(1)
    B, S = 50, 24
    depths = rng.gamma(5, 6, size=(B, S))
    depths[rng.random((B, S)) < 0.05] *= 8
    depths[rng.random((B, S)) < 0.05] /= 4
    lam, cns = _port(depths)
    jlam, jcns = _jax(depths)
    np.testing.assert_allclose(lam, jlam, **TOL)
    np.testing.assert_array_equal(cns, jcns)
    assert cns.dtype == np.int8
    for b in range(B):
        want = [min(c, tem.MAX_CN) for c in oracle.cns(depths[b])]
        assert list(cns[b]) == want, b


@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_small_sample_counts_match_jax(S):
    rng = np.random.default_rng(10 + S)
    d = rng.gamma(8, 4, size=(30, S)).round(1)
    d[::7, 0] *= 3
    lam, cn = _port(d)
    jlam, jcn = _jax(d)
    np.testing.assert_allclose(lam, jlam, **TOL)
    np.testing.assert_array_equal(cn, jcn)


def test_even_median_quirk_clamps_at_two_samples():
    """[10, 20]: the upper order statistic's index n/2 + 1 = 2 is past
    the end; JAX clamps it, so the median is (20 + 20) / 2 = 20."""
    d = np.array([[10.0, 20.0]])
    med = tem._median_even_quirk(torch.from_numpy(d))
    assert med.tolist() == [20.0]
    lam, cn = _port(d)
    jlam, jcn = _jax(d)
    assert lam[0, 2] == 20.0 == jlam[0, 2]
    assert cn.tolist() == [[2, 2]] == jcn.tolist()
    # S = 4 takes the two order statistics above the midpoint
    four = torch.tensor([[4.0, 1.0, 3.0, 2.0]], dtype=torch.float64)
    assert tem._median_even_quirk(four).tolist() == [3.5]


def test_all_zero_window_takes_the_fallback():
    d = np.zeros((3, 6))
    d[1, :2] = [0.0, 5.0]
    lam, cn = _port(d)
    jlam, jcn = _jax(d)
    np.testing.assert_allclose(lam, jlam, **TOL)
    np.testing.assert_array_equal(cn, jcn)
    assert not lam[0].any()


def test_depth_above_lambda8_is_cn8():
    d = np.array([[30.0, 31, 29, 30, 32, 28, 30, 400.0]])
    lam, cn = _port(d)
    jlam, jcn = _jax(d)
    assert d[0, -1] > lam[0, 8]
    assert cn[0, -1] == 8 == jcn[0, -1]
    np.testing.assert_array_equal(cn, jcn)
    np.testing.assert_allclose(lam, jlam, **TOL)


def test_log2fc_batch_matches_jax():
    rng = np.random.default_rng(3)
    d = rng.gamma(10, 3, size=(12, 9))
    lam, _ = _port(d)
    got = tem.log2fc_batch(torch.from_numpy(lam), torch.from_numpy(d))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jem.log2fc_batch(lam, d)), rtol=1e-12)


def test_same_golden():
    v1 = np.array([296.6, 16.7, 17.0, 3019.2, 14.4, 16.5, 14.2, 26, 7])
    v2 = np.array([96.6, 16.7, 17.0, 319.2, 14.4, 16.5, 14.2, 7, 16])
    non2, changed, pct = tem.em_depth(v2, device=CPU).same(
        tem.em_depth(v1, device=CPU))
    assert pct == pytest.approx(7.0 / 9.0)
    assert non2 == [0, 3]
    assert changed == [7, 8]
    assert (non2, changed, pct) == jem.em_depth(v2).same(jem.em_depth(v1))


def test_em_depth_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        tem.em_depth([10.0, 20.0, 30.0])


def _calls(cnvs):
    """Merged calls with log2FC rounded to 9 decimals (λ2 agrees with
    JAX's to the last few ulps, the EM tolerance above)."""
    return [(c.sample_i, c.positions, [round(f, 9) for f in c.log2fc],
             c.cn, c.depth, c.psize) for c in cnvs]


def _merge(pkg, windows, **kw):
    cache = pkg.Cache()
    out = []
    for d, start, end in windows:
        out += cache.add(pkg.em_depth(d, start=start, end=end, **kw))
    return out + cache.clear(None)


def test_cache_merge_matches_jax():
    rng = np.random.default_rng(2)
    windows = []
    for w in range(30):
        d = rng.gamma(40, 0.8, size=10)
        if 5 <= w <= 9:
            d[3] *= 0.25
        if 14 <= w <= 20:
            d[6] *= 1.8
        windows.append((d, w * 1000, (w + 1) * 1000))
    got = _merge(tem, windows, device=CPU)
    assert _calls(got) == _calls(_merge(jem, windows))
    c3 = next(c for c in got if c.sample_i == 3)
    assert c3.positions[0][0] == 6000 and c3.positions[-1][1] == 10000
    assert all(cn < 2 for cn in c3.cn)
    assert any(c.sample_i == 6 for c in got)


def test_cache_gap_rule_matches_jax():
    rng = np.random.default_rng(3)
    windows = []
    for w in range(6):
        d = rng.gamma(40, 0.8, size=8)
        if w == 0:
            d[0] *= 0.2
        windows.append((d, w * 40_000, w * 40_000 + 1000))
    cache = tem.Cache()
    emitted = []
    for d, s, e in windows:
        emitted += cache.add(tem.em_depth(d, start=s, end=e, device=CPU))
    assert any(c.sample_i == 0 for c in emitted)  # flushed by the gap
    assert _calls(_merge(tem, windows, device=CPU)) \
        == _calls(_merge(jem, windows))


def test_batched_em_in_chunks_matches_one_batch_and_jax(monkeypatch):
    rng = np.random.default_rng(0)
    d = rng.gamma(30, 1.0, size=(53, 10))
    d[20:30, 4] *= 0.3
    calls = []
    cn_batch = tem.cn_batch

    def counted(lam, depths):
        calls.append(len(depths))
        return cn_batch(lam, depths)

    monkeypatch.setattr(tem, "cn_batch", counted)
    monkeypatch.setattr(tcmd, "EM_CHUNK", 16)
    monkeypatch.setattr(jcmd, "EM_CHUNK", 16)
    lam_c, cn_c = tcmd._batched_em(d, device=CPU)
    assert calls == [16, 16, 16, 5]  # the last chunk at its own size
    jlam_c, jcn_c = jcmd._batched_em(d)
    monkeypatch.setattr(tcmd, "EM_CHUNK", 10**9)
    lam_f, cn_f = tcmd._batched_em(d, device=CPU)
    np.testing.assert_allclose(lam_c, lam_f, rtol=1e-12)
    np.testing.assert_array_equal(cn_c, cn_f)
    np.testing.assert_allclose(lam_c, jlam_c, **TOL)
    np.testing.assert_array_equal(cn_c, jcn_c)
    assert cn_c.dtype == np.int8 and cn_c.shape == d.shape


def test_call_cnvs_cn_comes_from_the_batch(monkeypatch):
    """The merge reads each aberrant window's CN from the batch's rows:
    one CN pass per EM chunk, none per window, and every merged call's
    CN equals JAX's (which runs cn_batch per window)."""
    rng = np.random.default_rng(4)
    B, S = 60, 9
    d = rng.gamma(40, 1.0, size=(B, S)).round(1)
    d[10:25, 2] *= 0.5
    d[30:50, 5] *= 1.6
    starts = np.arange(B) * 1000
    chroms = np.array(["chr1"] * B)
    calls = []
    cn_batch = tem.cn_batch

    def counted(lam, depths):
        calls.append(len(depths))
        return cn_batch(lam, depths)

    monkeypatch.setattr(tem, "cn_batch", counted)
    monkeypatch.setattr(tcmd, "EM_CHUNK", 16)
    monkeypatch.setattr(jcmd, "EM_CHUNK", 16)
    names = [f"s{i}" for i in range(S)]
    import io

    got = tcmd.call_cnvs(chroms, starts, starts + 1000, d, names,
                         out=io.StringIO(), device=CPU)
    want = jcmd.call_cnvs(chroms, starts, starts + 1000, d, names,
                          out=io.StringIO())
    assert calls == [16, 16, 16, 12]

    def rounded(calls):
        return [r[:5] + (round(r[5], 9),) for r in calls]

    assert rounded(got) == rounded(want)
    assert any(r[3] == "s2" and r[5] < -0.5 for r in got)
    assert any(r[3] == "s5" and r[4] > 2 for r in got)


def _mops_matrix():
    rng = np.random.default_rng(4)
    d = rng.gamma(20, 2.0, size=(40, 15))
    d[3, :4] = 0
    d[5] *= 0.01
    d[6] = 0
    d[7, 2] *= 5
    d[8:12, 9] *= 0.5
    return d


def test_mops_batch_matches_jax():
    d = _mops_matrix()
    want = jmops.mops_batch(d)
    got = tmops.mops_batch(torch.from_numpy(d))
    assert got["aik"].shape == (40, tmops.MAX_CN, 15)
    for key in ("aik", "alpha", "lambda"):
        np.testing.assert_allclose(got[key].numpy(),
                                   np.asarray(want[key]), rtol=1e-9,
                                   atol=1e-9, err_msg=key)


def test_posterior_cn_and_gain_match_jax():
    d = _mops_matrix()
    waik = np.asarray(jmops.mops_batch(d)["aik"])
    aik = tmops.mops_batch(torch.from_numpy(d))["aik"]
    cn = tmops.posterior_cn(aik).numpy()
    np.testing.assert_array_equal(cn, np.asarray(jmops.posterior_cn(waik)))
    assert cn.dtype == np.int8
    np.testing.assert_allclose(tmops.information_gain(aik).numpy(),
                               np.asarray(jmops.information_gain(waik)),
                               rtol=1e-9, atol=1e-9)
    # the first maximum wins a tie, as jnp.argmax
    tie = torch.zeros(1, tmops.MAX_CN, 2, dtype=torch.float64)
    tie[0, 3:6] = 1.0
    assert tmops.posterior_cn(tie).tolist() == [[3, 3]]
