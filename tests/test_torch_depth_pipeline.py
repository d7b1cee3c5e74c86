"""The port's per-shard pipeline (goleft_tpu_torch/ops/depth_pipeline.py,
plain version on the CPU) against the JAX package's
ops/depth_pipeline.py on the same seeded numpy inputs.

Window sums are bitwise equal wherever window * cap < 2**24: every
partial sum is then an exact integer in float32, whatever the reduction
order. Above that the JAX sums round in XLA's order and the port's are
the exact integer rounded once; there the two agree to 1e-6 relative
(float32 keeps 24 bits). Classes, packed classes and depth are integers
and must be equal.
"""

import numpy as np
import pytest
import torch

from goleft_tpu.commands.depth import DepthEngine as JaxEngine
from goleft_tpu.ops import depth_pipeline as jp
from goleft_tpu.ops.coverage import bucket_size as jax_bucket_size
from goleft_tpu.ops.coverage import pack_segments_u16 as jax_pack
from chip_smoke import DEPTH_EDGES, depth_edge_case
from goleft_tpu_torch.commands.depth import DepthEngine
from goleft_tpu_torch.ops import depth_kernel as dk
from goleft_tpu_torch.ops import depth_pipeline as tp
from goleft_tpu_torch.ops.coverage import bucket_size, pack_segments_u16


def _segments(rng, lo, hi, n, max_len=400, gap=None):
    s = np.sort(rng.integers(lo, hi, size=n))
    if gap is not None:  # a hole wider than one u16 delta
        s = s[(s < gap[0]) | (s >= gap[1])]
    e = s + rng.integers(0, max_len, size=s.size)
    return s.astype(np.int32), e.astype(np.int32)


# name: (w0, region_start, region_end, length, window, max_mean, cap,
#        n segments, gap)
CASES = {
    "full_shard": (0, 0, 12_000, 12_000, 250, 0, 2500, 3000, None),
    "max_mean": (0, 0, 12_000, 12_000, 250, 7, 2507, 3000, None),
    "inner_region": (5_000, 5_130, 14_870, 10_000, 250, 9, 2509, 3000,
                     None),
    "ragged_window": (1_001, 1_010, 10_000, 9_009, 13, 5, 2505, 2000,
                      None),
    "u16_gap": (0, 0, 200_000, 200_000, 1000, 6, 2506, 4000,
                (20_000, 150_000)),
    "window_ge_span": (0, 0, 7_000, 7_168, 7_168, 8, 2508, 2500, None),
}


def _scalars(c):
    w0, rs, re, _, _, mm, cap = c[:7]
    return tuple(np.int32(x) for x in (w0, rs, re, cap, 4, mm))


def _assert_same(got, want, exact_sums=True):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        if exact_sums or g.dtype != np.float32:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_int32_wire_matches_jax(case):
    c = CASES[case]
    w0, rs, re, L, W = c[:5]
    rng = np.random.default_rng(10)
    s, e = _segments(rng, w0 - 500, w0 + L + 500, c[7], gap=c[8])
    keep = rng.random(s.size) < 0.9
    kw = dict(length=L, window=W)
    sc = _scalars(c)
    t = [torch.from_numpy(x) for x in (s, e, keep)]
    ints = [int(x) for x in sc]
    _assert_same(tp.shard_depth_pipeline_cls_packed(*t, *ints, **kw),
                 jp.shard_depth_pipeline_cls_packed(s, e, keep, *sc, **kw))
    _assert_same(tp.shard_depth_pipeline(*t, *ints, **kw),
                 jp.shard_depth_pipeline(s, e, keep, *sc, **kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_u16_wire_matches_jax(case):
    c = CASES[case]
    w0, rs, re, L, W = c[:5]
    rng = np.random.default_rng(11)
    s, e = _segments(rng, w0 - 500, w0 + L + 500, c[7], gap=c[8])
    keep = rng.random(s.size) < 0.9
    d, ln, base, n_ent = pack_segments_u16(s, e, keep)
    for a, b in zip((d, ln, base, n_ent), jax_pack(s, e, keep)):
        np.testing.assert_array_equal(a, b)
    if c[8] is not None:
        assert (ln[:n_ent] == 0).any(), "the gap must need u16 fillers"
    b = bucket_size(n_ent)
    assert b == jax_bucket_size(n_ent)
    dd = np.zeros(b, np.uint16)
    ll = np.zeros(b, np.uint16)
    dd[:n_ent], ll[:n_ent] = d, ln
    kw = dict(length=L, window=W)
    sc = _scalars(c)
    t = [torch.from_numpy(x) for x in (dd, ll)]
    ints = [int(x) for x in sc]
    _assert_same(
        tp.shard_depth_pipeline_packed_cls_packed(*t, int(base), *ints,
                                                  **kw),
        jp.shard_depth_pipeline_packed_cls_packed(dd, ll, base, *sc, **kw))
    _assert_same(tp.shard_depth_pipeline_packed(*t, int(base), *ints, **kw),
                 jp.shard_depth_pipeline_packed(dd, ll, base, *sc, **kw))


@pytest.mark.parametrize("wire", ["int32", "u16"])
@pytest.mark.parametrize("name", sorted(DEPTH_EDGES))
def test_edge_cases_match_jax(name, wire):
    """chip_smoke.py's depth kernel edge cases (the ones the card holds
    the kernel to, bitwise against this plain version) through the
    port's public wrappers on the CPU and the JAX package's pipeline:
    window sums, dense classes, dense depth and packed classes. The u16
    wire runs where it can carry the segments (all of them here)."""
    (s, e, keep, args), packed = depth_edge_case(name)
    *sc, L, W = args
    sc = tuple(np.int32(x) for x in sc)
    kw = dict(length=L, window=W)
    exact = W * args[3] < 2**24
    if wire == "int32":
        t = [torch.from_numpy(x) for x in (s, e, keep)]
        got = dk.fused_depth(*t, *args, dense=True)
        sums, cls, depth = jp.shard_depth_pipeline(s, e, keep, *sc, **kw)
        want_packed = jp.shard_depth_pipeline_cls_packed(s, e, keep, *sc,
                                                         **kw)[1]
    else:
        assert packed is not None
        dd, ll, base = packed
        got = dk.fused_depth_wire(torch.from_numpy(dd), torch.from_numpy(ll),
                                  base, *args, dense=True)
        sums, cls, depth = jp.shard_depth_pipeline_packed(
            dd, ll, np.int32(base), *sc, **kw)
        want_packed = jp.shard_depth_pipeline_packed_cls_packed(
            dd, ll, np.int32(base), *sc, **kw)[1]
    _assert_same((got[0], got[2], got[3], got[1]),
                 (sums, cls, depth, want_packed), exact_sums=exact)


def test_sums_above_float32_exact_range():
    """window * cap ≥ 2**24: the JAX sums round in XLA's order, the
    port's once from the exact integer; 1e-6 relative."""
    L = W = 65_536
    s = np.zeros(300, np.int32)
    e = np.full(300, L, np.int32)
    keep = np.ones(300, bool)
    sc = tuple(np.int32(x) for x in (0, 0, L, 2600, 4, 100))
    got = tp.shard_depth_pipeline_cls_packed(
        *(torch.from_numpy(x) for x in (s, e, keep)), *(int(x) for x in sc),
        length=L, window=W)
    want = jp.shard_depth_pipeline_cls_packed(s, e, keep, *sc, length=L,
                                              window=W)
    assert float(got[0][0]) == 300.0 * L
    _assert_same(got, want, exact_sums=False)


def test_unpack_cls_2bit_matches_jax():
    rng = np.random.default_rng(12)
    packed = rng.integers(0, 256, size=37).astype(np.uint8)
    for n in (145, 148, 1):
        np.testing.assert_array_equal(tp.unpack_cls_2bit(packed, n),
                                      jp.unpack_cls_2bit(packed, n))


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("window,max_mean", [(250, 0), (100, 7),
                                             (10**9, 5)])
def test_engine_run_segments_matches_jax(packed, window, max_mean):
    """Both engines from the same constructor arguments, fed the same
    arrays: an inner region, keep masks, a u16 gap, and on the second
    call a segment of ≥ 65,536 bases that forces the int32 wire."""
    rng = np.random.default_rng(13)
    span = 300_000
    args = (window, 4, max_mean, 1)
    ours = DepthEngine(*args, max_span=span, packed=packed, device="cpu")
    ref = JaxEngine(*args, max_span=span, packed=packed)
    assert (ours.length, ours.w_eff, ours.cap) == \
        (ref.length, ref.w_eff, ref.cap)
    s, e = _segments(rng, 0, span, 6000, gap=(100_000, 250_000))
    kp = rng.random(s.size) < 0.9
    long_s = np.concatenate([s, [1_000]]).astype(np.int32)
    long_e = np.concatenate([e, [90_000]]).astype(np.int32)
    for ss, ee, k, start, end in (
            (s, e, kp, 130, span - 70),
            (s, e, None, 0, span),
            (long_s, long_e, None, 0, span)):
        got = ours.run_segments(ss, ee, k, start, end)
        want = ref.run_segments(ss, ee, k, start, end)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
