"""The port's per-base depth (goleft_tpu_torch/ops/depth_kernel.py) against
the JAX package's Pallas depth kernel, run in interpret mode on the CPU.

The same seeded endpoints go through ``pallas_depth`` (fed by the JAX
package's host tiler) and through the port's plain version; depth is a
count, so the two must be equal exactly. The CUDA kernel itself runs
only on a card: tests/test_torch_cuda.py holds it against the plain
version there.
"""

import numpy as np
import pytest
import torch

from goleft_tpu.ops.coverage import depth_from_segments as jax_depth_from_segments
from goleft_tpu.ops.pallas_coverage import (
    TILE, bucket_endpoints as jax_bucket_endpoints, pallas_depth,
)
from goleft_tpu_torch.ops import depth_kernel as dk
from goleft_tpu_torch.ops.coverage import depth_from_segments


def _random(rng):
    L = 8 * TILE
    n = 2000
    s = rng.integers(0, L - 200, size=n).astype(np.int32)
    e = (s + rng.integers(30, 900, size=n)).astype(np.int32)
    return s, e, rng.random(n) < 0.9, L


def _boundaries(rng):
    L = 4 * TILE
    s = np.array([0, TILE - 1, TILE, 2 * TILE, 0], dtype=np.int32)
    e = np.array([TILE, TILE + 1, 2 * TILE, 3 * TILE, L], dtype=np.int32)
    return s, e, np.ones(5, bool), L


def _overhang(rng):
    L = 2 * TILE
    s = np.array([L - 50, 3], dtype=np.int32)
    e = np.array([L + 500, 3], dtype=np.int32)  # past the end; empty
    return s, e, np.ones(2, bool), L


def _ragged(rng):
    L = 3 * TILE + 77  # not a tile multiple
    s = rng.integers(0, L, size=500).astype(np.int32)
    e = np.minimum(s + rng.integers(0, 300, size=500), L).astype(np.int32)
    return s, e, rng.random(500) < 0.7, L


CASES = {"random": _random, "boundaries": _boundaries,
         "overhang": _overhang, "ragged": _ragged}


def _clipped(s, e, keep, L):
    """Endpoints clipped to [0, L], keep-masked ones sent to L."""
    cs = np.where(keep, np.clip(s, 0, L), L).astype(np.int32)
    ce = np.where(keep, np.clip(e, 0, L), L).astype(np.int32)
    return torch.from_numpy(cs), torch.from_numpy(ce)


@pytest.mark.parametrize("case", sorted(CASES))
def test_depth_plain_equals_pallas_depth(case):
    s, e, keep, L = CASES[case](np.random.default_rng(0))
    st, et, n_tiles = jax_bucket_endpoints(s, e, keep, L)
    want = np.asarray(pallas_depth(st, et, n_tiles, interpret=True))[:L]
    got = dk.depth_plain(*_clipped(s, e, keep, L), L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_depth_from_segments_equals_jax(case):
    s, e, keep, L = CASES[case](np.random.default_rng(1))
    want = np.asarray(jax_depth_from_segments(s, e, keep, L, depth_cap=7))
    got = depth_from_segments(torch.from_numpy(s), torch.from_numpy(e),
                              torch.from_numpy(keep), L, depth_cap=7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bucket_endpoints_copy_matches_reference(case):
    s, e, keep, L = CASES[case](np.random.default_rng(2))
    for a, b in zip(dk.bucket_endpoints(s, e, keep, L),
                    jax_bucket_endpoints(s, e, keep, L)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bucket_endpoints_capacity():
    s = np.zeros(300, dtype=np.int32)  # all in tile 0
    e = np.full(300, 10, dtype=np.int32)
    st, _, _ = dk.bucket_endpoints(s, e, np.ones(300, bool), dk.TILE)
    assert st.shape[1] >= 300 and st.shape[1] % 128 == 0
    assert (st[0] != dk.SENTINEL).sum() == 300
    with pytest.raises(ValueError):
        dk.bucket_endpoints(s, e, np.ones(300, bool), dk.TILE, p_cap=128)


@pytest.mark.parametrize("window,tile", [
    (250, 4000), (500, 4000), (7, 4032), (251, 4016), (13, 3952),
    (1, 4096), (2049, 4096), (7168, 4096), (300_032, 4096)])
def test_tile_geometry(window, tile):
    """Launch B's tile: a multiple of 16 positions up to 4,096 that holds
    whole windows wherever lcm(window, 16) fits, else 4,096 (windows
    then cross tiles)."""
    got = dk.tile_positions(window)
    assert got == tile and got % 16 == 0 and got <= dk.TILE_MAX
    assert (got % window == 0) == (np.lcm(window, 16) <= dk.TILE_MAX)


def test_wrapper_checks_types():
    s = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        dk.fused_depth(s, s, torch.ones(4, dtype=torch.bool), 0, 0, 8, 9, 4,
                       0, 8, 4)
    d = torch.zeros(4, dtype=torch.uint16)
    with pytest.raises(ValueError):
        dk.fused_depth_wire(d, d[:3], 0, 0, 0, 8, 9, 4, 0, 8, 4)


def test_wrapper_launches_for_non_cpu_tensors(monkeypatch):
    """A tensor off the CPU goes to the kernel, never to the plain
    version: with the kernel library unavailable the call raises."""
    calls = []

    def no_library():
        calls.append(1)
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(dk, "load_library", no_library)
    meta = dict(device="meta")
    s = torch.zeros(8, dtype=torch.int32, **meta)
    keep = torch.ones(8, dtype=torch.bool, **meta)
    with pytest.raises(RuntimeError, match="unavailable"):
        dk.fused_depth(s, s, keep, 0, 0, 8, 9, 4, 0, 8, 4)
    d = torch.zeros(8, dtype=torch.uint16, **meta)
    with pytest.raises(RuntimeError, match="unavailable"):
        dk.fused_depth_wire(d, d, 0, 0, 0, 8, 9, 4, 0, 8, 4)
    assert len(calls) == 2


@pytest.mark.parametrize("region_start,region_end,window", [
    (0, 1000, 100), (130, 1020, 250), (5, 999, 7), (0, 50, 1000)])
def test_window_geometry_and_sums_match_jax(region_start, region_end,
                                            window):
    from goleft_tpu.ops import coverage as jc
    from goleft_tpu_torch.ops import coverage as tc

    got = tc.window_bounds(region_start, region_end, window)
    want = jc.window_bounds(region_start, region_end, window)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _, _, lpad, rpad = want
    n = region_end - region_start
    depth = np.random.default_rng(4).integers(0, 50, n).astype(np.int32)
    np.testing.assert_array_equal(
        tc.windowed_sums(torch.from_numpy(depth), n, window, lpad,
                         rpad).numpy(),
        np.asarray(jc.windowed_sums(depth, n, window, lpad, rpad)))


@pytest.mark.parametrize("max_mean", [0, 7])
def test_callable_classes_and_rle_match_jax(max_mean):
    from goleft_tpu.ops import coverage as jc
    from goleft_tpu_torch.ops import coverage as tc

    depth = np.random.default_rng(5).integers(0, 12, 3000).astype(np.int32)
    got = tc.callable_classes(torch.from_numpy(depth), 4, max_mean).numpy()
    want = np.asarray(jc.callable_classes(depth, 4, max_mean))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8
    for g, w in zip(tc.run_length_encode(got), jc.run_length_encode(want)):
        np.testing.assert_array_equal(g, w)
    assert tc.CLASS_NAMES == jc.CLASS_NAMES
