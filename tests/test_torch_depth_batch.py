"""The batch axis of the port's depth pass (DepthEngine.run_segments_batch,
ops/depth_kernel.py::fused_depth_batch, plain version on the CPU) against
the JAX package's run_segments_batch (a jax.vmap of the per-sample
pipeline) on the same seeded numpy segments, and against B single
run_segments calls.

Depths, classes and window sums are exact small integers here (window x
cap < 2**24), so every comparison is bitwise. The port takes the u16
wire when every sample packs and the int32 wire when any sample has a
segment of 65,536 bases or more; the JAX package takes the int32 wire
always. The bytes are the same either way.
"""

import numpy as np
import pytest
import torch

from goleft_tpu.commands.depth import DepthEngine as JaxEngine
from goleft_tpu_torch.commands.depth import DepthEngine
from goleft_tpu_torch.ops import depth_kernel as dk

WINDOW = 250
SHARD = 120_000


def _sample(rng, lo, hi, n, max_len=300):
    s = np.sort(rng.integers(lo, hi, size=n)).astype(np.int32)
    e = (s + rng.integers(1, max_len, size=n)).astype(np.int32)
    return s, e


def _batch(b: int, long_segment: bool, seed: int):
    """b samples over [0, SHARD): uneven counts, every third sample
    empty, a pileup in one; optionally one segment of 70,000 bases."""
    rng = np.random.default_rng(seed)
    segs = []
    for i in range(b):
        if i % 3 == 2:
            segs.append((np.zeros(0, np.int32), np.zeros(0, np.int32)))
            continue
        s, e = _sample(rng, -200, SHARD + 200, int(rng.integers(50, 3000)))
        if i == 1:  # a pileup above the cap of max_mean 3 + 2500
            s = np.sort(np.concatenate([s, np.full(2600, 5000, np.int32)]))
            e = np.sort(np.concatenate([e, np.full(2600, 5300, np.int32)]))
        segs.append((s, e))
    if long_segment:
        s, e = segs[0]
        segs[0] = (np.append(s, np.int32(SHARD - 80_000)),
                   np.append(e, np.int32(SHARD - 10_000)))
        order = np.argsort(segs[0][0], kind="stable")
        segs[0] = (segs[0][0][order], segs[0][1][order])
    return segs


# (start, end): the whole shard, and a region strictly inside it
REGIONS = {"shard": (0, SHARD), "inner": (1_130, SHARD - 7_870)}


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("long_segment", [False, True],
                         ids=["u16", "int32"])
@pytest.mark.parametrize("region", sorted(REGIONS))
def test_batch_matches_jax_and_singles(b, long_segment, region):
    start, end = REGIONS[region]
    segs = _batch(b, long_segment, seed=b * 7 + len(region))
    kw = dict(window=WINDOW, min_cov=4, max_mean_depth=3, mapq=1,
              max_span=SHARD)
    port = DepthEngine(packed=True, device="cpu", **kw)
    got = port.run_segments_batch(segs, start, end)
    want = JaxEngine(**kw).run_segments_batch(segs, start, end)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    for i, (s, e) in enumerate(segs):
        one = port.run_segments(s, e, None, start, end)
        np.testing.assert_array_equal(got[2][i], one[2])
        np.testing.assert_array_equal(got[3][i], one[3])


def test_batch_takes_the_int32_wire_only_for_long_segments(monkeypatch):
    """Which wire the batch sends: u16 when every sample packs, int32
    when one sample holds a segment of 65,536 bases or more."""
    seen = []
    real = dk.fused_depth_batch

    def spy(*a, **k):
        seen.append(k.get("bases") is not None)
        return real(*a, **k)

    monkeypatch.setattr(
        "goleft_tpu_torch.ops.depth_pipeline.fused_depth_batch", spy)
    eng = DepthEngine(WINDOW, 4, 0, 1, max_span=SHARD, packed=True,
                      device="cpu")
    for long_segment in (False, True):
        eng.run_segments_batch(_batch(3, long_segment, 5), 0, SHARD)
    assert seen == [True, False]


@pytest.mark.parametrize("wire", ["u16", "int32"])
def test_fused_depth_batch_rows_equal_single_calls(wire):
    """The wrapper's rows (dense outputs too) equal the single-shard
    wrappers on each sample's entries, with unaligned offsets."""
    rng = np.random.default_rng(3)
    L, W = 9_000, 9
    pieces = [_sample(rng, 0, L, n) for n in (40, 0, 333, 7)]
    kw = dict(w0=0, rs=17, re=L - 5, cap=2600, min_cov=4, max_mean=3,
              length=L, window=W)
    if wire == "u16":
        from goleft_tpu_torch.ops.coverage import pack_segments_u16

        packs = [pack_segments_u16(s, e, slice(None)) for s, e in pieces]
        cols = [(torch.from_numpy(p[0]), torch.from_numpy(p[1]))
                for p in packs]
        bases = [int(p[2]) for p in packs]
        singles = [dk.fused_depth_wire(x, y, base, dense=True, **kw)
                   for (x, y), base in zip(cols, bases)]
    else:
        cols = [(torch.from_numpy(s), torch.from_numpy(e))
                for s, e in pieces]
        bases = None
        singles = [dk.fused_depth(x, y, torch.ones(len(x), dtype=bool),
                                  dense=True, **kw) for x, y in cols]
    offsets = np.concatenate([[0], np.cumsum([len(x) for x, _ in cols])])
    a = torch.cat([x for x, _ in cols])
    b = torch.cat([y for _, y in cols])
    keep = None if bases else torch.ones(len(a), dtype=bool)
    got = dk.fused_depth_batch(a, b, offsets.tolist(), keep=keep,
                               bases=bases, dense=True, **kw)
    for i, one in enumerate(singles):
        for g, w in zip(got, one):
            assert torch.equal(g[i], w)
