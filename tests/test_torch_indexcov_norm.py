"""The port's cross-sample normalisation (goleft_tpu_torch/cohort/
streaming.py, ops/norm_kernel.py's plain version, on the CPU) against the
JAX package's cohort/streaming.py. Inputs are made from a seed with numpy.

- ``NormStats`` (host f64 pass 1, a copy of the reference's numpy, which
  divides by 7.0 in f64): the per-bin scalars and their digest are
  bitwise the reference's.
- Pass 2, the scan: the reference's source divides the smoothing sum by
  7.0, and XLA's algebraic simplifier turns that division into a
  multiply by float32(1/7), so the reference's answer is the multiply.
  The port multiplies too: its plain scan is bitwise equal
  (``SCAN_ULPS`` = 0) to XLA's and to a numpy transcription of the scan
  that multiplies, and not to the one that divides.
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

SCAN_ULPS = 0


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
    mul = _scan_numpy(depths, lengths, m, skip, reciprocal=True)
    assert np.array_equal(want.view(np.uint32), mul.view(np.uint32))
    assert np.array_equal(got.view(np.uint32), mul.view(np.uint32))
    assert _ulps(got, want).max() <= SCAN_ULPS
    # the cohort tells the two roundings apart: a scan that divides by 7
    # is not the reference's answer
    div = _scan_numpy(depths, lengths, m, skip, reciprocal=False)
    assert not np.array_equal(want.view(np.uint32), div.view(np.uint32))


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
    multiplies by float32(1/7), and to XLA's scan (SCAN_ULPS = 0)."""
    depths, lengths, m, skip = norm_edge_case(name)
    got = _plain(np.ascontiguousarray(depths), lengths.astype(np.int32), m,
                 skip)
    want = _scan_numpy(depths, lengths, m, skip, reciprocal=True)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    xla = np.asarray(jst.apply_normalization(depths, lengths, m, skip))
    assert _ulps(got, xla).max() <= SCAN_ULPS


@pytest.mark.parametrize("n", [1, 33, 2_504, 100_000])
@pytest.mark.parametrize("b", [1, 3, nk.TILE_BINS - 1, nk.TILE_BINS,
                               nk.TILE_BINS + 1, 248_956_422 // 16_384])
def test_launch_plan_covers_every_lane_once(n, b):
    """The wrapper's launch plan (passed to the C launch, which refuses
    another): every sample lane in exactly one block of LANES lanes, no
    empty block, the ring within the card's shared memory per block, the
    grid and the block within CUDA's limits, every bin in a tile. The
    byte counts are the wrapper's own arithmetic; what ties them to the
    kernel's ``sizeof(Stage)`` and ``sizeof(RawStage)`` is the C launch,
    which refuses any other plan on the card (tests/test_torch_cuda.py)."""
    plan = nk.launch_plan(n, b)
    lanes = plan["lanes_per_block"]
    block_of = np.arange(n) // lanes
    per_block = np.bincount(block_of, minlength=plan["blocks"])
    assert per_block.size == plan["blocks"]
    assert per_block.sum() == n and per_block.max() <= lanes
    assert per_block.min() >= 1
    assert plan["threads"] == 32 * (1 + plan["producer_warps"]) <= 1024
    assert 1 <= plan["blocks"] <= 2**31 - 1
    # two of the 16 named barriers a stage, one for the producers
    assert 2 <= plan["stages"] <= 7 and plan["load_stages"] >= 2
    assert plan["smem_bytes"] == (plan["stages"] * nk.stage_bytes()
                                  + plan["load_stages"]
                                  * nk.load_stage_bytes())
    assert plan["smem_bytes"] <= 232_448  # an H100 block's shared memory
    assert plan["tile_bins"] % 32 == 0
    assert (plan["tiles"] - 1) * plan["tile_bins"] < b
    assert plan["tiles"] * plan["tile_bins"] >= b


def test_chip_smoke_tile_edges_are_the_kernels():
    tile = nk.TILE_BINS
    widths = {norm_edge_case(name)[0].shape[1] for name in NORM_EDGES}
    assert {tile - 1, tile, tile + 1, tile + 3} <= widths
    lanes = {norm_edge_case(name)[0].shape[0] for name in NORM_EDGES}
    assert {1, 31, 33} <= lanes


# ---- the kernel's division (csrc/indexcov_norm.cu::div_by) -------------


def _rn32(s, t):
    """The float32 nearest to s + t, ties to even (s = fl64(s + t), t its
    rounding error): only an s that is a float32 midpoint needs t."""
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    lo = np.nextafter(r, np.float32(-np.inf)).astype(np.float64)
    hi = np.nextafter(r, np.float32(np.inf)).astype(np.float64)
    r64 = np.where((s == (r64 + lo) / 2) & (t < 0), lo, r64)
    r64 = np.where((s == (r64 + hi) / 2) & (t > 0), hi, r64)
    return r64.astype(np.float32)


def _div_by(x, m):
    """csrc/indexcov_norm.cu's div_by, each step rounded once as on the
    card: y = RN(1/m), q0 = RN(x y), e = RN(x - m q0), RN(q0 + y e). The
    products of two float32 are exact in float64, as is x - m q0 (it is
    under 2^-22 x); q0 + y e is taken exactly by TwoSum."""
    x64, m64 = x.astype(np.float64), m.astype(np.float64)
    y = (np.float32(1) / m).astype(np.float64)
    q0 = (x64 * y).astype(np.float32).astype(np.float64)
    e = (x64 - m64 * q0).astype(np.float32).astype(np.float64)
    p = y * e
    s = q0 + p
    bb = s - q0
    return _rn32(s, (q0 - (s - bb)) + (p - bb))


def _near_midpoints(M, ebits, kmax):
    """Mantissa pairs (X, M), x = X 2^-23 and m = M 2^-23 in [1, 2), with
    |X 2^ebits - M J| <= kmax for an odd J in [2^24, 2^25): x / m near
    the float32 midpoint J 2^-25 (ebits 25, quotients below 1) or J 2^-24
    (ebits 24, quotients from 1 to 2). For k = X 2^ebits - M J, M J = -k
    mod 2^ebits fixes J modulo 2^(ebits - s), s the trailing zero bits of
    M (k a multiple of 2^s); each such J gives X = (M J + k) / 2^ebits."""
    s = np.zeros_like(M)
    odd = M.copy()
    while ((odd & 1) == 0).any():
        ev = (odd & 1) == 0
        s[ev] += 1
        odd[ev] >>= 1
    xs, ms = [], []
    for k in range(-kmax, kmax + 1):
        for sv in range(5):
            sel = s == sv
            if k == 0 or k % (1 << sv) or (k >> sv) % 2 == 0 or \
                    not sel.any():
                continue
            bits = ebits - sv
            mask = (1 << bits) - 1
            mo, mf = odd[sel], M[sel]
            inv = mo.copy()  # Newton's iteration for 1/mo mod 2^bits
            for _ in range(6):
                inv = (inv * ((2 - mo * inv) & mask)) & mask
            j0 = (-(k >> sv) * inv) & mask
            for t in range(1 << (sv + 1)):
                j = j0 + t * (1 << bits)
                num = mf * j + k
                x = num >> ebits
                ok = ((j >= 1 << 24) & (j < 1 << 25)
                      & (num & ((1 << ebits) - 1) == 0)
                      & (x >= 1 << 23) & (x < 1 << 24))
                xs.append(x[ok])
                ms.append(mf[ok])
    return np.concatenate(xs), np.concatenate(ms)


@pytest.mark.parametrize("ebits,kmax", [(25, 11), (24, 5)],
                         ids=["quotients_below_1", "quotients_from_1"])
def test_div_by_is_ieee_division_near_every_midpoint(ebits, kmax):
    """The kernel's one-reciprocal division equals IEEE x / m wherever its
    error could matter, for every float32 mantissa of m. Scaling x and m
    by powers of two scales every step exactly inside div_fast's range,
    so x, m in [1, 2) stand for all. There, with q = x / m: |y - 1/m| <=
    2^-25, so |q0 - q| < 2^-23 (q0 need not be faithful: x = 2 - 2^-22,
    m = 2 - 2^-23 gives q0 = 1 above q's two neighbours); |x - m q0| <
    2^-22, so e is within 2^-47 of it; and q0 + y e is within 2^-47 +
    2^-47 of q. So RN(q0 + y e) = RN(q) unless q lies within 2^-46 < 3
    2^-47 of a float32 midpoint, i.e. |x - m mid| < 6 2^-47: below 1
    (mid = J 2^-25) |X 2^25 - M J| <= 11, from 1 (mid = J 2^-24) |X 2^24
    - M J| <= 5. Every such pair is checked: about 44.5 million."""
    n = 0
    for lo in range(1 << 23, 1 << 24, 1 << 19):
        X, M = _near_midpoints(
            np.arange(lo, lo + (1 << 19), dtype=np.int64), ebits, kmax)
        x = np.ldexp(X.astype(np.float64), -23).astype(np.float32)
        m = np.ldexp(M.astype(np.float64), -23).astype(np.float32)
        got, want = _div_by(x, m), x / m
        bad = np.flatnonzero(got.view(np.uint32) != want.view(np.uint32))
        assert bad.size == 0, (x[bad[:5]], m[bad[:5]])
        n += x.size
    assert n > 10_000_000


def test_div_by_is_ieee_division_on_random_and_named_pairs():
    """The case where q0 is not faithful, and random pairs over the
    kernel's fast range [2^-60, 2^61) and x = +0; the kernel's div_by is
    the sequence that ``_div_by`` reproduces."""
    src = open(nk._nvcc.CSRC + "/indexcov_norm.cu").read()
    for step in ("const float rm = __frcp_rn(m);",
                 "const float q0 = __fmaf_rn(x, r, 0.f);",
                 "return __fmaf_rn(r, __fmaf_rn(-m, q0, x), q0);"):
        assert step in src, step
    rng = np.random.default_rng(11)
    x = np.float32([2 - 2**-22, 0.0])
    m = np.float32([2 - 2**-23, 1.5])
    q0 = (x.astype(np.float64) * (np.float32(1) / m)).astype(np.float32)
    # x / m lies below 1 - 2^-24, the float32 under 1, and q0 is 1
    assert q0[0] == 1 and np.float64(x[0]) / np.float64(m[0]) < 1 - 2**-24
    rx = np.ldexp(rng.uniform(1, 2, 2_000_000), rng.integers(-60, 61,
                                                             2_000_000))
    rm = np.ldexp(rng.uniform(1, 2, 2_000_000), rng.integers(-60, 61,
                                                             2_000_000))
    x = np.r_[x, rx.astype(np.float32)]
    m = np.r_[m, rm.astype(np.float32)]
    assert np.array_equal(_div_by(x, m).view(np.uint32),
                          (x / m).view(np.uint32))
