"""The port's pair-HMM forward (goleft_tpu_torch/ops/pairhmm.py and
ops/pairhmm_kernel.py) against the JAX package's XLA wavefront
``_forward_bucket_impl`` and the f64 log-space oracle of
tests/test_pairhmm.py, on the CPU.

The same seeded, ``_pack_bucket``-packed buckets go through the JAX
wavefront (CPU, x64 on, as the suite's conftest sets it) and through the
port's plain version (``device="cpu"``). Tolerances: shifts equal;
within 1e-4 log10 of the oracle (the reference's own bound); f64 within
1e-12 of the reference. In f32 two things part the reference from the
port on the CPU: XLA's CPU ``exp2`` is a few ulps off at the integer
arguments of the scale factors (the port's factors are exact powers of
two), and XLA contracts ``a*b + c`` into FMA (the port rounds each
product and sum, as its kernel does with ``-fmad=false``). With the
reference as it is, the folded log10 differ by up to 1.7e-5 (measured,
seed 11) and the port is the closer of the two to the oracle; with an
exact ``exp2`` swapped into the reference for the test, they agree
within 1e-6 (measured max 1.9e-7, the FMA residue). The
CUDA kernel itself runs only on a card: tests/test_torch_cuda.py holds it
against the plain version there.
"""

import numpy as np
import pytest
import torch

from goleft_tpu.ops import pairhmm as jph
from goleft_tpu_torch.ops import pairhmm as tph
from goleft_tpu_torch.ops import pairhmm_kernel as pk
from test_pairhmm import _BASES, _random_pairs, oracle_log10


def _buckets(reads, quals, haps, dtype, bucket=32):
    """Each length bucket packed the reference's way →
    [(idxs, packed)]."""
    enc_r = [jph.encode_seq(r) for r in reads]
    errs = [jph.phred_to_err(np.broadcast_to(np.asarray(q), (len(r),)))
            for r, q in zip(enc_r, quals)]
    enc_h = [jph.encode_seq(h) for h in haps]
    out = []
    for (rp, hp), idxs in sorted(jph.bucket_pairs(enc_r, enc_h,
                                                  bucket).items()):
        out.append((idxs, jph._pack_bucket(idxs, enc_r, errs, enc_h, rp,
                                           hp, dtype)))
    return out


def _both(reads, quals, haps, dtype):
    """(jax folded, port folded, jax shifts, port shifts) per pair."""
    rescale = dtype == np.float32
    trans = jph.transition_probs().astype(dtype)
    n = len(reads)
    got, want = np.zeros(n), np.zeros(n)
    shifts_equal = True
    for idxs, packed in _buckets(reads, quals, haps, dtype):
        jc, js = jph._forward_bucket(*packed, trans, rescale=rescale)
        jc, js = np.asarray(jc), np.asarray(js)
        pc, ps = pk.forward_bucket(
            *(torch.from_numpy(a) for a in (*packed, trans)),
            rescale=rescale)
        assert pc.dtype == torch.from_numpy(trans).dtype
        assert ps.dtype == torch.int32 and pc.shape == jc.shape
        shifts_equal &= bool(np.array_equal(ps.numpy(), js))
        want[idxs] = jph._fold_contribs(jc, js)
        got[idxs] = tph._fold_contribs(pc.numpy(), ps.numpy())
    return got, want, shifts_equal


@pytest.fixture
def exact_xla_exp2(monkeypatch):
    """The reference's wavefront traced with an exact ``exp2`` (ldexp of
    one); jit caches are cleared on both sides so no other test sees the
    swapped trace."""
    import jax
    import jax.numpy as jnp

    def exact(x):
        return jnp.ldexp(jnp.ones_like(x), x.astype(jnp.int32))

    monkeypatch.setattr(jnp, "exp2", exact)
    monkeypatch.setattr(jph, "_FORWARD_JIT", None)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _f32_pairs():
    return _random_pairs(60, np.random.default_rng(11), max_r=70,
                         max_h=90)


def test_plain_f32_matches_xla_wavefront():
    """Against the reference as it is: shifts equal, log10 within 5e-5
    (measured 1.7e-5, from XLA's inexact CPU exp2), and the port nearer
    the oracle than the reference on every pair."""
    reads, quals, haps = _f32_pairs()
    got, want, shifts_equal = _both(reads, quals, haps, np.float32)
    assert shifts_equal
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    orc = np.array([oracle_log10(r, q, h)
                    for r, q, h in zip(reads, quals, haps)])
    assert np.abs(got - orc).max() < 1e-6
    assert np.abs(got - orc).max() < np.abs(want - orc).max()


def test_plain_f32_matches_xla_wavefront_with_exact_exp2(exact_xla_exp2):
    """With the reference's scale factors exact, the two agree within
    1e-6 log10 (what remains is XLA's FMA contraction)."""
    reads, quals, haps = _f32_pairs()
    got, want, shifts_equal = _both(reads, quals, haps, np.float32)
    assert shifts_equal
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_plain_f64_matches_xla_wavefront():
    rng = np.random.default_rng(12)
    reads, quals, haps = _random_pairs(40, rng, max_r=50, max_h=70)
    got, want, shifts_equal = _both(reads, quals, haps, np.float64)
    assert shifts_equal
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_f32_within_oracle_on_110_random_pairs():
    rng = np.random.default_rng(2)
    reads, quals, haps = _random_pairs(110, rng)
    want = np.array([oracle_log10(r, q, h)
                     for r, q, h in zip(reads, quals, haps)])
    got = tph.forward_pairs(reads, quals, haps, dtype=np.float32,
                            device="cpu")
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    got64 = tph.forward_pairs(reads[:20], quals[:20], haps[:20],
                              dtype=np.float64, device="cpu")
    np.testing.assert_allclose(got64, want[:20], rtol=0, atol=1e-12)


@pytest.mark.parametrize("qual", [4, 35, 93])
def test_f32_underflow_edge_reads(qual):
    """A 300 bp junk read (likelihood far below f32's range) survives the
    per-row rescaling to 1e-4 log10; q4 drives the scale ramp the other
    way."""
    rng = np.random.default_rng(3)
    read = "".join(rng.choice(_BASES, 300))
    hap = "".join(rng.choice(_BASES, 360))
    q = np.full(300, qual)
    want = oracle_log10(read, q, hap)
    got = tph.forward_pairs([read], [q], [hap], dtype=np.float32,
                            device="cpu")[0]
    assert want < -100
    assert abs(got - want) < 1e-4
    # the reference's inexact CPU exp2 (module docstring): measured
    # 1.5e-5 here
    ref = jph.forward_pairs([read], [q], [hap], dtype=np.float32)[0]
    assert abs(got - ref) < 5e-5


def test_f32_overflow_side_stays_finite():
    """Near-certain alignments and a read longer than its hap."""
    hap = "ACGTACGTACGTACGTACGTACGTACGTAC"
    read = hap[2:26]
    got = tph.forward_pairs([read], [40], [hap], device="cpu")[0]
    assert abs(got - oracle_log10(read, 40, hap)) < 1e-4
    rng = np.random.default_rng(4)
    long_read = "".join(rng.choice(_BASES, 90))
    short_hap = "".join(rng.choice(_BASES, 30))
    q = np.full(90, 30)
    got2 = tph.forward_pairs([long_read], [q], [short_hap],
                             device="cpu")[0]
    assert abs(got2 - oracle_log10(long_read, q, short_hap)) < 1e-4


def test_padding_and_bucketing_invariance_bitwise():
    """A pair's result is bitwise the same alone, in a mixed batch, and
    at a coarser bucket granularity."""
    rng = np.random.default_rng(5)
    reads, quals, haps = _random_pairs(20, rng, max_r=40, max_h=70)
    batch = tph.forward_pairs(reads, quals, haps, device="cpu")
    for i in (0, 7, 19):
        alone = tph.forward_pairs([reads[i]], [quals[i]], [haps[i]],
                                  device="cpu")[0]
        assert alone == batch[i]
    fat = tph.forward_pairs(reads, quals, haps, device="cpu", bucket=128)
    np.testing.assert_array_equal(fat, batch)


def test_host_layer_matches_reference():
    rng = np.random.default_rng(8)
    reads, quals, haps = _random_pairs(15, rng, max_r=40, max_h=50)
    for s in ("ACGTNacgtx", b"GATTACA", np.array([0, 3, 4], np.uint8)):
        np.testing.assert_array_equal(tph.encode_seq(s), jph.encode_seq(s))
    np.testing.assert_array_equal(tph.phred_to_err([1, 30, 93]),
                                  jph.phred_to_err([1, 30, 93]))
    for go, ge in ((45.0, 10.0), (30.0, 5.0)):
        np.testing.assert_array_equal(tph.transition_probs(go, ge),
                                      jph.transition_probs(go, ge))
    enc_r = [tph.encode_seq(r) for r in reads]
    enc_h = [tph.encode_seq(h) for h in haps]
    errs = [tph.phred_to_err(q) for q in quals]
    for bucket in (32, 128):
        assert tph.bucket_pairs(enc_r, enc_h, bucket) == \
            jph.bucket_pairs(enc_r, enc_h, bucket)
    for (rp, hp), idxs in tph.bucket_pairs(enc_r, enc_h).items():
        for dtype in (np.float32, np.float64):
            for a, b in zip(
                    tph._pack_bucket(idxs, enc_r, errs, enc_h, rp, hp,
                                     dtype),
                    jph._pack_bucket(idxs, enc_r, errs, enc_h, rp, hp,
                                     dtype)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    c = rng.random((4, 9)).astype(np.float32)
    c[1] = 0.0
    c[2, ::2] = 0.0
    s = rng.integers(-3, 4, (4, 9)).astype(np.int32)
    np.testing.assert_array_equal(tph._fold_contribs(c, s),
                                  jph._fold_contribs(c, s))
    assert tph.total_cells(reads, haps) == jph.total_cells(reads, haps)


def test_input_validation():
    with pytest.raises(ValueError, match="empty read"):
        tph.forward_pairs([""], [30], ["ACGT"], device="cpu")
    with pytest.raises(ValueError, match="empty haplotype"):
        tph.forward_pairs(["ACGT"], [30], [""], device="cpu")
    with pytest.raises(ValueError, match="lengths must match"):
        tph.forward_pairs(["ACGT"], [30, 30], ["ACGT", "ACGT"],
                          device="cpu")


def _packed_tensors(device="cpu", dtype=np.float32):
    rng = np.random.default_rng(9)
    reads, quals, haps = _random_pairs(3, rng, max_r=20, max_h=30)
    (_, packed), = _buckets(reads, quals, haps, dtype)
    trans = jph.transition_probs().astype(dtype)
    return [torch.from_numpy(a).to(device) for a in (*packed, trans)]


def test_wrapper_checks_types_and_shapes():
    t = _packed_tensors()
    bad = list(t)
    bad[3] = t[3].to(torch.int64)  # rlens
    with pytest.raises(TypeError):
        pk.forward_bucket(*bad, rescale=True)
    bad = list(t)
    bad[2] = t[2][:, :-1].contiguous()  # px narrower than pm
    with pytest.raises(ValueError):
        pk.forward_bucket(*bad, rescale=True)
    bad = list(t)
    bad[6] = t[6].to(torch.float64)  # trans in another dtype
    with pytest.raises(TypeError):
        pk.forward_bucket(*bad, rescale=True)


def test_wrapper_launches_for_non_cpu_tensors(monkeypatch):
    """A tensor off the CPU goes to the kernel, never to the plain
    version: with the kernel library unavailable the call raises; a
    dtype the kernel does not pair with ``rescale`` raises too."""
    calls = []

    def no_library():
        calls.append(1)
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(pk, "load_library", no_library)
    t = _packed_tensors("meta")
    with pytest.raises(RuntimeError, match="unavailable"):
        pk.forward_bucket(*t, rescale=True)
    with pytest.raises(ValueError, match="rescaled"):
        pk.forward_bucket(*t, rescale=False)
    assert len(calls) == 1
    assert pk.LAUNCHES["pairhmm"] >= 0


def test_build_errors_are_kernel_faults(monkeypatch, tmp_path):
    """A missing or failing nvcc raises KernelFault, which the retry
    policy lets through unretried."""
    import subprocess

    from goleft_tpu_torch.device import KernelFault
    from goleft_tpu_torch.ops import _nvcc
    from goleft_tpu_torch.resilience.policy import DEFAULT_POLICY

    monkeypatch.setattr(_nvcc, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_nvcc.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_nvcc.shutil, "which", lambda name: None)
    with pytest.raises(KernelFault, match="nvcc not found"):
        _nvcc.build("pairhmm_kernel.cu", pk.NVCC_FLAGS, "pairhmm kernel")
    monkeypatch.setattr(_nvcc, "nvcc_path", lambda what: "nvcc")
    monkeypatch.setattr(
        _nvcc.subprocess, "run",
        lambda *a, **k: subprocess.CompletedProcess(a, 1, "", "ptxas died"))
    calls = []

    def build():
        calls.append(1)
        return _nvcc.build("pairhmm_kernel.cu", pk.NVCC_FLAGS,
                           "pairhmm kernel")

    with pytest.raises(KernelFault, match="ptxas died"):
        DEFAULT_POLICY.call(("pairhmm",), build)
    assert calls == [1]


def test_default_device_raises_without_cuda(monkeypatch):
    from goleft_tpu_torch.device import NoCudaDevice

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        tph.forward_pairs(["ACGT"], [30], ["ACGTA"])


def test_chip_smoke_row_oracle_matches_test_oracle():
    """chip_smoke.py scores its subsets with a row-at-a-time f64 oracle;
    it agrees with the cell-at-a-time log-space oracle here to 1e-9,
    on random pairs and on a 300 bp junk read near 1e-200."""
    import chip_smoke

    rng = np.random.default_rng(13)
    reads, quals, haps = _random_pairs(25, rng, max_r=50, max_h=70)
    reads.append("".join(rng.choice(_BASES, 300)))
    quals.append(np.full(300, 4))
    haps.append("".join(rng.choice(_BASES, 360)))
    for r, q, h in zip(reads, quals, haps):
        want = oracle_log10(r, q, h)
        e = tph.phred_to_err(np.broadcast_to(np.asarray(q), (len(r),)))
        got = chip_smoke.oracle_log10_rows(tph.encode_seq(r)[None],
                                           e[None], tph.encode_seq(h))[0]
        assert abs(got - want) < 1e-9
        cell = chip_smoke.oracle_log10(tph.encode_seq(r), e,
                                       tph.encode_seq(h)) \
            if len(r) < 100 else want
        assert abs(cell - want) < 1e-12
