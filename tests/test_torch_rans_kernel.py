"""The port's rANS-Nx16 device decode (goleft_tpu_torch/ops/rans_kernel.py,
ops/rans_device.py) against the JAX package's, on the CPU.

On the CPU the kernel wrapper runs its plain PyTorch version: the ORDER0
stage is held against ``pallas_decode0`` in interpret mode, and
``decode_streams`` against the JAX package's ``decode_streams`` and both
host decoders over the corpora of tests/test_rans_device.py: the ORDER0
and ORDER1 flag matrices (N = 4 and 32, plain, RLE, PACK, RLE+PACK),
NOSZ, STRIPE with uneven lanes and the ORDER1 table edge cases. The same
inputs raise the same errors and take the same fallbacks. The CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from goleft_tpu.io import rans_nx16 as jrx
from goleft_tpu.ops import rans_device as jrd
from goleft_tpu_torch.io import rans_nx16 as rx
from goleft_tpu_torch.io.cram import M_RANSNX16, RawBlock
from goleft_tpu_torch.obs import get_registry
from goleft_tpu_torch.ops import rans_device as rd
from goleft_tpu_torch.ops import rans_kernel as rk

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_signature_registries():
    rd.reset_signature_registry()
    jrd.reset_signature_registry()
    yield
    rd.reset_signature_registry()
    jrd.reset_signature_registry()


def _corpus(rng, sizes, *, order=0, x32=False, rle=False, pack=False,
            alpha=None):
    out = []
    for sz in sizes:
        a = alpha if alpha is not None else int(rng.integers(1, 256))
        data = bytes(rng.integers(0, a, sz, dtype=np.uint8))
        out.append((data, jrx.encode(data, order=order, use_rle=rle,
                                     use_pack=pack, x32=x32)))
    return out


def _order1_corpus(rng, n=20000):
    deltas = rng.choice([0, 0, 0, 1, 2, 5], size=n)
    return bytes((np.cumsum(deltas) % 120).astype(np.uint8))


def _strip_size(enc: bytes, out_len: int) -> bytes:
    szlen = len(jrx.write_uint7(out_len))
    return bytes([enc[0] | jrx.F_NOSZ]) + enc[1 + szlen:]


def _both_agree(cases, reference=True):
    """decode_streams of the port on the CPU == the JAX package's ==
    both host decoders == the data, for every case."""
    encs = [e for _, e in cases]
    lens = [len(d) for d, _ in cases]
    got = rd.decode_streams(encs, lens, device=CPU)
    want = jrd.decode_streams(encs, lens) if reference else [None] * len(
        cases)
    for (data, enc), g, w in zip(cases, got, want):
        assert g is not None, "a supported stream must not fall back"
        assert g == rx.decode(enc, len(data)) == data
        if reference:
            assert w == g


SIZES = [0, 1, 3, 17, 63, 64, 65, 127, 4095, 4097, 8191, 20000]


@pytest.mark.parametrize("x32", [False, True])
@pytest.mark.parametrize("rle,pack", [(False, False), (True, False),
                                      (False, True), (True, True)])
def test_order0_flag_matrix_matches_jax(x32, rle, pack):
    rng = np.random.default_rng(0)
    cases = _corpus(rng, SIZES, x32=x32, rle=rle, pack=pack)
    if pack:
        cases += _corpus(rng, SIZES[3:], x32=x32, rle=rle, pack=pack,
                         alpha=7)
    if rle:
        data = b"".join(bytes([int(s)]) * int(r) for s, r in zip(
            rng.integers(0, 6, 300), rng.integers(1, 50, 300)))
        cases.append((data, jrx.encode(data, use_rle=True, use_pack=pack,
                                       x32=x32)))
    _both_agree(cases)


@pytest.mark.parametrize("x32", [False, True])
@pytest.mark.parametrize("rle,pack", [(False, False), (True, False),
                                      (False, True), (True, True)])
def test_order1_flag_matrix_matches_jax(x32, rle, pack):
    rng = np.random.default_rng(20)
    base = _order1_corpus(rng)
    cases = []
    for sz in (0, 1, 63, 127, 4095, 4097, 8191, 19997, 20000):
        data = base[:sz]
        if pack:
            data = bytes((np.frombuffer(data, np.uint8) % 11)
                         .astype(np.uint8))
        cases.append((data, jrx.encode(data, order=1, use_rle=rle,
                                       use_pack=pack, x32=x32)))
    assert any(e[0] & jrx.F_ORDER1 for _, e in cases)
    _both_agree(cases)


def test_nosz_matches_jax():
    rng = np.random.default_rng(1)
    cases = []
    for x32 in (False, True):
        for data, enc in _corpus(rng, [0, 1, 500, 5000], x32=x32,
                                 rle=True):
            if not enc[0] & jrx.F_NOSZ:
                cases.append((data, _strip_size(enc, len(data))))
    _both_agree(cases)


def test_order1_table_edge_cases_match_jax():
    """Single-successor contexts (rows of one symbol at 4096), a two-
    symbol skew, a wide alphabet whose table ships order-0-compressed, a
    tiny raw table, NOSZ."""
    rng = np.random.default_rng(21)
    cases = [(bytes(p * r), jrx.encode(bytes(p * r), order=1))
             for p, r in ((b"abc", 4000), (b"ab", 3000),
                          (b"\x00\xff", 2000))]
    data = bytes((rng.random(12000) < 0.02).astype(np.uint8) + 65)
    cases.append((data, jrx.encode(data, order=1)))
    wide = _order1_corpus(rng)
    ewide = jrx.encode(wide, order=1)
    assert ewide[1 + len(jrx.write_uint7(len(wide)))] & 1
    cases += [(wide, ewide), (wide, _strip_size(ewide, len(wide)))]
    _both_agree(cases)


def test_stripe_uneven_lanes_match_jax():
    rng = np.random.default_rng(22)
    base = _order1_corpus(rng)
    cases = []
    for sz in (20000, 19999, 19998, 4097, 101, 7):
        for kw in (dict(stripe=4), dict(stripe=3),
                   dict(stripe=4, x32=True), dict(stripe=2, order=1)):
            enc = jrx.encode(base[:sz], **kw)
            assert enc[0] & jrx.F_STRIPE
            cases.append((base[:sz], enc))
    _both_agree(cases)


def test_order0_stage_equals_pallas_decode0_interpret():
    """The plain ORDER0 stage against the TPU kernel itself, in
    interpret mode, packed as the JAX package's _pallas_scan_bytes packs
    it; symbols up to each stream's inner length."""
    rng = np.random.default_rng(2)
    for x32 in (False, True):
        cases = _corpus(rng, [17, 201, 4097], x32=x32)
        cases += _corpus(rng, [4097], x32=x32, rle=True, pack=True, alpha=9)
        plans = [rx.parse_nx16(e, len(d)) for d, e in cases]
        jplans = [jrx.parse_nx16(e, len(d)) for d, e in cases]
        plans = [p for p in plans if not p.cat]
        jplans = [p for p in jplans if not p.cat]
        assert plans
        for p, jp in zip(plans, jplans):
            sig = rd._signature(p)
            n, rounds, p_cap = sig[0], sig[6], sig[7]
            want = jrd._pallas_scan_bytes([jp], n, rounds, p_cap,
                                          interpret=True)[0]
            host = rd._host_arrays([p], sig)
            t = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in host.items()}
            got, bad = rk.rans_decode(
                t["payload"], t["plen"], t["states"].view(torch.int32),
                t["inner"], n_states=n, out_len=sig[8], freq=t["freq"])
            assert bad is None
            k = p.inner_len
            assert np.array_equal(got[0, :k].numpy(), want[:k])
            assert not got[0, k:].any()


def test_order1_stage_plain_matches_host_on_parsed_tables():
    """The plain ORDER1 stage on one bucket of several streams (lanes of
    different lengths share the round loop) gives each stream's symbols
    and zeros past them."""
    rng = np.random.default_rng(3)
    base = _order1_corpus(rng, 20000)
    datas = [base[:n] for n in (19997, 20000, 5003)]
    plans = [rx.parse_nx16(jrx.encode(d, order=1), len(d)) for d in datas]
    assert all(p.order1 for p in plans)
    p_cap = rd.bucket(max(len(p.payload) for p in plans))
    n_ctx_cap = rd.bucket(max(p.n_ctx for p in plans), minimum=16)
    sig = (4, False, True, plans[0].shift, False, False, 0, p_cap, 0, 0, 0,
           16, n_ctx_cap)
    host = rd._host_arrays(plans, sig)
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in host.items()}
    out, bad = rk.rans_decode(
        t["payload"], t["plen"], t["states"].view(torch.int32), t["inner"],
        n_states=4, out_len=20032, ctx_index=t["ctx_index"],
        ctx_freq=t["ctx_freq"], alphabet=t["alphabet"], shift=sig[3])
    assert not bad.any()
    for j, d in enumerate(datas):
        assert bytes(out[j, :len(d)].numpy()) == d
        assert not out[j, len(d):].any()


def test_order1_missing_context_raises_the_jax_error():
    rng = np.random.default_rng(24)
    data = _order1_corpus(rng, 4000)
    enc = jrx.encode(data, order=1)
    p = rx.parse_nx16(enc, len(data))
    jp = jrx.parse_nx16(enc, len(data))
    used = np.flatnonzero(np.asarray(p.ctx_index) >= 0)
    for q in (p, jp):
        q.ctx_index = q.ctx_index.copy()
        q.ctx_index[used[len(used) // 2]] = -1
    with pytest.raises(ValueError, match="missing order-1 context"):
        rd.decode_parsed([p], device=CPU)
    with pytest.raises(ValueError, match="missing order-1 context"):
        jrd.decode_parsed([jp])


def test_order1_corrupt_table_falls_back_as_jax_does():
    """A corrupt ORDER1 table parses to None in both packages; the block
    decoder decodes it on the host (the host codec's error), counted as a
    fallback, and decodes the good block on the device."""
    rng = np.random.default_rng(23)
    data = _order1_corpus(rng, 6000)
    enc = bytes(jrx.encode(data, order=1))
    szlen = len(jrx.write_uint7(len(data)))
    bad = enc[:1 + szlen + 40]
    big = enc[:1 + szlen + 1] + jrx.write_uint7(1 << 23) + enc[1 + szlen + 1:]
    for b in (bad, big):
        assert rx.parse_nx16(b, len(data)) is None
        assert jrx.parse_nx16(b, len(data)) is None
    with pytest.raises(ValueError, match="implausible o1 table"):
        rx.decode(big, len(data))
    reg = get_registry()
    c = reg.snapshot()["counters"]
    dec = rd.DeviceBlockDecoder(device=CPU)
    assert dec.decode_blocks([RawBlock(M_RANSNX16, 4, 1, enc,
                                       len(data))]) == [data]
    with pytest.raises((ValueError, IndexError)):
        dec.decode_blocks([RawBlock(M_RANSNX16, 4, 1, bad, len(data))])
    after = reg.snapshot()["counters"]
    assert after["decode.device_blocks_total"] \
        == c.get("decode.device_blocks_total", 0) + 1
    assert after["decode.device_fallback_total"] \
        == c.get("decode.device_fallback_total", 0) + 1


def test_signature_cap_takes_the_jax_fallbacks(caplog):
    import logging

    rng = np.random.default_rng(25)
    datas = [bytes(rng.integers(0, 40, n, dtype=np.uint8))
             for n in (300, 5000, 70000)]
    encs = [jrx.encode(d) for d in datas]
    old = (rd.MAX_BUCKET_SIGNATURES, jrd.MAX_BUCKET_SIGNATURES)
    reg = get_registry()
    try:
        rd.MAX_BUCKET_SIGNATURES = jrd.MAX_BUCKET_SIGNATURES = 1
        before = reg.snapshot()["counters"]
        with caplog.at_level(logging.WARNING):
            got = rd.decode_streams(encs, [len(d) for d in datas],
                                    device=CPU)
        want = jrd.decode_streams(encs, [len(d) for d in datas])
        assert got == want == [datas[0], None, None]
        assert any("bucket-signature cap" in r.message
                   for r in caplog.records)
        dec = rd.DeviceBlockDecoder(device=CPU)
        raws = [RawBlock(M_RANSNX16, 4, 1, e, len(d))
                for e, d in zip(encs, datas)]
        assert dec.decode_blocks(raws) == datas
        after = reg.snapshot()["counters"]
        for name in ("decode.bucket_cap_fallback_total",
                     "decode.device_fallback_total"):
            assert after[name] == before.get(name, 0) + 2, name
    finally:
        rd.MAX_BUCKET_SIGNATURES, jrd.MAX_BUCKET_SIGNATURES = old


def test_decode_site_transient_retried_permanent_raised():
    from goleft_tpu_torch.resilience import faults

    rng = np.random.default_rng(10)
    data = bytes(rng.integers(0, 50, 5000, dtype=np.uint8))
    raws = [RawBlock(M_RANSNX16, 4, 1, jrx.encode(data), len(data))]
    try:
        faults.install("decode:after=1:transient")
        assert rd.DeviceBlockDecoder(device=CPU).decode_blocks(raws) \
            == [data]
        faults.install("decode:after=1:permanent")
        with pytest.raises(faults.InjectedPermanentFault):
            rd.DeviceBlockDecoder(device=CPU).decode_blocks(raws)
    finally:
        faults.install(None)


def test_wrapper_checks_its_inputs():
    z = torch.zeros
    args = (z(2, 64, dtype=torch.uint8), z(2, dtype=torch.int32),
            z(2, 4, dtype=torch.int32), z(2, dtype=torch.int32))
    ok = dict(n_states=4, out_len=64, freq=z(2, 256, dtype=torch.int16))
    out, bad = rk.rans_decode(*args, **ok)
    assert out.shape == (2, 64) and bad is None and not out.any()
    with pytest.raises(TypeError):
        rk.rans_decode(args[0].to(torch.int32), *args[1:], **ok)
    with pytest.raises(ValueError):
        rk.rans_decode(*args, **dict(ok, n_states=8))
    with pytest.raises(ValueError):
        rk.rans_decode(*args, **dict(ok, freq=z(2, 255, dtype=torch.int16)))
    with pytest.raises(ValueError, match="ORDER1 table"):
        rk.rans_decode(*args, n_states=4, out_len=64,
                       ctx_index=z(2, 256, dtype=torch.int16),
                       ctx_freq=z(2, 300, 300, dtype=torch.int16),
                       alphabet=z(2, 300, dtype=torch.int16))


def test_stage_block_arrays_counts_compressed_bytes():
    from goleft_tpu_torch.parallel.prefetch import stage_block_arrays

    reg = get_registry()
    before = reg.counter("prefetch.bytes_staged_total").value
    arrs = {"payload": np.zeros(1000, np.uint8),
            "freq": np.zeros(256, np.int16)}
    out = stage_block_arrays(arrs, CPU)
    assert reg.counter("prefetch.bytes_staged_total").value - before \
        == 1000 + 512
    assert set(out) == {"payload", "freq"}
    assert out["freq"].dtype == torch.int16
