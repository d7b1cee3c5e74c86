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
    """The JAX package caps its compile signatures per process; the port
    has no cap."""
    jrd.reset_signature_registry()
    yield
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


def _tensors(host: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in host.items()}


def test_order0_stage_equals_pallas_decode0_interpret():
    """The plain ORDER0 stage, on the port's launch groups, against the
    TPU kernel itself in interpret mode at the JAX package's own bucket
    shapes (its _signature), packed as its _pallas_scan_bytes packs it;
    symbols up to each stream's inner length, zeros past it."""
    rng = np.random.default_rng(2)
    for x32 in (False, True):
        cases = _corpus(rng, [17, 201, 4097], x32=x32)
        cases += _corpus(rng, [4097], x32=x32, rle=True, pack=True, alpha=9)
        plans = [rx.parse_nx16(e, len(d)) for d, e in cases]
        jplans = {id(p): jrx.parse_nx16(e, len(d))
                  for p, (d, e) in zip(plans, cases)}
        groups = rd.launch_groups(plans)
        assert [k for k, _, _ in groups] == [(False, 32 if x32 else 4,
                                              rk.TF_SHIFT)]
        (key, grp, host), = groups
        assert len(grp) == sum(not p.cat for p in plans) > 1
        got, bad = rd.group_stage(key, grp, _tensors(host))
        assert bad is None and got.shape == (len(grp), rd.lit_width(grp))
        for j, p in enumerate(grp):
            jp = jplans[id(p)]
            sig = jrd._signature(jp)
            n, rounds, p_cap = sig[0], sig[6], sig[7]
            want = jrd._pallas_scan_bytes([jp], n, rounds, p_cap,
                                          interpret=True)[0]
            k = p.inner_len
            assert np.array_equal(got[j, :k].numpy(), want[:k])
            assert not got[j, k:].any()


def test_order1_stage_plain_matches_host_on_parsed_tables():
    """The plain ORDER1 stage on one launch group of several streams
    (states of different lengths share the round loop, a narrower table
    comes padded to the widest) gives each stream's symbols and zeros
    past them."""
    rng = np.random.default_rng(3)
    base = _order1_corpus(rng, 20000)
    narrow = bytes(np.frombuffer(base, np.uint8) % 7)
    datas = [base[:19997], base[:20000], narrow[:5003]]
    plans = [rx.parse_nx16(jrx.encode(d, order=1), len(d)) for d in datas]
    assert all(p.order1 for p in plans)
    assert len({p.n_ctx for p in plans}) == 2
    (key, grp, host), = rd.launch_groups(plans)
    assert grp == plans and key == (True, 4, plans[0].shift)
    assert host["ctx_freq"].shape[1:] == (plans[0].n_ctx, plans[0].n_ctx)
    out, bad = rd.group_stage(key, grp, _tensors(host))
    assert not bad.any() and out.shape == (3, 20000)
    for j, d in enumerate(datas):
        assert bytes(out[j, :len(d)].numpy()) == d
        assert not out[j, len(d):].any()


def _first_container_blocks(path: str):
    """The raw blocks of a CRAM file's first container."""
    from goleft_tpu_torch.io.crai import load_crai_entries
    from goleft_tpu_torch.io.cram import CramFile, decode_raw_block

    class Recorder:
        raws = []

        def decode_blocks(self, raws):
            self.raws.append(list(raws))
            return [decode_raw_block(rb).data for rb in raws]

    start = load_crai_entries(path + ".crai")[0][1]  # 1-based
    cf = CramFile.from_file(path)
    rec = Recorder()
    cf.set_block_decoder(rec)
    cf.read_columns(tid=0, start=start - 1, end=start)
    return rec.raws[0]


def test_launch_groups_of_each_fixture_codec(tmp_path):
    """One container of each codec of the cohort fixture: ORDER0 N=4 is
    one launch, ORDER1 N=4 one for all its ORDER1 blocks, whatever their
    table sizes, and STRIPE 4 one for all its lanes; the decoded bytes
    equal the JAX package's decode_streams and the host decoder."""
    from goleft_tpu.ops.decode_smoke import make_cram_cohort

    crams, _ = make_cram_cohort(str(tmp_path))
    o0 = (False, 4, rk.TF_SHIFT)
    for path, order1, stripe in zip(crams, (0, 0, 1, 0), (0, 0, 0, 4)):
        raws = [rb for rb in _first_container_blocks(path)
                if rb.method == M_RANSNX16]
        plans = [rx.parse_nx16(rb.raw, rb.rsize) for rb in raws]
        assert all(p is not None for p in plans)
        keys = [k for k, _, _ in rd.launch_groups(plans)]
        flat = [c for p in plans for c in (p.children if p.stripe else [p])
                if not c.cat]
        assert sum(len(g) for _, g, _ in rd.launch_groups(plans)) \
            == len(flat) > 0
        if order1:
            assert keys == [(True, 4, flat[0].shift)]
            assert all(p.order1 for p in flat)
            assert len({p.n_ctx for p in flat}) > 1
        else:
            assert keys == [o0]
            assert all(p.stripe for p in plans) == bool(stripe)
        encs = [rb.raw for rb in raws]
        lens = [rb.rsize for rb in raws]
        got = rd.decode_streams(encs, lens, device=CPU)
        assert got == jrd.decode_streams(encs, lens)
        assert got == [rx.decode(e, n) for e, n in zip(encs, lens)]


def test_mixed_streams_split_one_group_per_key():
    """N = 4 and X32, ORDER0 and ORDER1, three ORDER1 shifts and two
    table sizes in one call: one launch group per (ORDER1, N, shift),
    whatever the lengths and table sizes; bytes equal to the JAX
    package's and to the data."""
    rng = np.random.default_rng(26)
    base = _order1_corpus(rng, 9000)
    narrow = bytes(np.frombuffer(base, np.uint8) % 7)
    cases = []
    for x32 in (False, True):
        for n in (9000, 3001, 40):
            d = bytes(rng.integers(0, 30, n, dtype=np.uint8))
            cases.append((d, rx.encode(d, x32=x32)))
            for data in (base[:n], narrow[:n]):
                for shift in (12, 10, 7):
                    cases.append((data, rx.encode(data, order=1, x32=x32,
                                                  shift=shift)))
    plans = [rx.parse_nx16(e, len(d)) for d, e in cases]
    coded = [p for p in plans if not p.cat]
    want_keys = sorted({rd.group_key(p) for p in coded})
    assert {k[2] for k in want_keys if k[0]} == {12, 10, 7}
    assert {k[1] for k in want_keys} == {4, 32}
    assert len(want_keys) == 8
    groups = rd.launch_groups(plans)
    assert [k for k, _, _ in groups] == want_keys
    for key, grp, host in groups:
        assert all(rd.group_key(p) == key for p in grp)
        if key[0]:
            assert len({p.n_ctx for p in grp}) >= 2
            c = max(p.n_ctx for p in grp)
            assert host["ctx_freq"].shape == (len(grp), c, c)
    assert sum(len(g) for _, g, _ in groups) == len(coded)
    _both_agree(cases)


def test_payload_rows_are_16_byte_strides():
    """A group's payloads lie back to back, each from a multiple of 16
    bytes (its offset in 16-byte units) and padded only up to the next,
    then the kernel's tail: no stream is padded to the longest. The
    wrapper refuses a payload that is not a multiple of 16 bytes long or
    not 16-byte aligned, and a stream that runs into the tail."""
    rng = np.random.default_rng(27)
    cases = _corpus(rng, [100, 1001, 3333], alpha=50)
    plans = [rx.parse_nx16(e, len(d)) for d, e in cases]
    (key, grp, host), = rd.launch_groups(plans)
    units = [-(-len(p.payload) // 16) for p in grp]
    assert host["payload"].shape == (16 * sum(units) + rk.PAYLOAD_TAIL,)
    assert list(host["poff"]) == list(np.cumsum(units) - units)
    assert list(host["plen"]) == [len(p.payload) for p in grp]
    for j, p in enumerate(grp):
        o = 16 * int(host["poff"][j])
        assert bytes(host["payload"][o:o + len(p.payload)]) \
            == bytes(p.payload)
    data = {id(p): d for p, (d, _) in zip(plans, cases)}
    t = _tensors(host)
    got, _ = rd.group_stage(key, grp, t)
    for j, p in enumerate(grp):
        assert bytes(got[j, :p.inner_len].numpy()) == data[id(p)]
    for cut in (1, 2, 8):
        t2 = dict(t, payload=t["payload"][:-cut].contiguous())
        with pytest.raises(ValueError, match="multiple of 16"):
            rd.group_stage(key, grp, t2)
    odd = torch.zeros(t["payload"].numel() + 1, dtype=torch.uint8)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        rd.group_stage(key, grp, dict(t, payload=odd))
    with pytest.raises(ValueError, match="past the end"):
        rd.group_stage(key, grp, dict(t, payload=t["payload"][:-16]))


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
    args = (z(rk.PAYLOAD_TAIL, dtype=torch.uint8), z(2, dtype=torch.int32),
            z(2, dtype=torch.int32), z(2, 4, dtype=torch.int32),
            z(2, dtype=torch.int32))
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
