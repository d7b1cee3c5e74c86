"""The CUDA kernels (depth, pair-HMM, rANS-Nx16, indexcov's
normalisation, the mapper's swalign) against their plain PyTorch
versions, and the EM
copy-number caller, cn.mops and indexcov against their CPU path, on a
card.

Imports neither JAX nor the JAX package, so it runs on a machine with
only PyTorch, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (DEPTH_EDGES, HG38, NORM_EDGES, SW_CASES,
                        compare_indexcov_dirs, depth_edge_case,
                        indexcov_fabricate, norm_edge_case, norm_main_case,
                        sw_case)
from goleft_tpu_torch.ops import depth_kernel as dk
from goleft_tpu_torch.ops.coverage import bucket_size, pack_segments_u16


@pytest.mark.cuda
def test_kernel_equals_plain_on_card():
    """Both wires, dense outputs, a region inside the buffer; bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    L, W = 40 * dk.TILE, 100
    L -= L % W
    s = rng.integers(-300, L + 300, size=20_000).astype(np.int32)
    e = (s + rng.integers(0, 400, size=s.size)).astype(np.int32)
    keep = rng.random(s.size) < 0.95
    args = (0, 130, L - 70, 60, 4, 40, L, W)
    dev = torch.device("cuda")
    t = [torch.from_numpy(x).to(dev) for x in (s, e, keep)]
    got = dk.fused_depth(*t, *args, dense=True)
    want = dk.fused_depth_plain(*t, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    order = np.argsort(s, kind="stable")
    ok = keep[order] & (s[order] >= 0)
    d, ln, base, n_ent = pack_segments_u16(s[order], e[order], ok)
    b = bucket_size(n_ent)
    dd = np.zeros(b, np.uint16)
    ll = np.zeros(b, np.uint16)
    dd[:n_ent], ll[:n_ent] = d, ln
    tw = [torch.from_numpy(x).to(dev) for x in (dd, ll)]
    got = dk.fused_depth_wire(*tw, int(base), *args, dense=True)
    want = dk.fused_depth_wire_plain(*tw, int(base), *args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DEPTH_EDGES))
def test_depth_kernel_edge_cases_on_card(name):
    """chip_smoke.py's DEPTH_EDGES (the widest halo, a gap bridged by
    u16 fillers, one tile past the cap, no segments, an inner region, a
    ragged length, windows of 7, 251 and 250, one window wider than a
    tile, window sums above 2**24) on both wires where the wire can
    carry them, dense outputs bitwise against the plain version; one
    counted launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (s, e, keep, args), wire = depth_edge_case(name)
    dev = torch.device("cuda")
    runs = [(dk.fused_depth, dk.fused_depth_plain,
             [torch.from_numpy(x).to(dev) for x in (s, e, keep)])]
    if wire is not None:
        dd, ll, base = wire
        runs.append((dk.fused_depth_wire, dk.fused_depth_wire_plain,
                     [torch.from_numpy(dd).to(dev),
                      torch.from_numpy(ll).to(dev), base]))
    for kern, plain, t in runs:
        before = dk.LAUNCHES["depth"]
        got = kern(*t, *args, dense=True)
        want = plain(*t, *args)
        torch.cuda.synchronize()
        assert dk.LAUNCHES["depth"] == before + 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)
        sums, packed, _, _ = kern(*t, *args)
        assert torch.equal(sums, want[0]) and torch.equal(packed, want[1])


@pytest.mark.cuda
def test_depth_u16_call_allocates_no_per_base_buffer():
    """A dense=False call on the u16 wire at chip_smoke.py's 10 Mb shard
    allocates less than one int32 a base (workspace and outputs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import SHARD, depth_main_cases, depth_scratch_bytes

    dev = torch.device("cuda")
    kern = depth_main_cases(dev, dk)["u16"][0]
    kern(False)
    assert depth_scratch_bytes(dev, kern) < 4 * SHARD


def _pairhmm_bucket(rng, b, read_len, hap_len, dtype, r_pad=None):
    """``b`` pairs packed as one bucket: by ``bucket_pairs``' padding, or
    at exactly ``r_pad`` + 1 rows."""
    from goleft_tpu_torch.ops import pairhmm as tph

    bases = np.frombuffer(b"ACGT", np.uint8)
    haps = [bases[rng.integers(0, 4, hap_len)] for _ in range(b)]
    reads = []
    for h in haps:
        start = int(rng.integers(0, max(1, hap_len - read_len)))
        r = np.resize(h[start:start + read_len], read_len).copy()
        err = rng.random(read_len) < 0.05
        r[err] = bases[rng.integers(0, 4, int(err.sum()))]
        reads.append(tph.encode_seq(r))
    haps = [tph.encode_seq(h) for h in haps]
    errs = [tph.phred_to_err(rng.integers(2, 42, read_len)) for _ in reads]
    (rp, hp), idxs = next(iter(tph.bucket_pairs(reads, haps).items()))
    packed = tph._pack_bucket(idxs, reads, errs, haps, r_pad or rp, hp,
                              dtype)
    trans = tph.transition_probs().astype(dtype)
    return [torch.from_numpy(a).cuda() for a in (*packed, trans)]


#: (read bp, hap bp, pairs, r_pad): 150 bp reads (r1 161, R 6), 1,100 bp
#: reads (r1 1,121: five strips of 256 rows), and reads filling r1 =
#: 32 R and 32 R + 1 rows for R = 1..8: each compiled R and the next
#: one's first r1; 256 | 257 is the strip edge
_PAIRHMM_CASES = [(150, 400, 64, None), (1100, 200, 3, None)] + [
    (r1 - 1, 120, 6, r1 - 1) for rows in range(1, 9)
    for r1 in (32 * rows, 32 * rows + 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("read_len,hap_len,b,r_pad", _PAIRHMM_CASES)
def test_pairhmm_kernel_equals_plain_on_card(dtype, read_len, hap_len, b,
                                             r_pad):
    """f32 rescaled and f64 unscaled, contribs and shifts bitwise: 150
    bp reads, 1,100 bp reads in strips, and every R with its edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from goleft_tpu_torch.ops import pairhmm_kernel as pk

    t = _pairhmm_bucket(np.random.default_rng(read_len), b, read_len,
                        hap_len, dtype, r_pad)
    rescale = dtype == np.float32
    before = pk.LAUNCHES["pairhmm"]
    got = pk.forward_bucket(*t, rescale=rescale)
    want = pk.forward_bucket_plain(*t, rescale=rescale)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["pairhmm"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), (g.double() - w.double()).abs().max()
    if not rescale:
        assert not got[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pairhmm_kernel_adoption_trap_on_card(dtype):
    """chip_smoke.py's adoption-trap bucket (pm = 0 where each read's
    first base meets its hap's first base, so cell (1, 1) is all zero
    inside the valid area; zero priors in other rows): bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import ph_trap_bucket
    from goleft_tpu_torch.ops import pairhmm as tph
    from goleft_tpu_torch.ops import pairhmm_kernel as pk

    packed = ph_trap_bucket(np.random.default_rng(5), 64, 150, 416, dtype)
    trans = tph.transition_probs().astype(dtype)
    t = [torch.from_numpy(a).cuda() for a in (*packed, trans)]
    rescale = dtype == np.float32
    got = pk.forward_bucket(*t, rescale=rescale)
    want = pk.forward_bucket_plain(*t, rescale=rescale)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g.double() - w.double()).abs().max()


def _rans_streams(rng):
    """A flag matrix of streams, encoded by the port: N = 4 and X32 x
    ORDER0 and ORDER1 x plain, RLE, PACK, RLE+PACK, ORDER1 at shifts 10
    and 7 (the bucket index inexact and exact), STRIPE lanes, a
    256-context ORDER1 table, and a 100,000-symbol ORDER1 stream (a 64 KB+ payload: the shared payload
    ring and the staging ring wrap many times)."""
    from goleft_tpu_torch.io import rans_nx16 as rx

    ramp = (np.cumsum(rng.choice([0, 0, 0, 1, 2, 5], 9000)) % 120) \
        .astype(np.uint8)
    cases = []
    for x32 in (False, True):
        for order in (0, 1):
            for rle, pack in ((False, False), (True, False), (False, True),
                              (True, True)):
                for sz in (17, 4097, 9000):
                    d = (ramp[:sz] % 11 if pack else ramp[:sz]) if order \
                        else rng.integers(0, 7 if pack else 40, sz).astype(
                            np.uint8)
                    d = d.tobytes()
                    cases.append((d, rx.encode(d, order=order, use_rle=rle,
                                               use_pack=pack, x32=x32)))
        for shift in (10, 7):
            d = ramp[:5000].tobytes()
            cases.append((d, rx.encode(d, order=1, x32=x32, shift=shift)))
    for sz in (9000, 8999, 101):
        cases.append((ramp[:sz].tobytes(), rx.encode(ramp[:sz].tobytes(),
                                                     stripe=3)))
    d = rng.integers(0, 60, 100000).astype(np.uint8).tobytes()
    cases.append((d, rx.encode(d, order=1)))
    assert len(cases[-1][1]) > 65536
    # 256 contexts: the widest ORDER1 table, with fewer buckets a row
    d = (np.cumsum(rng.choice([0, 1, 2, 3, 255], 30000)) % 256) \
        .astype(np.uint8).tobytes()
    cases.append((d, rx.encode(d, order=1)))
    assert cases[-1][1][0] & rx.F_ORDER1
    return cases


def _rans_groups(plans, dev):
    """Each launch group's tensors on ``dev``: (key, streams, tensors)."""
    from goleft_tpu_torch.ops import rans_device as rd

    for key, grp, host in rd.launch_groups(plans):
        yield key, grp, {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                         for k, v in host.items()}


@pytest.mark.cuda
def test_rans_kernel_equals_plain_on_card():
    """ORDER0 and ORDER1 at N = 4 and 32, every transform, three ORDER1
    shifts, STRIPE lanes, a 64 KB+ ORDER1 payload, one launch per group:
    symbols and missing-context flags bitwise; the device decode equals
    the data."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from goleft_tpu_torch.io import rans_nx16 as rx
    from goleft_tpu_torch.ops import rans_device as rd
    from goleft_tpu_torch.ops import rans_kernel as rk

    cases = _rans_streams(np.random.default_rng(4))
    plans = [rx.parse_nx16(e, len(d)) for d, e in cases]
    dev = torch.device("cuda")
    n = 0
    for key, grp, t in _rans_groups(plans, dev):
        before = rk.LAUNCHES["rans"]
        got = rd.group_stage(key, grp, t)
        want = rd.group_stage(key, grp, t, rk.rans_decode_plain)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["rans"] == before + 1
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None)
        if got[1] is not None:
            assert torch.equal(got[1], want[1])
        n += 1
    assert n >= 8
    assert rd.decode_parsed(plans, device=dev) == [d for d, _ in cases]


@pytest.mark.cuda
def test_rans_order1_threads_launch_at_once():
    """Eight threads, each on its own CUDA stream as the cohort's sample
    threads are, launch ORDER1 groups of seven table sizes (2 to 256
    contexts: 4 KB to 199 KB of dynamic shared memory) at once, 42 each:
    every launch succeeds and equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from concurrent.futures import ThreadPoolExecutor

    from goleft_tpu_torch.io import rans_nx16 as rx
    from goleft_tpu_torch.ops import rans_device as rd
    from goleft_tpu_torch.ops import rans_kernel as rk

    rng = np.random.default_rng(6)
    ramp = np.cumsum(rng.choice([0, 1, 2, 3, 255], 6000)) % 256
    dev = torch.device("cuda")
    groups = []
    for a in (2, 3, 13, 39, 77, 150, 256):
        d = (ramp % a).astype(np.uint8).tobytes()
        p = rx.parse_nx16(rx.encode(d, order=1), len(d))
        assert p.order1 and p.n_ctx == a
        (key, grp, t), = _rans_groups([p], dev)
        want = rd.group_stage(key, grp, {k: v.cpu() for k, v in t.items()},
                              rk.rans_decode_plain)
        groups.append((key, grp, t, want))
    torch.cuda.synchronize()

    def work(i):
        # launches queued back to back, one wait at the end: the threads'
        # launches then overlap on the host
        s = torch.cuda.Stream(dev)
        with torch.cuda.stream(s):
            order = [(i + r) % len(groups) for r in range(42)]
            outs = [rd.group_stage(*groups[g][:3]) for g in order]
        s.synchronize()
        return [groups[g][1][0].n_ctx for g, got in zip(order, outs)
                if not (torch.equal(got[0].cpu(), groups[g][3][0])
                        and torch.equal(got[1].cpu(), groups[g][3][1]))]

    with ThreadPoolExecutor(8) as pool:
        bad = [c for b in pool.map(work, range(8)) for c in b]
    assert not bad, f"launches differ from the plain version: {bad}"


@pytest.mark.cuda
def test_cuda_tensors_never_reach_the_plain_rans(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from goleft_tpu_torch.io import rans_nx16 as rx
    from goleft_tpu_torch.ops import rans_device as rd
    from goleft_tpu_torch.ops import rans_kernel as rk

    def boom(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    for name in ("rans_decode_plain", "order0_plain", "order1_plain"):
        monkeypatch.setattr(rk, name, boom)
    cases = _rans_streams(np.random.default_rng(5))
    plans = [rx.parse_nx16(e, len(d)) for d, e in cases]
    assert rd.decode_parsed(plans, device=torch.device("cuda")) \
        == [d for d, _ in cases]


@pytest.mark.cuda
def test_dispatch_fences_the_launching_threads_stream():
    """Under device events each launch is one fenced device span of
    platform gpu, and the fence waits on the launching thread's stream:
    a span on a side stream ends after its own kernel, not after a
    kernel still spinning on the default stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from goleft_tpu_torch import obs

    tracer = obs.get_tracer()
    tracer.clear()
    dev = torch.device("cuda")
    x = torch.ones(1 << 20, device=dev)
    obs.set_device_events(True)
    try:
        assert obs.dispatch("depth", torch.mul, x, 2).sum().item() \
            == 2 * x.numel()
        side = torch.cuda.Stream(dev)
        # allocated and launched once now: a cudaMalloc, or the lazy load
        # of a kernel's module at its first launch, waits for the device
        out = torch.empty_like(x)
        with torch.cuda.stream(side):
            torch.add(x, 1, out=out)
        torch.cuda.synchronize()
        torch.cuda._sleep(4_000_000_000)  # ~2 s spin on the default stream
        with torch.cuda.stream(side):
            obs.dispatch("rans", torch.add, x, 1, out=out)
            assert side.query()  # the fence waited on this stream
        default_busy = not torch.cuda.current_stream(dev).query()
        torch.cuda.synchronize()
    finally:
        obs.set_device_events(False)
    assert out.sum().item() == 2 * x.numel()
    spans = [sp for sp in tracer.snapshot() if sp.category == "device"]
    assert [sp.name for sp in spans] == ["device.depth", "device.rans"]
    assert all(sp.attrs["fenced"] and sp.attrs["platform"] == "gpu"
               for sp in spans)
    assert default_busy, "the fence must not wait on other streams"
    assert spans[1].duration() < 0.5, spans[1].duration()
    tracer.clear()


def _em_matrix(rng, B=300, S=40):
    d = rng.poisson(30, size=(B, S)).astype(np.float64)
    d[40:60, 3] *= 0.5
    d[100:130, 7] = 0
    d[200:220, 11] *= 1.5
    d[250, 5] = 900.0  # above λ8: CN 8
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, 10**9])
def test_em_on_card_equals_cpu(monkeypatch, chunk):
    """_batched_em on the card (whole chunks and one batch) against the
    CPU path: λ within 1e-9, CN equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from goleft_tpu_torch.commands import emdepth_cmd as ec

    d = _em_matrix(np.random.default_rng(8))
    med, medmed = ec.sample_medians(d)
    monkeypatch.setattr(ec, "EM_CHUNK", chunk)
    lam_g, cn_g = ec._batched_em(d, med, medmed, device="cuda")
    lam_c, cn_c = ec._batched_em(d, med, medmed, device="cpu")
    np.testing.assert_allclose(lam_g, lam_c, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(cn_g, cn_c)
    assert cn_g[250, 5] == 8


@pytest.mark.cuda
def test_norm_chunk_on_card_equals_host():
    """The int16 rows scaled on the card equal numpy's ``v / med *
    medmed`` on the host bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from goleft_tpu_torch.commands import emdepth_cmd as ec

    d = _em_matrix(np.random.default_rng(10)).astype(np.int16)
    med, medmed = ec.sample_medians(d)
    got = ec._norm_chunk(d, med, medmed, np.float64, "cuda")
    np.testing.assert_array_equal(got.cpu().numpy(), d / med * medmed)


@pytest.mark.cuda
def test_mops_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from goleft_tpu_torch.models import mops

    d = torch.from_numpy(_em_matrix(np.random.default_rng(9)))
    g = mops.mops_batch(d.cuda())
    c = mops.mops_batch(d)
    for key in ("aik", "alpha", "lambda"):
        np.testing.assert_allclose(g[key].cpu().numpy(), c[key].numpy(),
                                   rtol=1e-9, atol=1e-9, err_msg=key)
    assert torch.equal(mops.posterior_cn(g["aik"]).cpu(),
                       mops.posterior_cn(c["aik"]))
    np.testing.assert_allclose(mops.information_gain(g["aik"]).cpu(),
                               mops.information_gain(c["aik"]), rtol=1e-9)


def _norm_on_card(case):
    d, ln, m, skip = case
    dev = torch.device("cuda")
    return (torch.from_numpy(np.ascontiguousarray(d)).to(dev),
            torch.from_numpy(ln.astype(np.int32)).to(dev),
            torch.from_numpy(m).to(dev), torch.from_numpy(skip).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NORM_EDGES) + ["main"])
def test_indexcov_norm_kernel_equals_plain_on_card(name):
    """chip_smoke.py's NORM_EDGES and a 300-sample slice of its main case
    (chr1 at 16 KB): the kernel bitwise against its plain version, one
    counted launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from goleft_tpu_torch.ops import norm_kernel as nk

    case = norm_main_case(np.random.default_rng(1), n=300) \
        if name == "main" else norm_edge_case(name)
    t = _norm_on_card(case)
    before = nk.LAUNCHES["indexcov_norm"]
    got = nk.norm_scan(*t)
    want = nk.apply_normalization_plain(*t)
    torch.cuda.synchronize()
    assert nk.LAUNCHES["indexcov_norm"] == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_indexcov_norm_kernel_takes_a_skip_view_at_any_offset(offset):
    """A ``skip[lo:hi]`` view whose data is not 4-byte aligned (the kernel
    copies skip 4 bytes at a time): bitwise the plain version's answer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from goleft_tpu_torch.ops import norm_kernel as nk

    d, ln, m, skip = _norm_on_card(norm_edge_case("skip_runs"))
    b = d.shape[1]
    wide = torch.zeros(b + offset, dtype=torch.bool, device=skip.device)
    wide[offset:] = skip
    view = wide[offset:]
    assert view.data_ptr() % 4 == offset % 4
    got = nk.norm_scan(d, ln, m, view)
    want = nk.apply_normalization_plain(d, ln, m, skip)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_run_indexcov_on_card_equals_cpu(tmp_path):
    """``run_indexcov`` on the card against its CPU path on eight
    fabricated .bai files (chr1-chr3, chrX, chrY): every output
    byte-identical but the PCA columns and charts (equal up to sign),
    with and without -n; -n launches the kernel once an autosome."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from goleft_tpu_torch.commands.indexcov import run_indexcov
    from goleft_tpu_torch.ops import norm_kernel as nk

    contigs = tuple((n, (400 + 57 * i) * 16384 + 99) for i, (n, _) in
                    enumerate(HG38[:3] + HG38[-2:]))
    bais, fai = indexcov_fabricate(str(tmp_path), 8,
                                   np.random.default_rng(6), contigs)
    for k, kw in enumerate(({}, {"extra_normalize": True})):
        card = str(tmp_path / f"card{k}" / "out")
        cpu = str(tmp_path / f"cpu{k}" / "out")
        before = nk.LAUNCHES["indexcov_norm"]
        run_indexcov(bais, card, fai=fai, device="cuda", **kw)
        assert nk.LAUNCHES["indexcov_norm"] - before == 3 * k
        run_indexcov(bais, cpu, fai=fai, device="cpu", **kw)
        compare_indexcov_dirs(cpu, card)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SW_CASES))
def test_swalign_kernel_equals_plain_on_card(name):
    """chip_smoke.py's SW_CASES (a batch of 4,096 pairs of 150 bp reads,
    1,100 and 2,000 bp reads, B = 1, an all-N read, an all-mismatch pair,
    a tie, a window length past the bucket's width), one counted launch a
    bucket: best, bi, bj and every byte of the unpacked direction plane
    bitwise against the plain version on the card (the long reads cross
    band boundaries), the run buffer, formatted, equal to the host
    traceback of the plain version's plane on every pair, and on the main
    bucket 64 pairs equal to sw_oracle (best cell, direction bytes and
    alignment)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from goleft_tpu_torch.ops import swalign, swalign_kernel

    dev = torch.device("cuda")
    sc = torch.tensor([2, -4, -4, -2], dtype=torch.int32, device=dev)
    host = sw_case(name)
    t = [torch.from_numpy(a).to(dev) for a in host] + [sc]
    r1, wcap = host[0].shape[1], host[2].shape[1]
    want = swalign.sw_bucket_plain(*t)
    before = swalign_kernel.LAUNCHES["swalign"]
    meta, runs, plane, plan = swalign_kernel.launch(*t)
    torch.cuda.synchronize()
    assert swalign_kernel.LAUNCHES["swalign"] == before + 1
    dirs = swalign.unpack_dirs(plane, plan.rows_per_lane, t[1], t[3], r1,
                               wcap)
    for g, w in zip((meta[0], meta[1], meta[2], dirs), want):
        assert torch.equal(g, w)
    meta = meta.cpu().numpy()
    got = swalign.alignments(
        meta, runs[:max(1, int(meta[5].max()))].cpu().numpy())
    wb, wi, wj, wd = (x.cpu().numpy() for x in want)
    for n in range(len(got)):
        assert tuple(got[n]) == (int(wb[n]),) + swalign.traceback(
            wd[n], wi[n], wj[n]), n
    if name == "main":
        reads_p, rlens, wins_p, wlens = host
        dirs = dirs.cpu().numpy()
        for n in range(64):
            r, w = int(rlens[n]), int(wlens[n])
            ob, oi, oj, od = swalign.sw_oracle(reads_p[n, 1:r + 1],
                                               wins_p[n, :w])
            assert tuple(int(x) for x in meta[:3, n]) == (ob, oi, oj)
            assert np.array_equal(dirs[n, :r + w + 1, :r + 1], od)
            assert tuple(got[n]) == (ob,) + swalign.traceback(od, oi, oj)


@pytest.mark.cuda
def test_swalign_launch_plan_comes_from_the_kernel():
    """The kernel's own plan: R = ceil(rows / 32) read rows a lane, at
    most 8, in bands of 32 R rows; 8 pairs (warps) a block; a device
    scratch of the band boundary rows (4 x (ncols + 1) int32 a pair,
    ncols = r1 + w_pad - 2) only past one band; ncols + 31 steps a band
    in the plane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from goleft_tpu_torch.ops import swalign_kernel

    plan = swalign_kernel.launch_plan
    assert plan(1, 1) == (1, 1, 8, 0, 32)
    assert plan(33, 64) == (1, 1, 8, 0, 126)
    assert plan(129, 192) == (4, 1, 8, 0, 350)
    assert plan(161, 256) == (5, 1, 8, 0, 446)
    assert plan(257, 320) == (8, 1, 8, 0, 606)
    assert plan(258, 320) == (8, 2, 8, 4 * 577, 607)
    assert plan(1121, 1216) == (8, 5, 8, 4 * 2336, 2366)
    assert plan(2017, 2112) == (8, 8, 8, 4 * 4128, 4158)


@pytest.mark.cuda
def test_swalign_wrapper_refuses_what_the_kernel_does_not_take():
    """Non-contiguous, wrongly typed or mixed-device tensors raise before
    any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from goleft_tpu_torch.ops import swalign, swalign_kernel

    dev = torch.device("cuda")
    reads, rl, wins, wl = (torch.from_numpy(a).to(dev)
                           for a in sw_case("tie"))
    sc = torch.tensor([2, -4, -4, -2], dtype=torch.int32, device=dev)
    before = swalign_kernel.LAUNCHES["swalign"]
    with pytest.raises(TypeError):
        swalign.sw_bucket(reads.to(torch.int32), rl, wins, wl, sc)
    with pytest.raises(TypeError):
        swalign.sw_bucket(reads, rl.to(torch.int64), wins, wl, sc)
    wide = torch.cat([wins, wins], dim=1)[:, ::2]
    with pytest.raises(ValueError):
        swalign.sw_bucket(reads, rl, wide, wl, sc)
    with pytest.raises(ValueError):
        swalign.sw_bucket(reads, rl, wins, wl, sc.cpu())
    with pytest.raises(TypeError):
        swalign.sw_align(reads, rl, wins.to(torch.int32), wl, sc)
    with pytest.raises(ValueError):
        swalign.sw_align(reads, rl.cpu(), wins, wl, sc)
    assert swalign_kernel.LAUNCHES["swalign"] == before
