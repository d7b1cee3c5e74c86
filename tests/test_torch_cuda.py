"""The CUDA kernels (depth, pair-HMM) against their plain PyTorch
versions, on a card.

Imports neither JAX nor the JAX package, so it runs on a machine with
only PyTorch, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

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


def _pairhmm_bucket(rng, b, read_len, hap_len, dtype):
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
    packed = tph._pack_bucket(idxs, reads, errs, haps, rp, hp, dtype)
    trans = tph.transition_probs().astype(dtype)
    return [torch.from_numpy(a).cuda() for a in (*packed, trans)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("read_len,hap_len,b", [(150, 400, 64),
                                                (1100, 200, 3)])
def test_pairhmm_kernel_equals_plain_on_card(dtype, read_len, hap_len, b):
    """f32 rescaled and f64 unscaled; 150 bp reads, and 1,100 bp reads
    whose rows take two strips of one block; contribs and shifts
    bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from goleft_tpu_torch.ops import pairhmm_kernel as pk

    t = _pairhmm_bucket(np.random.default_rng(read_len), b, read_len,
                        hap_len, dtype)
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
