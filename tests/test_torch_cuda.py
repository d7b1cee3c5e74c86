"""The CUDA depth kernel against its plain PyTorch version, on a card.

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
