"""The port's banded Smith-Waterman (goleft_tpu_torch/ops/swalign.py)
against the JAX package's, on the CPU: the plain PyTorch wavefront
equals the reference's XLA program ``_sw_bucket_impl`` in best, bi, bj
and every direction byte, and ``align_pairs`` / ``oracle_align`` give
the reference's Alignments. The cases mirror tests/test_swalign.py.
Every comparison is exact."""

import numpy as np
import pytest
import torch

from goleft_tpu.ops import swalign as ref
from goleft_tpu.ops.pairhmm import encode_seq as ref_encode
from goleft_tpu_torch.ops import swalign as port
from goleft_tpu_torch.ops import swalign_kernel
from goleft_tpu_torch.ops.pairhmm import encode_seq

_BASES = b"ACGT"


def _rand_seq(rng, n, n_rate=0.0):
    s = bytearray(rng.choice(list(_BASES), size=n).tolist())
    if n_rate:
        for i in range(n):
            if rng.random() < n_rate:
                s[i] = ord("N")
    return bytes(s)


def _mutate(rng, seq, subs=2, ins=1, dels=1):
    s = bytearray(seq)
    for _ in range(subs):
        i = rng.integers(0, len(s))
        s[i] = _BASES[rng.integers(0, 4)]
    for _ in range(ins):
        i = rng.integers(0, len(s))
        s[i:i] = bytes([_BASES[rng.integers(0, 4)]])
    for _ in range(dels):
        i = rng.integers(0, len(s) - 1)
        del s[i]
    return bytes(s)


def _bucket(rng, b, r1, wcap, n_rate=0.1, related=True):
    """A padded bucket in _pack_bucket's layout: reads of length
    [1, r1 - 1], windows of [1, wcap], N bases and padding at N."""
    reads = np.full((b, r1), 4, np.uint8)
    wins = np.full((b, wcap), 4, np.uint8)
    rl = rng.integers(1, r1, b).astype(np.int32)
    wl = rng.integers(1, wcap + 1, b).astype(np.int32)
    for n in range(b):
        w = ref_encode(_rand_seq(rng, int(wl[n]), n_rate))
        wins[n, :wl[n]] = w
        if related and wl[n] > 4:
            r = ref_encode(_mutate(rng, _rand_seq(rng, 3) + bytes(
                b"ACGTN"[c] for c in w[:rl[n]]), subs=2))[:rl[n]]
            r = np.concatenate([r, np.full(rl[n] - len(r), 4, np.uint8)])
        else:
            r = ref_encode(_rand_seq(rng, int(rl[n]), n_rate))
        reads[n, 1:rl[n] + 1] = r
    return reads, rl, wins, wl


def _both(reads, rl, wins, wl, sc=(2, -4, -4, -2)):
    sc = np.asarray(sc, np.int32)
    want = [np.asarray(x) for x in
            ref._sw_bucket_impl(reads, rl, wins, wl, sc)]
    got = [x.numpy() for x in port.sw_bucket_plain(
        *[torch.from_numpy(a) for a in (reads, rl, wins, wl, sc)])]
    return got, want


@pytest.mark.parametrize("b,r1,wcap", [
    (6, 33, 64),     # one bucket each
    (5, 65, 64),     # read spills into the second bucket
    (4, 33, 128),    # window spills
    (3, 161, 256),   # the main path's 150 bp bucket
    (1, 33, 64),     # B = 1
])
def test_plain_wavefront_equals_the_reference_program(b, r1, wcap):
    rng = np.random.default_rng(b * 1000 + r1 + wcap)
    got, want = _both(*_bucket(rng, b, r1, wcap))
    for name, g, w in zip(("best", "bi", "bj", "dirs"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name
    assert (got[0] > 0).any()


@pytest.mark.parametrize("what", ["all_n_read", "mismatch", "tie",
                                  "custom_scores", "wlen_past_pad"])
def test_plain_wavefront_edge_buckets(what):
    """An all-N read, an all-mismatch pair (best 0, no cell), the
    first-wavefront-cell tie, custom scores, a window length past the
    bucket's width (the column is clipped to the last one): bitwise
    equal."""
    reads = np.full((1, 33), 4, np.uint8)
    wins = np.full((1, 64), 4, np.uint8)
    sc = (2, -4, -4, -2)
    if what == "all_n_read":
        r, w = b"N" * 20, b"ACGT" * 10
    elif what == "mismatch":
        r, w = b"A" * 10, b"C" * 10
    elif what == "tie":
        r, w = b"ACGT", b"ACGTTTTTACGT"
    elif what == "custom_scores":
        r, w = b"ACGTACCGTACGT", b"ACGTACGTACGTACGT"
        sc = (1, -1, -2, -1)
    else:
        r, w = b"ACGTACGTACGT" + b"T" * 12, b"ACGT" * 16
    reads[0, 1:len(r) + 1] = ref_encode(r)
    wins[0, :len(w)] = ref_encode(w)
    rl = np.array([len(r)], np.int32)
    wl = np.array([len(w) + 20 * (what == "wlen_past_pad")], np.int32)
    got, want = _both(reads, rl, wins, wl, sc)
    for g, w_ in zip(got, want):
        assert np.array_equal(g, w_)
    if what in ("all_n_read", "mismatch"):
        assert (got[0][0], got[1][0], got[2][0]) == (0, 0, 0)
    if what == "tie":
        assert (got[0][0], got[1][0], got[2][0]) == (8, 4, 4)
    if what == "wlen_past_pad":
        # the last base repeats past the window: the best cell lies there
        assert got[2][0] > 64


@pytest.mark.parametrize("rlen,wlen", [
    (20, 40),    # below both buckets
    (32, 64),    # exactly one bucket each
    (33, 64),    # read spills into the second bucket
    (40, 100),   # window spills
])
def test_align_pairs_matches_reference_per_bucket_shape(rlen, wlen):
    rng = np.random.default_rng(rlen * 1000 + wlen)
    for trial in range(4):
        win = _rand_seq(rng, wlen)
        read = _mutate(rng, win[5:5 + rlen])[:rlen]
        got, = port.align_pairs([encode_seq(read)], [encode_seq(win)],
                                device="cpu")
        want, = ref.align_pairs([ref_encode(read)], [ref_encode(win)])
        assert tuple(got) == tuple(want), (rlen, wlen, trial)
        assert tuple(port.oracle_align(read, win)) == tuple(
            ref.oracle_align(read, win))


def test_n_bases_never_match():
    got, = port.align_pairs([encode_seq(b"ACGNNACG")],
                            [encode_seq(b"ACGNNACG")], device="cpu")
    assert tuple(got) == tuple(ref.oracle_align(b"ACGNNACG", b"ACGNNACG"))
    assert "M" in got.cigar


def test_batch_and_padding_independence():
    rng = np.random.default_rng(7)
    win = _rand_seq(rng, 50)
    read = _mutate(rng, win[3:33])
    r, w = encode_seq(read), encode_seq(win)
    alone, = port.align_pairs([r], [w], device="cpu")
    others = [encode_seq(_rand_seq(rng, 30)) for _ in range(3)]
    owins = [encode_seq(_rand_seq(rng, 50)) for _ in range(3)]
    batched = port.align_pairs([r] + others, [w] + owins, device="cpu")
    assert batched[0] == alone
    packed = port._pack_bucket([0], [r], [w], 2 * port.BUCKET,
                               2 * port.WBUCKET)
    padded, = port.align_bucket(*packed, device="cpu")
    assert padded == alone
    want = ref.align_pairs([r] + others, [w] + owins)
    assert [tuple(a) for a in batched] == [tuple(a) for a in want]


def test_exact_match_scores_full_length():
    win = b"TTTT" + b"ACGTACGTAC" * 3 + b"GGGG"
    read = b"ACGTACGTAC" * 3
    a, = port.align_pairs([encode_seq(read)], [encode_seq(win)],
                          device="cpu")
    assert a.score == 2 * len(read)
    assert (a.read_start, a.read_end) == (0, len(read))
    assert (a.win_start, a.win_end) == (4, 4 + len(read))
    assert a.cigar == f"{len(read)}M"


def test_indel_alignments_match_reference():
    rng = np.random.default_rng(11)
    reads, wins = [], []
    for _ in range(8):
        win = _rand_seq(rng, 80)
        reads.append(encode_seq(_mutate(rng, win[10:60], subs=3, ins=2,
                                        dels=2)))
        wins.append(encode_seq(win))
    got = port.align_pairs(reads, wins, device="cpu")
    want = ref.align_pairs(reads, wins)
    assert [tuple(a) for a in got] == [tuple(a) for a in want]
    assert any("I" in a.cigar or "D" in a.cigar for a in got)


def test_no_alignment_scores_zero():
    a, = port.align_pairs([encode_seq(b"AAAAAAAAAA")],
                          [encode_seq(b"CCCCCCCCCC")], device="cpu")
    assert a == port.Alignment(0, 0, 0, 0, 0, "")


def test_dispatch_hook_sees_bucket_shapes():
    rng = np.random.default_rng(3)
    reads = [encode_seq(_rand_seq(rng, n)) for n in (20, 30, 40)]
    wins = [encode_seq(_rand_seq(rng, n)) for n in (60, 60, 90)]
    seen = []

    def dispatch(sig, thunk):
        seen.append(sig)
        return thunk()

    hooked = port.align_pairs(reads, wins, dispatch=dispatch, device="cpu")
    assert hooked == port.align_pairs(reads, wins, device="cpu")
    assert sorted(seen) == [(port.BUCKET, port.WBUCKET, 2),
                            (2 * port.BUCKET, 2 * port.WBUCKET, 1)]


def test_bucket_shape_and_oracle_tie_rule():
    for r, w in ((1, 1), (32, 64), (33, 65)):
        assert port.bucket_shape(r, w) == ref.bucket_shape(r, w)
    best, bi, bj, dirs = port.sw_oracle(encode_seq(b"ACGT"),
                                        encode_seq(b"ACGTTTTTACGT"))
    want = ref.sw_oracle(ref_encode(b"ACGT"), ref_encode(b"ACGTTTTTACGT"))
    assert (best, bi, bj) == want[:3] == (8, 4, 4)
    assert np.array_equal(dirs, want[3])
    assert port.traceback(np.zeros((4, 4), np.uint8), 0, 0) == \
        (0, 0, 0, 0, "")


def test_wrapper_refuses_bad_tensors_and_counts_no_cpu_launch():
    rng = np.random.default_rng(2)
    reads, rl, wins, wl = _bucket(rng, 2, 33, 64)
    t = [torch.from_numpy(a) for a in (reads, rl, wins, wl,
                                       np.array([2, -4, -4, -2], np.int32))]
    before = swalign_kernel.LAUNCHES["swalign"]
    port.sw_bucket(*t)
    assert swalign_kernel.LAUNCHES["swalign"] == before
    with pytest.raises(TypeError):
        port.sw_bucket(t[0].to(torch.int32), *t[1:])
    with pytest.raises(ValueError):
        port.sw_bucket(t[0].t().contiguous().t(), *t[1:])
    with pytest.raises(ValueError):
        port.sw_bucket(t[0], t[1], t[2][:, ::2], *t[3:])
