"""The port's banded Smith-Waterman (goleft_tpu_torch/ops/swalign.py)
against the JAX package's, on the CPU: the plain PyTorch wavefront
equals the reference's XLA program ``_sw_bucket_impl`` in best, bi, bj
and every direction byte, the kernel's plane layout (``_pack_dirs``, the
plain version of the kernel's writes) unpacks to the reference's bytes,
the run-length traceback formats to the reference's ``traceback``, and
``align_pairs`` / ``oracle_align`` give the reference's Alignments. The
cases mirror tests/test_swalign.py. Every comparison is exact."""

import functools
import re

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


def _edge_bucket(what):
    """One-pair buckets: an all-N read, an all-mismatch pair (best 0, no
    cell), the first-wavefront-cell tie, custom scores, a window length
    past the bucket's width (the column is clipped to the last one) →
    (reads, rlens, wins, wlens, scores)."""
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
    return reads, rl, wins, wl, sc


@pytest.mark.parametrize("what", ["all_n_read", "mismatch", "tie",
                                  "custom_scores", "wlen_past_pad"])
def test_plain_wavefront_edge_buckets(what):
    """An all-N read, an all-mismatch pair (best 0, no cell), the
    first-wavefront-cell tie, custom scores, a window length past the
    bucket's width (the column is clipped to the last one): bitwise
    equal."""
    got, want = _both(*_edge_bucket(what))
    for g, w_ in zip(got, want):
        assert np.array_equal(g, w_)
    if what in ("all_n_read", "mismatch"):
        assert (got[0][0], got[1][0], got[2][0]) == (0, 0, 0)
    if what == "tie":
        assert (got[0][0], got[1][0], got[2][0]) == (8, 4, 4)
    if what == "wlen_past_pad":
        # the last base repeats past the window: the best cell lies there
        assert got[2][0] > 64


def _gap_bucket(rng):
    """Reads with one gap of 33-70 bases against their windows, both ways
    (runs of D and of I longer than a warp), at scores that keep the gap
    in the alignment."""
    reads, wins = [], []
    for gap in (33, 40, 64, 70):
        win = _rand_seq(rng, 260)
        reads.append(win[10:80] + win[80 + gap:150 + gap])
        wins.append(win)
        reads.append(win[10:80] + _rand_seq(rng, gap) + win[80:150])
        wins.append(win)
    reads = [encode_seq(r) for r in reads]
    wins = [encode_seq(w) for w in wins]
    r_pad = max(port.bucket_shape(len(r), 1)[0] for r in reads)
    w_pad = max(port.bucket_shape(1, len(w))[1] for w in wins)
    return port._pack_bucket(list(range(len(reads))), reads, wins, r_pad,
                             w_pad) + ((2, -4, -4, 0),)


#: buckets of the plane and run-length checks: random ones of the main
#: path's shapes, reads of 299 and 599 rows (two and three bands of 256
#: at 8 rows a lane), long gaps and the edge pairs
_PLANE_CASES = {
    "r33_w64": lambda rng: _bucket(rng, 6, 33, 64) + ((2, -4, -4, -2),),
    "r65_w64": lambda rng: _bucket(rng, 5, 65, 64) + ((2, -4, -4, -2),),
    "r33_w128": lambda rng: _bucket(rng, 4, 33, 128) + ((2, -4, -4, -2),),
    "r161_w256": lambda rng: _bucket(rng, 3, 161, 256)
    + ((2, -4, -4, -2),),
    "two_bands": lambda rng: _bucket(rng, 3, 300, 128)
    + ((2, -4, -4, -2),),
    "three_bands": lambda rng: _bucket(rng, 2, 600, 192)
    + ((1, -1, -2, -1),),
    "long_gaps": _gap_bucket,
    **{what: (lambda rng, w=what: _edge_bucket(w)) for what in (
        "all_n_read", "mismatch", "tie", "custom_scores", "wlen_past_pad")},
}


@functools.lru_cache(maxsize=None)
def _plane_case(name):
    """(port tensors, the reference's (best, bi, bj, dirs) as numpy) of
    ``_PLANE_CASES[name]``."""
    reads, rl, wins, wl, sc = _PLANE_CASES[name](
        np.random.default_rng(len(name) * 7919))
    sc = np.asarray(sc, np.int32)
    want = tuple(np.asarray(x) for x in
                 ref._sw_bucket_impl(reads, rl, wins, wl, sc))
    return [torch.from_numpy(a) for a in (reads, rl, wins, wl, sc)], want


def _pack_dirs(dirs, rows_per_lane: int) -> torch.Tensor:
    """The plain version of the kernel's plane: (B, R1 + W, R1) direction
    bytes in the reference's layout → (B, bands, ncols + 31, 32) int32
    with ncols = R1 + W - 2, every column a cell can reach, in the
    layout ``port.unpack_dirs`` reads; every bit of no cell is 0."""
    b, steps, r1 = dirs.shape
    rpl = rows_per_lane
    ncols = max(steps - 2, 1)
    bands = -(-max(r1 - 1, 1) // (32 * rpl))
    pad = torch.zeros((b, max(steps, r1 + ncols), r1), dtype=torch.uint8)
    pad[:, :steps] = dirs
    rows = torch.zeros((b, bands * 32 * rpl, ncols), dtype=torch.uint8)
    rows[:, :r1 - 1] = port._cells(pad, ncols)
    nib = torch.zeros((b, bands, ncols + 31, 32, rpl), dtype=torch.uint8)
    port._skewed(nib, ncols).copy_(rows.view(b, bands, 32, rpl, ncols))
    shift = 4 * torch.arange(rpl, dtype=torch.int64)
    words = (nib.to(torch.int64) << shift).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def _plan_rows_per_lane(r1):
    """csrc/swalign_kernel.cu::swalign_plan's rows a lane: ceil(rows /
    32), at most 8."""
    return min(8, -(-max(r1 - 1, 1) // 32))


@pytest.mark.parametrize("rows_per_lane", ["plan", 1, 3])
@pytest.mark.parametrize("name", sorted(_PLANE_CASES))
def test_unpacked_plane_equals_reference_dirs(name, rows_per_lane):
    """The plain path's plane, packed into the kernel's layout (a 32-bit
    word a band, step and lane, 4 bits a row), unpacks to the reference
    program's direction bytes, every byte, across band boundaries."""
    t, want = _plane_case(name)
    b, r1 = t[0].shape
    wcap = t[2].shape[1]
    rpl = (_plan_rows_per_lane(r1) if rows_per_lane == "plan"
           else rows_per_lane)
    dirs = port.sw_bucket_plain(*t)[3]
    plane = _pack_dirs(dirs, rpl)
    bands = -(-(r1 - 1) // (32 * rpl))
    assert plane.dtype == torch.int32
    assert tuple(plane.shape) == (b, bands, r1 + wcap - 2 + 31, 32)
    got = port.unpack_dirs(plane, rpl, t[1], t[3], r1, wcap)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want[3])
    if name == "three_bands" and rows_per_lane == "plan":
        assert bands == 3


@pytest.mark.parametrize("name", sorted(_PLANE_CASES))
def test_run_length_traceback_equals_reference(name):
    """``sw_align_plain``'s meta and run buffer (the kernel's output
    format), formatted by ``alignments``, give the reference traceback's
    (score, read_start, read_end, win_start, win_end, cigar) on every
    pair."""
    t, (wb, wi, wj, wd) = _plane_case(name)
    meta, runs = port.sw_align_plain(*t)
    assert meta.dtype == runs.dtype == torch.int32
    assert tuple(meta.shape) == (6, t[0].shape[0])
    assert tuple(runs.shape) == (t[0].shape[1] + t[2].shape[1],
                                 t[0].shape[0])
    got = port.alignments(meta.numpy(), runs.numpy())
    for n, a in enumerate(got):
        assert tuple(a) == (int(wb[n]),) + ref.traceback(wd[n], wi[n],
                                                         wj[n]), n
    if name == "long_gaps":
        assert all("D" in a.cigar or "I" in a.cigar for a in got)
        assert max(int(c[:-1]) for a in got for c in
                   re.findall(r"\d+[ID]", a.cigar)) > 64


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
    port.sw_align(*t)
    assert swalign_kernel.LAUNCHES["swalign"] == before
    with pytest.raises(TypeError):
        port.sw_align(t[0], t[1].to(torch.int64), *t[2:])
    with pytest.raises(TypeError):
        port.sw_bucket(t[0].to(torch.int32), *t[1:])
    with pytest.raises(ValueError):
        port.sw_bucket(t[0].t().contiguous().t(), *t[1:])
    with pytest.raises(ValueError):
        port.sw_bucket(t[0], t[1], t[2][:, ::2], *t[3:])
