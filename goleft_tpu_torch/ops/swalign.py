"""Banded Smith-Waterman: the read-mapper's extension stage.

The counterpart of the JAX package's ops/swalign.py. Local alignment of
a read against a bounded reference window, affine gaps, int32 scores,
over the anti-diagonal wavefront: cell (i, j) depends only on diagonals
i+j-1 and i+j-2, so each of the R+W steps updates three (R+1)-lane
vectors with shifts and elementwise max.

    H[i,j] = max(0, H[i-1,j-1] + sub(i,j), E[i,j], F[i,j])
    E[i,j] = max(H[i,j-1] + open + ext, E[i,j-1] + ext)   (gap in read)
    F[i,j] = max(H[i-1,j] + open + ext, F[i-1,j] + ext)   (gap in ref)

A bucket is one launch of the hand-written kernel (csrc/swalign_kernel.cu,
ops/swalign_kernel.py) on CUDA tensors: the wavefront, each pair's best
cell, a direction plane of 4 bits a cell in the kernel's layout that
stays on the card, and the traceback walked there into run-length CIGAR
ops. Its plain version on CPU tensors is :func:`sw_align_plain`: the same
loop as PyTorch ops over pairs and lanes (:func:`sw_bucket_plain`), then
:func:`traceback_runs` on the host. :func:`sw_align` and
:func:`sw_bucket` choose by the tensors' device and never fall back.
Both match the NumPy oracle (:func:`sw_oracle`) and the reference's
``_sw_bucket_impl`` bit for bit: per pair the best score and cell and
the direction-bit plane (2 bits of H-source, one E-extend bit, one
F-extend bit per cell; :func:`unpack_dirs` turns the kernel's plane into
the reference's layout for the checks). Padding lanes are the identity,
so a pair's result is independent of its bucket shape and batch
neighbours.

Tie-breaking is pinned on both sides: the best cell is the
lexicographically first (i+j, i) among maximal cells, H prefers
diagonal > E > F on ties, and E/F prefer extension on ties.

Reads pad to ``BUCKET`` (32), windows to ``WBUCKET`` (64);
:func:`align_pairs` is the host entry the mapping pipeline drives (the
``map`` fault site wraps each bucket one level up, in
mapping/pipeline.py). Stages (``TIMER``, summed into the CLI's
``--metrics-out`` spans): ``extend-kernel`` (the upload and one
:func:`sw_align`, waited on: on the card the wavefront and the walk),
``extend-d2h`` (each pair's best, spans and run count, and the filled
rows of the run buffer, to the host) and ``traceback`` (the CIGAR
strings formatted from the runs).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..utils.profiling import StageTimer
from . import swalign_kernel
from .pairhmm import encode_seq  # shared A=0 C=1 G=2 T=3, N=4 codes

BUCKET = 32    # read-length bucket granularity
WBUCKET = 64   # window-length bucket granularity
N_CODE = 4
#: "minus infinity" for int32 gap states: low enough to never win a
#: max, high enough that adding a gap penalty cannot wrap
NEG = np.int32(-(1 << 28))
#: the CIGAR ops of a run's low two bits
OPS = "MID"
OP_M, OP_I, OP_D = range(3)

#: stage clock of the extend stage
TIMER = StageTimer()


class Scores(NamedTuple):
    """Integer alignment scores (penalties negative)."""

    match: int = 2
    mismatch: int = -4
    gap_open: int = -4   # charged once per gap, on top of gap_ext
    gap_ext: int = -2

    def astuple(self) -> tuple[int, int, int, int]:
        return (int(self.match), int(self.mismatch),
                int(self.gap_open), int(self.gap_ext))


DEFAULT_SCORES = Scores()


def _pad_up(n: int, to: int) -> int:
    return max(to, ((n + to - 1) // to) * to)


def bucket_shape(rlen: int, wlen: int) -> tuple[int, int]:
    """(r_pad, w_pad) signature for one read/window pair."""
    return _pad_up(rlen, BUCKET), _pad_up(wlen, WBUCKET)


def sw_bucket_plain(reads_p, rlens, wins, wlens, scores):
    """The wavefront as a Python loop over the r1 + w_pad steps,
    vectorised over pairs and lanes: ``_sw_bucket_impl``'s operations in
    its order. Inputs and outputs as :func:`sw_bucket`."""
    b, r1 = reads_p.shape
    wcap = wins.shape[1]
    steps = r1 + wcap
    dev = reads_p.device
    i32 = dict(dtype=torch.int32, device=dev)
    s_match, s_mis, s_open, s_ext = (scores[n] for n in range(4))
    neg = torch.tensor(int(NEG), **i32)
    zero = torch.tensor(0, **i32)
    ii = torch.arange(r1, **i32)[None, :]
    rl = rlens[:, None]
    wl = wlens[:, None]
    read = reads_p.to(torch.int32)
    win = wins.to(torch.int32)
    read_n = read != N_CODE

    def shift1(x, fill):
        # x[i-1] with ``fill`` entering at lane 0
        return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]],
                         dim=1)

    h1 = torch.zeros(b, r1, **i32)
    h2 = torch.zeros(b, r1, **i32)
    e1 = torch.full((b, r1), int(NEG), **i32)
    f1 = torch.full((b, r1), int(NEG), **i32)
    best = torch.zeros(b, **i32)
    bi = torch.zeros(b, **i32)
    bj = torch.zeros(b, **i32)
    dirs = torch.zeros((b, steps, r1), dtype=torch.uint8, device=dev)
    for k in range(1, steps):
        jj = k - ii
        in_w = (jj >= 1) & (jj <= wl)
        col = torch.clamp(jj - 1, 0, wcap - 1).long().expand(b, r1)
        wb = torch.where(in_w, win.gather(1, col), N_CODE)
        valid = (ii >= 1) & (ii <= rl) & in_w
        is_match = (read == wb) & read_n & (wb != N_CODE)
        sub = torch.where(is_match, s_match, s_mis)
        h_diag = shift1(h2, 0) + sub
        e_open = h1 + s_open + s_ext
        e_ext = e1 + s_ext
        e = torch.maximum(e_open, e_ext)
        f_open = shift1(h1, 0) + s_open + s_ext
        f_ext = shift1(f1, int(NEG)) + s_ext
        f = torch.maximum(f_open, f_ext)
        h = torch.maximum(torch.maximum(zero, h_diag), torch.maximum(e, f))
        h = torch.where(valid, h, zero)
        e = torch.where(valid, e, neg)
        f = torch.where(valid, f, neg)
        src = torch.where(h <= 0, 0, torch.where(
            h == h_diag, 1, torch.where(h == e, 2, 3)))
        d = (src | ((e_ext >= e_open).to(torch.int32) << 2)
             | ((f_ext >= f_open).to(torch.int32) << 3))
        dirs[:, k] = torch.where(valid, d, 0).to(torch.uint8)
        hv = torch.where(valid, h, -1)
        am = hv.argmax(dim=1)  # the first lane of the maximum
        m = hv.gather(1, am[:, None])[:, 0]
        take = m > best  # strict: keeps the earliest diagonal
        best = torch.where(take, m, best)
        bi = torch.where(take, am.to(torch.int32), bi)
        bj = torch.where(take, k - am.to(torch.int32), bj)
        h2, h1, e1, f1 = h1, h, e, f
    return best, bi, bj, dirs


def _check(t: torch.Tensor, dtype, name: str, shape: tuple):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor of shape "
                         f"{shape}, got {tuple(t.shape)}")


def _checked_device(reads_p, rlens, wins, wlens, scores) -> torch.device:
    """The bucket's device, after the checks the kernel needs."""
    b, r1 = reads_p.shape
    wcap = wins.shape[1]
    _check(reads_p, torch.uint8, "reads_p", (b, r1))
    _check(rlens, torch.int32, "rlens", (b,))
    _check(wins, torch.uint8, "wins", (b, wcap))
    _check(wlens, torch.int32, "wlens", (b,))
    _check(scores, torch.int32, "scores", (4,))
    if b < 1 or r1 < 1 or wcap < 1:
        raise ValueError(f"swalign: bad bucket geometry b={b} r1={r1} "
                         f"w_pad={wcap}")
    dev = reads_p.device
    if any(t.device != dev for t in (rlens, wins, wlens, scores)):
        raise ValueError("swalign: inputs on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"swalign: unsupported device {dev}")
    return dev


def sw_bucket(reads_p, rlens, wins, wlens, scores):
    """One padded bucket through the wavefront, in the reference's
    layout.

    reads_p: (B, R1) uint8, the read base at lane i (1-based; lane 0 is
             the boundary row), rlens (B,) int32
    wins:    (B, W) uint8 window bases (0-based), wlens (B,) int32
    scores:  (4,) int32 [match, mismatch, gap_open, gap_ext]

    Returns (best (B,) int32, bi (B,) int32, bj (B,) int32, dirs (B,
    R1 + W, R1) uint8) on the inputs' device: on CUDA tensors one kernel
    launch and :func:`unpack_dirs` of its plane, on CPU tensors the
    plain version's.
    """
    dev = _checked_device(reads_p, rlens, wins, wlens, scores)
    if dev.type == "cpu":
        return sw_bucket_plain(reads_p, rlens, wins, wlens, scores)
    meta, _, plane, plan = swalign_kernel.launch(reads_p, rlens, wins,
                                                 wlens, scores)
    return (meta[0], meta[1], meta[2],
            unpack_dirs(plane, plan.rows_per_lane, rlens, wlens,
                        reads_p.shape[1], wins.shape[1]))


def sw_align_plain(reads_p, rlens, wins, wlens, scores):
    """The plain version of the kernel's outputs: :func:`sw_bucket_plain`
    and :func:`traceback_runs` of every pair, on the host. Inputs and
    outputs as :func:`sw_align`."""
    b, r1 = reads_p.shape
    wcap = wins.shape[1]
    best, bi, bj, dirs = (x.cpu().numpy() for x in sw_bucket_plain(
        reads_p, rlens, wins, wlens, scores))
    meta = np.zeros((6, b), np.int32)
    runs = np.zeros((r1 + wcap, b), np.int32)
    for n in range(b):
        rs, ws, rr = traceback_runs(dirs[n], bi[n], bj[n])
        meta[:, n] = (best[n], bi[n], bj[n], rs, ws, len(rr))
        runs[:len(rr), n] = rr
    return (torch.from_numpy(meta).to(reads_p.device),
            torch.from_numpy(runs).to(reads_p.device))


def sw_align(reads_p, rlens, wins, wlens, scores):
    """One padded bucket (inputs as :func:`sw_bucket`) through the
    wavefront and the traceback → (meta (6, B) int32: best, bi, bj,
    read_start, win_start, runs; runs (R1 + W, B) int32: a pair's first
    meta[5] rows are its CIGAR's run-length ops, ``(length << 2) | op``
    with op an index of ``OPS``, in the CIGAR's order; the rows past them
    are undefined). One kernel launch on CUDA tensors, whose direction
    plane stays on the card; :func:`sw_align_plain` on CPU tensors."""
    dev = _checked_device(reads_p, rlens, wins, wlens, scores)
    if dev.type == "cpu":
        return sw_align_plain(reads_p, rlens, wins, wlens, scores)
    meta, runs, _, _ = swalign_kernel.launch(reads_p, rlens, wins, wlens,
                                             scores)
    return meta, runs


def _cells(t: torch.Tensor, ncols: int) -> torch.Tensor:
    """The (B, R1 - 1, ncols) view of cells (i, j) = [i - 1, j - 1] of a
    contiguous (B, steps, R1) plane in the reference's layout, whose
    cell (i, j) lies at [i + j, i]; ``steps`` >= R1 + ncols."""
    b, steps, r1 = t.shape
    return t.as_strided((b, r1 - 1, ncols), (steps * r1, r1 + 1, r1),
                        t.storage_offset() + 2 * r1 + 1)


def _skewed(nib: torch.Tensor, ncols: int) -> torch.Tensor:
    """The (B, bands, 32, R, ncols) view of a contiguous (B, bands, S,
    32, R) nibble plane in the kernel's layout: lane L's row r of a band
    at column c + 1 was written at step c + L."""
    b, bands, s, w, r = nib.shape
    return nib.as_strided((b, bands, w, r, ncols),
                          (bands * s * w * r, s * w * r, w * r + r, 1,
                           w * r), nib.storage_offset())


def unpack_dirs(plane, rows_per_lane: int, rlens, wlens, r1: int,
                wcap: int) -> torch.Tensor:
    """The kernel's direction plane ((B, bands, ncols + 31, 32) int32,
    ncols at least every column of the cell set: one word a (band, step,
    lane) holding the lane's ``rows_per_lane`` rows x 4 bits, row r in
    bits 4r..4r+3, lane L's rows of a band being 32 R x band + L R + 1
    ..., its column j at step j - 1 + L) → the reference's (B, R1 + W,
    R1) uint8 layout, 0 wherever the reference computes no cell. Only
    the checks' view of the plane: the main path never calls it."""
    b, bands, s, _ = plane.shape
    ncols = s - 31
    dev = plane.device
    shift = 4 * torch.arange(rows_per_lane, dtype=torch.int32, device=dev)
    nib = ((plane.unsqueeze(-1) >> shift) & 15).to(torch.uint8)
    rows = _skewed(nib, ncols).reshape(b, -1, ncols)[:, :r1 - 1]
    i = torch.arange(1, r1, device=dev)[None, :, None]
    j = torch.arange(1, ncols + 1, device=dev)[None, None, :]
    valid = ((i <= rlens.to(torch.int64)[:, None, None])
             & (j <= wlens.to(torch.int64)[:, None, None])
             & (i + j <= r1 + wcap - 1))
    out = torch.zeros((b, r1 + max(wcap, ncols), r1), dtype=torch.uint8,
                      device=dev)
    _cells(out, ncols).copy_(torch.where(valid, rows, 0))
    return out[:, :r1 + wcap].contiguous()


def sw_oracle(read_codes: np.ndarray, win_codes: np.ndarray,
              scores: Scores = DEFAULT_SCORES):
    """Exact NumPy reference: plain nested-loop affine-gap local DP.

    Independent of the wavefront formulation (row-major cell loop,
    no shifts, no masks) but pinned to the same int arithmetic and
    tie rules, so device output must match it bit for bit. Returns
    (best, bi, bj, dirs) in the device layout: dirs[k, i] holds the
    bits for cell (i, j=k-i) with i 1-based over the read.
    """
    s_match, s_mis, s_open, s_ext = scores.astuple()
    r = len(read_codes)
    w = len(win_codes)
    neg = int(NEG)
    H = np.zeros((r + 1, w + 1), dtype=np.int64)
    E = np.full((r + 1, w + 1), neg, dtype=np.int64)
    F = np.full((r + 1, w + 1), neg, dtype=np.int64)
    dirs = np.zeros((r + 1 + w, r + 1), dtype=np.uint8)
    for i in range(1, r + 1):
        rb = int(read_codes[i - 1])
        for j in range(1, w + 1):
            wb = int(win_codes[j - 1])
            sub = s_match if (rb == wb and rb != N_CODE
                              and wb != N_CODE) else s_mis
            h_diag = H[i - 1, j - 1] + sub
            e_open = H[i, j - 1] + s_open + s_ext
            e_ext = E[i, j - 1] + s_ext
            e = max(e_open, e_ext)
            f_open = H[i - 1, j] + s_open + s_ext
            f_ext = F[i - 1, j] + s_ext
            f = max(f_open, f_ext)
            h = max(0, h_diag, e, f)
            H[i, j], E[i, j], F[i, j] = h, e, f
            if h <= 0:
                src = 0
            elif h == h_diag:
                src = 1
            elif h == e:
                src = 2
            else:
                src = 3
            dirs[i + j, i] = (src | ((e_ext >= e_open) << 2)
                              | ((f_ext >= f_open) << 3))
    # best cell with the device's tie rule: among maximal cells the
    # lexicographically first (i+j, i) — strict improvement over
    # wavefront steps, first lane within a step
    best = int(max(H.max(), 0))
    bi = bj = 0
    if best > 0:
        cand = np.argwhere(H == best)
        order = np.lexsort((cand[:, 0], cand[:, 0] + cand[:, 1]))
        bi, bj = (int(cand[order[0], 0]), int(cand[order[0], 1]))
    return best, bi, bj, dirs


def traceback_runs(dirs: np.ndarray, bi: int, bj: int):
    """Walk the direction bits back from the best cell.

    ``dirs`` is the (steps, R1) per-pair plane (device or oracle);
    (bi, bj) the 1-based best cell. Returns (read_start, win_start,
    runs): the 0-based starts of the half-open spans that end at bi, bj,
    and the CIGAR as run-length ops, ``(length << 2) | op`` with op an
    index of ``OPS`` (M, I consuming read, D consuming window), in the
    CIGAR's order. The plain version of the kernel's walk.
    """
    i, j = int(bi), int(bj)
    if i == 0 and j == 0:
        return 0, 0, []
    ops: list[list[int]] = []  # [op, length], walked from the end

    def push(op: int):
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])

    state = "H"
    while True:
        d = int(dirs[i + j, i])
        if state == "H":
            src = d & 3
            if src == 0:
                break
            if src == 1:
                push(OP_M)
                i -= 1
                j -= 1
            elif src == 2:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            push(OP_D)  # gap in read: consumes a window base
            ext = (d >> 2) & 1
            j -= 1
            state = "E" if ext else "H"
        else:
            push(OP_I)  # gap in window: consumes a read base
            ext = (d >> 3) & 1
            i -= 1
            state = "F" if ext else "H"
    return i, j, [(n << 2) | op for op, n in reversed(ops)]


def format_cigar(runs) -> str:
    """Run-length ops (:func:`traceback_runs`) → a SAM-style CIGAR."""
    return "".join([f"{w >> 2}{OPS[w & 3]}" for w in runs])


def traceback(dirs: np.ndarray, bi: int, bj: int):
    """Walk the direction bits back from the best cell → (read_start,
    read_end, win_start, win_end, cigar) with half-open 0-based spans and
    a SAM-style cigar over M/I/D (I consumes read, D consumes window)."""
    rs, ws, runs = traceback_runs(dirs, bi, bj)
    return rs, int(bi), ws, int(bj), format_cigar(runs)


class Alignment(NamedTuple):
    """One read↔window local alignment (spans 0-based half-open)."""

    score: int
    read_start: int
    read_end: int
    win_start: int
    win_end: int
    cigar: str


def _pack_bucket(idxs, reads, wins, r_pad, w_pad):
    """Pad one bucket's pairs into the kernel layout."""
    b = len(idxs)
    r1 = r_pad + 1
    reads_p = np.full((b, r1), N_CODE, dtype=np.uint8)
    rlens = np.zeros(b, dtype=np.int32)
    wins_p = np.full((b, w_pad), N_CODE, dtype=np.uint8)
    wlens = np.zeros(b, dtype=np.int32)
    for row, n in enumerate(idxs):
        r, w = reads[n], wins[n]
        reads_p[row, 1:len(r) + 1] = r
        rlens[row] = len(r)
        wins_p[row, :len(w)] = w
        wlens[row] = len(w)
    return reads_p, rlens, wins_p, wlens


def alignments(meta: np.ndarray, runs: np.ndarray) -> list[Alignment]:
    """:func:`sw_align`'s outputs on the host (meta (6, B), and the run
    buffer's first rows, at least every pair's run count) → per-pair
    :class:`Alignment` list."""
    best, bi, bj, rs, ws, nruns = meta.tolist()
    cols = runs.T.tolist()
    return [Alignment(best[n], rs[n], bi[n], ws[n], bj[n],
                      format_cigar(cols[n][:nruns[n]]))
            for n in range(len(best))]


def align_bucket(reads_p, rlens, wins_p, wlens,
                 scores: Scores = DEFAULT_SCORES, device=None):
    """One padded bucket (numpy, :func:`_pack_bucket`'s layout) →
    per-pair :class:`Alignment` list: one :func:`sw_align` on ``device``
    (the card unless ``"cpu"``), then each pair's best, spans and run
    count and the filled rows of the run buffer to the host, where the
    CIGAR strings are formatted. The direction plane stays on the
    device."""
    dev = resolve_device(device)
    sc = np.asarray(scores.astuple(), dtype=np.int32)
    from ..obs.compiles import TRACKER

    sig = {"stage": "extend", "r_pad": reads_p.shape[1] - 1,
           "w_pad": wins_p.shape[1], "b": reads_p.shape[0]}
    with TIMER.stage("extend-kernel"), TRACKER.observe(
            "swalign", signature=sig, trigger="map_extend"):
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (reads_p, rlens, wins_p, wlens, sc)]
        meta, runs = obs.dispatch("swalign", sw_align, *args)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    with TIMER.stage("extend-d2h"):
        meta = meta.cpu().numpy()
        runs = runs[:int(meta[5].max())].cpu().numpy()
    with TIMER.stage("traceback"):
        return alignments(meta, runs)


def align_pairs(reads, wins, scores: Scores = DEFAULT_SCORES,
                dispatch=None, device=None) -> list[Alignment]:
    """Host entry: N (read, window) code pairs → N alignments.

    Pairs bucket by (r_pad, w_pad); each bucket is one wavefront on
    ``device`` (the card unless ``"cpu"``). ``dispatch``, when given,
    wraps each bucket call — the mapping pipeline passes its plan-Step
    runner there so extension rides the ``map`` fault site with
    per-bucket quarantine; ``None`` dispatches directly.
    """
    out: list[Alignment | None] = [None] * len(reads)
    groups: dict[tuple[int, int], list[int]] = {}
    for n, (r, w) in enumerate(zip(reads, wins)):
        groups.setdefault(bucket_shape(len(r), len(w)), []).append(n)
    for (r_pad, w_pad), idxs in sorted(groups.items()):
        packed = _pack_bucket(idxs, reads, wins, r_pad, w_pad)
        if dispatch is None:
            res = align_bucket(*packed, scores=scores, device=device)
        else:
            res = dispatch((r_pad, w_pad, len(idxs)),
                           lambda p=packed: align_bucket(
                               *p, scores=scores, device=device))
        for n, a in zip(idxs, res):
            out[n] = a
    return out  # type: ignore[return-value]


def oracle_align(read, win, scores: Scores = DEFAULT_SCORES
                 ) -> Alignment:
    """Oracle counterpart of one :func:`align_pairs` element."""
    r = encode_seq(read)
    w = encode_seq(win)
    best, bi, bj, dirs = sw_oracle(r, w, scores)
    rs, re_, ws, we, cig = traceback(dirs, bi, bj)
    return Alignment(best, rs, re_, ws, we, cig)
