"""Vectorised BAM + BAI writer for large fabricated fixtures.

The per-record :class:`~goleft_tpu_torch.io.bam.BamWriter` and
:func:`~goleft_tpu_torch.io.bai.build_bai` run at Python speed, far too
slow for millions of reads. This writer builds every record of a
single-reference, coordinate-sorted BAM at once with numpy, deflates the
stream in 65,280-byte BGZF blocks and derives the BAI (bins, linear
index, stats bin) from the virtual offsets it already knows. The index
equals what ``build_bai`` computes from the written file.

Records carry no SEQ/QUAL (``l_seq = 0``, the spec's '*'): depth reads
only positions, CIGARs, MAPQ and flags. Read names are ``r%07d`` padded
so that every record has the same size whatever its CIGAR.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from goleft_tpu_torch.io.bai import TILE_SHIFT, BaiIndex, RefIndex
from goleft_tpu_torch.io.bam import BAM_MAGIC, _CONSUMES_REF, parse_cigar
from goleft_tpu_torch.io.bgzf import BGZF_EOF, WRITE_CHUNK

_NAME_DIGITS = 7


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Vectorised SAM spec section 5.3 bin of [beg, end)."""
    e = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9),
                          (26, 1)):
        hit = ~done & ((beg >> shift) == (e >> shift))
        out[hit] = offset + (beg[hit] >> shift)
        done |= hit
    return out


def _deflate(chunk: bytes, level: int) -> bytes:
    from goleft_tpu_torch.io import native

    blob = native.bgzf_deflate_block(chunk, level)
    if blob is not None:
        return blob
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(chunk) + co.flush()
    bsize = len(cdata) + 26
    header = struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                         0x42, 0x43, 2, bsize - 1)
    return header + cdata + struct.pack(
        "<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk))


def write_bam_bulk(path: str, ref_name: str, ref_len: int,
                   pos: np.ndarray, cigar_idx: np.ndarray,
                   cigars: list[str], mapq: np.ndarray, flag: np.ndarray,
                   header_text: str | None = None,
                   level: int = 1) -> BaiIndex:
    """Write reads on one reference to ``path``; return their BAI.

    ``pos`` must be sorted; read i has CIGAR ``cigars[cigar_idx[i]]``.
    """
    pos = np.asarray(pos, np.int64)
    cigar_idx = np.asarray(cigar_idx, np.int64)
    n = len(pos)
    if n and np.any(pos[1:] < pos[:-1]):
        raise ValueError("write_bam_bulk: positions must be sorted")
    if n >= 10 ** _NAME_DIGITS:
        raise ValueError("write_bam_bulk: too many reads")
    parsed = [parse_cigar(c) for c in cigars]
    max_ops = max(len(c) for c in parsed)
    n_cig = np.array([len(c) for c in parsed], np.int64)[cigar_idx]
    ref_span = np.array([sum(ln * int(_CONSUMES_REF[op]) for ln, op in c)
                         for c in parsed], np.int64)[cigar_idx]
    end = pos + ref_span
    l_rn = 2 + _NAME_DIGITS + 4 * (max_ops - n_cig)  # 'r' + digits + pad + NUL
    block = 32 + 2 + _NAME_DIGITS + 4 * max_ops  # same for every record
    rec = np.zeros((n, 4 + block), np.uint8)

    def put(col: int, values, dtype: str):
        v = np.ascontiguousarray(np.asarray(values).astype(dtype))
        w = v.dtype.itemsize
        rec[:, col:col + w] = v.view(np.uint8).reshape(n, w)

    put(0, np.full(n, block), "<i4")
    put(4, np.zeros(n), "<i4")  # refID
    put(8, pos, "<i4")
    put(12, l_rn, "u1")
    put(13, mapq, "u1")
    put(14, _reg2bin(pos, np.maximum(end, pos + 1)), "<u2")
    put(16, n_cig, "<u2")
    put(18, flag, "<u2")
    put(20, np.zeros(n), "<i4")  # l_seq
    put(24, np.full(n, -1), "<i4")  # next refID
    put(28, np.full(n, -1), "<i4")  # next pos
    put(32, np.zeros(n), "<i4")  # tlen
    name = 36
    rec[:, name] = ord("r")
    idx = np.arange(n)
    for k in range(_NAME_DIGITS):
        rec[:, name + 1 + k] = ord("0") + (idx // 10 ** (
            _NAME_DIGITS - 1 - k)) % 10
    for t, ops in enumerate(parsed):
        rows = np.flatnonzero(cigar_idx == t)
        pad = 4 * (max_ops - len(ops))
        rec[np.ix_(rows, name + 1 + _NAME_DIGITS + np.arange(pad))] = \
            ord("_")
        cig = name + 2 + _NAME_DIGITS + pad  # after the NUL
        words = np.array([(ln << 4) | op for ln, op in ops], "<u4")
        rec[np.ix_(rows, cig + np.arange(4 * len(ops)))] = \
            words.view(np.uint8)[None, :]

    text = (header_text if header_text is not None else
            f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{ref_name}\t"
            f"LN:{ref_len}\n").encode()
    nm = ref_name.encode() + b"\x00"
    head = (BAM_MAGIC + struct.pack("<i", len(text)) + text
            + struct.pack("<i", 1) + struct.pack("<i", len(nm)) + nm
            + struct.pack("<i", ref_len))
    stream = head + rec.tobytes()
    coffs = []
    off = 0
    with open(path, "wb") as fh:
        for i in range(0, len(stream), WRITE_CHUNK):
            blob = _deflate(stream[i:i + WRITE_CHUNK], level)
            coffs.append(off)
            fh.write(blob)
            off += len(blob)
        fh.write(BGZF_EOF)
    coffs = np.array(coffs + [off], np.uint64)

    # virtual offset before each record and after the last, as a reader
    # that loads a block only when it needs its bytes reports them: an
    # offset on a block boundary names the end of the previous block
    u = len(head) + np.arange(n + 1, dtype=np.int64) * (4 + block)
    blk = u // WRITE_CHUNK
    within = u % WRITE_CHUNK
    edge = (within == 0) & (blk > 0)
    blk[edge] -= 1
    within[edge] = WRITE_CHUNK
    voff = (coffs[blk] << np.uint64(16)) | within.astype(np.uint64)
    return _index(pos, end, flag, voff)


def _index(pos, end, flag, voff) -> BaiIndex:
    n = len(pos)
    if n == 0:
        return BaiIndex([RefIndex({}, np.zeros(0, np.uint64), 0, 0)], 0)
    end1 = np.maximum(end, pos + 1)
    bins = _reg2bin(pos, end1)
    # bins: each run of consecutive records in one bin is one chunk (the
    # runs of one bin never touch, so nothing merges)
    first = np.flatnonzero(np.r_[True, bins[1:] != bins[:-1]])
    last = np.r_[first[1:], n] - 1
    chunks: dict[int, list[tuple[int, int]]] = {}
    for b, lo, hi in zip(bins[first].tolist(), voff[first].tolist(),
                         voff[last + 1].tolist()):
        chunks.setdefault(b, []).append((lo, hi))
    # linear index: smallest voffset of a record overlapping each 16 kb
    # window; windows no record touches repeat the previous value
    w_lo = pos >> TILE_SHIFT
    w_hi = (end1 - 1) >> TILE_SHIFT
    reps = w_hi - w_lo + 1
    rec_of = np.repeat(np.arange(n), reps)
    wins = w_lo[rec_of] + (np.arange(len(rec_of))
                           - np.repeat(np.cumsum(reps) - reps, reps))
    n_intv = int(wins.max()) + 1
    lin = np.full(n_intv, np.iinfo(np.uint64).max, np.uint64)
    np.minimum.at(lin, wins, voff[rec_of])
    touched = np.zeros(n_intv, bool)
    touched[wins] = True
    src = np.maximum.accumulate(np.where(touched, np.arange(n_intv), -1))
    intervals = np.where(src >= 0, lin[np.maximum(src, 0)],
                         lin[touched].min())
    unmapped = int(np.count_nonzero(np.asarray(flag) & 0x4))
    return BaiIndex([RefIndex(chunks, intervals.astype(np.uint64),
                              n - unmapped, unmapped)], 0)

