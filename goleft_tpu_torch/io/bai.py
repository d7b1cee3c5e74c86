"""BAI (BAM index) codec, from the SAM specification section 5.2.

A copy of the JAX package's io/bai.py trimmed to what ``depth`` and
``indexcov`` use: parse (``read_bai``), region seek (``query_voffset``),
indexcov's per-16KB-tile sizes (``BaiIndex.sizes``: the deltas of
consecutive linear-index virtual offsets, indexcov/indexcov.go:78-80; a
reference with <2 linear intervals yields an empty list) and read
counts, and ``build_bai`` + ``write_bai``, which fabricate .bai fixtures
from BAMs written with io.bam.BamWriter. The stats pseudo-bin 37450
(0x924a) carries per-reference mapped/unmapped read counts.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

BAI_MAGIC = b"BAI\x01"
TILE_SHIFT = 14  # 16384-base linear-index windows, indexcov/types.go:15
STATS_DUMMY_BIN = 0x924A


class RefIndex:
    """One reference's index entries.

    ``bins`` parse lazily: the region-query path (query_voffset) only
    reads the linear index, and indexcov only needs intervals + stats.
    """

    __slots__ = ("intervals", "mapped", "unmapped", "_bins", "_raw")

    def __init__(self, bins: dict | None, intervals: np.ndarray,
                 mapped: int, unmapped: int, raw=None):
        self.intervals = intervals  # uint64 linear-index voffsets
        self.mapped = mapped  # -1 if no stats bin
        self.unmapped = unmapped
        self._bins = bins
        self._raw = raw  # (data, start, end) byte range of the bin table

    @property
    def bins(self) -> dict:
        """bin number -> list[(chunk_beg, chunk_end)] virtual offsets."""
        if self._bins is None:
            data, start, end = self._raw
            self._bins = _parse_bins(data, start, end)[0]
        return self._bins


@dataclass
class BaiIndex:
    refs: list[RefIndex]
    n_no_coor: int

    def sizes(self) -> list[np.ndarray]:
        """Per-reference int64 arrays of per-16KB-tile voffset deltas."""
        out = []
        for r in self.refs:
            iv = r.intervals.astype(np.int64)
            if len(iv) < 2:
                out.append(np.zeros(0, dtype=np.int64))
                continue
            d = np.diff(iv)
            if np.any(d < 0):
                raise ValueError("bai: negative voffset delta in linear index")
            out.append(d)
        return out

    @property
    def mapped_total(self) -> int:
        return sum(r.mapped for r in self.refs if r.mapped >= 0)

    @property
    def unmapped_total(self) -> int:
        return sum(r.unmapped for r in self.refs if r.unmapped >= 0)

    def reference_stats(self, tid: int) -> tuple[int, int] | None:
        r = self.refs[tid]
        if r.mapped < 0:
            return None
        return r.mapped, r.unmapped


def _parse_bins(data, start: int, end: int) -> tuple[dict, int, int]:
    """Bin table bytes [start, end) → (bins dict, mapped, unmapped)."""
    off = start
    bins: dict = {}
    mapped, unmapped = -1, -1
    while off < end:
        bno, n_chunk = struct.unpack_from("<Ii", data, off)
        off += 8
        chunks = np.frombuffer(
            data, dtype="<u8", count=2 * n_chunk, offset=off
        ).reshape(-1, 2)
        off += 16 * n_chunk
        if bno == STATS_DUMMY_BIN and n_chunk == 2:
            mapped = int(chunks[1, 0])
            unmapped = int(chunks[1, 1])
        else:
            bins[int(bno)] = [tuple(map(int, c)) for c in chunks]
    return bins, mapped, unmapped


def read_bai(path_or_bytes) -> BaiIndex:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        from . import remote

        data = remote.fetch_bytes(path_or_bytes)
    if data[:4] != BAI_MAGIC:
        raise ValueError("not a BAI file (bad magic)")

    from . import native

    # a negative scan result (truncated/corrupt) raises with a specific
    # message — only lib-unavailability (None) falls back to pure Python
    scan = native.bai_scan(data)
    if scan is not None:
        refs = []
        last_end = 8
        for r in range(len(scan["n_intv"])):
            n_intv = int(scan["n_intv"][r])
            ioff = int(scan["intv_off"][r])
            intervals = np.frombuffer(
                data, dtype="<u8", count=n_intv, offset=ioff
            ).copy()
            refs.append(RefIndex(
                None, intervals, int(scan["mapped"][r]),
                int(scan["unmapped"][r]),
                raw=(data, int(scan["bins_start"][r]),
                     int(scan["bins_end"][r])),
            ))
            last_end = ioff + 8 * n_intv
        n_no_coor = 0
        if last_end + 8 <= len(data):
            (n_no_coor,) = struct.unpack_from("<Q", data, last_end)
        return BaiIndex(refs, n_no_coor)

    # pure-Python fallback: eager parse. Corruption surfaces as the
    # module's typed ValueError (same contract as the native scanner's
    # negative codes) — struct/numpy errors from truncated or
    # garbage-count bytes must not leak (tests/test_index_fuzz.py).
    try:
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        if n_ref < 0 or n_ref > len(data) // 8 + 1:
            # every reference costs >= 8 bytes, so this bound rejects
            # only counts the bytes cannot hold — parity with the
            # native scanner, which errors on the same inputs
            raise ValueError(f"bai: implausible n_ref {n_ref}")
        refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            if n_bin < 0:
                raise ValueError("bai: negative bin count")
            bins_start = off
            for _ in range(n_bin):
                _bno, n_chunk = struct.unpack_from("<Ii", data, off)
                if n_chunk < 0 or off + 8 + 16 * n_chunk > len(data):
                    raise ValueError("bai: truncated bin chunks")
                off += 8 + 16 * n_chunk
            bins, mapped, unmapped = _parse_bins(data, bins_start, off)
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            if n_intv < 0 or off + 8 * n_intv > len(data):
                raise ValueError("bai: truncated linear index")
            intervals = np.frombuffer(
                data, dtype="<u8", count=n_intv, offset=off
            ).copy()
            off += 8 * n_intv
            refs.append(RefIndex(bins, intervals, mapped, unmapped))
        n_no_coor = 0
        if off + 8 <= len(data):
            (n_no_coor,) = struct.unpack_from("<Q", data, off)
        return BaiIndex(refs, n_no_coor)
    except struct.error as e:
        raise ValueError(f"bai: truncated index ({e})")


def write_bai(idx: BaiIndex, path: str) -> None:
    out = bytearray(BAI_MAGIC)
    out += struct.pack("<i", len(idx.refs))
    for r in idx.refs:
        bins = dict(r.bins)
        n_bin = len(bins) + (1 if r.mapped >= 0 else 0)
        out += struct.pack("<i", n_bin)
        for bno in sorted(bins):
            chunks = bins[bno]
            out += struct.pack("<Ii", bno, len(chunks))
            for beg, end in chunks:
                out += struct.pack("<QQ", beg, end)
        if r.mapped >= 0:
            out += struct.pack("<Ii", STATS_DUMMY_BIN, 2)
            out += struct.pack("<QQ", 0, 0)
            out += struct.pack("<QQ", r.mapped, r.unmapped)
        out += struct.pack("<i", len(r.intervals))
        out += r.intervals.astype("<u8").tobytes()
    out += struct.pack("<Q", idx.n_no_coor)
    with open(path, "wb") as fh:
        fh.write(out)


def build_bai(bam_path: str) -> BaiIndex:
    """Index a coordinate-sorted BAM: bins + linear index + stats bins.

    Linear-index semantics per spec 5.1.3: entry w holds the smallest
    virtual offset of any alignment overlapping window w; gaps are filled
    with the preceding value so tile deltas are non-negative.
    """
    from .bam import BamReader, reg2bin
    from .bam import FLAG_UNMAPPED

    rdr = BamReader.from_file(bam_path)
    n_ref = len(rdr.header.ref_names)
    bins: list[dict] = [{} for _ in range(n_ref)]
    lin: list[dict] = [{} for _ in range(n_ref)]
    mapped = [0] * n_ref
    unmapped = [0] * n_ref
    n_no_coor = 0
    while True:
        v0 = rdr._r.tell_virtual()
        rec = rdr.next_record()
        if rec is None:
            break
        v1 = rdr._r.tell_virtual()
        if rec.tid < 0:
            n_no_coor += 1
            continue
        if rec.flag & FLAG_UNMAPPED:
            unmapped[rec.tid] += 1
        else:
            mapped[rec.tid] += 1
        end = max(rec.ref_end, rec.pos + 1)
        b = reg2bin(rec.pos, end)
        bins[rec.tid].setdefault(b, []).append((v0, v1))
        for w in range(rec.pos >> TILE_SHIFT, (end - 1 >> TILE_SHIFT) + 1):
            cur = lin[rec.tid].get(w)
            if cur is None or v0 < cur:
                lin[rec.tid][w] = v0
    refs = []
    for tid in range(n_ref):
        merged = {
            b: _merge_chunks(ch) for b, ch in bins[tid].items()
        }
        if lin[tid]:
            n_intv = max(lin[tid]) + 1
            iv = np.zeros(n_intv, dtype=np.uint64)
            prev = min(lin[tid].values())
            for w in range(n_intv):
                if w in lin[tid]:
                    prev = lin[tid][w]
                iv[w] = prev
        else:
            iv = np.zeros(0, dtype=np.uint64)
        refs.append(RefIndex(merged, iv, mapped[tid], unmapped[tid]))
    return BaiIndex(refs, n_no_coor)


def query_voffset(idx: BaiIndex, tid: int, start: int) -> int | None:
    """Virtual offset at which to begin scanning for records overlapping
    positions ≥ start on tid, via the linear index (spec 5.1.3: entry w is
    the smallest voffset of an alignment overlapping window w — so long
    reads spanning into the region are caught). None → no data."""
    r = idx.refs[tid]
    if len(r.intervals) == 0:
        return None
    w = min(start >> TILE_SHIFT, len(r.intervals) - 1)
    return int(r.intervals[w])


def _merge_chunks(chunks: list[tuple[int, int]]) -> list[tuple[int, int]]:
    chunks = sorted(chunks)
    out = [list(chunks[0])]
    for beg, end in chunks[1:]:
        if beg <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([beg, end])
    return [tuple(c) for c in out]
