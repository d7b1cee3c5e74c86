"""BAM container codec, from the SAM/BAM specification (section 4).

A copy of the JAX package's io/bam.py trimmed to what ``depth`` uses on
BAM input: header parsing, record decode into columnar arrays, the lazy
native region-streaming handle whose ``read_segments`` feeds the depth
kernel, the pure-Python fallback adapter, and the record writer used to
fabricate test fixtures. CRAM input is not ported yet.

CIGAR op semantics (spec table): M/=/X consume query+ref, D/N consume ref
only, I/S consume query only, H/P consume neither. Depth counts only
query+ref-consuming ops (the ``samtools depth`` default), so a record's
coverage contribution is its list of M/=/X blocks.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from .bgzf import BgzfReader, BgzfWriter

BAM_MAGIC = b"BAM\x01"

CIGAR_OPS = "MIDNSHP=X"
# ops that consume the reference
_CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.int64)
# ops that consume the query
_CONSUMES_QUERY = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=np.int64)
# ops that count toward depth (query+ref aligned): M, =, X
_IS_ALIGNED = np.array([1, 0, 0, 0, 0, 0, 0, 1, 1], dtype=np.bool_)

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
_NT16_CODE = {c: i for i, c in enumerate(SEQ_NT16)}

FLAG_UNMAPPED = 0x4
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400

# samtools depth default skip mask: UNMAP | SECONDARY | QCFAIL | DUP
DEPTH_SKIP_FLAGS = FLAG_UNMAPPED | FLAG_SECONDARY | FLAG_QCFAIL | FLAG_DUP


@dataclass
class BamHeader:
    text: str
    ref_names: list[str]
    ref_lens: list[int]
    _name_to_tid: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self._name_to_tid = {n: i for i, n in enumerate(self.ref_names)}

    def tid(self, name: str) -> int:
        return self._name_to_tid[name]


@dataclass
class BamRecord:
    """One decoded alignment (used by build_bai and tests)."""

    tid: int
    pos: int
    mapq: int
    flag: int
    mate_tid: int
    mate_pos: int
    tlen: int
    name: str
    cigar: list[tuple[int, int]]  # (oplen, opcode)
    seq: str
    qual: bytes

    @property
    def ref_end(self) -> int:
        n = self.pos
        for oplen, op in self.cigar:
            n += oplen * int(_CONSUMES_REF[op])
        return n

    def aligned_blocks(self) -> list[tuple[int, int]]:
        out = []
        p = self.pos
        for oplen, op in self.cigar:
            if _IS_ALIGNED[op]:
                out.append((p, p + oplen))
            if _CONSUMES_REF[op]:
                p += oplen
        return out


@dataclass
class ReadColumns:
    """Columnar read tuples. ``seg_*`` arrays have one row per M/=/X
    CIGAR block; ``seg_read`` maps each segment back to its read row."""

    tid: np.ndarray  # int32  (n_reads,)
    pos: np.ndarray  # int32
    end: np.ndarray  # int32  ref end (pos + ref-consumed length)
    mapq: np.ndarray  # uint8
    flag: np.ndarray  # uint16
    tlen: np.ndarray  # int32
    read_len: np.ndarray  # int32
    mate_pos: np.ndarray  # int32
    single_m: np.ndarray  # bool: cigar is exactly one M op
    seg_tid: np.ndarray  # int32 (n_segs,)
    seg_start: np.ndarray  # int32
    seg_end: np.ndarray  # int32
    seg_read: np.ndarray  # int32 index into read rows

    @property
    def n_reads(self) -> int:
        return len(self.pos)


def _decode_record(buf: bytes, want_seq: bool = False) -> BamRecord:
    (tid, pos, l_rn, mapq, _bin, n_cig, flag, l_seq, mtid, mpos, tlen
     ) = struct.unpack_from("<iiBBHHHiiii", buf, 0)
    off = 32
    name = buf[off : off + l_rn - 1].decode()
    off += l_rn
    cigar = []
    for _ in range(n_cig):
        (v,) = struct.unpack_from("<I", buf, off)
        cigar.append((v >> 4, v & 0xF))
        off += 4
    seq = ""
    qual = b""
    if want_seq:
        nb = (l_seq + 1) // 2
        sq = buf[off : off + nb]
        chars = []
        for i in range(l_seq):
            b = sq[i // 2]
            code = (b >> 4) if i % 2 == 0 else (b & 0xF)
            chars.append(SEQ_NT16[code])
        seq = "".join(chars)
        qual = buf[off + nb : off + nb + l_seq]
    return BamRecord(tid, pos, mapq, flag, mtid, mpos, tlen, name, cigar,
                     seq, qual)


class BamReader:
    """Sequential + random-access BAM reader over an in-memory file."""

    def __init__(self, data: bytes):
        if data[:4] == b"CRAM":
            raise ValueError("CRAM input is not supported by this port yet")
        self._r = BgzfReader(data)
        magic = self._r.read(4)
        if magic != BAM_MAGIC:
            raise ValueError("not a BAM file (bad magic)")
        (l_text,) = struct.unpack("<i", self._r.read(4))
        text = self._r.read(l_text).rstrip(b"\x00").decode()
        (n_ref,) = struct.unpack("<i", self._r.read(4))
        names, lens = [], []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._r.read(4))
            names.append(self._r.read(l_name)[:-1].decode())
            (l_ref,) = struct.unpack("<i", self._r.read(4))
            lens.append(l_ref)
        self.header = BamHeader(text, names, lens)
        self._body_voffset = self._r.tell_virtual()

    @classmethod
    def from_file(cls, path: str) -> "BamReader":
        with open(path, "rb") as fh:
            return cls(fh.read())

    def seek_virtual(self, voffset: int) -> None:
        self._r.seek_virtual(voffset)

    def __iter__(self):
        return self

    def __next__(self) -> BamRecord:
        rec = self.next_record(want_seq=True)
        if rec is None:
            raise StopIteration
        return rec

    def next_record(self, want_seq: bool = False) -> BamRecord | None:
        szb = self._r.read(4)
        if len(szb) < 4:
            return None
        (block_size,) = struct.unpack("<i", szb)
        if block_size < 32:
            raise ValueError("bam: malformed record geometry")
        buf = self._r.read(block_size)
        if len(buf) < block_size:
            raise ValueError("bam: truncated record")
        return _decode_record(buf, want_seq=want_seq)

    def read_columns(
        self,
        tid: int | None = None,
        start: int = 0,
        end: int | None = None,
    ) -> ReadColumns:
        """Decode records into columnar arrays.

        When ``tid`` is given, only records on that reference overlapping
        [start, end) are kept (the stream is still scanned sequentially from
        the current position; pair with a BAI region seek for random access).
        """
        tids, poss, ends, mapqs, flags, tlens, rlens = \
            [], [], [], [], [], [], []
        mposs, singlem = [], []
        seg_t, seg_s, seg_e, seg_r = [], [], [], []
        n = 0
        while True:
            szb = self._r.read(4)
            if len(szb) < 4:
                break
            (block_size,) = struct.unpack("<i", szb)
            if block_size < 32:
                raise ValueError("bam: malformed record geometry")
            buf = self._r.read(block_size)
            (rtid, pos, l_rn, mapq, _bin, n_cig, flag, l_seq
             ) = struct.unpack_from("<iiBBHHHi", buf, 0)
            if 32 + l_rn + 4 * n_cig > block_size:
                raise ValueError("bam: malformed record geometry")
            if tid is not None:
                if rtid > tid or rtid < 0:
                    break  # sorted BAM: past the target chromosome
                if rtid < tid:
                    continue
                if end is not None and pos >= end:
                    break
            mpos, tlen = struct.unpack_from("<ii", buf, 24)
            off = 32 + l_rn
            cig = np.frombuffer(buf, dtype=np.uint32, count=n_cig, offset=off)
            oplen = (cig >> 4).astype(np.int64)
            opc = (cig & 0xF).astype(np.int64)
            ref_len = int(np.sum(oplen * _CONSUMES_REF[opc]))
            rend = pos + ref_len
            if tid is not None and rend <= start:
                continue
            row = n
            n += 1
            tids.append(rtid)
            poss.append(pos)
            ends.append(rend)
            mapqs.append(mapq)
            flags.append(flag)
            tlens.append(tlen)
            # read length from l_seq, falling back to the CIGAR query
            # length when SEQ is omitted ('*', l_seq=0)
            if l_seq > 0:
                rlens.append(l_seq)
            else:
                rlens.append(int(np.sum(oplen * _CONSUMES_QUERY[opc])))
            mposs.append(mpos)
            singlem.append(n_cig == 1 and (cig[0] & 0xF) == 0)
            ref_steps = oplen * _CONSUMES_REF[opc]
            block_starts = pos + np.concatenate(
                ([0], np.cumsum(ref_steps[:-1]))
            )
            al = _IS_ALIGNED[opc]
            for bs, ln in zip(block_starts[al], oplen[al]):
                seg_t.append(rtid)
                seg_s.append(int(bs))
                seg_e.append(int(bs + ln))
                seg_r.append(row)
        return ReadColumns(
            np.asarray(tids, dtype=np.int32),
            np.asarray(poss, dtype=np.int32),
            np.asarray(ends, dtype=np.int32),
            np.asarray(mapqs, dtype=np.uint8),
            np.asarray(flags, dtype=np.uint16),
            np.asarray(tlens, dtype=np.int32),
            np.asarray(rlens, dtype=np.int32),
            np.asarray(mposs, dtype=np.int32),
            np.asarray(singlem, dtype=bool),
            np.asarray(seg_t, dtype=np.int32),
            np.asarray(seg_s, dtype=np.int32),
            np.asarray(seg_e, dtype=np.int32),
            np.asarray(seg_r, dtype=np.int32),
        )


def _cols_from_decode(out: dict) -> ReadColumns:
    """Native bam_decode output dict → ReadColumns."""
    return ReadColumns(
        out["tid"], out["pos"], out["end"], out["mapq"],
        out["flag"], out["tlen"], out["read_len"],
        out["mate_pos"], out["single_m"].astype(bool),
        out["tid"][out["seg_read"]] if out["n_reads"] else
        np.zeros(0, np.int32),
        out["seg_start"], out["seg_end"], out["seg_read"],
    )


def _parse_header_buf(buf) -> tuple[BamHeader, int]:
    """Parse the BAM header block from an uncompressed buffer; returns
    (header, offset of first alignment record). Corrupt header geometry
    surfaces as ValueError."""
    if bytes(buf[:4]) != BAM_MAGIC:
        raise ValueError("not a BAM file (bad magic)")
    try:
        (l_text,) = struct.unpack_from("<i", buf, 4)
        text = bytes(buf[8 : 8 + l_text]).rstrip(b"\x00").decode()
        off = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", buf, off)
        off += 4
        if l_text < 0 or n_ref < 0:
            raise ValueError("bam: negative header length")
        names, lens = [], []
        for _ in range(n_ref):
            (l_name,) = struct.unpack_from("<i", buf, off)
            names.append(
                bytes(buf[off + 4 : off + 4 + l_name - 1]).decode())
            (l_ref,) = struct.unpack_from("<i", buf, off + 4 + l_name)
            lens.append(l_ref)
            off += 8 + l_name
    except (struct.error, UnicodeDecodeError) as e:
        raise ValueError(f"bam: corrupt header ({e})") from e
    return BamHeader(text, names, lens), off


class BamFile:
    """Native-decoded BAM in lazy (region-streaming) mode.

    Only the BGZF block table is built up front; each region inflates
    just the block range it needs, so host memory scales with the
    shard, not the file. All native calls release the GIL, so shard
    decode threads scale. Requires the native library.
    """

    def __init__(self, data):
        from . import native

        if bytes(data[:4]) == b"CRAM":
            raise ValueError("CRAM input is not supported by this port yet")
        scan = native.bgzf_scan(data)
        if scan is None:
            raise RuntimeError("BamFile requires the native library")
        self._co, self._uo, self._total = scan
        self._comp = native._as_u8(data)
        self.header, self._body_start = self._parse_header()

    def _parse_header(self):
        from . import native

        # inflate a growing block prefix until the header parses
        nb = len(self._co)
        k = min(8, nb)
        while True:
            c_end = int(self._co[k]) if k < nb else len(self._comp)
            cap = int(self._uo[k]) if k < nb else self._total
            buf = native.bgzf_inflate_range(self._comp, 0, c_end, cap)
            try:
                return _parse_header_buf(bytes(buf))
            except Exception:
                if k >= nb:
                    raise
                k = min(k * 4, nb)

    @classmethod
    def from_file(cls, path: str) -> "BamFile":
        import mmap

        # POSIX mmap stays valid after the fd closes
        with open(path, "rb") as fh:
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        return cls(mm)

    def _block_of(self, voff: int) -> int:
        coff = voff >> 16
        if coff > int(self._co[-1]):
            # a truncated file with its stale .bai would otherwise decode
            # as silent zero depth for every shard beyond the cut
            raise ValueError(
                "bam: virtual offset beyond file end (truncated file "
                "or stale index)"
            )
        blk = int(np.searchsorted(self._co, coff, side="right")) - 1
        return max(blk, 0)

    def read_columns(self, tid: int | None = None, start: int = 0,
                     end: int | None = None,
                     voffset: int | None = None) -> ReadColumns:
        """Decode records on ``tid`` overlapping [start, end) from the
        block window starting at ``voffset``, growing the window until
        the decoder reports a clean stop."""
        from . import native

        nb = len(self._co)
        if voffset is not None:
            b0 = self._block_of(voffset)
            in_block = voffset & 0xFFFF
        else:
            b0 = 0
            in_block = self._body_start  # header is in block 0's stream
        b1 = nb
        while True:
            c0 = int(self._co[b0])
            c_end = int(self._co[b1]) if b1 < nb else len(self._comp)
            cap = (int(self._uo[b1]) if b1 < nb else self._total) - int(
                self._uo[b0])
            body = native.bgzf_inflate_range(self._comp, c0, c_end, cap)
            out = native.bam_decode(
                body, in_block, -1 if tid is None else tid, start,
                -1 if end is None else end)
            mid_stop = in_block + out["consumed"] < len(body)
            if (out["done"] and mid_stop) or b1 >= nb:
                return _cols_from_decode(out)
            b1 = min(b1 + max(b1 - b0, 64), nb)

    def read_segments(self, tid: int, start: int, end: int,
                      min_mapq: int, flag_mask: int,
                      voffset: int | None = None):
        """(seg_start, seg_end) int32 arrays of the region's FILTERED
        clipped M/=/X segments — the depth path's host stage, streamed
        through the C walk (no column arrays, no uncompressed body)."""
        from . import native

        if end is None or end < 0:
            raise ValueError("read_segments requires an explicit end")
        if voffset is not None:
            c_begin = int(self._co[self._block_of(voffset)])
            in_block = voffset & 0xFFFF
        else:
            c_begin = 0
            in_block = self._body_start
        # cap heuristic: ~5x coverage of 100bp reads over the span; an
        # undersized cap costs one exact-size re-walk
        return native.bam_segments_stream(
            self._comp, c_begin, in_block, tid, start, end,
            min_mapq, flag_mask,
            cap_hint=max(65536, (end - start) // 16))


class _PyBamAdapter:
    """BamFile-compatible shard decoder over the pure-Python reader."""

    def __init__(self, data):
        self._data = data if isinstance(data, bytes) else bytes(data)
        self.header = BamReader(self._data).header

    def read_columns(self, tid=None, start=0, end=None,
                     voffset=None) -> ReadColumns:
        rdr = BamReader(self._data)
        if voffset is not None:
            rdr.seek_virtual(voffset)
        return rdr.read_columns(tid=tid, start=start, end=end)

    def read_segments(self, tid: int, start: int, end: int,
                      min_mapq: int, flag_mask: int,
                      voffset: int | None = None):
        """Same contract as BamFile.read_segments, over the pure-Python
        reader."""
        cols = self.read_columns(tid=tid, start=start, end=end,
                                 voffset=voffset)
        return filter_clip_segments(cols, start, end, min_mapq,
                                    flag_mask)


def open_bam_file(path: str):
    """Open a BAM from disk: the lazy native handle (mmap of the
    compressed file) when the native library is available, else the
    pure-Python adapter. Corrupt input exits with one clean line."""
    import zlib

    from . import native

    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic == b"CRAM":
        raise SystemExit(f"{path}: CRAM input is not supported by this "
                         "port yet")
    try:
        if native.get_lib() is not None:
            return BamFile.from_file(path)
        with open(path, "rb") as fh:
            return _PyBamAdapter(fh.read())
    except (ValueError, zlib.error) as e:
        raise SystemExit(f"{path}: {e}") from e


def reg2bin(beg: int, end: int) -> int:
    """SAM spec section 5.3 bin number for [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BamWriter:
    """Minimal BAM writer for fabricating hermetic test fixtures."""

    def __init__(self, fh, header_text: str, ref_names: list[str],
                 ref_lens: list[int], level: int = 6,
                 block_size: int = 0xFF00):
        self._w = BgzfWriter(fh, level=level, block_size=block_size)
        self.ref_names = ref_names
        text = header_text.encode()
        self._w.write(BAM_MAGIC + struct.pack("<i", len(text)) + text)
        self._w.write(struct.pack("<i", len(ref_names)))
        for nm, ln in zip(ref_names, ref_lens):
            nb = nm.encode() + b"\x00"
            self._w.write(struct.pack("<i", len(nb)) + nb +
                          struct.pack("<i", ln))

    def write_record(
        self,
        tid: int,
        pos: int,
        cigar: list[tuple[int, int]],
        mapq: int = 60,
        flag: int = 0,
        name: str = "r",
        seq: str | None = None,
        mate_tid: int = -1,
        mate_pos: int = -1,
        tlen: int = 0,
    ) -> None:
        if seq is None:
            qlen = sum(ln for ln, op in cigar if _CONSUMES_QUERY[op])
            seq = "A" * qlen
        l_seq = len(seq)
        nb = name.encode() + b"\x00"
        end = pos + sum(ln for ln, op in cigar if _CONSUMES_REF[op])
        body = struct.pack(
            "<iiBBHHHiiii", tid, pos, len(nb), mapq,
            reg2bin(pos, max(end, pos + 1)), len(cigar), flag, l_seq,
            mate_tid, mate_pos, tlen,
        )
        body += nb
        for ln, op in cigar:
            body += struct.pack("<I", (ln << 4) | op)
        packed = bytearray()
        for i in range(0, l_seq, 2):
            hi = _NT16_CODE.get(seq[i], 15) << 4
            lo = _NT16_CODE.get(seq[i + 1], 15) if i + 1 < l_seq else 0
            packed.append(hi | lo)
        body += bytes(packed) + b"\xff" * l_seq
        self._w.write(struct.pack("<i", len(body)) + body)

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def filter_clip_segments(cols, start: int, end: int, min_mapq: int,
                         flag_mask: int):
    """Decoded columns → (seg_start, seg_end) filtered/clipped segment
    arrays — the host reference semantics of the C streaming extractor
    (``bam_segments_stream``)."""
    n = len(cols.seg_start)
    if not n:
        z = np.empty(0, np.int32)
        return z, z.copy()
    ok = (cols.mapq >= min_mapq) & ((cols.flag & flag_mask) == 0)
    kp = ok[cols.seg_read]
    s = np.clip(cols.seg_start[kp], start, end).astype(np.int32)
    e = np.clip(cols.seg_end[kp], start, end).astype(np.int32)
    nz = e > s
    return s[nz], e[nz]


def parse_cigar(s: str) -> list[tuple[int, int]]:
    """'100M' → [(100, 0)]; convenience for tests."""
    out = []
    num = ""
    for ch in s:
        if ch.isdigit():
            num += ch
        else:
            out.append((int(num), CIGAR_OPS.index(ch)))
            num = ""
    return out
