"""CRAM 3.0 container/slice codec, clean-room from the CRAM specification.

A copy of the JAX package's io/cram.py on its Python codec paths, for
the port's CRAM input (``depth`` and ``cohortdepth``). The
``block_decoder`` hook of :class:`CramFile` is where
ops/rans_device.py's DeviceBlockDecoder runs the rANS-Nx16 entropy
stage on the card. A remote (``https://``, ``s3://``) path is staged once
through io/remote.py, its ``.crai`` sibling too.
Container decode is timed in two stages of utils/profiling.py, summed
over threads: ``cram.blocks`` (block framing and entropy decode, host
or device) and ``cram.records`` (record decode into columns).

Round 1 refused CRAM alignment decode (the reference accepts CRAM
everywhere via samtools/biogo: covstats/covstats.go:229 smoove
shared.NewReader, depth/depth.go:45 samtools, indexcov/indexcov.go:359-371
CRAM headers). This module decodes CRAM 3.0 records into the same
columnar ``ReadColumns`` feed the BAM path produces, so depth / covstats
/ cohortdepth accept .cram inputs.

Scope (everything the depth tools need):
  - file definition, containers, blocks (raw/gzip/bzip2/lzma/rANS-4x8)
  - compression header: preservation map (RN/AP/RR/SM/TD), data-series
    and tag encoding maps
  - codecs: EXTERNAL, HUFFMAN (canonical, incl. the common 0-bit
    single-symbol case), BETA, GAMMA, BYTE_ARRAY_LEN, BYTE_ARRAY_STOP
  - slice decode: BF/CF/RI/RL/AP(delta)/RG/RN/mate/TL+tags/features/
    MQ/QS with ref-span reconstruction from features (S/I/i/D/N/H/P)
  - .crai-driven random access (container offsets per region)

Bases themselves are not reconstructed (depth counts alignment spans,
never sequence), so reference-based decoding (RR) only needs feature
bookkeeping — no FASTA round trip. A fixture writer (CramWriter) and a
rANS-4x8 order-0 encoder live alongside so the test suite can fabricate
hermetic .cram files and round-trip the decoder without copying any
reference test data.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..obs.logging import get_logger as _get_logger
from ..utils.profiling import StageTimer
from .crai import load_crai_entries

_SPANS = StageTimer()

CRAM_MAGIC = b"CRAM"

# block compression methods
M_RAW, M_GZIP, M_BZIP2, M_LZMA, M_RANS = 0, 1, 2, 3, 4
M_RANSNX16, M_ARITH, M_FQZCOMP, M_TOK3 = 5, 6, 7, 8
# block content types
CT_FILE_HEADER, CT_COMP_HEADER, CT_SLICE_HEADER = 0, 1, 2
CT_EXTERNAL, CT_CORE = 4, 5

# CRAM record flags (CF)
CF_QS_STORED = 0x1
CF_DETACHED = 0x2
CF_MATE_DOWNSTREAM = 0x4
CF_NO_SEQ = 0x8

# BAM flag bits reconstructed from MF
MF_MATE_REVERSE = 0x1
MF_MATE_UNMAPPED = 0x2
BAM_MREVERSE = 0x20
BAM_MUNMAP = 0x8


# ---------------------------------------------------------------- itf8

def read_itf8(buf: memoryview, pos: int) -> tuple[int, int]:
    b0 = buf[pos]
    if b0 < 0x80:
        return b0, pos + 1
    if b0 < 0xC0:
        return ((b0 & 0x7F) << 8) | buf[pos + 1], pos + 2
    if b0 < 0xE0:
        return ((b0 & 0x3F) << 16) | (buf[pos + 1] << 8) | buf[pos + 2], \
            pos + 3
    if b0 < 0xF0:
        return ((b0 & 0x1F) << 24) | (buf[pos + 1] << 16) | \
            (buf[pos + 2] << 8) | buf[pos + 3], pos + 4
    v = ((b0 & 0x0F) << 28) | (buf[pos + 1] << 20) | \
        (buf[pos + 2] << 12) | (buf[pos + 3] << 4) | (buf[pos + 4] & 0x0F)
    # interpret as signed 32-bit
    if v & 0x80000000:
        v -= 1 << 32
    return v, pos + 5


def write_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def read_ltf8(buf: memoryview, pos: int) -> tuple[int, int]:
    b0 = buf[pos]
    n_extra = 0
    mask = 0x80
    while n_extra < 8 and (b0 & mask):
        n_extra += 1
        mask >>= 1
    if n_extra == 0:
        return b0, pos + 1
    if n_extra < 8:
        v = b0 & (0xFF >> (n_extra + 1))
    else:
        v = 0
    for i in range(n_extra):
        v = (v << 8) | buf[pos + 1 + i]
    if n_extra == 8 and v & (1 << 63):
        v -= 1 << 64
    return v, pos + 1 + n_extra


def write_ltf8(v: int) -> bytes:
    v &= (1 << 64) - 1
    if v < 0x80:
        return bytes([v])
    for n in range(1, 8):  # n extra bytes; (7 - n) value bits in byte 0
        if v < (1 << (7 + 7 * n)):
            prefix = (0xFF << (8 - n)) & 0xFF
            body = v.to_bytes(n + 1, "big")
            return bytes([prefix | body[0]]) + body[1:]
    return bytes([0xFF]) + v.to_bytes(8, "big")


# --------------------------------------------------------- rANS 4x8

RANS_LOW = 1 << 23
TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT


def _read_u7(buf, pos):
    """rANS frequency value: 1 byte (<128) or 2 bytes (0x80|hi, lo)."""
    b0 = buf[pos]
    if b0 < 0x80:
        return b0, pos + 1
    return ((b0 & 0x7F) << 8) | buf[pos + 1], pos + 2


def _write_u7(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    return bytes([0x80 | (v >> 8), v & 0xFF])


def _read_freqs0(buf, pos):
    freqs = np.zeros(256, dtype=np.int64)
    sym = buf[pos]
    pos += 1
    last_sym = sym
    rle = 0
    while True:
        f, pos = _read_u7(buf, pos)
        freqs[sym] = f
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            sym = buf[pos]
            pos += 1
            # unmasked comparison: last_sym 255 must NOT treat the 0x00
            # terminator as an adjacent-run marker (255 + 1 = 256 != 0)
            if sym == last_sym + 1:
                rle = buf[pos]
                pos += 1
            last_sym = sym
        if sym == 0 and rle == 0:
            break
    return freqs, pos


def _rans_decode_0(buf, pos, out_len):
    freqs, pos = _read_freqs0(buf, pos)
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(freqs, out=cum[1:])
    # symbol lookup table over the 4096 range
    lut = np.zeros(TOTFREQ, dtype=np.uint8)
    for s in np.nonzero(freqs)[0]:
        lut[cum[s]:cum[s + 1]] = s
    R = list(struct.unpack_from("<4I", buf, pos))
    pos += 16
    out = bytearray(out_len)
    n = len(buf)
    for i in range(out_len):
        j = i & 3
        x = R[j]
        m = x & (TOTFREQ - 1)
        s = lut[m]
        out[i] = s
        x = int(freqs[s]) * (x >> TF_SHIFT) + m - int(cum[s])
        while x < RANS_LOW and pos < n:
            x = (x << 8) | buf[pos]
            pos += 1
        R[j] = x
    return bytes(out)


def _rans_decode_1(buf, pos, out_len):
    # outer RLE over contexts, inner order-0 tables
    freqs = np.zeros((256, 256), dtype=np.int64)
    cums = np.zeros((256, 257), dtype=np.int64)
    ctx = buf[pos]
    pos += 1
    last_ctx = ctx
    rle = 0
    luts = {}
    while True:
        f, pos = _read_freqs0(buf, pos)
        freqs[ctx] = f
        np.cumsum(f, out=cums[ctx][1:])
        lut = np.zeros(TOTFREQ, dtype=np.uint8)
        for s in np.nonzero(f)[0]:
            lut[cums[ctx][s]:cums[ctx][s + 1]] = s
        luts[ctx] = lut
        if rle > 0:
            rle -= 1
            ctx += 1
        else:
            ctx = buf[pos]
            pos += 1
            if ctx == last_ctx + 1:  # unmasked: see _read_freqs0
                rle = buf[pos]
                pos += 1
            last_ctx = ctx
        if ctx == 0 and rle == 0:
            break
    R = list(struct.unpack_from("<4I", buf, pos))
    pos += 16
    out = bytearray(out_len)
    n = len(buf)
    F = out_len >> 2
    last = [0, 0, 0, 0]
    idx = [j * F for j in range(4)]
    ends = [F, 2 * F, 3 * F, out_len]
    i = 0
    while True:
        done = True
        for j in range(4):
            if idx[j] >= ends[j]:
                continue
            done = False
            x = R[j]
            c = last[j]
            m = x & (TOTFREQ - 1)
            if c not in luts:
                # a context byte with no frequency table means the
                # stream is corrupt or foreign — fail loudly instead of
                # silently desynchronizing on symbol 0
                raise ValueError("cram: rans missing order-1 context")
            s = luts[c][m]
            out[idx[j]] = s
            x = int(freqs[c][s]) * (x >> TF_SHIFT) + m - int(cums[c][s])
            while x < RANS_LOW and pos < n:
                x = (x << 8) | buf[pos]
                pos += 1
            R[j] = x
            last[j] = s
            idx[j] += 1
        i += 1
        if done:
            break
    return bytes(out)


def rans_decode(data: bytes) -> bytes:
    buf = memoryview(data)
    order = buf[0]
    # compressed size u32, uncompressed size u32
    out_len = struct.unpack_from("<I", buf, 5)[0]
    if out_len == 0:
        return b""
    if order in (0, 1):
        return (_rans_decode_0 if order == 0 else _rans_decode_1)(
            buf, 9, out_len)
    raise ValueError(f"cram: unknown rANS order {order}")


def _normalize_freqs(freqs: np.ndarray, total: int,
                     target: int = TOTFREQ) -> np.ndarray:
    """Counts → per-symbol frequencies summing exactly to ``target``
    (TOTFREQ for 4x8; the Nx16 codec passes its shift-derived total).

    Rare symbols floor-clamp to 1, which can push the sum ABOVE target
    for large skewed alphabets (e.g. 200 singleton symbols); the deficit
    is then shaved from the largest entries (each kept ≥ 1) rather than
    blindly subtracted from one argmax, which could go negative.
    """
    present = freqs > 0
    norm = np.maximum((freqs * target) // max(total, 1),
                      present.astype(np.int64))
    diff = target - int(norm.sum())
    if diff >= 0:
        norm[int(np.argmax(norm))] += diff
        return norm
    while diff < 0:
        big = int(np.argmax(norm))
        if norm[big] <= 1:
            # all present symbols at 1 and still over TOTFREQ: >4096
            # distinct symbols is impossible for a byte alphabet
            raise ValueError("rans: degenerate distribution")
        take = min(-diff, int(norm[big]) - 1)
        norm[big] -= take
        diff += take
    return norm


def _serialize_rle(symbols, payload_fn) -> bytearray:
    """The rANS table outer structure shared by both orders: ascending
    symbol/context bytes with adjacent-run RLE (marker byte sym+1, then
    the count of FURTHER consecutive entries), each entry followed by
    ``payload_fn(symbol)`` bytes, 0x00-terminated."""
    table = bytearray()
    i = 0
    while i < len(symbols):
        run = 0
        while (i + run + 1 < len(symbols)
               and symbols[i + run + 1] == symbols[i + run] + 1):
            run += 1
        table.append(int(symbols[i]))
        table += payload_fn(int(symbols[i]))
        if run:
            table.append(int(symbols[i] + 1))
            table.append(run - 1)
            for k in range(1, run + 1):
                table += payload_fn(int(symbols[i + k]))
        i += run + 1
    table.append(0)
    return table


def _serialize_freqs0(norm: np.ndarray) -> bytearray:
    """Order-0 frequency table bytes (RLE over adjacent symbols)."""
    return _serialize_rle(np.nonzero(norm > 0)[0],
                          lambda s: _write_u7(int(norm[s])))


def rans_encode_0(data: bytes) -> bytes:
    """Order-0 rANS 4x8 encoder (for fixtures + decoder round-trips)."""
    if len(data) == 0:
        return b"\x00" + struct.pack("<II", 0, 0)
    arr = np.frombuffer(data, dtype=np.uint8)
    freqs = np.bincount(arr, minlength=256).astype(np.int64)
    norm = _normalize_freqs(freqs, len(arr))
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(norm, out=cum[1:])
    table = _serialize_freqs0(norm)

    # encode backwards with 4 interleaved states
    R = [RANS_LOW] * 4
    payload = bytearray()
    for i in range(len(arr) - 1, -1, -1):
        s = int(arr[i])
        j = i & 3
        f = int(norm[s])
        x = R[j]
        x_max = ((RANS_LOW >> TF_SHIFT) << 8) * f
        while x >= x_max:
            payload.append(x & 0xFF)
            x >>= 8
        R[j] = ((x // f) << TF_SHIFT) + (x % f) + int(cum[s])
    states = b"".join(struct.pack("<I", R[j]) for j in range(4))
    body = bytes(table) + states + bytes(reversed(payload))
    return b"\x00" + struct.pack("<II", len(body), len(arr)) + body


def rans_encode_1(data: bytes) -> bytes:
    """Order-1 rANS 4x8 encoder — validation twin for the order-1
    decoder (real CRAMs use o1 for base/quality streams; our block
    writer uses o0/gzip). Four interleaved streams over quarters, each
    symbol coded in its in-stream predecessor's context, encoded in the
    exact reverse of the decoder's consumption order.
    """
    n = len(data)
    if n < 4:
        raise ValueError("rans o1 needs at least 4 bytes")
    arr = np.frombuffer(data, dtype=np.uint8)
    F = n >> 2
    quarter_lo = [0, F, 2 * F, 3 * F]
    quarter_hi = [F, 2 * F, 3 * F, n]

    counts = np.zeros((256, 256), dtype=np.int64)
    totals = np.zeros(256, dtype=np.int64)
    for j in range(4):
        lo, hi = quarter_lo[j], quarter_hi[j]
        prevs = np.concatenate(([0], arr[lo:hi - 1]))
        np.add.at(counts, (prevs, arr[lo:hi]), 1)
        np.add.at(totals, prevs, 1)

    norm = np.zeros((256, 256), dtype=np.int64)
    cums = np.zeros((256, 257), dtype=np.int64)
    ctxs = np.nonzero(totals > 0)[0]
    for c in ctxs:
        norm[c] = _normalize_freqs(counts[c], int(totals[c]))
        np.cumsum(norm[c], out=cums[c][1:])

    # outer context table: RLE over contexts, inner o0 table each
    table = _serialize_rle(ctxs, lambda c: _serialize_freqs0(norm[c]))

    # decoder consumption order: for i ascending, streams 0..3 each
    # decode their i-th in-quarter symbol (stream 3 alone in the tail);
    # encode by walking that order backwards directly
    def reverse_steps():
        for i in range(n - 3 * F - 1, -1, -1):
            for j in (3, 2, 1, 0):
                p = quarter_lo[j] + i
                if p < quarter_hi[j]:
                    yield j, p

    R = [RANS_LOW] * 4
    payload = bytearray()
    for j, p in reverse_steps():
        s = int(arr[p])
        ctx = int(arr[p - 1]) if p > quarter_lo[j] else 0
        f = int(norm[ctx][s])
        x = R[j]
        x_max = ((RANS_LOW >> TF_SHIFT) << 8) * f
        while x >= x_max:
            payload.append(x & 0xFF)
            x >>= 8
        R[j] = ((x // f) << TF_SHIFT) + (x % f) + int(cums[ctx][s])
    states = b"".join(struct.pack("<I", R[j]) for j in range(4))
    body = bytes(table) + states + bytes(reversed(payload))
    return b"\x01" + struct.pack("<II", len(body), n) + body


# ------------------------------------------------------------- blocks

def _decompress(method: int, data: bytes, raw_size: int) -> bytes:
    if method == M_RAW:
        return data
    if method in (M_GZIP, M_BZIP2, M_LZMA):
        import lzma

        try:
            if method == M_GZIP:
                return gzip.decompress(data)
            if method == M_BZIP2:
                import bz2

                return bz2.decompress(data)
            return lzma.decompress(data)
        except (OSError, ValueError, zlib.error, EOFError,
                lzma.LZMAError) as e:
            # stdlib decompressors raise their own error types on a
            # corrupt payload (LZMAError is not an OSError; truncated
            # bz2 raises a bare ValueError) — re-wrap with the
            # module's 'cram:' context
            raise ValueError(
                f"cram: corrupt block payload (method {method}: {e})"
            ) from e
    if method == M_RANS:
        return rans_decode(data)
    if method in (M_RANSNX16, M_ARITH, M_FQZCOMP, M_TOK3):
        if method == M_RANSNX16:
            from .rans_nx16 import decode as dec
        elif method == M_ARITH:
            from .arith import decode as dec
        elif method == M_FQZCOMP:
            from .fqzcomp import decode as dec
        else:
            from .tok3 import decode as dec
        try:
            return dec(data, raw_size)
        except ValueError as e:
            # the 3.1 codec layouts are pinned by in-repo encoder
            # twins (no htslib exists here to cross-validate, see
            # docs/cram.md): keep the actionable remedy a foreign
            # stream's parse failure used to get
            raise ValueError(
                f"cram: {e} — if this block came from another CRAM "
                "writer, its 3.1 codec layout may diverge from this "
                "clean-room implementation; re-encode with samtools "
                "view -O cram,version=3.0 (see docs/cram.md)"
            ) from e
    raise ValueError(f"cram: unsupported block compression method {method}")


@dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes  # uncompressed


@dataclass
class RawBlock:
    """One block as stored: compressed payload + frame, not decoded.

    The raw-access surface the device decode path needs — a container's
    blocks are collected first, then the entropy stage runs wherever
    the installed block decoder puts it (ops/rans_device.py ships
    these bytes compressed over the wire)."""

    method: int
    content_type: int
    content_id: int
    raw: bytes   # compressed payload as stored
    rsize: int   # declared uncompressed size


def read_block_raw(buf: memoryview, pos: int,
                   v2: bool = False) -> tuple[RawBlock, int]:
    """Parse one block's frame + CRC without decompressing."""
    start = pos
    method = buf[pos]
    ctype = buf[pos + 1]
    pos += 2
    cid, pos = read_itf8(buf, pos)
    csize, pos = read_itf8(buf, pos)
    rsize, pos = read_itf8(buf, pos)
    raw = bytes(buf[pos:pos + csize])
    pos += csize
    if not v2:  # CRAM 2.x blocks carry no CRC trailer
        want_crc = struct.unpack_from("<I", buf, pos)[0]
        # CRC covers the block's bytes exactly as stored (a spec-legal
        # non-minimal ITF8 must not be re-canonicalized before
        # checking)
        got_crc = zlib.crc32(bytes(buf[start:pos]))
        pos += 4
        if got_crc != want_crc:
            raise ValueError("cram: block CRC mismatch")
    return RawBlock(method, ctype, cid, raw, rsize), pos


def decode_raw_block(rb: RawBlock, data: bytes | None = None) -> Block:
    """RawBlock → Block, with the shared size validation. ``data``
    injects already-decoded bytes (the device decode path)."""
    if data is None:
        data = _decompress(rb.method, rb.raw, rb.rsize)
    if len(data) != rb.rsize:
        raise ValueError("cram: block size mismatch after decompression")
    return Block(rb.method, rb.content_type, rb.content_id, data)


def read_block(buf: memoryview, pos: int,
               v2: bool = False) -> tuple[Block, int]:
    rb, pos = read_block_raw(buf, pos, v2)
    return decode_raw_block(rb), pos


def write_block(method: int, ctype: int, cid: int, data: bytes,
                rans_order: int = 0, v2: bool = False,
                rans_stripe: int = 0) -> bytes:
    if method == M_RANSNX16:
        from .rans_nx16 import encode as nx16_encode

        # STRIPE only pays (and only exercises multi-lane framing)
        # past a few lanes' worth of bytes; tiny blocks stay plain
        comp = nx16_encode(data, order=rans_order if len(data) >= 16
                           else 0,
                           stripe=rans_stripe
                           if len(data) >= 16 * max(rans_stripe, 1)
                           else 0)
    elif method == M_ARITH:
        from .arith import encode as arith_encode

        comp = arith_encode(data, order=rans_order if len(data) >= 16
                            else 0)
    elif method == M_RANS and (rans_order == 0 or len(data) < 4):
        comp = rans_encode_0(data)
    elif method == M_RANS:
        comp = rans_encode_1(data)
    elif method == M_GZIP:
        comp = gzip.compress(data, 6)
    else:
        comp = data
    return _write_block_pre(method, ctype, cid, comp, len(data), v2)


def _write_block_pre(method: int, ctype: int, cid: int, comp: bytes,
                     raw_size: int, v2: bool = False) -> bytes:
    """Frame an already-compressed payload (write_block's tail, and
    the direct entry for the specialized codecs — tok3 names, fqzcomp
    qualities — which compress with record structure write_block
    cannot know)."""
    head = bytes([method, ctype]) + write_itf8(cid) + \
        write_itf8(len(comp)) + write_itf8(raw_size)
    if v2:  # CRAM 2.x blocks carry no CRC trailer
        return head + comp
    return head + comp + struct.pack("<I", zlib.crc32(head + comp))


# ------------------------------------------------------- encodings

E_NULL, E_EXTERNAL, E_GOLOMB, E_HUFFMAN = 0, 1, 2, 3
E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP, E_BETA = 4, 5, 6
E_SUBEXP, E_GOLOMB_RICE, E_GAMMA = 7, 8, 9


class BitReader:
    """MSB-first reader over the core block."""

    __slots__ = ("data", "byte", "bit")

    def __init__(self, data: bytes):
        self.data = data
        self.byte = 0
        self.bit = 0

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            b = (self.data[self.byte] >> (7 - self.bit)) & 1
            v = (v << 1) | b
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
        return v

    def read_unary(self) -> int:
        n = 0
        while True:
            b = (self.data[self.byte] >> (7 - self.bit)) & 1
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
            if b:
                return n
            n += 1


@dataclass
class Encoding:
    codec: int
    params: dict = field(default_factory=dict)

    @staticmethod
    def parse(buf: memoryview, pos: int) -> tuple["Encoding", int]:
        codec, pos = read_itf8(buf, pos)
        size, pos = read_itf8(buf, pos)
        end = pos + size
        p: dict = {}
        if codec == E_EXTERNAL:
            p["id"], pos = read_itf8(buf, pos)
        elif codec == E_HUFFMAN:
            n, pos = read_itf8(buf, pos)
            alphabet = []
            for _ in range(n):
                v, pos = read_itf8(buf, pos)
                alphabet.append(v)
            n2, pos = read_itf8(buf, pos)
            lens = []
            for _ in range(n2):
                v, pos = read_itf8(buf, pos)
                lens.append(v)
            p["alphabet"], p["lengths"] = alphabet, lens
        elif codec == E_BYTE_ARRAY_LEN:
            p["len_enc"], pos = Encoding.parse(buf, pos)
            p["val_enc"], pos = Encoding.parse(buf, pos)
        elif codec == E_BYTE_ARRAY_STOP:
            p["stop"] = buf[pos]
            pos += 1
            p["id"], pos = read_itf8(buf, pos)
        elif codec == E_BETA:
            p["offset"], pos = read_itf8(buf, pos)
            p["length"], pos = read_itf8(buf, pos)
        elif codec == E_GAMMA:
            p["offset"], pos = read_itf8(buf, pos)
        elif codec == E_NULL:
            pass
        else:
            raise ValueError(f"cram: unsupported codec id {codec}")
        return Encoding(codec, p), end

    def serialize(self) -> bytes:
        body = b""
        if self.codec == E_EXTERNAL:
            body = write_itf8(self.params["id"])
        elif self.codec == E_HUFFMAN:
            a, ls = self.params["alphabet"], self.params["lengths"]
            body = write_itf8(len(a)) + b"".join(write_itf8(x) for x in a)
            body += write_itf8(len(ls)) + b"".join(write_itf8(x) for x in ls)
        elif self.codec == E_BYTE_ARRAY_LEN:
            body = self.params["len_enc"].serialize() + \
                self.params["val_enc"].serialize()
        elif self.codec == E_BYTE_ARRAY_STOP:
            body = bytes([self.params["stop"]]) + \
                write_itf8(self.params["id"])
        elif self.codec == E_BETA:
            body = write_itf8(self.params["offset"]) + \
                write_itf8(self.params["length"])
        elif self.codec == E_GAMMA:
            body = write_itf8(self.params["offset"])
        return write_itf8(self.codec) + write_itf8(len(body)) + body


class BitWriter:
    """MSB-first writer (the BitReader's exact inverse) for the
    fixture writer's core-bit series."""

    __slots__ = ("out", "acc", "nbits")

    def __init__(self) -> None:
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.acc)
                self.acc = 0
                self.nbits = 0

    def finish(self) -> bytes:
        if self.nbits:
            self.out.append(self.acc << (8 - self.nbits))
            self.acc = 0
            self.nbits = 0
        return bytes(self.out)


def _huffman_lengths(values) -> tuple[list[int], list[int]]:
    """Canonical-Huffman code lengths for a value multiset (ascending
    alphabet; single-symbol alphabets get the spec's 0-bit code)."""
    import heapq
    import itertools
    from collections import Counter

    freq = Counter(values)
    if len(freq) == 1:
        return [next(iter(freq))], [0]
    cnt = itertools.count()
    heap = [(f, next(cnt), s) for s, f in freq.items()]
    heapq.heapify(heap)
    while len(heap) > 1:
        f1, _, n1 = heapq.heappop(heap)
        f2, _, n2 = heapq.heappop(heap)
        heapq.heappush(heap, (f1 + f2, next(cnt), (n1, n2)))
    lengths: dict[int, int] = {}

    def walk(node, depth):
        if isinstance(node, tuple):
            walk(node[0], depth + 1)
            walk(node[1], depth + 1)
        else:
            lengths[node] = depth

    walk(heap[0][2], 0)
    alphabet = sorted(lengths)
    return alphabet, [lengths[s] for s in alphabet]


def _canonical_codes(alphabet, lengths) -> dict[int, tuple[int, int]]:
    """symbol → (code, length), assigned exactly like the decoder's
    _build_huffman (sorted by (length, symbol))."""
    order = sorted(range(len(alphabet)),
                   key=lambda i: (lengths[i], alphabet[i]))
    codes: dict[int, tuple[int, int]] = {}
    code = 0
    prev = lengths[order[0]]
    for i in order:
        code <<= lengths[i] - prev
        prev = lengths[i]
        codes[alphabet[i]] = (code, lengths[i])
        code += 1
    return codes


class _ExternalStream:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def itf8(self) -> int:
        v, self.pos = read_itf8(self.data, self.pos)
        return v

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def until(self, stop: int) -> bytes:
        start = self.pos
        data = self.data
        p = self.pos
        n = len(data)
        while p < n and data[p] != stop:
            p += 1
        out = bytes(data[start:p])
        self.pos = p + 1  # skip the stop byte
        return out

    def take(self, n: int) -> bytes:
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out


class Decoder:
    """One data series decoder bound to core/external streams."""

    def __init__(self, enc: Encoding, core: BitReader,
                 externals: dict[int, _ExternalStream]):
        self.enc = enc
        self.core = core
        self.ext = externals
        if enc.codec in (E_EXTERNAL, E_BYTE_ARRAY_STOP) \
                and enc.params["id"] not in externals:
            # validate at construction so a corrupt content id (which
            # nothing upstream catches in the CRC-less 2.x layout)
            # fails typed instead of KeyError-ing mid-record
            raise ValueError(
                f"cram: slice references missing external block "
                f"{enc.params['id']}")
        if enc.codec == E_HUFFMAN:
            self._build_huffman()
        elif enc.codec == E_BYTE_ARRAY_LEN:
            self.len_dec = Decoder(enc.params["len_enc"], core, externals)
            self.val_dec = Decoder(enc.params["val_enc"], core, externals)

    def _build_huffman(self):
        alphabet = self.enc.params["alphabet"]
        lengths = self.enc.params["lengths"]
        if len(alphabet) == 1:
            self.hf_single = alphabet[0]
            return
        self.hf_single = None
        # canonical assignment shared with the writer
        # (_canonical_codes): sort by (code length, symbol value) —
        # the spec/htslib tie-break; appearance order would swap
        # codes for equal-length symbols listed out of order
        codes = _canonical_codes(alphabet, lengths)
        self.hf_table = {(ln, code): sym
                         for sym, (code, ln) in codes.items()}
        self.hf_maxlen = max(lengths)

    def read_int(self) -> int:
        c = self.enc.codec
        if c == E_EXTERNAL:
            return self.ext[self.enc.params["id"]].itf8()
        if c == E_HUFFMAN:
            if self.hf_single is not None:
                return self.hf_single
            ln = 0
            code = 0
            while ln <= self.hf_maxlen:
                code = (code << 1) | self.core.read(1)
                ln += 1
                if (ln, code) in self.hf_table:
                    return self.hf_table[(ln, code)]
            raise ValueError("cram: bad huffman code")
        if c == E_BETA:
            return self.core.read(self.enc.params["length"]) - \
                self.enc.params["offset"]
        if c == E_GAMMA:
            n = self.core.read_unary()
            v = (1 << n) | (self.core.read(n) if n else 0)
            return v - self.enc.params["offset"]
        raise ValueError(f"cram: codec {c} cannot decode ints")

    def read_byte(self) -> int:
        c = self.enc.codec
        if c == E_EXTERNAL:
            return self.ext[self.enc.params["id"]].byte()
        return self.read_int() & 0xFF

    def read_bytes(self) -> bytes:
        c = self.enc.codec
        if c == E_BYTE_ARRAY_STOP:
            return self.ext[self.enc.params["id"]].until(
                self.enc.params["stop"]
            )
        if c == E_BYTE_ARRAY_LEN:
            n = self.len_dec.read_int()
            if self.val_dec.enc.codec == E_EXTERNAL:
                return self.val_dec.ext[
                    self.val_dec.enc.params["id"]
                ].take(n)
            return bytes(self.val_dec.read_byte() for _ in range(n))
        raise ValueError(f"cram: codec {c} cannot decode byte arrays")

    def read_bytes_n(self, n: int) -> bytes:
        """n bytes for fixed-length series (QS, unmapped bases)."""
        if self.enc.codec == E_EXTERNAL:
            return self.ext[self.enc.params["id"]].take(n)
        return bytes(self.read_byte() for _ in range(n))


# --------------------------------------------- compression header

# in-read length the feature consumes (query) / reference length
_Q_CONSUME = {ord("S"), ord("I"), ord("i")}
_R_CONSUME = {ord("D"), ord("N")}
# features that add a CIGAR op (break the single-M shape) even though
# they consume neither query nor reference
_STRUCTURAL = _Q_CONSUME | _R_CONSUME | {ord("H"), ord("P")}


@dataclass
class CompressionHeader:
    rn_included: bool = True
    ap_delta: bool = True
    ref_required: bool = True
    sub_matrix: bytes = b"\x00" * 5
    tag_dict: list[list[tuple[str, str]]] = field(default_factory=list)
    encodings: dict[str, Encoding] = field(default_factory=dict)
    tag_encodings: dict[int, Encoding] = field(default_factory=dict)

    @staticmethod
    def parse(data: bytes) -> "CompressionHeader":
        buf = memoryview(data)
        ch = CompressionHeader()
        pos = 0
        # preservation map
        _size, pos = read_itf8(buf, pos)
        nmap, pos = read_itf8(buf, pos)
        for _ in range(nmap):
            key = bytes(buf[pos:pos + 2]).decode()
            pos += 2
            if key == "RN":
                ch.rn_included = bool(buf[pos])
                pos += 1
            elif key == "AP":
                ch.ap_delta = bool(buf[pos])
                pos += 1
            elif key == "RR":
                ch.ref_required = bool(buf[pos])
                pos += 1
            elif key == "SM":
                ch.sub_matrix = bytes(buf[pos:pos + 5])
                pos += 5
            elif key == "TD":
                blob_len, pos = read_itf8(buf, pos)
                blob = bytes(buf[pos:pos + blob_len])
                pos += blob_len
                ch.tag_dict = []
                for line in blob.split(b"\x00")[:-1] if blob else []:
                    tags = []
                    for i in range(0, len(line), 3):
                        tags.append((line[i:i + 2].decode(),
                                     chr(line[i + 2])))
                    ch.tag_dict.append(tags)
                if not ch.tag_dict:
                    ch.tag_dict = [[]]
            else:
                raise ValueError(f"cram: unknown preservation key {key}")
        # data series encodings
        _size, pos = read_itf8(buf, pos)
        n, pos = read_itf8(buf, pos)
        for _ in range(n):
            key = bytes(buf[pos:pos + 2]).decode()
            pos += 2
            enc, pos = Encoding.parse(buf, pos)
            ch.encodings[key] = enc
        # tag encodings
        _size, pos = read_itf8(buf, pos)
        n, pos = read_itf8(buf, pos)
        for _ in range(n):
            key, pos = read_itf8(buf, pos)
            enc, pos = Encoding.parse(buf, pos)
            ch.tag_encodings[key] = enc
        return ch

    def serialize(self) -> bytes:
        pres = bytearray()
        entries = [
            (b"RN", bytes([1 if self.rn_included else 0])),
            (b"AP", bytes([1 if self.ap_delta else 0])),
            (b"RR", bytes([1 if self.ref_required else 0])),
            (b"SM", self.sub_matrix),
        ]
        blob = b""
        for line in self.tag_dict:
            for tag, typ in line:
                blob += tag.encode() + typ.encode()
            blob += b"\x00"
        entries.append((b"TD", write_itf8(len(blob)) + blob))
        body = write_itf8(len(entries))
        for k, v in entries:
            body += k + v
        out = write_itf8(len(body)) + body
        body = write_itf8(len(self.encodings))
        for k, enc in self.encodings.items():
            body += k.encode() + enc.serialize()
        out += write_itf8(len(body)) + body
        body = write_itf8(len(self.tag_encodings))
        for k, enc in self.tag_encodings.items():
            body += write_itf8(k) + enc.serialize()
        out += write_itf8(len(body)) + body
        return bytes(out)


# ----------------------------------------------------------- slices

@dataclass
class SliceHeader:
    ref_id: int
    start: int
    span: int
    n_records: int
    counter: int
    n_blocks: int
    content_ids: list[int]
    embedded_ref_id: int
    md5: bytes

    @staticmethod
    def parse(data: bytes, v2: bool = False) -> "SliceHeader":
        buf = memoryview(data)
        pos = 0
        ref_id, pos = read_itf8(buf, pos)
        start, pos = read_itf8(buf, pos)
        span, pos = read_itf8(buf, pos)
        nrec, pos = read_itf8(buf, pos)
        # ITF8 in 2.x, LTF8 from 3.0 (same as the container header)
        if v2:
            counter, pos = read_itf8(buf, pos)
        else:
            counter, pos = read_ltf8(buf, pos)
        nblocks, pos = read_itf8(buf, pos)
        ncids, pos = read_itf8(buf, pos)
        cids = []
        for _ in range(ncids):
            v, pos = read_itf8(buf, pos)
            cids.append(v)
        emb, pos = read_itf8(buf, pos)
        md5 = bytes(buf[pos:pos + 16])
        return SliceHeader(ref_id, start, span, nrec, counter, nblocks,
                           cids, emb, md5)

    def serialize(self, v2: bool = False) -> bytes:
        wc = write_itf8 if v2 else write_ltf8
        out = write_itf8(self.ref_id) + write_itf8(self.start) + \
            write_itf8(self.span) + write_itf8(self.n_records) + \
            wc(self.counter) + write_itf8(self.n_blocks) + \
            write_itf8(len(self.content_ids))
        for c in self.content_ids:
            out += write_itf8(c)
        out += write_itf8(self.embedded_ref_id) + self.md5
        return out


@dataclass
class CramRecord:
    bf: int
    cf: int
    ref_id: int
    read_len: int
    pos: int  # 1-based alignment position
    mapq: int
    mate_ref: int
    mate_pos: int
    tlen: int
    name: bytes
    features: list[tuple[int, int, int]]  # (code, in-read pos, length)

    @property
    def flag(self) -> int:
        f = self.bf
        return f

    def ref_end(self) -> int:
        """1-based exclusive-ish: pos + ref-consumed length."""
        q_only = sum(ln for c, _, ln in self.features if c in _Q_CONSUME)
        r_only = sum(ln for c, _, ln in self.features if c in _R_CONSUME)
        return self.pos + self.read_len - q_only + r_only

    def aligned_blocks(self) -> list[tuple[int, int]]:
        """0-based [start, end) M-run blocks (depth counts these)."""
        ref = self.pos - 1
        prev_q = 1
        blocks = []
        for code, fp, ln in sorted(self.features, key=lambda t: t[1]):
            if code in _Q_CONSUME:
                m = fp - prev_q
                if m > 0:
                    blocks.append((ref, ref + m))
                    ref += m
                prev_q = fp + ln
            elif code in _R_CONSUME:
                m = fp - prev_q
                if m > 0:
                    blocks.append((ref, ref + m))
                    ref += m
                ref += ln
                prev_q = fp
        m = self.read_len - prev_q + 1
        if m > 0:
            blocks.append((ref, ref + m))
        return blocks

    def single_m(self) -> bool:
        return not self.features


def decode_slice(comp: CompressionHeader, sl: SliceHeader,
                 core: bytes, externals: dict[int, bytes],
                 ) -> list[CramRecord]:
    br = BitReader(core)
    streams = {cid: _ExternalStream(d) for cid, d in externals.items()}

    decs: dict[str, Decoder] = {}

    def dec(key: str) -> Decoder:
        d = decs.get(key)
        if d is None:
            enc = comp.encodings.get(key)
            if enc is None:
                raise ValueError(f"cram: no encoding for series {key}")
            d = Decoder(enc, br, streams)
            decs[key] = d
        return d

    tag_decs: dict[int, Decoder] = {}
    records = []
    nf_links: list[int | None] = []
    prev_pos = sl.start
    for _ in range(sl.n_records):
        bf = dec("BF").read_int()
        cf = dec("CF").read_int()
        ref_id = sl.ref_id
        if sl.ref_id == -2:
            ref_id = dec("RI").read_int()
        rl = dec("RL").read_int()
        ap = dec("AP").read_int()
        if comp.ap_delta:
            pos = prev_pos + ap
            prev_pos = pos
        else:
            pos = ap
        dec("RG").read_int()
        name = b""
        if comp.rn_included:
            name = dec("RN").read_bytes()
        mate_ref, mate_pos, tlen = -1, -1, 0
        nf: int | None = None
        if cf & CF_DETACHED:
            mf = dec("MF").read_int()
            if not comp.rn_included:
                name = dec("RN").read_bytes()
            mate_ref = dec("NS").read_int()
            mate_pos = dec("NP").read_int()
            tlen = dec("TS").read_int()
            bf |= (BAM_MREVERSE if mf & MF_MATE_REVERSE else 0)
            bf |= (BAM_MUNMAP if mf & MF_MATE_UNMAPPED else 0)
        elif cf & CF_MATE_DOWNSTREAM:
            nf = dec("NF").read_int()
        tl = dec("TL").read_int()
        if not (0 <= tl < max(len(comp.tag_dict), 1)):
            # a bad index would silently desync every shared stream
            raise ValueError(f"cram: tag-line index {tl} out of range")
        if comp.tag_dict:
            for tag, typ in comp.tag_dict[tl]:
                key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
                td = tag_decs.get(key)
                if td is None:
                    enc = comp.tag_encodings.get(key)
                    if enc is None:
                        raise ValueError(f"cram: no tag encoding {tag}")
                    td = Decoder(enc, br, streams)
                    tag_decs[key] = td
                td.read_bytes()  # consume; values unused for depth
        features: list[tuple[int, int, int]] = []
        mapq = 0
        if not (bf & 0x4):  # mapped
            fn = dec("FN").read_int()
            fpos = 0
            for _ in range(fn):
                fc = dec("FC").read_byte()
                fpos += dec("FP").read_int()
                ln = 0
                if fc == ord("S"):
                    ln = len(dec("SC").read_bytes())
                elif fc == ord("I"):
                    ln = len(dec("IN").read_bytes())
                elif fc == ord("i"):
                    dec("BA").read_byte()
                    ln = 1
                elif fc == ord("D"):
                    ln = dec("DL").read_int()
                elif fc == ord("N"):
                    ln = dec("RS").read_int()
                elif fc == ord("H"):
                    dec("HC").read_int()
                elif fc == ord("P"):
                    dec("PD").read_int()
                elif fc == ord("X"):
                    dec("BS").read_byte()
                elif fc == ord("B"):
                    dec("BA").read_byte()
                    dec("QS").read_byte()
                elif fc == ord("Q"):
                    dec("QS").read_byte()
                elif fc == ord("b"):
                    dec("BB").read_bytes()
                elif fc == ord("q"):
                    dec("QQ").read_bytes()
                else:
                    raise ValueError(f"cram: unknown feature {chr(fc)}")
                if fc in _STRUCTURAL:
                    features.append((fc, fpos, ln))
            mapq = dec("MQ").read_int()
            if cf & CF_QS_STORED:
                dec("QS").read_bytes_n(rl)
        else:
            if not (cf & CF_NO_SEQ):
                dec("BA").read_bytes_n(rl)
            if cf & CF_QS_STORED:
                dec("QS").read_bytes_n(rl)
        records.append(CramRecord(bf, cf, ref_id, rl, pos, mapq,
                                  mate_ref, mate_pos, tlen, name,
                                  features))
        nf_links.append(nf)
    # resolve downstream mates (spec: mate = this + NF + 1, same slice)
    for i, nf in enumerate(nf_links):
        if nf is None:
            continue
        j = i + nf + 1
        if j >= len(records):
            continue
        a, b = records[i], records[j]
        for rec, other in ((a, b), (b, a)):
            rec.mate_ref = other.ref_id
            rec.mate_pos = other.pos
            if other.bf & 0x10:
                rec.bf |= BAM_MREVERSE
            if other.bf & 0x4:
                rec.bf |= BAM_MUNMAP
        # BAM-rule template length: outermost span, + on the leftmost
        lo = min(a.pos, b.pos)
        hi = max(a.ref_end(), b.ref_end())
        span = hi - lo
        if a.pos <= b.pos:
            a.tlen, b.tlen = span, -span
        else:
            a.tlen, b.tlen = -span, span
    return records


# -------------------------------------------------------- containers

@dataclass
class ContainerHeader:
    length: int  # total byte size of the container's blocks
    ref_id: int
    start: int
    span: int
    n_records: int
    counter: int
    n_bases: int
    n_blocks: int
    landmarks: list[int]

    @staticmethod
    def parse(buf: memoryview, pos: int,
              v2: bool = False) -> tuple["ContainerHeader", int]:
        (length,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        ref_id, pos = read_itf8(buf, pos)
        start, pos = read_itf8(buf, pos)
        span, pos = read_itf8(buf, pos)
        nrec, pos = read_itf8(buf, pos)
        # the record counter widened to LTF8 in 3.0; 2.x stores ITF8
        if v2:
            counter, pos = read_itf8(buf, pos)
        else:
            counter, pos = read_ltf8(buf, pos)
        nbases, pos = read_ltf8(buf, pos)
        nblocks, pos = read_itf8(buf, pos)
        nland, pos = read_itf8(buf, pos)
        lands = []
        for _ in range(nland):
            v, pos = read_itf8(buf, pos)
            lands.append(v)
        if not v2:
            pos += 4  # header crc32 (v3 only)
        return ContainerHeader(length, ref_id, start, span, nrec, counter,
                               nbases, nblocks, lands), pos

    @staticmethod
    def build(length, ref_id, start, span, nrec, counter, nbases,
              nblocks, landmarks, v2: bool = False) -> bytes:
        wc = write_itf8 if v2 else write_ltf8
        body = write_itf8(ref_id) + write_itf8(start) + \
            write_itf8(span) + write_itf8(nrec) + wc(counter) + \
            write_ltf8(nbases) + write_itf8(nblocks) + \
            write_itf8(len(landmarks))
        for v in landmarks:
            body += write_itf8(v)
        head = struct.pack("<i", length) + body
        if v2:
            return head
        return head + struct.pack("<I", zlib.crc32(head))


def _container_blocks(buf: memoryview, pos: int, end: int,
                      v2: bool, block_decoder) -> list[Block]:
    """All of a container's blocks, decoded.

    Without a decoder this is the sequential read-and-inflate walk.
    With one (``--decode-device``), the frames are parsed first —
    still-compressed payloads — and the whole container's entropy
    decode runs as ONE batched call, so supported blocks share a
    single bucketed device dispatch instead of N host loops."""
    if block_decoder is None:
        blocks = []
        while pos < end:
            b, pos = read_block(buf, pos, v2)
            blocks.append(b)
        return blocks
    raws = []
    while pos < end:
        rb, pos = read_block_raw(buf, pos, v2)
        raws.append(rb)
    datas = block_decoder.decode_blocks(raws)
    return [decode_raw_block(rb, data=d) for rb, d in zip(raws, datas)]


def _container_records(buf: memoryview, pos: int,
                       hdr: ContainerHeader,
                       v2: bool = False,
                       block_decoder=None) -> list[CramRecord]:
    """Decode every record in the container starting at its first block."""
    end = pos + hdr.length
    try:
        with _SPANS.stage("cram.blocks"):
            blocks = iter(_container_blocks(buf, pos, end, v2,
                                            block_decoder))
        block = next(blocks, None)
        if block is None or block.content_type != CT_COMP_HEADER:
            raise ValueError("cram: expected compression header block")
        comp = CompressionHeader.parse(block.data)
        records: list[CramRecord] = []
        while True:
            sh_block = next(blocks, None)
            if sh_block is None:
                break
            if sh_block.content_type != CT_SLICE_HEADER:
                raise ValueError("cram: expected slice header block")
            sl = SliceHeader.parse(sh_block.data, v2)
            core = b""
            externals: dict[int, bytes] = {}
            for _ in range(sl.n_blocks):
                b = next(blocks, None)
                if b is None:
                    raise IndexError("slice block past container end")
                if b.content_type == CT_CORE:
                    core = b.data
                elif b.content_type == CT_EXTERNAL:
                    externals[b.content_id] = b.data
            with _SPANS.stage("cram.records"):
                records.extend(decode_slice(comp, sl, core, externals))
    except (IndexError, struct.error) as e:
        # truncated mid-container: raw memoryview/struct errors become
        # the module's clean error surface (missing external ids are
        # validated at Decoder construction, so a KeyError here would
        # be a genuine bug and must surface as one)
        raise ValueError(
            f"cram: truncated or corrupt container body at byte {pos}"
        ) from e
    return records


class CramFile:
    """Decoded-CRAM handle with the BAM-handle surface the depth tools
    use: ``.header`` (BamHeader), ``read_columns(tid, start, end)``,
    ``stream_columns()``. Region access uses the .crai when present
    (container offsets per (seq, start, span) — the same index
    indexcov's QC path already parses)."""

    native = False
    lazy = True
    is_cram = True

    def __init__(self, data, crai_path: str | None = None):
        from .bam import BamHeader

        self._buf = memoryview(data) if not isinstance(data, memoryview) \
            else data
        buf = self._buf
        if bytes(buf[:4]) != CRAM_MAGIC:
            raise ValueError("not a CRAM file (bad magic)")
        self.major, self.minor = buf[4], buf[5]
        if self.major not in (2, 3):
            raise ValueError(
                f"cram: unsupported major version {self.major} "
                "(2.x and 3.0/3.1 supported; re-encode with samtools)"
            )
        # 2.x shares the 3.0 container/slice layout minus the CRC32
        # trailers on container headers and blocks (the CRAM 2.1 spec
        # predates them); 3.1 adds block codecs, handled per block in
        # _decompress
        self._v2 = self.major == 2
        pos = 26  # magic + version + 20-byte file id
        try:
            hdr, pos = ContainerHeader.parse(buf, pos, self._v2)
            first_block, _ = read_block(buf, pos, self._v2)
        except (IndexError, struct.error) as e:
            # a file truncated inside the header container raises raw
            # memoryview/struct errors; surface the module's clean
            # error type like every other parse path
            raise ValueError(
                "cram: truncated or corrupt file header"
            ) from e
        if first_block.content_type != CT_FILE_HEADER:
            raise ValueError("cram: first container must hold SAM header")
        text = _sam_header_text(first_block.data)
        names, lens = [], []
        for line in text.splitlines():
            if line.startswith("@SQ"):
                nm, ln = None, 0
                for tok in line.split("\t")[1:]:
                    if tok.startswith("SN:"):
                        nm = tok[3:]
                    elif tok.startswith("LN:"):
                        ln = int(tok[3:])
                if nm is not None:
                    names.append(nm)
                    lens.append(ln)
        self.header = BamHeader(text, names, lens)
        import threading

        self._first_data_container = pos + hdr.length
        self._crai = None
        self._all_records = None  # no-.crai fallback decode cache
        self._cache_lock = threading.Lock()
        # pluggable per-container block decode (ops/rans_device.py's
        # DeviceBlockDecoder under --decode-device); None = host codecs
        self.block_decoder = None
        if crai_path:
            self._crai = load_crai_entries(crai_path)

    def set_block_decoder(self, decoder) -> None:
        """Install a batch block decoder (``decode_blocks(raws) ->
        list[bytes]``) used for every container this handle decodes —
        byte-identical output is the decoder's contract."""
        self.block_decoder = decoder

    @classmethod
    def from_file(cls, path: str, lazy: bool = True) -> "CramFile":
        import mmap
        import os

        from . import remote

        crai = path + ".crai"
        if remote.is_remote(path):
            # stage the object once (block-cached ranged fetches); the
            # .crai sibling resolves through the same data plane
            data = remote.fetch_bytes(path)
            return cls(memoryview(data),
                       crai_path=crai if remote.exists(crai) else None)
        with open(path, "rb") as fh:
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        return cls(memoryview(mm),
                   crai_path=crai if os.path.exists(crai) else None)

    def _iter_containers(self, offset: int | None = None):
        buf = self._buf
        pos = offset if offset is not None else self._first_data_container
        n = len(buf)
        while pos + 4 <= n:
            try:
                hdr, body = ContainerHeader.parse(buf, pos, self._v2)
            except (IndexError, struct.error) as e:
                # memoryview reads past a truncated/corrupt container
                # raise raw slicing errors; surface the module's own
                # error type so CLIs print a clean "cram:" message
                raise ValueError(
                    f"cram: truncated or corrupt container at byte {pos}"
                ) from e
            if hdr.ref_id == -1 and hdr.n_records == 0:
                if hdr.n_blocks <= 1:
                    return  # EOF container
                pos = body + hdr.length
                continue  # unmapped-only container: skip (no positions)
            yield hdr, body
            pos = body + hdr.length

    def records(self, offset: int | None = None):
        for hdr, body in self._iter_containers(offset):
            yield from _container_records(self._buf, body, hdr,
                                          self._v2,
                                          self.block_decoder)

    def _region_offsets(self, tid: int, start: int, end: int):
        """Container offsets overlapping 0-based [start, end) from the
        .crai (whose alignment starts are 1-based)."""
        offs = []
        for (seq, s, span, c_off) in self._crai:
            if seq != tid or span <= 0:
                continue
            s0 = s - 1
            if s0 < end and s0 + span > start:
                offs.append(c_off)
        return sorted(set(offs))

    def read_columns(self, tid: int | None = None, start: int = 0,
                     end: int | None = None, voffset=None,
                     end_voffset=None):
        """Decode records into ReadColumns (BAM-handle-compatible).

        ``voffset``/``end_voffset`` are accepted for interface parity and
        ignored — CRAM random access goes through the .crai instead.
        """
        recs: list[CramRecord] = []
        e = end if end is not None else 1 << 60
        if tid is not None and self._crai is not None:
            seen = set()
            for off in self._region_offsets(tid, start, e):
                for hdr, body in self._iter_containers(off):
                    if hdr.ref_id not in (-2, tid) or hdr.start > e:
                        break
                    if body in seen:
                        break
                    seen.add(body)
                    recs.extend(_container_records(
                        self._buf, body, hdr, self._v2,
                        self.block_decoder))
                    break  # one container per crai offset
        else:
            # no .crai: decode the whole file ONCE and answer every
            # region from the cache (a sharded whole-genome run would
            # otherwise re-decode the file per region); shard threads
            # share the handle, so the fill is locked
            with self._cache_lock:
                if self._all_records is None:
                    if tid is not None:
                        _get_logger("cram").warning(
                            "no .crai alongside CRAM — region queries "
                            "fall back to one full-file decode held in "
                            "memory"
                        )
                    self._all_records = list(self.records())
            recs = self._all_records
        with _SPANS.stage("cram.records"):
            return _records_to_columns(recs, tid, start, e)

    def window_reduce(self, tid, start, end, w0, length, window,
                      depth_cap, min_mapq, flag_mask, voffset=None,
                      delta_scratch=None, **_ignored):
        """Fused decode + per-window depth sums for one region — the
        numpy equivalent of csrc/fastio.cpp::bam_window_reduce's dense
        path (M/=/X segments of records passing mapq/flag filters,
        clipped to [start, end) and [w0, w0+length), per-base depth
        capped at depth_cap, summed per window). Lets the cohort
        hybrid engine treat a CRAM handle like a native BAM handle:
        Python-orchestrated (the record decode already rides the C
        codec ports) but identical output.
        """
        del voffset  # CRAM random access rides the .crai
        if length % window:
            raise ValueError("length must be a multiple of window")
        cols = self.read_columns(tid=tid, start=start, end=end)
        with _SPANS.stage("reduce"):
            wsums = np.zeros(length // window, dtype=np.int64)
            if cols.n_reads == 0:
                return wsums
            keep = ((cols.mapq.astype(np.int32) >= min_mapq)
                    & ((cols.flag.astype(np.int32) & flag_mask) == 0))
            segk = keep[cols.seg_read]
            s = cols.seg_start[segk].astype(np.int64)
            e = cols.seg_end[segk].astype(np.int64)
            np.clip(s, start, end, out=s)
            np.clip(e, start, end, out=e)
            s -= w0
            e -= w0
            np.clip(s, 0, length, out=s)
            np.clip(e, 0, length, out=e)
            m = e > s
            if not m.any():
                return wsums
            delta = np.zeros(length + 1, dtype=np.int64)
            np.add.at(delta, s[m], 1)
            np.add.at(delta, e[m], -1)
            depth = np.cumsum(delta[:length])
            np.minimum(depth, depth_cap, out=depth)
            return depth.reshape(-1, window).sum(axis=1)

    def stream_columns(self, window_bytes: int = 0, chunk_records: int = 0):
        """Per-container column chunks (bounded by container size)."""
        for hdr, body in self._iter_containers():
            recs = _container_records(self._buf, body, hdr,
                                      self._v2, self.block_decoder)
            cols = _records_to_columns(recs, None, 0, 1 << 60)
            if cols.n_reads:
                yield cols


def _sam_header_text(data: bytes) -> str:
    # htslib prefixes the text with an int32 length; the spec allows the
    # raw text (possibly NUL-padded) as well — accept both
    if len(data) >= 4:
        (n,) = struct.unpack_from("<i", data, 0)
        if 0 <= n <= len(data) - 4:
            return data[4:4 + n].decode(errors="replace")
    return data.rstrip(b"\x00").decode(errors="replace")


def _records_to_columns(recs, tid, start, end):
    from .bam import ReadColumns

    tids, poss, ends, mapqs, flags, tlens, rlens = [], [], [], [], [], [], []
    mposs, singlem = [], []
    seg_t, seg_s, seg_e, seg_r = [], [], [], []
    n = 0
    for r in recs:
        if r.bf & 0x4:
            rpos, rend = r.pos - 1, r.pos - 1
        else:
            rpos, rend = r.pos - 1, r.ref_end() - 1
        if tid is not None:
            if r.ref_id != tid or rpos >= end or rend <= start:
                continue
        row = n
        n += 1
        tids.append(r.ref_id)
        poss.append(rpos)
        ends.append(rend)
        mapqs.append(r.mapq)
        flags.append(r.bf)
        tlens.append(r.tlen)
        rlens.append(r.read_len)
        mposs.append(r.mate_pos - 1 if r.mate_pos > 0 else -1)
        singlem.append(r.single_m() and not (r.bf & 0x4))
        if not (r.bf & 0x4):
            for bs, be in r.aligned_blocks():
                seg_t.append(r.ref_id)
                seg_s.append(bs)
                seg_e.append(be)
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


# -------------------------------------------------------------- writer

# EOF container (CRAM 3.0 spec appendix: fixed marker bytes)
EOF_CONTAINER = bytes([
    0x0f, 0x00, 0x00, 0x00, 0xff, 0xff, 0xff, 0xff, 0x0f, 0xe0,
    0x45, 0x4f, 0x46, 0x00, 0x00, 0x00, 0x00, 0x01, 0x00, 0x05,
    0xbd, 0xd9, 0x4f, 0x00, 0x01, 0x00, 0x06, 0x06, 0x01, 0x00,
    0x01, 0x00, 0x01, 0x00, 0xee, 0x63, 0x01, 0x4b,
])

# the 2.x EOF marker: same empty container (ref -1, start 0x454F46
# "EOF", one 6-byte raw compression-header block of empty maps) in the
# CRC-less 2.x layout with its ITF8 record counter — validated by
# exact byte comparison at open by other readers
EOF_CONTAINER_V2 = bytes([
    0x0b, 0x00, 0x00, 0x00,              # container length 11
    0xff, 0xff, 0xff, 0xff, 0x0f,        # ref id -1 (itf8)
    0xe0, 0x45, 0x4f, 0x46,              # start 0x454F46 "EOF"
    0x00, 0x00, 0x00, 0x00,              # span, nrec, counter, bases
    0x01, 0x00,                          # 1 block, 0 landmarks
    0x00, 0x01, 0x00, 0x06, 0x06,        # raw comp-header block, 6 bytes
    0x01, 0x00, 0x01, 0x00, 0x01, 0x00,  # empty preservation/maps
])

# external block content ids for the fixture writer's series
_W_IDS = {
    "BF": 1, "CF": 2, "RL": 3, "AP": 4, "RG": 5, "RN": 6, "MF": 7,
    "NS": 8, "NP": 9, "TS": 10, "TL": 11, "FN": 12, "FC": 13, "FP": 14,
    "DL": 15, "RS": 16, "HC": 17, "PD": 18, "SC": 19, "IN": 20,
    "BA": 21, "MQ": 22, "QS": 23, "BS": 24, "NF": 25, "RI": 26,
}


class CramWriter:
    """Minimal spec-conformant CRAM 3.0 writer for hermetic fixtures.

    One slice per container; every data series EXTERNAL in its own
    block (ITF8 ints / stop-byte name arrays); detached mate info; no
    tag values (one empty TD line). ``block_method`` picks the block
    compression (gzip default; rans exercises the rANS decoder
    round-trip). This is a test tool, not a production encoder — the
    production direction CRAM→columns is what the reader implements.
    """

    def __init__(self, fh, header_text: str, ref_names: list[str],
                 ref_lens: list[int], records_per_container: int = 10000,
                 block_method: int = M_GZIP, ap_delta: bool = True,
                 rans_order: int = 0, minor: int = 0, major: int = 3,
                 series_methods: dict[str, int] | None = None,
                 core_series: tuple = (), with_tags: bool = False,
                 rans_stripe: int = 0):
        if major not in (2, 3):
            raise ValueError("cram: writer supports major 2 and 3")
        self._fh = fh
        self.ref_names = list(ref_names)
        self._rpc = records_per_container
        self._method = block_method
        self._rans_order = rans_order
        self._rans_stripe = rans_stripe
        self._ap_delta = ap_delta
        self._v2 = major == 2
        # per-series block-method overrides, e.g. the htslib 3.1 shape
        # {"RN": M_TOK3, "QS": M_FQZCOMP}: RN switches to a \0 stop
        # byte and the tokeniser; QS compresses the per-record quality
        # payload through fqzcomp. Only combinations with a real
        # encoder are accepted — anything else would write a method
        # byte over a payload that codec cannot decode.
        general = {M_RAW, M_GZIP, M_RANS, M_RANSNX16, M_ARITH}
        if block_method not in general:
            raise ValueError(
                "cram: block_method must be a general-purpose codec "
                "(raw/gzip/rans4x8/rans-nx16/arith); use "
                "series_methods for RN:tok3 / QS:fqzcomp")
        self._series_methods = dict(series_methods or {})
        for k, m in self._series_methods.items():
            if m in general or (k == "RN" and m == M_TOK3) or \
                    (k == "QS" and m == M_FQZCOMP):
                continue
            raise ValueError(
                f"cram: no encoder for series {k!r} with method {m} "
                "(tok3 is RN-only, fqzcomp is QS-only)")
        # core-bit series: integer series coded as canonical HUFFMAN
        # bits in the CORE block (the layout real htslib CRAMs use for
        # BF/TL/MQ) instead of EXTERNAL ITF8 streams
        self._core_series = tuple(core_series)
        for k in self._core_series:
            if k not in ("BF", "RL", "MQ"):
                raise ValueError(
                    "cram: core_series supports BF/RL/MQ (the integer "
                    "series this fixture writer emits per record)")
        self._with_tags = with_tags
        self._pending: list[dict] = []
        self._counter = 0
        self._offsets: list[tuple[int, int, int, int, int]] = []
        fh.write(CRAM_MAGIC + bytes([major, minor])
                 + b"goleft-tpu-cram\x00\x00\x00\x00\x00")
        sq = "".join(
            f"@SQ\tSN:{n}\tLN:{ln}\n"
            for n, ln in zip(ref_names, ref_lens)
        )
        text = (header_text if "@SQ" in header_text
                else header_text + sq).encode()
        blob = struct.pack("<i", len(text)) + text
        block = write_block(M_RAW, CT_FILE_HEADER, 0, blob,
                            v2=self._v2)
        self._fh.write(ContainerHeader.build(
            len(block), 0, 0, 0, 0, 0, 0, 1, [0],
            v2=self._v2) + block)

    def write_record(self, tid: int, pos0: int,
                     cigar: list[tuple[int, int]], mapq: int = 60,
                     flag: int = 0, name: str = "r", mate_tid: int = -1,
                     mate_pos: int = -1, tlen: int = 0,
                     quals: bytes | None = None) -> None:
        """pos0 is 0-based (BamWriter-compatible); CRAM stores 1-based.
        ``quals`` (one byte per query base) stores the record's quality
        string (CF_QS_STORED) in the QS series."""
        if quals is not None:
            q_len = sum(ln for ln, op in cigar if op in (0, 1, 4, 7, 8))
            if len(quals) != q_len or not quals:
                raise ValueError(
                    "cram: quals must be non-empty and match the "
                    "query length")
        self._pending.append(dict(
            tid=tid, pos=pos0 + 1, cigar=cigar, mapq=mapq, flag=flag,
            name=name, mate_tid=mate_tid, mate_pos=mate_pos + 1,
            tlen=tlen, quals=quals,
        ))
        if len(self._pending) >= self._rpc or (
            len(self._pending) > 1
            and self._pending[-2]["tid"] != tid
        ):
            # flush everything before a tid change (single-ref slices)
            tail = []
            while self._pending and self._pending[-1]["tid"] != \
                    self._pending[0]["tid"]:
                tail.append(self._pending.pop())
            self._flush()
            self._pending = list(reversed(tail))

    def _flush(self) -> None:
        recs = self._pending
        if not recs:
            return
        self._pending = []
        ids = _W_IDS
        ints: dict[str, list[int]] = {k: [] for k in ids}
        rn_tok3 = self._series_methods.get("RN") == M_TOK3
        rn_stop = 0x00 if rn_tok3 else 0x09
        names = bytearray()
        name_list: list[bytes] = []
        qs_payload = bytearray()
        qs_lens: list[int] = []
        sc_bytes = bytearray()
        in_bytes = bytearray()
        ref_id = recs[0]["tid"]
        first_pos = recs[0]["pos"]
        prev = first_pos
        max_end = first_pos
        for r in recs:
            q_len = sum(ln for ln, op in r["cigar"]
                        if op in (0, 1, 4, 7, 8))  # M I S = X
            bf = r["flag"] & ~(BAM_MREVERSE | BAM_MUNMAP)
            cf = CF_DETACHED | CF_NO_SEQ
            if r.get("quals") is not None:
                cf |= CF_QS_STORED
                qs_payload += r["quals"]
                qs_lens.append(len(r["quals"]))
            ints["BF"].append(bf)
            ints["CF"].append(cf)
            ints["RL"].append(q_len)
            if self._ap_delta:
                ints["AP"].append(r["pos"] - prev)
                prev = r["pos"]
            else:
                ints["AP"].append(r["pos"])
            ints["RG"].append(-1)
            nm = r["name"].encode()
            names += nm + bytes([rn_stop])
            name_list.append(nm)
            mf = ((MF_MATE_REVERSE if r["flag"] & BAM_MREVERSE else 0)
                  | (MF_MATE_UNMAPPED if r["flag"] & BAM_MUNMAP else 0))
            ints["MF"].append(mf)
            ints["NS"].append(r["mate_tid"])
            ints["NP"].append(r["mate_pos"])
            ints["TS"].append(r["tlen"])
            ints["TL"].append(0)
            if not (r["flag"] & 0x4):
                feats = []
                qp = 1
                for ln, op in r["cigar"]:
                    if op == 0 or op == 7 or op == 8:  # M/=/X
                        qp += ln
                    elif op == 4:  # S
                        feats.append((ord("S"), qp, ln))
                        qp += ln
                    elif op == 1:  # I
                        feats.append((ord("I"), qp, ln))
                        qp += ln
                    elif op == 2:  # D
                        feats.append((ord("D"), qp, ln))
                    elif op == 3:  # N
                        feats.append((ord("N"), qp, ln))
                    elif op == 5:  # H
                        feats.append((ord("H"), qp, ln))
                    elif op == 6:  # P
                        feats.append((ord("P"), qp, ln))
                ints["FN"].append(len(feats))
                fprev = 0
                for code, fp, ln in feats:
                    ints["FC"].append(code)
                    ints["FP"].append(fp - fprev)
                    fprev = fp
                    if code == ord("S"):
                        sc_bytes += b"N" * ln + b"\x00"
                    elif code == ord("I"):
                        in_bytes += b"N" * ln + b"\x00"
                    elif code == ord("D"):
                        ints["DL"].append(ln)
                    elif code == ord("N"):
                        ints["RS"].append(ln)
                    elif code == ord("H"):
                        ints["HC"].append(ln)
                    elif code == ord("P"):
                        ints["PD"].append(ln)
                ints["MQ"].append(r["mapq"])
                ref_len = sum(ln for ln, op in r["cigar"]
                              if op in (0, 2, 3, 7, 8))
                max_end = max(max_end, r["pos"] + ref_len)
        span = max_end - first_pos

        comp = CompressionHeader(
            rn_included=True, ap_delta=self._ap_delta, ref_required=False,
            tag_dict=[[]],
        )
        tag_cid = max(ids.values()) + 1  # past every series block id
        if self._with_tags:
            # one NM:C tag per record through BYTE_ARRAY_LEN — the
            # nested-encoding shape real htslib CRAMs use for tag
            # values: length from a 0-bit single-symbol HUFFMAN (every
            # 'C' value is 1 byte), bytes from their own EXTERNAL
            # block
            comp.tag_dict = [[("NM", "C")]]
            key = (ord("N") << 16) | (ord("M") << 8) | ord("C")
            comp.tag_encodings[key] = Encoding(E_BYTE_ARRAY_LEN, {
                "len_enc": Encoding(E_HUFFMAN, {"alphabet": [1],
                                                "lengths": [0]}),
                "val_enc": Encoding(E_EXTERNAL, {"id": tag_cid}),
            })
        huff_codes: dict[str, dict[int, tuple[int, int]]] = {}
        for key, cid in ids.items():
            if key in self._core_series and ints[key]:
                alphabet, lengths = _huffman_lengths(ints[key])
                comp.encodings[key] = Encoding(
                    E_HUFFMAN, {"alphabet": alphabet,
                                "lengths": lengths})
                huff_codes[key] = _canonical_codes(alphabet, lengths)
            elif key == "RN":
                comp.encodings[key] = Encoding(
                    E_BYTE_ARRAY_STOP, {"stop": rn_stop, "id": cid})
            elif key in ("SC", "IN"):
                comp.encodings[key] = Encoding(
                    E_BYTE_ARRAY_STOP, {"stop": 0x00, "id": cid})
            else:
                comp.encodings[key] = Encoding(E_EXTERNAL, {"id": cid})

        # core bits, in the exact order decode_slice consumes them:
        # BF then RL per record, MQ only for mapped records
        core_bytes = b""
        if huff_codes:
            bw = BitWriter()
            mq_vals = iter(ints["MQ"])
            for i, r in enumerate(recs):
                per_rec = [("BF", ints["BF"][i]), ("RL", ints["RL"][i])]
                if not (r["flag"] & 0x4):
                    per_rec.append(("MQ", next(mq_vals)))
                for key, v in per_rec:
                    codes = huff_codes.get(key)
                    if codes is not None:
                        code, ln = codes[v]
                        bw.write(code, ln)
            core_bytes = bw.finish()

        ext_payload: dict[int, bytes] = {}
        for key, cid in ids.items():
            if key in huff_codes:
                continue  # series lives in the core block
            if key == "RN":
                ext_payload[cid] = bytes(names)
            elif key == "QS":
                ext_payload[cid] = bytes(qs_payload)
            elif key == "SC":
                ext_payload[cid] = bytes(sc_bytes)
            elif key == "IN":
                ext_payload[cid] = bytes(in_bytes)
            else:
                ext_payload[cid] = b"".join(
                    write_itf8(v) for v in ints[key]
                )
        if self._with_tags:
            # stand-in per-record NM value (any byte works — the
            # decoder consumes tag values for stream alignment only)
            ext_payload[tag_cid] = bytes(
                min(len(r["cigar"]), 255) for r in recs)
        used = [cid for cid, payload in ext_payload.items() if payload]
        key_of = {cid: key for key, cid in ids.items()}

        sl = SliceHeader(
            ref_id, first_pos, span, len(recs), self._counter,
            1 + len(used), list(used), -1, b"\x00" * 16,
        )
        blocks = write_block(M_RAW, CT_SLICE_HEADER, 0,
                             sl.serialize(v2=self._v2), v2=self._v2)
        blocks += write_block(M_RAW, CT_CORE, 0, core_bytes,
                              v2=self._v2)
        for cid in used:
            key = key_of.get(cid)  # None for the tag-value block
            method = self._series_methods.get(key, self._method)
            payload = ext_payload[cid]
            if method == M_TOK3 and key == "RN":
                from .tok3 import encode as tok3_encode

                comp_bytes = tok3_encode(name_list)
                blocks += _write_block_pre(M_TOK3, CT_EXTERNAL, cid,
                                           comp_bytes, len(payload),
                                           self._v2)
            elif method == M_FQZCOMP and key == "QS":
                from .fqzcomp import encode as fqz_encode

                comp_bytes = fqz_encode(qs_lens, bytes(payload))
                blocks += _write_block_pre(M_FQZCOMP, CT_EXTERNAL, cid,
                                           comp_bytes, len(payload),
                                           self._v2)
            else:
                blocks += write_block(method, CT_EXTERNAL, cid, payload,
                                      rans_order=self._rans_order,
                                      v2=self._v2,
                                      rans_stripe=self._rans_stripe)
        comp_block = write_block(M_RAW, CT_COMP_HEADER, 0,
                                 comp.serialize(), v2=self._v2)
        body = comp_block + blocks
        container_off = self._fh.tell()
        n_bases = sum(ints["RL"])
        self._fh.write(ContainerHeader.build(
            len(body), ref_id, first_pos, span, len(recs),
            self._counter, n_bases, 2 + len(used), [len(comp_block)],
            v2=self._v2,
        ))
        self._fh.write(body)
        self._offsets.append(
            (ref_id, first_pos, span, container_off, len(comp_block))
        )
        self._counter += len(recs)

    def close(self) -> None:
        self._flush()
        self._fh.write(EOF_CONTAINER_V2 if self._v2 else EOF_CONTAINER)

    def write_crai(self, path: str) -> None:
        """Companion .crai (gzipped 6-column TSV, spec appendix)."""
        with gzip.open(path, "wt") as fh:
            for (seq, start, span, c_off, slice_off) in self._offsets:
                fh.write(f"{seq}\t{start}\t{span}\t{c_off}\t"
                         f"{slice_off}\t0\n")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
