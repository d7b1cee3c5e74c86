"""BGZF codec, clean-room from the SAM/BAM specification (section 4.1).

BGZF is a series of gzip members, each with an extra subfield ("BC") carrying
the total compressed block size minus one; blocks hold at most 65536 bytes of
uncompressed payload. The stream ends with a fixed 28-byte empty block.

Virtual offsets are ``coffset << 16 | uoffset`` exactly as in
BAI/virtual-file-offset semantics. A copy of the JAX package's
io/bgzf.py; the native C++ fast path (csrc/fastio.cpp) inflates and
deflates blocks when available, this module is the portable fallback.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO


# Fixed empty final block from the SAM spec (magic EOF marker).
BGZF_EOF = bytes(
    [
        0x1F, 0x8B, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xFF,
        0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1B, 0x00, 0x03, 0x00,
        0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    ]
)

# Leave headroom for the gzip wrapper so a worst-case incompressible block
# still fits in the u16 BSIZE field.
WRITE_CHUNK = 0xFF00


def _parse_block_header(buf: bytes, off: int) -> tuple[int, int]:
    """Return (bsize, xlen) for the gzip member starting at ``off``.

    bsize is the total compressed size of the member (BC subfield + 1).
    """
    if buf[off : off + 2] != b"\x1f\x8b":
        raise ValueError(f"bgzf: bad gzip magic at offset {off}")
    flg = buf[off + 3]
    if not flg & 4:  # FEXTRA
        raise ValueError("bgzf: gzip member without FEXTRA (not BGZF)")
    (xlen,) = struct.unpack_from("<H", buf, off + 10)
    xoff = off + 12
    xend = xoff + xlen
    while xoff < xend:
        si1, si2, slen = struct.unpack_from("<BBH", buf, xoff)
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            (bsize_minus1,) = struct.unpack_from("<H", buf, xoff + 4)
            return bsize_minus1 + 1, xlen
        xoff += 4 + slen
    raise ValueError("bgzf: no BC subfield in gzip extra")


class BgzfReader:
    """Random-access BGZF reader over an in-memory compressed stream.

    Supports sequential ``read`` and ``seek_virtual(voffset)`` where
    voffset = compressed_offset << 16 | within_block_offset.
    """

    def __init__(self, data: bytes):
        self._data = data
        self._coffset = 0  # compressed offset of current block
        self._block = b""
        self._uoffset = 0  # position within current inflated block
        self._next_coffset = 0
        self._load_block(0)

    @classmethod
    def from_file(cls, path: str) -> "BgzfReader":
        with open(path, "rb") as fh:
            return cls(fh.read())

    def _load_block(self, coffset: int) -> None:
        if coffset >= len(self._data):
            self._coffset = coffset
            self._block = b""
            self._uoffset = 0
            self._next_coffset = coffset
            return
        bsize, xlen = _parse_block_header(self._data, coffset)
        cdata_off = coffset + 12 + xlen
        cdata_len = bsize - 12 - xlen - 8
        self._block = zlib.decompress(
            self._data[cdata_off : cdata_off + cdata_len], wbits=-15
        )
        (crc,) = struct.unpack_from("<I", self._data, coffset + bsize - 8)
        if zlib.crc32(self._block) & 0xFFFFFFFF != crc:
            raise ValueError("bgzf: CRC mismatch (corrupt block)")
        self._coffset = coffset
        self._next_coffset = coffset + bsize
        self._uoffset = 0

    def seek_virtual(self, voffset: int) -> None:
        coffset = voffset >> 16
        uoffset = voffset & 0xFFFF
        if coffset != self._coffset or not self._block:
            self._load_block(coffset)
        self._uoffset = uoffset

    def tell_virtual(self) -> int:
        return (self._coffset << 16) | self._uoffset

    @property
    def eof(self) -> bool:
        return self._uoffset >= len(self._block) and self._next_coffset >= len(
            self._data
        )

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if self._uoffset >= len(self._block):
                if self._next_coffset >= len(self._data):
                    break
                self._load_block(self._next_coffset)
                if not self._block:
                    break
                continue
            take = min(n, len(self._block) - self._uoffset)
            out += self._block[self._uoffset : self._uoffset + take]
            self._uoffset += take
            n -= take
        return bytes(out)


class BgzfWriter:
    """Streaming BGZF writer (used for .bam fixtures and bed.gz outputs).

    ``block_size`` caps uncompressed bytes per block — small blocks give
    test fixtures realistic multi-block-per-tile BAI linear indexes.
    """

    def __init__(self, fh: BinaryIO, level: int = 6,
                 block_size: int = WRITE_CHUNK):
        self._fh = fh
        self._level = level
        self._chunk = min(block_size, WRITE_CHUNK)
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= self._chunk:
            self._flush_block(self._chunk)

    def _flush_block(self, n: int) -> None:
        chunk = bytes(self._buf[:n])
        del self._buf[:n]
        # native libdeflate block compression is 2-4x zlib; decompressed
        # content is identical either way, only compressed bytes differ
        from . import native

        blob = native.bgzf_deflate_block(chunk, self._level)
        if blob is not None:
            self._fh.write(blob)
            return
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        crc = zlib.crc32(chunk) & 0xFFFFFFFF
        bsize = len(cdata) + 12 + 6 + 8  # header(12) + extra(6) + crc/isize(8)
        header = struct.pack(
            "<BBBBIBBHBBHH",
            0x1F, 0x8B, 8, 4,  # magic, deflate, FEXTRA
            0, 0, 0xFF,  # mtime, xfl, os
            6,  # xlen
            0x42, 0x43, 2,  # BC subfield
            bsize - 1,
        )
        self._fh.write(header + cdata + struct.pack("<II", crc, len(chunk)))

    def close(self) -> None:
        while self._buf:
            self._flush_block(min(len(self._buf), self._chunk))
        self._fh.write(BGZF_EOF)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
