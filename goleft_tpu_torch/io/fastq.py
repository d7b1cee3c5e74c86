"""Strict streaming FASTQ reader: plain, gzip/BGZF, local or remote.

A copy of the JAX package's io/fastq.py over the port's io/remote.py.

The read-mapping pipeline's input layer. Bytes come through the data
plane's :func:`~goleft_tpu.io.remote.source_io`, so ``http(s)://`` /
``s3://`` FASTQs read exactly like local paths (block-cached ranged
reads); gzip — including BGZF, which is concatenated gzip members —
is detected from magic bytes like utils/xopen does.

Parsing is deliberately strict 4-line FASTQ. Every malformed shape is
a :class:`FastqError` (a ``ValueError`` → classified PERMANENT by the
resilience RetryPolicy — retrying a corrupt file cannot help) with
the record number and offending line in the message, never a hang or
a silently-truncated iteration:

  - a record line missing at EOF → "truncated FASTQ record"
  - a sequence wrapped over multiple lines → rejected with a clear
    error (the '+' separator is how we detect it)
  - a '+' separator repeating a DIFFERENT header → rejected
    (repeating the same header is legal and accepted)
  - quality/sequence length mismatch → rejected
  - an empty file → rejected (a mapper fed zero bytes is a broken
    upstream, not an empty cohort)
  - CRLF line endings are accepted (both \\r\\n and \\n strip)
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, NamedTuple

from . import remote

#: bases the mapper accepts; anything else in a sequence line is
#: treated as corruption, not data
_SEQ_OK = frozenset(b"ACGTNacgtn" + bytes(range(ord("A"), ord("Z") + 1))
                    + bytes(range(ord("a"), ord("z") + 1)))


class FastqError(ValueError):
    """Malformed FASTQ — permanent under the RetryPolicy."""


class FastqRecord(NamedTuple):
    name: str
    seq: bytes
    qual: bytes


def _open_stream(path: str):
    """Binary line stream for ``path`` (gzip/BGZF auto-detected)."""
    raw = remote.source_io(path)
    buf = raw if isinstance(raw, io.BufferedReader) \
        else io.BufferedReader(raw)
    if buf.peek(2)[:2] == b"\x1f\x8b":
        return gzip.GzipFile(fileobj=buf), buf
    return buf, buf


class FastqReader:
    """Iterate :class:`FastqRecord` from a FASTQ path/URL.

    Usable as an iterator or a context manager; iteration raises
    :class:`FastqError` at the first malformed record (position
    included) and StopIteration cleanly at a well-formed EOF.
    """

    def __init__(self, path: str):
        self.path = path
        self._fh, self._raw = _open_stream(path)
        self._lineno = 0
        self.records = 0

    def close(self) -> None:
        try:
            self._fh.close()
        finally:
            if self._raw is not self._fh:
                self._raw.close()

    def __enter__(self) -> "FastqReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _err(self, msg: str) -> FastqError:
        return FastqError(
            f"{self.path}: record {self.records + 1} "
            f"(line {self._lineno}): {msg}")

    def _line(self) -> bytes | None:
        ln = self._fh.readline()
        if not ln:
            return None
        self._lineno += 1
        return ln.rstrip(b"\r\n")

    def __iter__(self) -> Iterator[FastqRecord]:
        return self

    def __next__(self) -> FastqRecord:
        hdr = self._line()
        if hdr is None:
            if self.records == 0:
                raise FastqError(
                    f"{self.path}: empty FASTQ (zero records)")
            raise StopIteration
        if not hdr.startswith(b"@"):
            raise self._err(
                f"expected '@' header, got {hdr[:40]!r}")
        seq = self._line()
        if seq is None:
            raise self._err("truncated FASTQ record (no sequence)")
        if not seq or not all(b in _SEQ_OK for b in seq):
            raise self._err(
                f"invalid sequence line {seq[:40]!r}")
        sep = self._line()
        if sep is None:
            raise self._err("truncated FASTQ record (no '+' line)")
        if not sep.startswith(b"+"):
            if all(b in _SEQ_OK for b in sep):
                raise self._err(
                    "multi-line sequences are not supported "
                    "(expected '+' separator)")
            raise self._err(
                f"expected '+' separator, got {sep[:40]!r}")
        if len(sep) > 1 and sep[1:] != hdr[1:]:
            raise self._err(
                "'+' separator repeats a different header")
        qual = self._line()
        if qual is None:
            raise self._err("truncated FASTQ record (no quality)")
        if len(qual) != len(seq):
            raise self._err(
                f"quality length {len(qual)} != sequence length "
                f"{len(seq)}")
        self.records += 1
        name = hdr[1:].split()[0].decode("ascii", "replace") \
            if len(hdr) > 1 else ""
        return FastqRecord(name, seq, qual)


def read_fastq(path: str) -> list[FastqRecord]:
    """Whole-file convenience (tests, small inputs)."""
    with FastqReader(path) as r:
        return list(r)
