"""Transparent text/gzip/bgzip file IO.

Covers the role of brentp/xopen in the reference (see SURVEY.md §2.4): every
subcommand reads/writes plain or (b)gzipped files through one helper.
"""

from __future__ import annotations

import gzip
import io
import sys


def _is_gzip(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(2) == b"\x1f\x8b"


def xopen(path: str, mode: str = "r"):
    """Open ``path`` transparently.

    - "-" means stdin/stdout.
    - Reading: gzip is auto-detected from magic bytes (BGZF is a valid gzip
      stream, so .bam/.bed.gz both inflate correctly).
    - Writing: paths ending in .gz are gzip-compressed.
    """
    if path == "-":
        if "r" in mode:
            return sys.stdin if "b" not in mode else sys.stdin.buffer
        return sys.stdout if "b" not in mode else sys.stdout.buffer
    if "r" in mode:
        if _is_gzip(path):
            fh = gzip.open(path, "rb")
            if "b" in mode:
                return fh
            return io.TextIOWrapper(fh)
        return open(path, mode)
    if path.endswith(".gz"):
        fh = gzip.open(path, "wb")
        if "b" in mode:
            return fh
        return io.TextIOWrapper(fh)
    return open(path, mode)
