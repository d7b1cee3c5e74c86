"""FASTA index (.fai) parsing and random sequence access.

A copy of the JAX package's io/fai.py: chromosome name/length lists for
``depth`` shards and random-access GC/CpG/masked window stats for
``depth -s``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FaiRecord:
    name: str
    length: int
    offset: int
    line_bases: int
    line_width: int


def read_fai(path: str) -> list[FaiRecord]:
    out = []
    with open(path) as fh:
        lines = fh.read().splitlines()
    for lineno, line in enumerate(lines, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            f = line.split("\t")
            try:
                out.append(FaiRecord(f[0], int(f[1]), int(f[2]),
                                     int(f[3]), int(f[4])))
            except (ValueError, IndexError):
                raise ValueError(
                    f"{path}:{lineno}: not a .fai line (need name + 4 "
                    f"integer fields)"
                )
    return out


def write_fai(fasta_path: str) -> list[FaiRecord]:
    """Index a FASTA file, writing ``<fasta>.fai``. For fixtures and -s."""
    recs = []
    with open(fasta_path, "rb") as fh:
        name = None
        length = 0
        offset = 0
        line_bases = 0
        line_width = 0
        pos = 0
        for raw in fh:
            if raw.startswith(b">"):
                if name is not None:
                    recs.append(FaiRecord(name, length, offset, line_bases,
                                          line_width))
                name = raw[1:].split()[0].decode()
                length = 0
                line_bases = 0
                line_width = 0
                offset = pos + len(raw)
            else:
                stripped = raw.rstrip(b"\r\n")
                if line_bases == 0:
                    line_bases = len(stripped)
                    line_width = len(raw)
                length += len(stripped)
            pos += len(raw)
        if name is not None:
            recs.append(FaiRecord(name, length, offset, line_bases,
                                  line_width))
    with open(fasta_path + ".fai", "w") as out:
        for r in recs:
            out.write(f"{r.name}\t{r.length}\t{r.offset}\t{r.line_bases}\t"
                      f"{r.line_width}\n")
    return recs


class Faidx:
    """Random access to FASTA subsequences via the .fai index."""

    def __init__(self, fasta_path: str, fai_path: str | None = None):
        self.path = fasta_path
        if fai_path:
            self.records = {r.name: r for r in read_fai(fai_path)}
        else:
            try:
                self.records = {
                    r.name: r for r in read_fai(fasta_path + ".fai")}
            except FileNotFoundError:
                self.records = {r.name: r for r in write_fai(fasta_path)}
        self._fh = open(fasta_path, "rb")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def names(self) -> list[str]:
        return list(self.records)

    def length(self, name: str) -> int:
        return self.records[name].length

    def fetch(self, name: str, start: int, end: int) -> bytes:
        """0-based half-open subsequence (newlines stripped)."""
        r = self.records[name]
        start = max(0, start)
        end = min(end, r.length)
        if end <= start:
            return b""
        first_line = start // r.line_bases
        byte_start = r.offset + first_line * r.line_width + (
            start - first_line * r.line_bases
        )
        last_line = (end - 1) // r.line_bases
        byte_end = r.offset + last_line * r.line_width + (
            end - last_line * r.line_bases
        )
        self._fh.seek(byte_start)
        raw = self._fh.read(byte_end - byte_start)
        return raw.replace(b"\n", b"").replace(b"\r", b"")

    def window_stats(self, name: str, start: int, end: int,
                     gc_flank: int = 0) -> dict:
        """GC / CpG / masked fractions for a window.

        Matches the stats reported by ``goleft depth -s``
        (depth/depth.go:191-200): GC over [start-flank, end+flank) when a
        flank is configured (reference uses start-250, dcnv/dcnv.go:82-86
        for its variant), CpG count, and lowercase (soft-masked) fraction.
        """
        seq = self.fetch(name, start - gc_flank, end + gc_flank)
        if not seq:
            return {"gc": 0.0, "cpg": 0.0, "masked": 0.0}
        arr = np.frombuffer(seq, dtype=np.uint8)
        upper = np.where((arr >= 97) & (arr <= 122), arr - 32, arr)
        n = len(arr)
        gc = float(np.sum((upper == 71) | (upper == 67))) / n  # G, C
        cpg = 0.0
        if n > 1:
            cpg = 2.0 * float(
                np.sum((upper[:-1] == 67) & (upper[1:] == 71))
            ) / n
        masked = float(np.sum((arr >= 97) & (arr <= 122))) / n
        return {"gc": gc, "cpg": cpg, "masked": masked}
