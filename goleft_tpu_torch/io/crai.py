"""CRAI (CRAM index) reader: region entries, and 16KB tile interpolation
for indexcov.

The .crai format is gzipped TSV with six fields per line
(seqID, alnStart, alnSpan, containerStart, sliceStart, sliceLen), CRAM spec
appendix. A copy of the JAX package's io/crai.py. ``load_crai_entries``
keeps what io/cram.py's region lookup reads: the (seqID, alnStart,
alnSpan, containerStart) of each line, as the JAX package's
io/cram.py::_load_crai_entries does. ``read_crai`` parses every slice,
and ``CraiIndex.sizes`` interpolates them into indexcov's 16,384bp tiles
(CRAM slices are irregularly sized).

Behavioral contract of the tile interpolation, from the reference
(indexcov/crai/crai.go:45-127):
  - lines with seqID == -1 (unmapped) are skipped; a negative alnSpan stops
    parsing early (crai.go:163-166)
  - the final slice's span is zeroed when negative or > 1e6 (":63-69")
  - gaps before a slice back-fill one tile of the previous per-base value
    then zeros (":76-85")
  - slices starting > one tile *before* the current tile cursor (long reads
    overlapping) are trimmed forward by whole tiles (":91-99")
  - per-base value = 100000 * sliceBytes / span (":105-106"), emitted
    span/16384 times; slices shorter than a tile carry their value into
    ``lastVal`` (":108-115")
"""

from __future__ import annotations

import gzip
import zlib
from dataclasses import dataclass

import numpy as np

TILE_WIDTH = 16384
PER_BASE_SCALE = 100000


@dataclass
class CraiSlice:
    aln_start: int
    aln_span: int
    container_start: int
    slice_start: int
    slice_len: int


@dataclass
class CraiIndex:
    slices: list[list[CraiSlice]]  # per seqID

    def sizes(self) -> list[np.ndarray]:
        # share one empty result across absent seqIDs so a sparse
        # high-seqID index costs pointers, not millions of arrays
        empty = np.zeros(0, dtype=np.int64)
        return [_make_sizes(s) if s else empty for s in self.slices]


def _make_sizes(slices: list[CraiSlice]) -> np.ndarray:
    if not slices:
        return np.zeros(0, dtype=np.int64)
    # defensive fix-ups on the final slice
    last = slices[-1]
    last_span = last.aln_span
    if last_span < 0 or last_span > 1_000_000:
        last = CraiSlice(last.aln_start, 0, last.container_start,
                         last.slice_start, last.slice_len)
        slices = slices[:-1] + [last]

    sizes: list[int] = []
    last_start = 0
    last_val = 0
    for sl in slices:
        start, span = sl.aln_start, sl.aln_span
        # back-fill gap tiles: first gets the carried value, rest zero
        k = 0
        while last_start < start - TILE_WIDTH:
            sizes.append(last_val if k == 0 else 0)
            if k == 0:
                last_val = 0
            k += 1
            last_start += TILE_WIDTH
        overhang = start - last_start
        if overhang > TILE_WIDTH:
            raise ValueError("crai: tile cursor logic error")
        while overhang < -TILE_WIDTH:
            # long reads from the prior slice spilled more than a tile in
            start += TILE_WIDTH
            span -= TILE_WIDTH
            overhang = start - last_start
        if span <= 0:
            continue
        per_base = int(PER_BASE_SCALE * float(sl.slice_len) / float(sl.aln_span))
        n_tiles = int(float(sl.aln_span) / TILE_WIDTH)
        if n_tiles == 0 and start - last_start < TILE_WIDTH:
            last_val = per_base
            continue
        sizes.extend([per_base] * n_tiles)
        last_start += TILE_WIDTH * n_tiles
        last_val = per_base
    return np.asarray(sizes, dtype=np.int64)


def read_crai(path_or_bytes) -> CraiIndex:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        from . import remote

        data = remote.fetch_bytes(path_or_bytes)
    if data[:2] == b"\x1f\x8b":
        # typed error surface: corrupt/truncated compressed bytes must
        # come out as the module's ValueError, not raw zlib/EOF errors
        # (pinned by tests/test_index_fuzz.py)
        try:
            data = gzip.decompress(data)
        except (OSError, EOFError, zlib.error) as e:
            raise ValueError(f"crai: corrupt gzip stream ({e})")
    try:
        text = data.decode()
    except UnicodeDecodeError:
        raise ValueError("crai: not a text index (bad utf-8)")
    # parse into a sparse {seqID: slices} map — a single hostile line
    # claiming a huge (but in-bounds) seqID must not allocate millions
    # of per-seqID lists mid-parse (ADVICE r3); densification at the
    # end shares one sentinel list across absent ids, so the dense
    # index costs one pointer per id, not one list object per id.
    by_id: dict[int, list[CraiSlice]] = {}
    lines = text.splitlines()
    # 16.7M references clears every real assembly (largest public ones
    # are ~5M scaffolds — including regionally-subsetted CRAMs whose
    # few lines may all carry a high seqID); beyond is corruption/DoS
    si_bound = 2 ** 24
    for lineno, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        parts = line.split("\t")
        if len(parts) != 6:
            raise ValueError(
                f"crai: expected 6 fields, got {len(parts)} at line {lineno}"
            )
        try:
            vals = [int(p) for p in parts]
        except ValueError:
            raise ValueError(f"crai: non-integer field at line {lineno}")
        si, aln_start, aln_span, cstart, sstart, slen = vals
        if si == -1:
            continue  # unmapped
        # bounds sanity: a corrupt/malicious line must not allocate an
        # unbounded per-seqID list (DoS) or overflow later float math
        if si < 0 or si > si_bound:
            raise ValueError(f"crai: implausible seqID {si} at line "
                             f"{lineno}")
        if max(abs(cstart), abs(sstart), abs(slen)) > 2**62:
            raise ValueError(f"crai: out-of-range field at line {lineno}")
        if max(abs(aln_start), aln_span) > 2**40:
            # genomic coordinates: anything past ~1e12 is corruption and
            # would make _make_sizes extend an unbounded tile list
            raise ValueError(f"crai: implausible genomic span at line "
                             f"{lineno}")
        if aln_span < 0:
            break  # matches reference early-break on negative span
        by_id.setdefault(si, []).append(
            CraiSlice(aln_start, aln_span, cstart, sstart, slen)
        )
    empty: list[CraiSlice] = []  # shared read-only sentinel
    dense = [empty] * (max(by_id) + 1 if by_id else 0)
    for si, lst in by_id.items():
        dense[si] = lst
    return CraiIndex(dense)


def load_crai_entries(path: str) -> list[tuple[int, int, int, int]]:
    """(seq_id, aln_start (1-based), aln_span, container_offset) per
    index line; lines with fewer than six fields are skipped. A URL is
    read through io/remote.py."""
    import io as _pyio

    from . import remote

    entries = []
    if remote.is_remote(path):
        fh = _pyio.TextIOWrapper(gzip.GzipFile(
            fileobj=_pyio.BytesIO(remote.fetch_bytes(path))))
    else:
        fh = gzip.open(path, "rt")
    with fh:
        for line in fh:
            t = line.split("\t")
            if len(t) < 6:
                continue
            entries.append((int(t[0]), int(t[1]), int(t[2]), int(t[3])))
    return entries
