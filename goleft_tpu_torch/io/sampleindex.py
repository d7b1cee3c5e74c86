"""A BAM/CRAM index as indexcov reads it (per-chromosome tile sizes and
their scaling median), the sample's short name, and the reference list:
the host half of indexcov, which ``indexsplit`` shares. It imports no
torch, so the host tool does not load it.
"""

from __future__ import annotations

import numpy as np

from .bai import read_bai
from .crai import read_crai
from .fai import read_fai

#: scaled depth cap (indexcov.go:129-151)
DEPTH_CAP = 50000.0


def median_size_per_tile(sizes: list[np.ndarray]) -> float:
    """Host, int64-exact (indexcov/indexcov.go:96-124)."""
    flat = np.concatenate([np.asarray(s, dtype=np.int64) for s in sizes]) \
        if sizes else np.zeros(0, dtype=np.int64)
    if flat.size < 1:
        raise ValueError("indexcov: no usable chromosomes in index")
    flat = np.sort(flat)
    n98 = flat[int(0.98 * len(flat))]
    capped = np.minimum(flat, n98)
    cumsum = np.cumsum(capped)
    total = int(cumsum[-1])
    idx = int(np.searchsorted(cumsum, total // 2, side="right"))
    idx = min(idx, len(flat) - 1)
    return float(flat[idx])


def normalized_depth(sizes: np.ndarray, median: float) -> np.ndarray:
    """float32 scaled depth, capped at 50000 (indexcov.go:129-151)."""
    if median == 0:
        return np.zeros(0, dtype=np.float32)
    d = (np.asarray(sizes, dtype=np.float64) / median).astype(np.float32)
    return np.minimum(d, np.float32(DEPTH_CAP))


class SampleIndex:
    """Parsed index: per-chromosome tile sizes + scaling median.

    Mirrors the reference's Index wrapper (indexcov.go:57-67,83-125).
    """

    def __init__(self, path: str):
        self.path = path
        if path.endswith(".cram"):
            # reference behavior: .cram rides its companion .crai
            # (indexcov.go:471-525 readIndex on rdr path + ".crai")
            path = path + ".crai"
        if path.endswith(".crai"):
            self.sizes = read_crai(path).sizes()
            self.mapped = 0
            self.unmapped = 0
        else:
            from ..io import remote

            bai_path = path
            if not path.endswith(".bai"):
                bai_path = path + ".bai"
                if not remote.exists(bai_path):
                    bai_path = path[:-4] + ".bai"
            idx = read_bai(bai_path)
            self.sizes = idx.sizes()
            self.mapped = idx.mapped_total
            self.unmapped = idx.unmapped_total
        self.median = median_size_per_tile(self.sizes)

    def normalized_depth(self, ref_id: int) -> np.ndarray:
        if ref_id >= len(self.sizes):
            return np.zeros(0, dtype=np.float32)
        return normalized_depth(self.sizes[ref_id], self.median)


def get_short_name(path: str) -> str:
    """Sample name: unique SM tag from the BAM header when available,
    else derived from the filename (indexcov.go:213-246)."""
    if not path.endswith((".crai", ".bai")):
        try:
            from ..io.bam import read_alignment_header

            names = read_alignment_header(path).sample_names()
            if len(names) > 1:
                raise ValueError(f"more than one RG SM for {path}")
            if names:
                return names[0]
        except (OSError, ValueError):
            pass
    base = path.rsplit("/", 1)[-1]
    parts = base.split(".")
    if len(parts) <= 2:
        return parts[0]
    return "-".join(parts[:-1])


def references(
    bams: list[str], fai: str | None, chrom: str = ""
) -> list[tuple[int, str, int]]:
    """(ref_id, name, length) list from an .fai (required for crai inputs)
    or the first BAM's header (indexcov.go:276-342). ref_id is the position
    in the full reference dictionary — the key into per-sample size arrays
    — even when ``chrom`` restricts the output."""
    if fai:
        recs = read_fai(fai)
        refs = [(i, r.name, r.length) for i, r in enumerate(recs)]
    else:
        path = next((b for b in bams if not b.endswith((".crai", ".bai"))),
                    None)
        if path is None:
            raise SystemExit(
                "indexcov: --fai is required when only index files are given"
            )
        from ..io.bam import read_alignment_header

        h = read_alignment_header(path)
        refs = [(i, n, l)
                for i, (n, l) in enumerate(zip(h.ref_names, h.ref_lens))]
    if chrom:
        want = chrom[3:] if chrom.startswith("chr") else chrom
        refs = [
            (i, n, l) for i, n, l in refs
            if n == chrom or (n[3:] if n.startswith("chr") else n) == want
        ]
        if not refs:
            raise SystemExit(f"indexcov: chromosome {chrom} not found")
    return refs
