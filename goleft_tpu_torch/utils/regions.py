"""Interval sets for BED overlap queries: a copy of the JAX package's
utils/regions.py.

Replaces the reference's biogo interval tree usage (depth/intervals.go:
25-79) with sorted start/end arrays + binary search — the same O(log n)
query without a tree, and trivially vectorizable.
"""

from __future__ import annotations

import numpy as np

from .xopen import xopen


class IntervalSet:
    """Static set of (start, end) intervals supporting overlap queries."""

    def __init__(self, starts, ends):
        order = np.argsort(starts, kind="stable")
        self.starts = np.asarray(starts, dtype=np.int64)[order]
        self.ends = np.asarray(ends, dtype=np.int64)[order]
        # running max of ends lets a single binary search bound the scan
        self.max_ends = np.maximum.accumulate(self.ends)

    def overlaps(self, start: int, end: int) -> bool:
        i = int(np.searchsorted(self.starts, end, side="left"))
        if i == 0:
            return False
        return bool(self.max_ends[i - 1] > start)


def read_tree(path: str) -> dict[str, IntervalSet]:
    """BED file → per-chromosome IntervalSet (depth/intervals.go:42-62)."""
    per: dict[str, list] = {}
    with xopen(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith(("#", "track")):
                continue
            t = line.split("\t")
            per.setdefault(t[0], []).append((int(t[1]), int(t[2])))
    return {
        c: IntervalSet([s for s, _ in iv], [e for _, e in iv])
        for c, iv in per.items()
    }


def overlaps(tree: dict[str, IntervalSet] | None, chrom: str, start: int,
             end: int) -> bool:
    if tree is None:
        return False
    ivs = tree.get(chrom)
    return ivs.overlaps(start, end) if ivs is not None else False
