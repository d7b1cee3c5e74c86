"""indexsplit: regions of even cross-cohort data volume from indexes.

A copy of the JAX package's commands/indexsplit.py over the port's
SampleIndex (io/sampleindex.py); no device stage, so it needs no
card.

Reference: indexsplit/indexsplit.go. Per-16KB tile sizes are summed across
samples (÷1e9, ":90-114"), outliers chopped at mean+3σ → 8×mean (":38-49"),
each chromosome gets a region budget proportional to its share of data
(":52-66,125-133"), then tiles are greedily accumulated into chunks;
oversized single tiles split into ≤8 pieces and "problematic" regions
force finer splits (":144-188").

Output: chrom  start  end  sum(%.2f)  splits
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np

from ..utils.regions import read_tree, overlaps
from ..io.sampleindex import SampleIndex, references

TILE = 16384
SCALAR = 1e9


@dataclass
class Chunk:
    chrom: str
    start: int
    end: int
    sum: float
    splits: int

    def __str__(self):
        return (f"{self.chrom}\t{self.start}\t{self.end}\t"
                f"{self.sum:.2f}\t{self.splits}")


def _chop(size: np.ndarray) -> np.ndarray:
    if len(size) == 0:
        return size
    m = float(size.mean())
    # sample (n-1) deviation, as gonum's stat.MeanStdDev computes
    std = float(size.std(ddof=1)) if len(size) > 1 else 0.0
    out = size.copy()
    out[out > m + 3 * std] = 8 * m
    return out


def split(paths: list[str], refs: list[tuple[int, str, int]], n: int,
          probs=None):
    """Yield Chunks; refs are (ref_id, name, length)."""
    sizes: dict[int, np.ndarray] = {}
    for path in paths:
        osz = SampleIndex(path).sizes
        for ref_id, _, _ in refs:
            if ref_id >= len(osz):
                continue
            o = np.asarray(osz[ref_id], dtype=np.float64) / SCALAR
            cur = sizes.get(ref_id)
            if cur is None:
                sizes[ref_id] = o.copy()
            elif len(cur) >= len(o):
                cur[: len(o)] += o
            else:
                o = o.copy()
                o[: len(cur)] += cur
                sizes[ref_id] = o

    chopped = {i: _chop(s) for i, s in sizes.items()}
    sums = {i: float(s.sum()) for i, s in chopped.items()}
    total = sum(sums.values()) or 1.0

    for ref_id, name, ref_len in refs:
        size = chopped.get(ref_id)
        if size is None or len(size) == 0:
            yield Chunk(name, 0, ref_len, 0.0, 0)
            continue
        pct = sums[ref_id] / total
        n_regions = int(pct * n)
        if n_regions == 0:
            if pct > 0:
                n_regions = 1
            else:
                yield Chunk(name, 0, ref_len, 0.0, 0)
                continue
        chunk = sums[ref_id] / n_regions
        acc = 0.0
        lasti = 0
        for i in range(len(size)):
            ovl = overlaps(probs, name, i * TILE, (i + 1) * TILE)
            if size[i] > chunk or (size[i] >= 0.05 * chunk and ovl):
                if i > lasti:
                    yield Chunk(name, lasti * TILE, i * TILE, acc, 1)
                acc = float(size[i])
                nsplits = int(0.5 + acc / (chunk / 2))
                nsplits = min(nsplits, 8)
                if nsplits < 1:
                    nsplits = 3 if ovl else 1
                start = i * TILE
                ln = int(TILE / nsplits + 1)
                for _ in range(nsplits):
                    yield Chunk(
                        name, start, min(start + ln, (i + 1) * TILE),
                        acc / nsplits, nsplits,
                    )
                    start += ln
                lasti, acc = i + 1, 0.0
                continue
            acc += size[i]
            if acc >= chunk or i == len(size) - 1 or \
                    (acc >= 0.2 * chunk and ovl):
                end = ref_len if i == len(size) - 1 else (i + 1) * TILE
                yield Chunk(name, lasti * TILE, end, acc, 1)
                lasti = i + 1
                acc = 0.0


def main(argv=None):
    p = argparse.ArgumentParser(
        "goleft-tpu-torch indexsplit",
        description="generate evenly-sized (by data) regions across a "
                    "cohort from bam/cram indexes",
    )
    p.add_argument("-n", type=int, required=True,
                   help="number of regions to split to")
    p.add_argument("--fai", default=None, help="fasta index file")
    p.add_argument("-p", "--problematic", default=None,
                   help="bed of regions to split small")
    p.add_argument("indexes", nargs="+", help="bams/bais/crais")
    a = p.parse_args(argv)
    probs = read_tree(a.problematic) if a.problematic else None
    refs = references(a.indexes, a.fai)
    for chunk in split(a.indexes, refs, a.n, probs):
        print(chunk)


if __name__ == "__main__":
    main()
