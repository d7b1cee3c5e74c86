"""cnveval: precision/recall of a CNV callset against a truth set.

A copy of the JAX package's models/cnveval.py.

Rebuild of cnveval/cnveval.go: overlap when the smaller interval is
covered ≥ po (default 0.4, cmd/cnveval:26) and the copy numbers agree
with CN>2 collapsed to 3 (":354-362"); stats stratified by sample and by
size class (<20kb, 20-100kb, ≥100kb, ":45-51"); cross-sample FP/TN logic
(":231-285") counts calls matching a truth interval assigned to *other*
samples as FP unless they also match a truth for their own sample.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CNV:
    chrom: str
    start: int
    end: int
    sample: str
    cn: int
    counted: bool = False


@dataclass
class Truth:
    chrom: str
    start: int
    end: int
    samples: list[str]
    cn: int
    used: set = field(default_factory=set)


SMALL = 20_000
MEDIUM = 100_000
CLASSES = ("small", "medium", "large", "all")


def size_class(start: int, end: int) -> str:
    l = end - start
    if l < SMALL:
        return "small"
    if l < MEDIUM:
        return "medium"
    return "large"


def same_cn(a: int, b: int) -> bool:
    return min(a, 3) == min(b, 3)


def poverlap(a, b) -> float:
    if a.chrom != b.chrom:
        return 0.0
    total = min(a.end - a.start, b.end - b.start)
    ovl = min(a.end, b.end) - max(a.start, b.start)
    if ovl < 0 or total <= 0:
        return 0.0
    return ovl / total


@dataclass
class Stat:
    tp: int = 0
    fp: int = 0
    fn: int = 0
    tn: int = 0

    def precision(self) -> float:
        return self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0

    def recall(self) -> float:
        return self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0

    def __str__(self):
        return (
            f"precision: {self.precision():.4f} ({self.tp:<4} / "
            f"({self.tp:<4} + {self.fp:<4})) recall: "
            f"{self.recall():.4f} ({self.tp:<4} / ({self.tp:<4} + "
            f"{self.fn:<4}))"
        )


def _key(x):
    return (x.chrom, x.start)


def evaluate(cnvs: list[CNV], truths: list[Truth], po: float = 0.4
             ) -> dict[tuple[str, str], Stat]:
    """→ {(size_class, sample): Stat} (cnveval.go:163-212)."""
    stat: dict[tuple[str, str], Stat] = {}
    samples = {s for t in truths for s in t.samples} | {
        c.sample for c in cnvs
    }
    by_sample: dict[str, list[Truth]] = {}
    without: dict[str, list[Truth]] = {}
    for t in truths:
        for s in t.samples:
            by_sample.setdefault(s, []).append(t)
        for s in samples:
            if s not in t.samples:
                without.setdefault(s, []).append(t)
    cnv_by_sample: dict[str, list[CNV]] = {}
    for c in cnvs:
        cnv_by_sample.setdefault(c.sample, []).append(c)

    for sample in samples:
        ts = sorted(by_sample.get(sample, []), key=_key)
        cs = sorted(cnv_by_sample.get(sample, []), key=_key)
        _update_positive(stat, ts, cs, po)
        os_ = sorted(without.get(sample, []), key=_key)
        _update_fp(stat, os_, cs, ts, po)
    return stat


def _get(stat, sc, sample) -> Stat:
    return stat.setdefault((sc, sample), Stat())


def _update_positive(stat, truths, cnvs, po):
    """(cnveval.go:289-341)"""
    if not cnvs:
        return
    i = 0
    for t in truths:
        val = _get(stat, size_class(t.start, t.end), cnvs[0].sample)
        found = False
        while i < len(cnvs) and (
            cnvs[i].chrom < t.chrom
            or (cnvs[i].chrom == t.chrom and cnvs[i].end < t.start)
        ):
            i += 1
        if i > 0:
            i -= 1
        for cnv in cnvs[i:]:
            if cnv.chrom > t.chrom or (
                cnv.chrom == t.chrom and cnv.start > t.end
            ):
                break
            if poverlap(cnv, t) >= po and same_cn(cnv.cn, t.cn):
                if cnv.sample not in t.used:
                    val.tp += 1
                    cnv.counted = True
                    found = True
                    t.used.add(cnv.sample)
        if not found:
            val.fn += 1
    for cnv in cnvs:
        if not cnv.counted:
            _get(stat, size_class(cnv.start, cnv.end), cnv.sample).fp += 1


def _update_fp(stat, others, cnvs, truths, po):
    """(cnveval.go:231-285)"""
    if not cnvs or not others:
        return
    i = 0
    for o in others:
        val = _get(stat, size_class(o.start, o.end), cnvs[0].sample)
        while i < len(cnvs) and (
            cnvs[i].chrom < o.chrom
            or (cnvs[i].chrom == o.chrom and cnvs[i].end < o.start)
        ):
            i += 1
        if i > 0:
            i -= 1
        tp_found = False
        fp_found = False
        found = False
        for cnv in cnvs[i:]:
            if cnv.chrom > o.chrom or (
                cnv.chrom == o.chrom and cnv.start > o.end
            ):
                break
            if poverlap(cnv, o) >= po and same_cn(cnv.cn, o.cn):
                fp_found = True
                for t in truths:
                    if t.chrom != cnv.chrom:
                        continue
                    if poverlap(cnv, t) >= po and same_cn(cnv.cn, t.cn):
                        tp_found = True
                        break
            if fp_found and not tp_found:
                val.fp += 1
                found = True
                cnv.counted = True
        if not (found or tp_found):
            val.tn += 1


def tabulate(stat: dict[tuple[str, str], Stat]) -> dict[str, Stat]:
    """Aggregate over samples per size class + "all" (cnveval.go:118-133)."""
    out = {c: Stat() for c in CLASSES}
    for (sc, _), st in stat.items():
        for f in ("tp", "fp", "fn", "tn"):
            setattr(out[sc], f, getattr(out[sc], f) + getattr(st, f))
    for c in ("small", "medium", "large"):
        for f in ("tp", "fp", "fn", "tn"):
            setattr(out["all"], f, getattr(out["all"], f) + getattr(out[c], f))
    return out
