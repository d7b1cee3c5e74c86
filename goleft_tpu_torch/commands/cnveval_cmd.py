"""cnveval: evaluate a CNV callset against a truth set.

A copy of the JAX package's commands/cnveval_cmd.py; host only, so it
needs no card.

Mirrors the reference CLI (cnveval/cmd/cnveval/cnveval.go): both files are
5+-column beds (chrom start end CN sample[,sample...]); prints a
precision/recall table per size class. (The reference also always dumps a
CPU pprof file, ":41-46" — not reproduced.)
"""

from __future__ import annotations

import argparse
import sys

from ..models.cnveval import CNV, Truth, evaluate, tabulate
from ..utils.xopen import xopen

CLASS_LABEL = {
    "small": f"0-{20_000}",
    "medium": f"{20_000}-{100_000}",
    "large": f">={100_000}",
    "all": "all",
}


def parse_truth(path: str, samples_filter=None) -> list[Truth]:
    out = []
    with xopen(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            t = line.rstrip("\r\n").split("\t")
            if len(t) < 5:
                raise SystemExit("cnveval: expected five fields for CNVs")
            samples = t[4].split(",")
            if samples_filter is not None and not any(
                s in samples_filter for s in samples
            ):
                continue
            out.append(Truth(t[0], int(t[1]), int(t[2]), samples, int(t[3])))
    return out


def run_cnveval(truth_path: str, test_path: str, min_overlap: float = 0.4,
                limit_samples: bool = False, out=None):
    out = out or sys.stdout
    test = parse_truth(test_path)
    filt = {t.samples[0] for t in test} if limit_samples else None
    truths = parse_truth(truth_path, filt)
    cnvs = [CNV(t.chrom, t.start, t.end, t.samples[0], t.cn) for t in test]
    stat = evaluate(cnvs, truths, min_overlap)
    tabs = tabulate(stat)
    for cls in ("small", "medium", "large", "all"):
        out.write(f"size-class: {CLASS_LABEL[cls]:<12} | {tabs[cls]}\n")
    return tabs


def main(argv=None):
    p = argparse.ArgumentParser(
        "goleft-tpu-torch cnveval",
        description="evaluate CNV calls against a truth set",
    )
    p.add_argument("-m", "--minoverlap", type=float, default=0.4)
    p.add_argument("-s", "--limitsamples", action="store_true",
                   help="only truth sites with samples present in test set")
    p.add_argument("truth", help="truth-set bed")
    p.add_argument("test", help="test-set bed")
    a = p.parse_args(argv)
    if not 0 < a.minoverlap <= 1:
        p.error("minoverlap must be between 0 and 1")
    run_cnveval(a.truth, a.test, a.minoverlap, a.limitsamples)


if __name__ == "__main__":
    main()
