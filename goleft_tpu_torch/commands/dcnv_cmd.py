"""dcnv: GC-debias and normalize a depth matrix.

The counterpart of the JAX package's commands/dcnv_cmd.py, with the same
flags and output bytes. Its path is host numpy end to end (the GC
windows, the sample medians, the moving-median debias): the reference
runs no device stage here either (its only device call, the SVD debias
of models/dcnv.py, is not on this path), so the command needs no card.

Rebuild of the reference's standalone prototype (dcnv/dcnv.go): read a
depthwed-style matrix + reference fasta, compute GC per window (flanked
250bp upstream, dcnv.go:82-86), sample-median normalize (65th pctile of
nonzero, ":108-125"), sort-by-GC → moving-median debias → unsort
(":331-335"), and write the normalized matrix.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io.fai import Faidx
from ..models.dcnv import gc_debias_pipeline
from .emdepth_cmd import read_matrix


def run_dcnv(matrix_path: str, fasta: str, window: int = 9, out=None,
             plot_prefix: str | None = None,
             candidates_out: str | None = None):
    out = out or sys.stdout
    chroms, starts, ends, depths, samples = read_matrix(matrix_path)
    fa = Faidx(fasta)
    gcs = np.array([
        fa.window_stats(c, max(int(s) - 250, 0), int(e))["gc"]
        for c, s, e in zip(chroms, starts, ends)
    ])
    norm = gc_debias_pipeline(depths, gcs, window=window)
    out.write("#chrom\tstart\tend\t" + "\t".join(samples) + "\n")
    for i in range(len(chroms)):
        vals = "\t".join(f"{v:.3f}" for v in norm[i])
        out.write(f"{chroms[i]}\t{starts[i]}\t{ends[i]}\t{vals}\n")
    if candidates_out:
        # aberrant intervals straight off the normalized matrix (the
        # debiased values are scaled coverage around 1.0): the
        # machine-readable handoff to `pairhmm --candidates`
        from ..models.candidates import (
            candidates_from_matrix, write_candidates,
        )

        write_candidates(
            candidates_out,
            candidates_from_matrix(chroms, starts, ends, norm,
                                   samples), "dcnv")
    if plot_prefix:
        # reference parity: per-chromosome scaled-coverage chart pages
        # (dcnv.go:274-345 writes "<base>-depth-<chrom>.html" with a
        # 0-2.5 y-axis, width thinning by cohort size, and its own
        # color fn without the background-env check)
        from ..utils.report import line_chart, write_page

        width = 0.4 if len(samples) <= 30 else \
            (0.3 if len(samples) <= 50 else 0.2)
        for c in dict.fromkeys(chroms):  # unique, ordered
            m = chroms == c
            xs = starts[m].tolist()
            sub = norm[m]
            series = [
                {"label": samples[k], "x": xs,
                 "y": sub[:, k].tolist(), "width": width}
                for k in range(len(samples))
            ]
            chart = line_chart(
                f"dcnv_{c}", series, f"position on {c}",
                "scaled coverage", y_max=2.5, per_sample=False,
            )
            write_page(f"{plot_prefix}-depth-{c}.html",
                       f"dcnv depths {c}", [chart])
    return norm


def run_device(argv) -> str:
    """The device dcnv runs on, whatever its argv: the CPU (its path is
    host numpy), so the CLI probes no card for it."""
    return "cpu"


def main(argv=None):
    p = argparse.ArgumentParser(
        "goleft-tpu-torch dcnv",
        description="GC-debias + normalize a depth matrix",
    )
    p.add_argument("-f", "--fasta", required=True)
    p.add_argument("-w", "--window", type=int, default=9,
                   help="moving-median window (rows)")
    p.add_argument("--plot", default=None, metavar="PREFIX",
                   help="write <PREFIX>-depth-<chrom>.html chart pages "
                        "(the reference prototype hardcodes 'dd')")
    p.add_argument("--candidates-out", default=None, metavar="FILE",
                   help="export aberrant intervals of the normalized "
                        "matrix as CNV candidates (BED-style TSV, or "
                        "JSON for *.json) — the `pairhmm "
                        "--candidates` input")
    p.add_argument("matrix")
    a = p.parse_args(argv)
    run_dcnv(a.matrix, a.fasta, window=a.window, plot_prefix=a.plot,
             candidates_out=a.candidates_out)


if __name__ == "__main__":
    main()
