"""cnv: BAMs → CNV calls in one pass, on the CUDA card.

The counterpart of the JAX package's commands/cnv.py, with the same
flags and output bytes. The cohort depth matrix comes from
cohortdepth.py's ``cohort_matrix_blocks`` (the exact hybrid host engine,
or ``--engine device``: the depth kernel of csrc/depth_kernel.cu, one
call per sample per shard), streams into one int16 matrix, and goes
through emdepth_cmd.py's ``call_cnvs``: per-sample median
normalisation, the batched EM on the card, the 30 kb streaming merge,
and

  chrom  start  end  sample  CN  log2FC

plus, optionally, the merged calls as VCF 4.2 (``--vcf``), the CN matrix
(``--matrix-out``) and the cn.mops posterior-CN / information-gain
tracks (``--mops-out`` / ``--gain-out``).

As in the JAX package, ``cnv`` runs without a quarantine: a sample that
fails to open, or fails permanently mid-run, fails the command instead
of zero-filling its column.

In a world of processes (parallel/mesh.py) the samples split over the
processes and the matrix assembles over Gloo
(parallel/distributed_cohort.py); process 0 runs the EM and the merge
and writes every output, the others return no calls.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..device import resolve_device
from ..io.fai import read_fai, write_fai
from ..ops.coverage import window_count
from . import add_no_crc_flag, apply_no_crc
from .cohortdepth import cohort_matrix_blocks, cohort_regions
from .emdepth_cmd import TIMER, call_cnvs


def collect_matrix(blocks, n_win: int, n_samples: int):
    """Stream cohort blocks into one preallocated int16 matrix of window
    means (depth is capped at DEPTH_CAP_EXTRA = 2500, so round-half-up
    means fit), (n_windows, samples). Normalisation and the EM later
    convert one chunk at a time, never the whole matrix."""
    depths = np.empty((n_win, n_samples), dtype=np.int16)
    starts = np.empty(n_win, dtype=np.int64)
    ends = np.empty(n_win, dtype=np.int64)
    chroms = np.empty(n_win, dtype=object)
    row = 0
    for c, st, en, v in blocks:
        k = len(st)
        chroms[row:row + k] = c
        starts[row:row + k] = st
        ends[row:row + k] = en
        assert v.max(initial=0) < 32768, "window mean exceeds int16"
        depths[row:row + k] = v.T
        row += k
    assert row == n_win, (row, n_win)
    return chroms, starts, ends, depths


def run_cnv(bams, reference=None, fai=None, window: int = 1000,
            mapq: int = 1, chrom: str = "", processes: int = 8,
            out=None, matrix_out=None, engine: str = "auto",
            vcf_out=None, mops_out=None, gain_out=None,
            bed: str | None = None, device=None):
    """The CLI body on ``device`` (the card unless ``"cpu"``) → the
    merged calls."""
    from ..parallel.mesh import rank_device, world

    n_proc, rank = world()
    out = out or sys.stdout
    fai_path = fai or (reference + ".fai" if reference else None)
    if n_proc > 1:
        from ..parallel.distributed_cohort import distributed_cohort_matrix

        device = rank_device(device, rank)
        names, chroms, starts, ends, depths = distributed_cohort_matrix(
            bams, reference=reference, fai=fai, window=window, mapq=mapq,
            chrom=chrom, processes=processes, engine=engine, bed=bed,
            device=device)
        if len(starts) == 0 or rank != 0:
            return []
        contig_lengths = None
        if vcf_out and fai_path:
            # the .fai exists now (process 0 wrote it before the barrier)
            contig_lengths = {r.name: r.length for r in read_fai(fai_path)}
        return call_cnvs(chroms, starts, ends, depths, names, out=out,
                         matrix_out=matrix_out, vcf_out=vcf_out,
                         mops_out=mops_out, gain_out=gain_out,
                         contig_lengths=contig_lengths,
                         ref_fasta=reference, ref_fai=fai, device=device)
    resolve_device(device)  # no card: fail before any decode
    contig_lengths = None
    if vcf_out and fai_path:
        # read the .fai up front: a missing or unreadable index fails
        # now, not after the whole cohort has been decoded
        if not os.path.exists(fai_path) and reference:
            write_fai(reference)
        contig_lengths = {r.name: r.length for r in read_fai(fai_path)}

    names, blocks = cohort_matrix_blocks(
        bams, reference=reference, fai=fai, window=window, mapq=mapq,
        chrom=chrom, processes=processes, engine=engine, bed=bed,
        quarantine=None, device=device)
    # the matrix's windows, from its regions (nothing decoded);
    # cohort_matrix_blocks has written a missing .fai by now
    n_win = sum(window_count(s, e, window) for _, s, e in
                cohort_regions(read_fai(fai_path), chrom, window, bed))
    if n_win == 0:
        return []
    with TIMER.stage("matrix"):
        chroms, starts, ends, depths = collect_matrix(blocks, n_win,
                                                      len(names))
    return call_cnvs(chroms, starts, ends, depths, names, out=out,
                     matrix_out=matrix_out, vcf_out=vcf_out,
                     mops_out=mops_out, gain_out=gain_out,
                     contig_lengths=contig_lengths,
                     ref_fasta=reference, ref_fai=fai, device=device)


def main(argv=None):
    p = argparse.ArgumentParser(
        "goleft-tpu-torch cnv",
        description="CNV calls straight from BAMs: cohort depth matrix "
                    "+ EM copy number, on the CUDA card",
    )
    p.add_argument("-w", "--windowsize", type=int, default=1000)
    p.add_argument("-Q", "--mapq", type=int, default=1)
    p.add_argument("-c", "--chrom", default="")
    p.add_argument("-b", "--bed", default=None,
                   help="restrict to regions in this bed")
    p.add_argument("-r", "--reference", default=None)
    p.add_argument("--fai", default=None)
    p.add_argument("-p", "--processes", type=int, default=8)
    p.add_argument("--matrix-out", default=None,
                   help="also write the per-window CN matrix here")
    p.add_argument("--vcf", default=None,
                   help="also write merged CNV calls as VCF 4.2 "
                        "(<DEL>/<DUP> symbolic alleles, GT:CN:L2FC)")
    p.add_argument("--mops-out", default=None,
                   help="write the cn.mops posterior-CN matrix here")
    p.add_argument("--gain-out", default=None,
                   help="write per-window cn.mops information gain here")
    p.add_argument("--engine", choices=("auto", "hybrid", "device"),
                   default="auto",
                   help="cohort matrix engine (see cohortdepth --engine)")
    add_no_crc_flag(p)
    p.add_argument("bams", nargs="+")
    a = p.parse_args(argv)
    apply_no_crc(a.no_crc)
    run_cnv(a.bams, reference=a.reference, fai=a.fai, window=a.windowsize,
            mapq=a.mapq, chrom=a.chrom, processes=a.processes,
            matrix_out=a.matrix_out, engine=a.engine, vcf_out=a.vcf,
            mops_out=a.mops_out, gain_out=a.gain_out, bed=a.bed)


if __name__ == "__main__":
    main()
