"""cohortscan: streaming, incremental indexcov for biobank cohorts, on the
CUDA card.

The counterpart of the JAX package's commands/cohortscan.py, with the
same flags and output bytes. The engine is cohort/scan.py: under ``-n``
each (autosome, sample chunk) is one ``indexcov_norm`` launch.

Same artifact surface as ``indexcov`` (bed.gz/.roc/.ped — byte-
identical on the same inputs, pinned by the biobank smoke), but the
cohort is processed in sample chunks with O(chunk × bins) peak memory,
every per-(sample, chromosome) QC result is committed under the
sample's content identity, and a committed manifest makes re-runs
incremental: append 500 samples to a 100k cohort and only the 500 new
QC columns are computed (the global normalization scalars and PCA are
refreshed from streamed statistics). Inputs may be local paths or
``https://``/``s3://`` URLs (io/remote.py).
"""

from __future__ import annotations

import argparse

from ..cohort.scan import PCA_EXACT_MAX, run_cohortscan
from .indexcov import DEFAULT_EXCLUDE


def main(argv=None):
    p = argparse.ArgumentParser(
        "goleft-tpu-torch cohortscan",
        description="streaming incremental cohort coverage QC from "
                    "BAM/CRAM indexes (local paths or URLs)",
    )
    p.add_argument("-d", "--directory", required=True,
                   help="directory for output files")
    p.add_argument("-e", "--includegl", action="store_true",
                   help="include GL chromosomes")
    p.add_argument("-p", "--excludepatt", default=DEFAULT_EXCLUDE,
                   help="regex of chromosomes to exclude")
    p.add_argument("-X", "--sex", default="X,Y",
                   help="comma-delimited sex chromosomes ('' for none)")
    p.add_argument("-c", "--chrom", default="",
                   help="optional chromosome to restrict")
    p.add_argument("-f", "--fai", default=None,
                   help="fasta index; required for crais and "
                        "recommended for URL inputs")
    p.add_argument("-n", "--extranormalize", action="store_true",
                   help="normalize across samples (recommended for "
                        "CRAI); streamed, byte-identical to indexcov")
    p.add_argument("--chunk-samples", type=int, default=256,
                   help="samples per streaming chunk (peak memory is "
                        "O(chunk x bins); default 256; 0 = auto-size "
                        "from measured per-sample bytes)")
    p.add_argument("--manifest", default=None,
                   help="cohort manifest path (default: "
                        "<dir>/<name>-indexcov.manifest.json) — the "
                        "goleft-tpu.cohort-manifest/1 commit record "
                        "driving incremental re-runs")
    p.add_argument("--checkpoint-dir", default=None,
                   help="per-(sample, chromosome) QC checkpoint store "
                        "(default: <dir>/.cohortscan-ck)")
    p.add_argument("--resume", action="store_true",
                   help="replay the checkpoint journal: committed "
                        "samples skip their QC device work with "
                        "byte-identical artifacts")
    p.add_argument("--pca", default="auto",
                   choices=("auto", "exact", "sharded"),
                   help="PCA engine: exact full-matrix oracle "
                        "(byte-parity with indexcov), sharded power "
                        "iteration (O(chunk) memory), or auto "
                        f"(exact up to {PCA_EXACT_MAX} samples)")
    p.add_argument("bam", nargs="+",
                   help="bam(s)/bai(s)/crai(s), local or https/s3 URLs")
    a = p.parse_args(argv)
    run_cohortscan(
        a.bam, a.directory, sex=a.sex, exclude_patt=a.excludepatt,
        chrom=a.chrom, fai=a.fai, extra_normalize=a.extranormalize,
        include_gl=a.includegl, chunk_samples=a.chunk_samples,
        manifest_path=a.manifest, resume=a.resume,
        checkpoint_dir=a.checkpoint_dir, pca_mode=a.pca,
    )


if __name__ == "__main__":
    main()
