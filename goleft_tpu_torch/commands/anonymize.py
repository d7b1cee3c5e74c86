"""anonymize: fabricate shareable indexcov fixtures from real BAMs.

A copy of the JAX package's commands/anonymize.py over the port's
BamReader and BamWriter; no device stage, so it needs no card.

Rebuild of the reference dev tool (indexcov/anonymize/main.go): for each
input BAM, write a header-only ``sample_<name>_%04d.bam`` whose @RG
carries the anonymized sample name, and copy the original .bai beside it
— indexcov only reads headers + indexes, so the pair behaves exactly
like the original cohort without exposing reads or names.
"""

from __future__ import annotations

import argparse
import os
import shutil

from ..io.bam import BamReader, BamWriter


def anonymize(name: str, bams: list[str], outdir: str = ".") -> list[str]:
    out_paths = []
    for i, path in enumerate(bams, 1):
        sample = f"sample_{name}_{i:04d}"
        rdr = BamReader.from_file(path)
        hdr = rdr.header
        # strip existing @RG lines; add the anonymized read group
        lines = [ln for ln in hdr.text.splitlines()
                 if not ln.startswith("@RG")]
        lines.append(f"@RG\tID:{sample}\tSM:{sample}\tPL:illumina"
                     f"\tLB:{i - 1}\tPU:XX\tCN:indexcov-anon")
        out_bam = os.path.join(outdir, sample + ".bam")
        with open(out_bam, "wb") as fh:
            with BamWriter(fh, "\n".join(lines) + "\n", hdr.ref_names,
                           hdr.ref_lens):
                pass  # header-only: indexcov never reads alignments
        bai = None
        for cand in (path + ".bai", path[:-4] + ".bai"):
            if os.path.exists(cand):
                bai = cand
                break
        if bai is None:
            raise SystemExit(f"anonymize: no bam index for {path}")
        shutil.copyfile(bai, out_bam + ".bai")
        print(f"wrote: {out_bam}")
        out_paths.append(out_bam)
    return out_paths


def main(argv=None):
    p = argparse.ArgumentParser(
        "goleft-tpu-torch anonymize",
        description="write header-only anonymized bam+bai pairs for "
                    "shareable indexcov fixtures",
    )
    p.add_argument("name", help="cohort tag used in anonymized names")
    p.add_argument("bams", nargs="+")
    p.add_argument("-d", "--outdir", default=".")
    a = p.parse_args(argv)
    if os.path.exists(a.name):
        raise SystemExit("anonymize: first argument is a tag, not a file")
    anonymize(a.name, a.bams, a.outdir)


if __name__ == "__main__":
    main()
