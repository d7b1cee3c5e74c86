"""samplename: print unique SM tags from a BAM/CRAM's @RG header lines.

A copy of the JAX package's commands/samplename.py over the port's
io/bam.py; no device stage, so it needs no card.

Reference: samplename/samplename.go:14-68 (CRAM accepted like the
reference's biogo reader handles either container).
"""

from __future__ import annotations

import argparse

from ..io.bam import read_alignment_header


def main(argv=None):
    p = argparse.ArgumentParser(
        "goleft-tpu-torch samplename",
        description="report the sample name(s) in a bam/cram file",
    )
    p.add_argument("bam")
    a = p.parse_args(argv)
    names = read_alignment_header(a.bam).sample_names()
    for n in names:
        print(n)
    if not names:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
