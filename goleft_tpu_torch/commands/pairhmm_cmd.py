"""pairhmm: pair-HMM genotype likelihoods over candidate windows, on the
CUDA card. The counterpart of the JAX package's commands/pairhmm_cmd.py:
same flags, same table bytes, same exit codes.

Input document (``goleft-tpu.pairhmm-windows/1``)::

    {"schema": "goleft-tpu.pairhmm-windows/1",
     "windows": [{"chrom": "chr1", "start": 1000, "end": 1500,
                  "haplotypes": ["ACGT...", ...],
                  "reads": [{"seq": "ACG...",
                             "quals": "II..." | [30, ...] | 30}]}]}

Output: one row per scored window, ``chrom start end reads haps
genotype GQ PL`` with the PL vector in VCF genotype order.
``--candidates`` restricts scoring to windows overlapping a candidate
interval. A window whose bucket fails permanently (after retries) is
quarantined: the rest of the table is written, the summary goes to
stderr (and ``--quarantine-out``), and the run exits 3. Bad input exits
1 with one line (the CLI's contract).

Stages (the ``--metrics-out`` manifest's ``spans``): ``load-validate``, then
ops/pairhmm.py's ``encode-pack``, ``device-h2d``, ``device-kernel``,
``device-d2h`` and ``host-fold``, then
``genotype-format``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..models import genotype
from ..models.candidates import overlaps_any, read_candidates
from ..ops.pairhmm import TIMER


def read_windows(path: str) -> list[dict]:
    """Load + validate + encode a windows JSON document."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except OSError as e:
        raise ValueError(f"cannot read windows file: {e}") from None
    except json.JSONDecodeError as e:
        raise ValueError(f"windows {path}: bad JSON: {e}") from None
    return genotype.load_windows(doc, source=path)


def select_windows(windows: list[dict],
                   candidates_path: str | None) -> list[dict]:
    """Windows overlapping the candidate intervals (all windows when no
    candidates file is given)."""
    if not candidates_path:
        return windows
    cands = read_candidates(candidates_path)
    return [w for w in windows
            if overlaps_any(cands, w["chrom"], w["start"], w["end"])]


def run_pairhmm(input_path: str, candidates: str | None = None,
                gap_open: float = 45.0, gap_ext: float = 10.0,
                use_f64: bool = False, out=None,
                quarantine_out: str | None = None, device=None) -> int:
    """The CLI body; returns the exit code (0 ok, 3 when windows were
    quarantined). ``device`` None means the CUDA card; ``"cpu"`` runs
    the kernel's plain version."""
    from ..resilience.policy import Quarantine

    out = out or sys.stdout
    with TIMER.stage("load-validate"):
        windows = select_windows(read_windows(input_path), candidates)
    quarantine = Quarantine()
    results, _ = genotype.score_windows(
        windows, gap_open=gap_open, gap_ext=gap_ext,
        dtype=np.float64 if use_f64 else np.float32,
        quarantine=quarantine, device=device)
    with TIMER.stage("genotype-format"):
        out.write(genotype.format_table(results))
    if quarantine:
        if quarantine_out:
            quarantine.write(quarantine_out)
        print(f"pairhmm: {len(quarantine)} window(s) quarantined "
              f"after failed dispatch — table emitted without them "
              f"(exit 3): {', '.join(quarantine.names)}",
              file=sys.stderr)
        return 3
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "goleft-tpu-torch pairhmm",
        description="pair-HMM genotype likelihoods (PL) for candidate "
                    "windows of reads × haplotypes, on the CUDA card",
    )
    p.add_argument("--candidates", default=None, metavar="FILE",
                   help="emdepth/dcnv --candidates-out file (BED or "
                        "JSON): only score windows overlapping a "
                        "candidate interval")
    p.add_argument("--gap-open", type=float, default=45.0,
                   help="phred gap-open score (delta = 10^(-q/10))")
    p.add_argument("--gap-ext", type=float, default=10.0,
                   help="phred gap-extend score (epsilon)")
    p.add_argument("--f64", action="store_true",
                   help="compute in float64 instead of the rescaled-"
                        "f32 wavefront (slower; for validation)")
    p.add_argument("--out", default=None,
                   help="write the table here instead of stdout")
    p.add_argument("--quarantine-out", default=None, metavar="FILE",
                   help="write the quarantine manifest here when any "
                        "window's dispatch permanently fails")
    p.add_argument("windows", help="pairhmm-windows JSON document")
    a = p.parse_args(argv)
    kw = dict(candidates=a.candidates, gap_open=a.gap_open,
              gap_ext=a.gap_ext, use_f64=a.f64,
              quarantine_out=a.quarantine_out)
    if a.out:
        with open(a.out, "w") as fh:
            return run_pairhmm(a.windows, out=fh, **kw)
    return run_pairhmm(a.windows, **kw)


if __name__ == "__main__":
    sys.exit(main())
