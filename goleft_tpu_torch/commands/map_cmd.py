"""map: FASTQ → mapped read tuples (→ windowed depth), on the CUDA card.

The counterpart of the JAX package's commands/map_cmd.py, with its flags
and output bytes: minimizer seeding (PyTorch ops) and the banded
Smith-Waterman wavefront (the hand-written kernel of
ops/swalign_kernel.py) on the card, no external aligner. Output is the
read-tuple TSV stream (`chrom start end name score strand`, 0-based
half-open); ``--depth-out`` fuses the tuples straight into windowed mean
depth through the depth kernel, and ``--from-tuples`` re-derives that
bed from a previously written tuple stream — the two are byte-identical.

Resilience follows the exit-3 contract: a corrupt FASTQ record
mid-stream quarantines the file (reads before the corruption still
map), and a mapping bucket whose dispatch exhausts retries quarantines
its reads — either way the run completes, prints the quarantine
summary, and exits 3. Fault injection reaches the ``map`` site via the
global ``--inject-faults``.
"""

from __future__ import annotations

import argparse
import sys

from ..device import resolve_device
from ..io.fastq import FastqError, FastqReader
from ..mapping import MapParams, get_index, map_reads
from ..mapping.index import (
    DEFAULT_K, DEFAULT_MAX_OCC, DEFAULT_W, _read_fasta,
)
from ..mapping.pipeline import (
    DEFAULT_BAND, DEFAULT_MIN_SUPPORT, TIMER, depth_bed_from_tuples,
    format_tuples, parse_tuples,
)

DEFAULT_BATCH = 4096
DEFAULT_WINDOW = 250


def chrom_lengths(reference: str) -> dict[str, int]:
    names, seqs = _read_fasta(reference)
    return {n: len(s) for n, s in zip(names, seqs)}


def main(argv=None):
    p = argparse.ArgumentParser(
        "goleft-tpu-torch map",
        description="map FASTQ reads against a FASTA reference "
                    "(minimizer seed + banded Smith-Waterman on "
                    "device); emits a read-tuple stream, optionally "
                    "fused straight into windowed depth",
    )
    p.add_argument("reference", help="FASTA reference (plain or "
                                     ".gz; local or http/s3)")
    p.add_argument("fastq", nargs="?", default=None,
                   help="FASTQ to map (plain, gzip or BGZF; local "
                        "or http/s3)")
    p.add_argument("-o", "--out", default="-",
                   help="tuple stream output (default stdout)")
    p.add_argument("--depth-out", default=None,
                   help="also write windowed mean depth bed derived "
                        "from the mapped tuples (fused, no "
                        "intermediate file)")
    p.add_argument("--from-tuples", default=None,
                   help="skip mapping: read a tuple stream written "
                        "by a previous run and derive --depth-out "
                        "from it (byte-identical to the fused path)")
    p.add_argument("--window", type=int, default=DEFAULT_WINDOW,
                   help="depth window size for --depth-out "
                        "(default %(default)s)")
    p.add_argument("-k", type=int, default=DEFAULT_K,
                   help="minimizer k-mer size (default %(default)s)")
    p.add_argument("-w", type=int, default=DEFAULT_W,
                   help="minimizer window (default %(default)s)")
    p.add_argument("--max-occ", type=int, default=DEFAULT_MAX_OCC,
                   help="drop minimizers occurring more than this "
                        "often in the reference (default "
                        "%(default)s)")
    p.add_argument("--min-support", type=int,
                   default=DEFAULT_MIN_SUPPORT,
                   help="minimum chained seed hits to attempt "
                        "extension (default %(default)s)")
    p.add_argument("--band", type=int, default=DEFAULT_BAND,
                   help="chaining/extension band in bases "
                        "(default %(default)s)")
    p.add_argument("--batch", type=int, default=DEFAULT_BATCH,
                   help="reads per device batch (default "
                        "%(default)s)")

    args = p.parse_args(argv)
    if args.from_tuples is not None:
        if not args.depth_out:
            p.error("--from-tuples requires --depth-out")
    elif args.fastq is None:
        p.error("fastq is required unless --from-tuples is given")
    return run_map(args.reference, args.fastq, out=args.out,
                   depth_out=args.depth_out, from_tuples=args.from_tuples,
                   window=args.window, k=args.k, w=args.w,
                   max_occ=args.max_occ, min_support=args.min_support,
                   band=args.band, batch=args.batch)


def run_map(reference: str, fastq: str | None = None, out="-",
            depth_out: str | None = None, from_tuples: str | None = None,
            window: int = DEFAULT_WINDOW, k: int = DEFAULT_K,
            w: int = DEFAULT_W, max_occ: int = DEFAULT_MAX_OCC,
            min_support: int = DEFAULT_MIN_SUPPORT,
            band: int = DEFAULT_BAND, batch: int = DEFAULT_BATCH,
            device=None) -> int:
    """The command's body on ``device`` (the card unless ``"cpu"``);
    returns the exit code (0, 1 on an unreadable first FASTQ record, 3
    when reads or the FASTQ were quarantined). ``out``: a path, "-" for
    stdout, or a binary file object."""
    dev = resolve_device(device)
    if from_tuples is not None:
        if not depth_out:
            raise ValueError("--from-tuples requires --depth-out")
        with open(from_tuples, "rb") as f:
            tuples = parse_tuples(f.read())
        bed = depth_bed_from_tuples(
            tuples, chrom_lengths(reference), window, device=dev)
        with open(depth_out, "wb") as f:
            f.write(bed)
        return 0

    if fastq is None:
        raise ValueError("fastq is required unless --from-tuples is "
                         "given")
    params = MapParams(k=k, w=w, max_occ=max_occ, band=band,
                       min_support=min_support)
    with TIMER.stage("index-build"):
        index = get_index(reference, k=k, w=w, max_occ=max_occ)

    from ..resilience.policy import Quarantine

    quarantine = Quarantine()
    own = isinstance(out, str) and out != "-"
    if out == "-":
        out = sys.stdout.buffer
    elif own:
        out = open(out, "wb")
    all_tuples: list = []
    totals = {"reads": 0, "mapped": 0, "unmapped": 0, "failed": 0}
    try:
        reader = FastqReader(fastq)
        recs: list = []
        while True:
            try:
                rec = next(reader)
            except StopIteration:
                rec = None
            except FastqError as e:
                if reader.records == 0:
                    print(f"map: {e}", file=sys.stderr)
                    return 1
                # corruption mid-stream: everything already read
                # still maps; the file is quarantined and the run
                # exits 3 like any other permanent input failure
                quarantine.add(("fastq", fastq), fastq,
                               fastq, e, phase="fastq")
                rec = None
            if rec is not None:
                recs.append(rec)
            if recs and (rec is None or len(recs) >= batch):
                res = map_reads(index, recs, params, device=dev)
                for key, err in res.failed.items():
                    quarantine.add(("read", totals["reads"] + key),
                                   recs[key].name, fastq, err,
                                   phase="map")
                for k_ in ("reads", "mapped", "unmapped", "failed"):
                    totals[k_] += res.stats[k_]
                out.write(format_tuples(res.tuples))
                if depth_out:
                    all_tuples.extend(
                        t for t in res.tuples if t is not None)
                recs = []
            if rec is None:
                break
        reader.close()
        if depth_out:
            lengths = {
                n: int(index.chrom_starts[i + 1]
                       - index.chrom_starts[i])
                for i, n in enumerate(index.chrom_names)}
            bed = depth_bed_from_tuples(all_tuples, lengths, window,
                                        device=dev)
            with open(depth_out, "wb") as f:
                f.write(bed)
    finally:
        if own:
            out.close()
    print(f"map: {totals['reads']} reads, {totals['mapped']} mapped,"
          f" {totals['unmapped']} unmapped, {totals['failed']} "
          f"failed", file=sys.stderr)
    if quarantine:
        print(quarantine.exit_summary(), file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
