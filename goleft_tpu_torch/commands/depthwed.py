"""depthwed: matricize N depth.bed files into one sites × samples TSV.

A copy of the JAX package's commands/depthwed.py: host text processing,
no device stage, so it needs no card.

Reference semantics (depthwed/depthwed.go):
  - sample name from filename with .gz/.bed/.depth suffixes stripped
    (":37-46")
  - per input row, depth = round-half-up(mean column) (":94-106")
  - consecutive rows are aggregated (depths summed, end extended) until
    the first file's span reaches -s size or the chromosome changes
    (":117-157"); a partial group cut off by EOF is dropped (":64-71")
  - all files must stay in lockstep (same row count) (":130-134")
"""

from __future__ import annotations

import argparse
import sys

from ..utils.xopen import xopen


def name_from_file(path: str) -> str:
    base = path.rsplit("/", 1)[-1]
    for suf in (".gz", ".bed", ".depth"):
        if base.endswith(suf):
            base = base[: -len(suf)]
    return base


def _parse(line: str) -> tuple[str, int, int, int]:
    t = line.rstrip("\n").split("\t")
    return t[0], int(t[1]), int(t[2]), int(0.5 + float(t[3]))


def run_depthwed(beds: list[str], size: int, out=None) -> None:
    out = out or sys.stdout
    fhs = [xopen(b) for b in beds]
    names = ["#chrom", "start", "end"] + [name_from_file(b) for b in beds]
    out.write("\t".join(names) + "\n")

    pending: list[tuple[str, int, int, int] | None] = [None] * len(fhs)

    def read_row(i):
        line = fhs[i].readline()
        if not line:
            return None
        return _parse(line)

    eof = False
    while not eof:
        group = [None] * len(fhs)
        span = 0
        chrom = None
        while True:
            rows = []
            for i in range(len(fhs)):
                r = read_row(i)
                if r is None:
                    if i > 0:
                        raise SystemExit(
                            "depthwed: not all files have same number of "
                            "records"
                        )
                    eof = True
                    rows = None
                    break
                rows.append(r)
            if eof or rows is None:
                break
            if chrom is None:
                chrom = rows[0][0]
            for i, r in enumerate(rows):
                if r[0] != chrom:
                    raise SystemExit(
                        f"depthwed: got unexpected chromosome from "
                        f"{beds[i]}: {r[0]}"
                    )
                if group[i] is None:
                    group[i] = list(r)
                else:
                    group[i][2] = r[2]
                    group[i][3] += r[3]
            span = group[0][2] - group[0][1]
            if span >= size:
                break
            # stop the group at a chromosome boundary (peek next row's
            # chrom via the first file)
            posn = fhs[0].tell() if hasattr(fhs[0], "tell") else None
            nxt = fhs[0].readline()
            if posn is not None:
                fhs[0].seek(posn)
            else:  # pragma: no cover - gz streams support tell/seek
                break
            if not nxt or nxt.split("\t", 1)[0] != chrom:
                break
        if group[0] is not None and not eof:
            out.write(
                f"{group[0][0]}\t{group[0][1]}\t{group[0][2]}"
                + "".join(f"\t{g[3]}" for g in group)
                + "\n"
            )
    for fh in fhs:
        fh.close()


def main(argv=None):
    p = argparse.ArgumentParser(
        "goleft-tpu-torch depthwed",
        description="combine goleft depth .depth.bed files into a matrix",
    )
    p.add_argument("-s", "--size", type=int, required=True,
                   help="window size to aggregate to (>= input window)")
    p.add_argument("beds", nargs="+", help="depth.bed files")
    a = p.parse_args(argv)
    run_depthwed(a.beds, a.size)


if __name__ == "__main__":
    main()
