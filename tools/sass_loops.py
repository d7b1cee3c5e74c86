#!/usr/bin/env python3
"""Instruction counts of the kernels in a ``cuobjdump -sass`` listing.

For every function whose (mangled) name matches NAME_REGEX, prints one
JSON line: its instruction count, the instruction counts of its loops
(each backward branch with its target; the smallest is the innermost),
the op mix of the innermost loop and of every loop, so a kernel's
per-iteration cost can be read without ``ncu``.

    cuobjdump -sass build/torch/libpairhmm_kernel-*.so > listing.txt
    python3 tools/sass_loops.py listing.txt 'pairhmm_forward_kernelIfLb1ELi6E'
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from collections import Counter


def functions(listing: str):
    """(name, [(address, instruction text)]) per function."""
    for block in re.split(r"\n\s*Function : ", listing)[1:]:
        name = block.split("\n", 1)[0].strip()
        yield name, [(int(a, 16), t.strip()) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]


def loops(ins):
    """Each backward branch's loop body, smallest first."""
    out = []
    for a, t in ins:
        m = re.search(r"BRA\s+(0x[0-9a-f]+)", t)
        if m and int(m[1], 16) < a:
            lo = int(m[1], 16)
            out.append([x for x in ins if lo <= x[0] <= a])
    return sorted(out, key=len)


def opcode(text: str) -> str:
    words = text.split()
    return words[1 if words[0].startswith("@") else 0].split(".")[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("listing")
    ap.add_argument("name_regex", nargs="?", default=".")
    args = ap.parse_args(argv)
    with open(args.listing) as fh:
        listing = fh.read()
    for name, ins in functions(listing):
        if not re.search(args.name_regex, name):
            continue
        body = loops(ins)
        print(json.dumps({
            "function": name, "instructions": len(ins),
            "loops": [len(b) for b in body],
            "innermost_ops": dict(Counter(
                opcode(t) for _, t in body[0]).most_common())
            if body else {},
            "loop_ops": [dict(Counter(opcode(t) for _, t in b)
                              .most_common()) for b in body]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
