"""CNV candidate intervals: the counterpart of the JAX package's
models/candidates.py, trimmed to what ``pairhmm --candidates`` reads
and what ``emdepth --candidates-out`` writes.

  - ``*.json``: ``{"schema": "goleft-tpu.cnv-candidates/1",
    "source": "<tool>", "candidates": [{chrom, start, end, sample, cn,
    log2fc}, ...]}``
  - anything else: BED-style TSV with two header lines,
    ``#goleft-tpu-candidates=1 source=<tool>`` then
    ``#chrom\\tstart\\tend\\tsample\\tCN\\tlog2FC``, one record per row

``read_candidates`` sniffs the format from content (a JSON document
starts with ``{``).
"""

from __future__ import annotations

import json

SCHEMA = "goleft-tpu.cnv-candidates/1"
_BED_MAGIC = "#goleft-tpu-candidates=1"


def write_candidates(path: str, records, source: str) -> None:
    """Write candidate records (dicts with chrom/start/end/sample/cn/
    log2fc) as JSON (``*.json``) or the BED-style TSV."""
    records = [
        {"chrom": str(r["chrom"]), "start": int(r["start"]),
         "end": int(r["end"]), "sample": str(r["sample"]),
         "cn": int(r["cn"]),
         # 4 decimals in both encodings, so the two round-trip equal
         "log2fc": round(float(r["log2fc"]), 4)}
        for r in records
    ]
    if path.endswith(".json"):
        with open(path, "w") as fh:
            json.dump({"schema": SCHEMA, "source": source,
                       "candidates": records}, fh, indent=1,
                      sort_keys=True)
            fh.write("\n")
        return
    with open(path, "w") as fh:
        fh.write(f"{_BED_MAGIC} source={source}\n")
        fh.write("#chrom\tstart\tend\tsample\tCN\tlog2FC\n")
        for r in records:
            fh.write(f"{r['chrom']}\t{r['start']}\t{r['end']}\t"
                     f"{r['sample']}\t{r['cn']}\t{r['log2fc']:.4f}\n")


def read_candidates(path: str) -> list[dict]:
    """Parse either candidate format → list of record dicts; raises
    ValueError (the CLI's clean-error contract) on anything else."""
    with open(path) as fh:
        text = fh.read()
    if text.lstrip().startswith("{"):
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"candidates {path}: bad JSON: {e}") \
                from None
        schema = doc.get("schema", "")
        if not schema.startswith(SCHEMA):
            raise ValueError(
                f"candidates {path}: unsupported schema {schema!r} "
                f"(want {SCHEMA})")
        out = []
        for r in doc.get("candidates", []):
            try:
                out.append({"chrom": str(r["chrom"]),
                            "start": int(r["start"]),
                            "end": int(r["end"]),
                            "sample": str(r.get("sample", "")),
                            "cn": int(r.get("cn", -1)),
                            "log2fc": float(r.get("log2fc", 0.0))})
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(
                    f"candidates {path}: bad record {r!r}: {e}") \
                    from None
        return out
    lines = text.splitlines()
    if not lines or not lines[0].startswith(_BED_MAGIC):
        raise ValueError(
            f"candidates {path}: not a goleft-tpu candidates file "
            f"(missing {_BED_MAGIC!r} header or JSON document)")
    out = []
    for ln in lines[1:]:
        if not ln or ln.startswith("#"):
            continue
        t = ln.split("\t")
        if len(t) < 6:
            raise ValueError(
                f"candidates {path}: short row {ln!r} (want 6 cols)")
        try:
            out.append({"chrom": t[0], "start": int(t[1]),
                        "end": int(t[2]), "sample": t[3],
                        "cn": int(t[4]), "log2fc": float(t[5])})
        except ValueError as e:
            raise ValueError(
                f"candidates {path}: bad row {ln!r}: {e}") from None
    return out


def overlaps_any(candidates, chrom: str, start: int, end: int) -> bool:
    """True when [start, end) on chrom overlaps any candidate."""
    return any(c["chrom"] == chrom and c["start"] < end
               and start < c["end"] for c in candidates)


def candidates_from_calls(results) -> list[dict]:
    """emdepth CNV-call tuples (chrom, start, end, sample, CN, log2FC),
    what ``call_cnvs`` returns, to candidate records."""
    return [{"chrom": c, "start": s, "end": e, "sample": smp,
             "cn": cn, "log2fc": fc}
            for c, s, e, smp, cn, fc in results]
