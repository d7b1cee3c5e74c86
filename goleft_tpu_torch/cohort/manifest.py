"""The cohort manifest: ``goleft-tpu.cohort-manifest/1``.

A copy of the JAX package's cohort/manifest.py, format string included,
so a manifest either package wrote loads under the other.

The manifest is the cohort plane's commit record: one JSON document
per output directory naming every sample by **content identity** —
``parallel.scheduler.file_key`` of the index file actually read
(path + size + mtime_ns locally; the ETag/Last-Modified/size tuple of
``io.remote.remote_file_key`` for ``https://``/``s3://`` inputs) —
plus the canonical scan parameters and the run's QC-compute counters.

Invalidation is two-layered and strictly content-keyed:

- The per-(sample, chromosome) checkpoint blocks embed the sample's
  own identity key, so a changed ETag (or a rewritten .bai) stops
  matching ONLY its own blocks; every other sample resumes. The
  manifest never has to *decide* invalidation — the store's key
  lookup is the decision.
- The manifest records what the previous committed run looked like, so
  an incremental re-run can report exactly which samples are new /
  changed / unchanged (the diff the append-k acceptance counter is
  asserted against), and refuse a silent parameter drift (changed
  params → every block is a miss anyway; the manifest makes it loud).

Schema (docs/cohort.md#manifest):

.. code-block:: json

    {"format": "goleft-tpu.cohort-manifest/1",
     "params": {"sex": "X,Y", "exclude": "...", "chrom": "",
                "extra_normalize": false, "tile": 16384},
     "samples": [{"path": "...", "name": "...", "key": [..]}],
     "counters": {"chrom_qc_computed_total": 0,
                  "chrom_qc_resumed_total": 0}}
"""

from __future__ import annotations

import json
import os

FORMAT = "goleft-tpu.cohort-manifest/1"


class CohortManifest:
    def __init__(self, params: dict, samples: list[dict],
                 counters: dict | None = None):
        self.params = params
        self.samples = samples
        self.counters = dict(counters or {})

    # ---- (de)serialization ----

    @classmethod
    def load(cls, path: str) -> "CohortManifest":
        with open(path) as f:
            doc = json.load(f)
        if doc.get("format") != FORMAT:
            raise ValueError(
                f"cohort: {path}: not a {FORMAT} document "
                f"(format={doc.get('format')!r})")
        return cls(doc["params"], doc["samples"], doc.get("counters"))

    def save(self, path: str) -> None:
        doc = {
            "format": FORMAT,
            "params": self.params,
            "samples": self.samples,
            "counters": {k: self.counters[k]
                         for k in sorted(self.counters)},
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic: a torn write never commits

    # ---- the incremental diff ----

    def diff(self, samples: list[dict]) -> dict:
        """Classify the *current* sample list against this committed
        manifest: ``{"new": [...], "changed": [...], "unchanged":
        [...], "removed": [...]}`` (lists of paths, current order).

        Identity is the path; content is the key — a sample whose path
        is known but whose key moved (ETag drift, rewritten index) is
        *changed*, and its checkpoint blocks are already unreachable
        because the key is part of every block's name.
        """
        committed = {s["path"]: _norm_key(s["key"])
                     for s in self.samples}
        out = {"new": [], "changed": [], "unchanged": [], "removed": []}
        seen = set()
        for s in samples:
            seen.add(s["path"])
            if s["path"] not in committed:
                out["new"].append(s["path"])
            elif committed[s["path"]] != _norm_key(s["key"]):
                out["changed"].append(s["path"])
            else:
                out["unchanged"].append(s["path"])
        out["removed"] = [p for p in sorted(committed) if p not in seen]
        return out


def _norm_key(key):
    """JSON round-trips tuples as lists; canonicalize for comparison."""
    return json.loads(json.dumps(key))
