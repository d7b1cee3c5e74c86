"""CRAI (CRAM index) entries for region access.

The .crai format is gzipped TSV with six fields per line (seqID,
alnStart, alnSpan, containerStart, sliceStart, sliceLen), CRAM spec
appendix. The port keeps only what io/cram.py's region lookup reads: the
(seqID, alnStart, alnSpan, containerStart) of each line, as the JAX
package's io/cram.py::_load_crai_entries does. The tile interpolation
that indexcov uses is not ported.
"""

from __future__ import annotations

import gzip


def load_crai_entries(path: str) -> list[tuple[int, int, int, int]]:
    """(seq_id, aln_start (1-based), aln_span, container_offset) per
    index line; lines with fewer than six fields are skipped. A URL is
    read through io/remote.py."""
    import io as _pyio

    from . import remote

    entries = []
    if remote.is_remote(path):
        fh = _pyio.TextIOWrapper(gzip.GzipFile(
            fileobj=_pyio.BytesIO(remote.fetch_bytes(path))))
    else:
        fh = gzip.open(path, "rt")
    with fh:
        for line in fh:
            t = line.split("\t")
            if len(t) < 6:
                continue
            entries.append((int(t[0]), int(t[1]), int(t[2]), int(t[3])))
    return entries
