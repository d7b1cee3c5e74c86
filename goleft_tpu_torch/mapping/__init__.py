"""FASTQ-native read mapping: minimizer seeding + banded SW extend.

The counterpart of the JAX package's mapping/ (its serve smoke is not
ported): ``index`` builds the (w,k) minimizer tables over a FASTA
reference; ``pipeline`` runs batched reads through seeding (PyTorch ops
on the device) and the banded Smith-Waterman wavefront (the hand-written
kernel of ops/swalign_kernel.py on the card), then emits the read-tuple
stream the depth kernel turns into windowed depth.
"""

from .index import (  # noqa: F401
    DEFAULT_K, DEFAULT_MAX_OCC, DEFAULT_W, MinimizerIndex,
    build_index, from_arrays, get_index,
)
from .pipeline import (  # noqa: F401
    MapParams, MapResult, depth_bed_from_tuples, format_tuples,
    map_reads, parse_tuples, seed_bucket,
)
