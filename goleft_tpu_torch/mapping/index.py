"""Minimizer index over a FASTA reference: host build, device tables.

A copy of the JAX package's mapping/index.py: the host build is the
reference's, probe loop included, so the tables are byte-identical;
``device_tables(device)`` gives them as int32 tensors on an explicit
device, and :func:`from_arrays` carries a table set across from the
reference (the tests seed both packages on the same tables).

The seed half of seed-and-extend (GenPairX and the PIM read-mapping
paper in PAPERS.md both reduce it to hashed k-mer table gathers). The
reference's chromosomes concatenate into one coordinate space; every
(w,k)-minimizer lands in an open-addressed int32 hash table plus a
flat positions array — four device arrays total, shipped once per
reference and content-keyed by the reference's ``file_key`` so the
ResultCache / checkpoint / dedup layers compose (a rebuilt FASTA
changes the key, never silently reuses stale tables).

Scheme (identical on host and device, which is what makes on-device
seeding exact):

  - k-mers are 2-bit packed (A=0 C=1 G=2 T=3; any k-mer touching an
    N/other base is excluded), k ≤ 15 so the code fits 30 bits of an
    int32
  - the k-mer code is avalanched through the 32-bit murmur3
    finalizer (:func:`fmix32`) — uint32 arithmetic, identical in
    numpy and in the port's int64 tensor arithmetic
  - position p is a minimizer iff hash[p] == min(hash[p-w+1 : p+w])
    — a symmetric windowed-min rule (density ~1/w) whose device
    formulation is w-1 shifted ``minimum`` ops, no argmin
  - the open-addressed table stores the k-mer CODE as the slot
    fingerprint (codes are < 2^30, so -1 means empty), probed
    linearly from ``fmix32(code) & (size-1)``; build grows the table
    until every key's probe chain fits ``PROBE_MAX``, so the device
    lookup is a fixed-depth unrolled probe, never a loop that can
    miss
  - keys occurring more than ``max_occ`` times are dropped whole
    (repeat masking, minimap2-style), bounding the per-seed gather
    fan-out to a static ``max_occ`` lanes
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..obs import get_registry

DEFAULT_K = 13
DEFAULT_W = 8
DEFAULT_MAX_OCC = 64
#: fixed device probe depth; the build grows the table until every
#: chain fits, so lookups are exact with a static unrolled probe
PROBE_MAX = 16

_ENCODE2 = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ENCODE2[_b] = _i
    _ENCODE2[ord(chr(_b).lower())] = _i


def encode_ref(seq: bytes) -> np.ndarray:
    """bytes → uint8 codes (A=0 C=1 G=2 T=3, other=4)."""
    return _ENCODE2[np.frombuffer(seq, dtype=np.uint8)]


def fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3 32-bit finalizer over uint32 (numpy side; the device
    seeding computes the identical mix in int64 masked to 32 bits,
    mapping/pipeline.py::fmix32_torch)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def kmer_codes(codes: np.ndarray, k: int) -> tuple[np.ndarray,
                                                   np.ndarray]:
    """(codes (L-k+1,) uint32, valid (L-k+1,) bool) rolling k-mers.

    A position is valid iff no base in [p, p+k) is an N/other."""
    L = len(codes)
    n = L - k + 1
    if n <= 0:
        return (np.zeros(0, np.uint32), np.zeros(0, bool))
    out = np.zeros(n, dtype=np.uint32)
    valid = np.ones(n, dtype=bool)
    for t in range(k):
        c = codes[t:t + n]
        out = (out << np.uint32(2)) | np.minimum(c, 3).astype(
            np.uint32)
        valid &= c < 4
    return out, valid


def minimizer_mask(hashes: np.ndarray, valid: np.ndarray,
                   w: int) -> np.ndarray:
    """p selected iff valid and hash[p] == min(hash[p-w+1 : p+w])
    (invalid positions count as +inf). The same rule, with the same
    boundary padding, runs on device for read minimizers."""
    INF = np.uint32(0xFFFFFFFF)
    h = np.where(valid, hashes, INF)
    m = h.copy()
    for d in range(1, w):
        m[d:] = np.minimum(m[d:], h[:-d])   # left neighbors
        m[:-d] = np.minimum(m[:-d], h[d:])  # right neighbors
    return valid & (h == m)


@dataclass
class MinimizerIndex:
    """Host-side index + the reference it was built over."""

    k: int
    w: int
    max_occ: int
    ref_codes: np.ndarray          # (L,) uint8 concatenated chroms
    chrom_names: list[str]
    chrom_starts: np.ndarray       # (C+1,) int64 concat offsets
    ht_code: np.ndarray            # (S,) int32 k-mer code, -1 empty
    ht_start: np.ndarray           # (S,) int32 into ``pos``
    ht_cnt: np.ndarray             # (S,) int32
    pos: np.ndarray                # (P,) int32 global positions
    ref_key: tuple = ()            # content identity (file_key)
    n_minimizers: int = 0
    n_dropped: int = 0             # keys over max_occ, dropped whole
    _device: dict = field(default_factory=dict, repr=False)

    @property
    def table_size(self) -> int:
        return len(self.ht_code)

    def chrom_of(self, gpos: int) -> tuple[str, int]:
        """global position → (chrom name, chrom-local position)."""
        c = int(np.searchsorted(self.chrom_starts, gpos,
                                side="right")) - 1
        c = max(0, min(c, len(self.chrom_names) - 1))
        return self.chrom_names[c], gpos - int(self.chrom_starts[c])

    def chrom_bounds(self, gpos: int) -> tuple[int, int]:
        """global [start, end) of the chromosome containing gpos."""
        c = int(np.searchsorted(self.chrom_starts, gpos,
                                side="right")) - 1
        c = max(0, min(c, len(self.chrom_names) - 1))
        return (int(self.chrom_starts[c]),
                int(self.chrom_starts[c + 1]))

    def device_tables(self, device):
        """(ht_code, ht_start, ht_cnt, pos) as int32 tensors on
        ``device``: copied once per device, reused across buckets. An
        empty ``pos`` is one zero, so a gather has a row to clamp to."""
        import torch

        dev = torch.device(device)
        key = str(dev)
        if key not in self._device:
            pos = self.pos if len(self.pos) else np.zeros(1, np.int32)
            self._device[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                for a in (self.ht_code, self.ht_start, self.ht_cnt, pos))
        return self._device[key]


#: the fields :func:`from_arrays` takes, as :class:`MinimizerIndex`
#: names them
ARRAY_FIELDS = ("k", "w", "max_occ", "ref_codes", "chrom_names",
                "chrom_starts", "ht_code", "ht_start", "ht_cnt", "pos",
                "ref_key", "n_minimizers", "n_dropped")


def from_arrays(a: dict) -> MinimizerIndex:
    """A :class:`MinimizerIndex` from its fields (``ARRAY_FIELDS``):
    arrays as numpy, ``k``/``w``/``max_occ``/counts as ints,
    ``chrom_names`` as strings. An index another build made, the JAX
    package's included, crosses over unchanged."""
    return MinimizerIndex(
        k=int(a["k"]), w=int(a["w"]), max_occ=int(a["max_occ"]),
        ref_codes=np.asarray(a["ref_codes"], np.uint8),
        chrom_names=[str(n) for n in a["chrom_names"]],
        chrom_starts=np.asarray(a["chrom_starts"], np.int64),
        ht_code=np.asarray(a["ht_code"], np.int32),
        ht_start=np.asarray(a["ht_start"], np.int32),
        ht_cnt=np.asarray(a["ht_cnt"], np.int32),
        pos=np.asarray(a["pos"], np.int32),
        ref_key=tuple(a["ref_key"]), n_minimizers=int(a["n_minimizers"]),
        n_dropped=int(a["n_dropped"]))


def _read_fasta(path: str) -> tuple[list[str], list[bytes]]:
    """Chromosome names + raw sequence bytes (local or remote)."""
    from ..io import remote

    data = remote.fetch_bytes(path)
    if data[:2] == b"\x1f\x8b":
        import gzip

        data = gzip.decompress(data)
    names: list[str] = []
    seqs: list[bytes] = []
    cur: list[bytes] = []
    for line in data.split(b"\n"):
        line = line.rstrip(b"\r")
        if line.startswith(b">"):
            if names:
                seqs.append(b"".join(cur))
            names.append(line[1:].split()[0].decode("ascii"))
            cur = []
        elif line:
            cur.append(line)
    if names:
        seqs.append(b"".join(cur))
    if not names:
        raise ValueError(f"{path}: no FASTA records")
    return names, seqs


def build_index(reference: str, k: int = DEFAULT_K,
                w: int = DEFAULT_W,
                max_occ: int = DEFAULT_MAX_OCC) -> MinimizerIndex:
    """Build the (w,k)-minimizer index over a FASTA reference."""
    if not (0 < k <= 15):
        raise ValueError(f"k must be in [1, 15], got {k}")
    if w < 1:
        raise ValueError(f"w must be >= 1, got {w}")
    from ..parallel.scheduler import file_key

    names, seqs = _read_fasta(reference)
    starts = np.zeros(len(seqs) + 1, dtype=np.int64)
    for i, s in enumerate(seqs):
        starts[i + 1] = starts[i] + len(s)
    ref_codes = encode_ref(b"".join(seqs))

    # minimizer positions per chromosome (windows never straddle a
    # chromosome boundary), collected in global coordinates
    mpos_parts: list[np.ndarray] = []
    mcode_parts: list[np.ndarray] = []
    for i in range(len(seqs)):
        codes = ref_codes[starts[i]:starts[i + 1]]
        kc, valid = kmer_codes(codes, k)
        if len(kc) == 0:
            continue
        sel = minimizer_mask(fmix32(kc), valid, w)
        p = np.nonzero(sel)[0]
        mpos_parts.append((p + starts[i]).astype(np.int64))
        mcode_parts.append(kc[p])
    if mpos_parts:
        mpos = np.concatenate(mpos_parts)
        mcode = np.concatenate(mcode_parts)
    else:
        mpos = np.zeros(0, np.int64)
        mcode = np.zeros(0, np.uint32)

    # group by code: sort (code, pos), then key runs
    order = np.lexsort((mpos, mcode))
    mcode = mcode[order]
    mpos = mpos[order]
    uniq, first, counts = np.unique(mcode, return_index=True,
                                    return_counts=True)
    keep = counts <= max_occ
    n_dropped = int((~keep).sum())
    uniq, first, counts = uniq[keep], first[keep], counts[keep]

    # open-addressed table: grow until every probe chain fits
    size = 64
    need = 2 * max(1, len(uniq))
    while size < need:
        size *= 2
    while True:
        ht_code = np.full(size, -1, dtype=np.int32)
        ht_start = np.zeros(size, dtype=np.int32)
        ht_cnt = np.zeros(size, dtype=np.int32)
        ok = True
        slots = fmix32(uniq) & np.uint32(size - 1)
        for n in range(len(uniq)):
            s = int(slots[n])
            for t in range(PROBE_MAX):
                j = (s + t) & (size - 1)
                if ht_code[j] == -1:
                    ht_code[j] = np.int32(uniq[n])
                    ht_start[j] = np.int32(first[n])
                    ht_cnt[j] = np.int32(counts[n])
                    break
            else:
                ok = False
                break
        if ok:
            break
        size *= 2

    reg = get_registry()
    reg.counter("mapping.index_builds_total").inc()
    reg.counter("mapping.index_minimizers_total").inc(len(mpos))
    try:
        ref_key = file_key(reference)
    except OSError:
        ref_key = (reference,)
    return MinimizerIndex(
        k=k, w=w, max_occ=max_occ, ref_codes=ref_codes,
        chrom_names=names, chrom_starts=starts,
        ht_code=ht_code, ht_start=ht_start, ht_cnt=ht_cnt,
        pos=mpos.astype(np.int32), ref_key=ref_key,
        n_minimizers=len(mpos), n_dropped=n_dropped)


_INDEX_CACHE: dict[tuple, MinimizerIndex] = {}


def get_index(reference: str, k: int = DEFAULT_K, w: int = DEFAULT_W,
              max_occ: int = DEFAULT_MAX_OCC) -> MinimizerIndex:
    """Content-keyed index cache: one build (and one device upload per
    device) per (reference identity, k, w, max_occ) per process."""
    from ..parallel.scheduler import file_key

    try:
        key = (tuple(file_key(reference)), k, w, max_occ)
    except OSError:
        key = ((reference,), k, w, max_occ)
    idx = _INDEX_CACHE.get(key)
    if idx is None:
        idx = build_index(reference, k=k, w=w, max_occ=max_occ)
        _INDEX_CACHE[key] = idx
    return idx
