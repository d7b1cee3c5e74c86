"""Seed-chain-extend pipeline: batched reads → mapped read tuples.

The counterpart of the JAX package's mapping/pipeline.py, with its
tuples and depth bytes. Three stages per read batch:

  1. **seed** — reads ship 2-bit packed (4 bases/byte + an N bitmask),
     unpack on the device, hash their (w,k)-minimizers with the same
     fmix32 the index used (int64 arithmetic masked to 32 bits, split
     multiplies: :func:`fmix32_torch`), probe the open-addressed table
     (a fixed ``PROBE_MAX`` probe — the build guaranteed every chain
     fits) and gather up to ``max_occ`` reference positions a seed.
  2. **chain** — in the same pass: seed hits become diagonals
     (ref_pos − read_pos), are sorted per read, and a searchsorted
     band-count scores every diagonal by how many hits land within
     ±band of it. Both strands run (the reverse complement is re-derived
     on the device); the higher-support strand wins, forward on ties,
     smallest diagonal on ties within a strand. :func:`seed_bucket` is
     the whole of 1 and 2 as PyTorch ops batched over the bucket's reads
     (the reference's ``_seed_bucket_impl`` is an XLA program, no
     Pallas).
  3. **extend** — the winning diagonal defines a reference window
     [diag − band, diag + rlen + band) clipped to its chromosome;
     read/window pairs go through the banded Smith-Waterman wavefront
     (ops/swalign.py: the hand-written kernel on the card) bucketed by
     (r_pad, w_pad).

Every device stage of a bucket is a plan Step at the ``map`` fault
site: transient faults retry under the RetryPolicy, exhausted buckets
fail only their own reads (``allow_partial``) and surface in the
returned ``failed`` map for the caller to quarantine (the exit-3
contract). The reference caps distinct bucket shapes at 128 to bound
its jit compiles and sends shapes past the cap to its host oracles; the
port compiles nothing per shape, so every bucket takes the device path
and ``mapping.host_fallback_total`` stays 0 (ROADMAP Queue C, noted
divergences; the bytes are the same, the reference's fallback being
bit-identical).

Stages (``TIMER``, in the CLI's ``--metrics-out`` spans):
``index-build`` (mapping/index.py via :func:`~.index.get_index` in
commands/map_cmd.py), ``seed`` (pack, upload, the ops, the fetch) and
``depth``; the extend stage's are ops/swalign.py's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..obs import get_registry
from ..ops import swalign
from ..ops.pairhmm import encode_seq
from ..ops.swalign import Scores, DEFAULT_SCORES
from ..utils.profiling import StageTimer
from .index import (
    DEFAULT_K, DEFAULT_MAX_OCC, DEFAULT_W, PROBE_MAX, MinimizerIndex,
    fmix32, kmer_codes, minimizer_mask,
)

BUCKET = swalign.BUCKET        # read-length bucket granularity
DEFAULT_BAND = 32
DEFAULT_MIN_SUPPORT = 2
#: diagonal sentinel for invalid seed-hit lanes: far above any real
#: diagonal (references cap at 2^29 bases), low enough that +band
#: cannot wrap int32
_DIAG_INF = 1 << 29
_M32 = 0xFFFFFFFF

#: stage clock of the seed and depth stages
TIMER = StageTimer()


class MapParams(NamedTuple):
    """Mapping parameters — part of every content/group key."""

    k: int = DEFAULT_K
    w: int = DEFAULT_W
    max_occ: int = DEFAULT_MAX_OCC
    band: int = DEFAULT_BAND
    min_support: int = DEFAULT_MIN_SUPPORT
    scores: Scores = DEFAULT_SCORES

    def key(self) -> tuple:
        return (self.k, self.w, self.max_occ, self.band,
                self.min_support) + self.scores.astuple()


class MapResult(NamedTuple):
    """One batch through :func:`map_reads`."""

    tuples: list          # per input read: tuple row or None
    failed: dict          # input index -> exception (quarantinable)
    stats: dict


def _pad_up(n: int, to: int) -> int:
    return max(to, ((n + to - 1) // to) * to)


def _smax(r_pad: int, k: int, w: int) -> int:
    """Per-read seed capacity for a bucket: ~2x the expected 1/w
    minimizer density plus slack; degenerate (all-tie) reads overflow
    it and simply lose tail seeds — they were unmappable repeats."""
    n = r_pad - k + 1
    return max(4, min(n, 2 * (n // w) + 8))


def rc_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement of a 0..4 code array (N stays N)."""
    r = codes[::-1]
    return np.where(r < 4, 3 - r, 4).astype(codes.dtype)


# ---------------------------------------------------------------------------
# device seeding + chaining

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): the multiply split into
    16-bit halves of ``c`` so that no product passes 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix32_torch(x: torch.Tensor) -> torch.Tensor:
    """:func:`~.index.fmix32` (the murmur3 32-bit finalizer) over int64
    tensors holding uint32 values: every step masked to 32 bits."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _seed_strand(codes: torch.Tensor, tables, *, k: int, w: int,
                 max_occ: int, band: int, smax: int):
    """codes (B, r_pad) int64 0..4 → (support (B,) int32, diag (B,)
    int32) of one strand, the reference's ``seed_one`` batched over
    reads."""
    ht_code, ht_start, ht_cnt, pos = tables
    b, r_pad = codes.shape
    dev = codes.device
    S = ht_code.shape[0]
    P = pos.shape[0]
    n = r_pad - k + 1
    inf = _M32
    kc = torch.zeros(b, n, dtype=torch.int64, device=dev)
    valid = torch.ones(b, n, dtype=torch.bool, device=dev)
    for t in range(k):
        c = codes[:, t:t + n]
        kc = (kc << 2) | torch.clamp_max(c, 3)
        valid = valid & (c < 4)
    h = torch.where(valid, fmix32_torch(kc), inf)
    # symmetric windowed min, out-of-range neighbours = +inf — the same
    # rule minimizer_mask applied to the reference
    pad = torch.full((b, w - 1), inf, dtype=torch.int64, device=dev)
    hp = torch.cat([pad, h, pad], dim=1)
    m = h
    for d in range(1, w):
        m = torch.minimum(m, hp[:, w - 1 - d:w - 1 - d + n])
        m = torch.minimum(m, hp[:, w - 1 + d:w - 1 + d + n])
    sel = valid & (h == m)
    # compact selected positions (stable: position order) to smax
    order = torch.argsort((~sel).to(torch.int32), dim=1, stable=True)
    take = order[:, :smax]
    tvalid = sel.gather(1, take)
    tkc = kc.gather(1, take)
    # fixed-depth probe: the index build guaranteed every chain fits
    # PROBE_MAX, so a miss after PROBE_MAX means "absent"
    slot = fmix32_torch(tkc) & (S - 1)
    fstart = torch.zeros_like(take, dtype=torch.int32)
    fcnt = torch.zeros_like(take, dtype=torch.int32)
    done = ~tvalid
    for t in range(PROBE_MAX):
        j = (slot + t) & (S - 1)
        c = ht_code[j].to(torch.int64)
        hit = (~done) & (c == tkc)
        fstart = torch.where(hit, ht_start[j], fstart)
        fcnt = torch.where(hit, ht_cnt[j], fcnt)
        done = done | hit | (c == -1)
    # gather ≤ max_occ reference positions per seed → diagonals
    lanes = torch.arange(max_occ, dtype=torch.int32, device=dev)
    gidx = torch.clamp(fstart[..., None] + lanes, 0, P - 1).long()
    pv = pos[gidx]
    ok = lanes < fcnt[..., None]
    ds = torch.where(ok, pv - take[..., None].to(torch.int32),
                     _DIAG_INF).reshape(b, -1)
    # chain: sort diagonals, score each by hits within ±band
    ds = torch.sort(ds, dim=1).values.contiguous()
    hi = torch.searchsorted(ds, ds + band, side="right")
    lo = torch.searchsorted(ds, ds - band, side="left")
    support = torch.where(ds >= _DIAG_INF, -1,
                          (hi - lo).to(torch.int32))
    best = torch.argmax(support, dim=1, keepdim=True)  # first max
    return (support.gather(1, best)[:, 0],
            ds.gather(1, best)[:, 0])


def seed_bucket(packed, nmask, rlens, tables, *, r_pad: int, k: int,
                w: int, max_occ: int, band: int, smax: int):
    """One read bucket: 2-bit unpack → minimizers → table probe →
    gather → diagonal chain, both strands, as PyTorch ops on the device
    of the inputs, batched over the reads.

    packed (B, ceil(r_pad/4)) uint8, nmask (B, ceil(r_pad/8)) uint8 (bit
    set = base is N or padding), rlens (B,) int32; ``tables`` as
    :meth:`~.index.MinimizerIndex.device_tables` gives them. Returns
    (support (B,) int32 — −1 when no valid seed hit, diag (B,) int32
    global, rev (B,) bool).
    """
    dev = packed.device
    p = torch.arange(r_pad, device=dev)
    code2 = (packed[:, p // 4].to(torch.int64) >> (2 * (p % 4))) & 3
    nbit = (nmask[:, p // 8].to(torch.int64) >> (p % 8)) & 1
    codes = torch.where(nbit == 1, 4, code2)
    # reverse complement, rolled per read so it re-starts at lane 0:
    # jnp.roll(x, rlen - r_pad)[j] = x[(j - rlen + r_pad) mod r_pad]
    flip = codes.flip(1)
    rcrev = torch.where(flip < 4, 3 - flip, 4)
    idx = (p[None, :] - rlens[:, None].to(torch.int64) + r_pad) % r_pad
    rc = rcrev.gather(1, idx)
    kw = dict(k=k, w=w, max_occ=max_occ, band=band, smax=smax)
    sf, df = _seed_strand(codes, tables, **kw)
    sr, dr = _seed_strand(rc, tables, **kw)
    rev = sr > sf  # forward wins ties
    return (torch.where(rev, sr, sf), torch.where(rev, dr, df), rev)


def _pack_reads_2bit(idxs, codes_list, r_pad):
    """Bucket pack: 2-bit bases + N/padding bitmask + lengths."""
    b = len(idxs)
    pbytes = (r_pad + 3) // 4
    nbytes = (r_pad + 7) // 8
    pk = np.zeros((b, pbytes), np.uint8)
    nm = np.zeros((b, nbytes), np.uint8)
    rl = np.zeros(b, np.int32)
    shifts4 = np.arange(4, dtype=np.uint16) * 2
    shifts8 = np.arange(8, dtype=np.uint16)
    for row, ridx in enumerate(idxs):
        c = codes_list[ridx]
        L = len(c)
        rl[row] = L
        c4 = np.full(pbytes * 4, 0, np.uint16)
        c4[:L] = np.minimum(c, 3)
        pk[row] = (c4.reshape(pbytes, 4)
                   << shifts4).sum(axis=1).astype(np.uint8)
        nb = np.ones(nbytes * 8, np.uint16)
        nb[:L] = (np.asarray(c) >= 4)
        nm[row] = (nb.reshape(nbytes, 8)
                   << shifts8).sum(axis=1).astype(np.uint8)
    return pk, nm, rl


def seed_reads_host(index: MinimizerIndex, codes: np.ndarray,
                    band: int, smax: int) -> tuple[int, int, bool]:
    """Host reference seeding for ONE read: the oracle the device
    seeding is pinned against. Returns (support, diag, rev) with
    identical tie rules."""

    def one(c: np.ndarray) -> tuple[int, int]:
        kc, valid = kmer_codes(c.astype(np.uint8), index.k)
        if len(kc) == 0:
            return -1, _DIAG_INF
        sel = minimizer_mask(fmix32(kc), valid, index.w)
        seeds = np.nonzero(sel)[0][:smax]
        ds: list[int] = []
        size = index.table_size
        for p in seeds:
            code = np.int32(kc[p])
            s = int(fmix32(np.asarray([kc[p]]))[0]) & (size - 1)
            for t in range(PROBE_MAX):
                j = (s + t) & (size - 1)
                cj = index.ht_code[j]
                if cj == -1:
                    break
                if cj == code:
                    st, ct = (int(index.ht_start[j]),
                              int(index.ht_cnt[j]))
                    ds.extend(int(index.pos[st + u]) - int(p)
                              for u in range(ct))
                    break
        if not ds:
            return -1, _DIAG_INF
        arr = np.sort(np.asarray(ds, np.int64))
        hi = np.searchsorted(arr, arr + band, side="right")
        lo = np.searchsorted(arr, arr - band, side="left")
        support = (hi - lo).astype(np.int64)
        b = int(np.argmax(support))
        return int(support[b]), int(arr[b])

    sf, df = one(codes)
    sr, dr = one(rc_codes(codes))
    rev = sr > sf
    return (sr, dr, True) if rev else (sf, df, False)


# ---------------------------------------------------------------------------
# the batch pipeline

def map_reads(index: MinimizerIndex, records,
              params: MapParams = MapParams(), *, policy=None,
              allow_partial: bool = True, device=None) -> MapResult:
    """Map one batch of FASTQ records against ``index`` on ``device``
    (the card unless ``"cpu"``).

    ``records`` is a sequence of objects with ``.name``/``.seq``
    (FastqRecord or equivalent). Returns per-read tuples
    ``(chrom, start, end, name, score, strand)`` — ``None`` for
    unmapped reads — plus a ``failed`` index→exception map for
    buckets whose dispatch exhausted retries (``allow_partial``;
    otherwise the exhaustion raises), and counters for the CLI
    summary. All device work rides plan Steps at the ``map`` fault
    site.
    """
    from ..plan import Executor as PlanExecutor, Step
    from ..resilience.policy import DEFAULT_POLICY

    dev = resolve_device(device)
    if policy is None:
        policy = DEFAULT_POLICY
    reg = get_registry()
    n_reads = len(records)
    reg.counter("mapping.reads_total").inc(n_reads)
    tuples: list = [None] * n_reads
    failed: dict[int, BaseException] = {}
    stats = {"reads": n_reads, "mapped": 0, "unmapped": 0,
             "failed": 0, "seed_buckets": 0, "extend_buckets": 0}
    if n_reads == 0:
        return MapResult(tuples, failed, stats)

    codes_list = [encode_seq(r.seq) for r in records]
    pex = PlanExecutor(policy=policy)

    # ---- stage 1+2: seed + chain, bucketed by padded read length
    support = np.full(n_reads, -1, np.int32)
    diag = np.full(n_reads, _DIAG_INF, np.int64)
    rev = np.zeros(n_reads, bool)
    groups: dict[int, list[int]] = {}
    for i, c in enumerate(codes_list):
        if len(c) < index.k:
            continue  # shorter than a seed: unmapped, not an error
        groups.setdefault(_pad_up(len(c), BUCKET), []).append(i)

    for r_pad, idxs in sorted(groups.items()):
        smax = _smax(r_pad, index.k, index.w)
        b = len(idxs)
        reg.counter("mapping.buckets_total").inc()
        stats["seed_buckets"] += 1

        def thunk(idxs=idxs, r_pad=r_pad, smax=smax):
            with TIMER.stage("seed"):
                host = _pack_reads_2bit(idxs, codes_list, r_pad)
                pk, nm, rl = (torch.from_numpy(a).to(dev) for a in host)
                s, d, rv = obs.dispatch(
                    "map_seed", seed_bucket, pk, nm, rl,
                    index.device_tables(dev), r_pad=r_pad, k=index.k,
                    w=index.w, max_occ=index.max_occ, band=params.band,
                    smax=smax)
                return (s.cpu().numpy(), d.cpu().numpy(),
                        rv.cpu().numpy())

        key = ("map-seed", index.ref_key, params.key(), r_pad, b)
        outcome = pex.run_step(Step(key=key, fn=thunk, site="map"))
        if outcome.error is not None:
            if not allow_partial:
                raise outcome.retries_exhausted
            reg.counter("mapping.buckets_failed_total").inc()
            for i in idxs:
                failed[i] = outcome.error
            continue
        s, d, rv = outcome.value
        ii = np.asarray(idxs)
        support[ii] = s
        diag[ii] = d
        rev[ii] = rv
    reg.counter("mapping.seed_hits_total").inc(
        int(support[support > 0].sum()))

    # ---- stage 3: extension windows for seeded reads
    ext_idx: list[int] = []
    ext_reads: list[np.ndarray] = []
    ext_wins: list[np.ndarray] = []
    ext_gstart: list[int] = []
    L = len(index.ref_codes)
    for i in range(n_reads):
        if i in failed or support[i] < params.min_support:
            continue
        rlen = len(codes_list[i])
        d = int(diag[i])
        center = min(max(d + rlen // 2, 0), max(L - 1, 0))
        cs, ce = index.chrom_bounds(center)
        ws = max(cs, d - params.band)
        we = min(ce, d + rlen + params.band)
        if we - ws < index.k:
            continue
        ext_idx.append(i)
        ext_reads.append(rc_codes(codes_list[i]) if rev[i]
                         else codes_list[i])
        ext_wins.append(index.ref_codes[ws:we])
        ext_gstart.append(ws)

    ext_failed: dict[tuple, BaseException] = {}

    def ext_dispatch(sig, thunk):
        r_pad, w_pad, b = sig
        reg.counter("mapping.buckets_total").inc()
        stats["extend_buckets"] += 1
        key = ("map-extend", index.ref_key, params.key(), r_pad,
               w_pad, b)
        outcome = pex.run_step(Step(
            key=key, fn=lambda: obs.dispatch("map_extend", thunk),
            site="map"))
        if outcome.error is not None:
            if not allow_partial:
                raise outcome.retries_exhausted
            reg.counter("mapping.buckets_failed_total").inc()
            ext_failed[(r_pad, w_pad)] = outcome.error
            return [None] * b
        return outcome.value

    aligned = swalign.align_pairs(ext_reads, ext_wins,
                                  scores=params.scores,
                                  dispatch=ext_dispatch, device=dev)
    for j, a in enumerate(aligned):
        i = ext_idx[j]
        if a is None:
            err = ext_failed.get(swalign.bucket_shape(
                len(ext_reads[j]), len(ext_wins[j])))
            failed[i] = err if err is not None else RuntimeError(
                "map: extension dispatch lost")
            continue
        if a.score <= 0:
            continue
        gs = ext_gstart[j] + a.win_start
        ge = ext_gstart[j] + a.win_end
        chrom, local = index.chrom_of(gs)
        tuples[i] = (chrom, local, local + (ge - gs),
                     records[i].name, int(a.score),
                     "-" if rev[i] else "+")

    stats["failed"] = len(failed)
    stats["mapped"] = sum(1 for t in tuples if t is not None)
    stats["unmapped"] = (n_reads - stats["mapped"]
                         - stats["failed"])
    reg.counter("mapping.reads_mapped_total").inc(stats["mapped"])
    reg.counter("mapping.reads_unmapped_total").inc(
        stats["unmapped"])
    return MapResult(tuples, failed, stats)


# ---------------------------------------------------------------------------
# tuple stream + fused windowed depth

def format_tuples(tuples) -> bytes:
    """Mapped tuples → the TSV stream (`chrom start end name score
    strand`, 0-based half-open; unmapped rows are absent)."""
    out = []
    for t in tuples:
        if t is None:
            continue
        chrom, s, e, name, score, strand = t
        out.append(f"{chrom}\t{s}\t{e}\t{name}\t{score}\t{strand}\n")
    return "".join(out).encode()


def parse_tuples(data: bytes):
    """Inverse of :func:`format_tuples` (the ``--from-tuples`` path)."""
    out = []
    for lineno, line in enumerate(data.splitlines(), 1):
        if not line.strip():
            continue
        parts = line.split(b"\t")
        if len(parts) != 6:
            raise ValueError(
                f"tuple line {lineno}: expected 6 fields, got "
                f"{len(parts)}")
        out.append((parts[0].decode(), int(parts[1]), int(parts[2]),
                    parts[3].decode(), int(parts[4]),
                    parts[5].decode()))
    return out


def depth_segments(tuples, chrom_lengths: dict[str, int]):
    """Mapped tuples → the depth kernel's inputs, one chromosome at a
    time in the bed's order (known chromosomes by name, then the rest):
    (chrom, length, seg_start, seg_end, keep), the segments in read
    order on the int32 wire, padded to ``bucket_size`` with masked
    zeros. A chromosome that is not in ``chrom_lengths`` ends at its
    last segment."""
    from ..ops.coverage import bucket_size

    by_chrom: dict[str, list[tuple[int, int]]] = {}
    for t in tuples:
        if t is None:
            continue
        chrom, s, e = t[0], t[1], t[2]
        if e > s:
            by_chrom.setdefault(chrom, []).append((s, e))
    for chrom in sorted(by_chrom, key=lambda c: (c not in chrom_lengths, c)):
        clen = int(chrom_lengths.get(
            chrom, max(e for _, e in by_chrom[chrom])))
        segs = by_chrom[chrom]
        cap = bucket_size(len(segs))
        ss = np.zeros(cap, np.int32)
        se = np.zeros(cap, np.int32)
        ss[:len(segs)] = [s for s, _ in segs]
        se[:len(segs)] = [e for _, e in segs]
        yield chrom, clen, ss, se, np.arange(cap) < len(segs)


def depth_bed_from_tuples(tuples, chrom_lengths: dict[str, int],
                          window: int, device=None) -> bytes:
    """Mapped tuples → windowed mean-depth bed on ``device`` (the card
    unless ``"cpu"``): per covered chromosome (:func:`depth_segments`)
    one launch of the depth kernel (ops/depth_kernel.py, the int32 wire,
    which takes endpoints in any order) for its int32 per-base depth
    (dense, window 1, no cap), summed into absolute-aligned windows in
    int64 and formatted like the reference's rows, so the fused
    ``map --depth-out`` path and a ``--from-tuples`` re-run are
    byte-identical by construction. The kernel's own float32 window sums
    are not used: exact sums need int64 (ROADMAP Queue C, C1).
    """
    from ..ops import depth_kernel
    from ..ops.coverage import window_bounds

    dev = resolve_device(device)
    out: list[str] = []
    with TIMER.stage("depth"):
        for chrom, clen, ss, se, keep in depth_segments(tuples,
                                                        chrom_lengths):
            res = obs.dispatch(
                "depth", depth_kernel.fused_depth,
                torch.from_numpy(ss).to(dev), torch.from_numpy(se).to(dev),
                torch.from_numpy(keep).to(dev), 0, 0, clen, 0x7FFFFFFF, 0,
                0, length=clen, window=1, dense=True)
            depth = res[3].to(torch.int64)
            starts, ends, lpad, rpad = window_bounds(0, clen, window)
            padded = torch.cat([depth.new_zeros(lpad), depth,
                                depth.new_zeros(rpad)])
            sums = padded.reshape(-1, window).sum(dim=1).cpu().numpy()
            spans = (ends - starts).astype(np.int64)
            for s, e, total, span in zip(starts, ends, sums, spans):
                m = total / span if span else 0.0
                out.append(f"{chrom}\t{s}\t{e}\t{m:.4g}\n")
    return "".join(out).encode()
