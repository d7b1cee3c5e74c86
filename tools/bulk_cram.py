"""Vectorised CRAM 3.1 writer for large fabricated fixtures.

The per-record :class:`~goleft_tpu_torch.io.cram.CramWriter` encodes its
rANS-Nx16 blocks one symbol at a time in Python (several microseconds a
symbol), so a cohort of realistic size takes hours. This writer builds
every record of a single-reference, coordinate-sorted CRAM with numpy
and steps the rANS encoders of ALL blocks of ALL files together: one
numpy step advances every interleaved state of every stream at once
(lanes sorted by length, so the active lanes are always a prefix), and
the 16-bit renormalisation words are put in the decoder's order
afterwards.

The bytes equal what ``CramWriter(..., block_method=M_RANSNX16,
rans_order=order, rans_stripe=stripe, minor=1)`` writes for the same
records, and :func:`encode_many` equals ``rans_nx16.encode`` stream by
stream. Every read is ``read_len`` M with its quality string stored (no
sequence, detached mates); names are ``r%07d``. A companion ``.crai``
is written beside each file. Fixtures only: nothing of the package
imports this module.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from goleft_tpu_torch.io import cram as C
from goleft_tpu_torch.io import rans_nx16 as rx

_RANS_LOW = rx.RANS_LOW
_TF_SHIFT = rx.TF_SHIFT


def itf8_concat(v: np.ndarray) -> bytes:
    """``b"".join(write_itf8(x) for x in v)``, vectorised (CRAM ITF8)."""
    u = np.asarray(v, np.int64) & 0xFFFFFFFF
    n = np.select([u < 0x80, u < 0x4000, u < 0x200000, u < 0x10000000],
                  [1, 2, 3, 4], 5)
    out = np.zeros((len(u), 5), np.uint8)
    for k, (lead, shifts) in {1: (0x00, (0,)), 2: (0x80, (8, 0)),
                              3: (0xC0, (16, 8, 0)),
                              4: (0xE0, (24, 16, 8, 0))}.items():
        m = n == k
        for col, sh in enumerate(shifts):
            out[m, col] = (u[m] >> sh) & 0xFF
        out[m, 0] |= lead
    m = n == 5
    out[m, 0] = 0xF0 | ((u[m] >> 28) & 0x0F)
    for col, sh in enumerate((20, 12, 4), 1):
        out[m, col] = (u[m] >> sh) & 0xFF
    out[m, 4] = u[m] & 0x0F
    keep = np.arange(5)[None, :] < n[:, None]
    return out[keep].tobytes()


# ---- the rANS-Nx16 encoder, all streams in lockstep -------------------

class _Leaf:
    """One rANS (or CAT) stream of encode(): flags, body, and, for a
    coded stream, its lanes' symbol frequencies in lane-major order."""

    def __init__(self, body: bytes, order: int):
        self.body = body
        self.flags = order & 1
        self.states = self.words = self.renorm = None
        arr = np.frombuffer(body, np.uint8)
        if len(arr) < 16 or arr.min() == arr.max():
            self.flags |= rx.F_CAT
            return
        n, N = len(arr), 4
        if self.flags & rx.F_ORDER1:
            self.table, norm, cums, _ = rx._rans1_table(arr, N)
            F = n // N
            lens = [F] * (N - 1) + [n - F * (N - 1)]
            starts = np.arange(N) * F
            ctx = np.concatenate([[0], arr[:-1]]).astype(np.int64)
            ctx[starts] = 0  # each lane starts from context 0
            syms = arr.astype(np.int64)
            self.freq = norm[ctx, syms]
            self.cum = cums[ctx, syms]
            # decoder order: round-major over lanes, the last lane's tail
            self.order = np.concatenate([
                (np.arange(F)[:, None] + starts[None, :]).ravel(),
                np.arange(N * F, n)])
        else:
            self.table, norm, cum = rx._rans0_table(arr)
            lens = [(n - j + N - 1) // N for j in range(N)]
            lane_major = np.concatenate([arr[j::N] for j in range(N)])
            self.freq = norm[lane_major]
            self.cum = cum[lane_major]
            # symbol i sits in lane i % N at step i // N
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            i = np.arange(n)
            self.order = starts[i % N] + i // N
        self.lens = np.asarray(lens, np.int64)
        self.lane_starts = np.asarray(starts, np.int64)

    @property
    def cat(self) -> bool:
        return bool(self.flags & rx.F_CAT)

    def finish(self) -> bytes:
        """encode()'s output, once the lockstep loop has left the final
        states and this stream's words and renormalisation flags (in
        lane-major order) here."""
        payload = self.body
        if not self.cat:
            w = self.words[self.order][self.renorm[self.order]]
            payload = (self.table + self.states.astype("<u4").tobytes()
                       + w.astype("<u2").tobytes())
            if len(payload) >= len(self.body):
                payload = self.body
                self.flags = (self.flags & ~rx.F_ORDER1) | rx.F_CAT
        return bytes([self.flags]) + rx.write_uint7(len(self.body)) \
            + payload


def _run_lockstep(leaves: list[_Leaf]) -> None:
    """Step every lane of every coded stream backwards through its
    symbols, as rans_nx16's scalar encoders do one lane at a time; the
    results land in each leaf's ``states``, ``words`` and ``renorm``."""
    coded = [lf for lf in leaves if not lf.cat]
    if not coded:
        return
    sizes = [len(lf.freq) for lf in coded]
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    freq = np.concatenate([lf.freq for lf in coded]).astype(np.int64)
    cum = np.concatenate([lf.cum for lf in coded]).astype(np.int64)
    start = np.concatenate([b + lf.lane_starts
                            for b, lf in zip(base, coded)])
    lens = np.concatenate([lf.lens for lf in coded])
    by_len = np.argsort(-lens, kind="stable")
    start_s, lens_s = start[by_len], lens[by_len]
    x = np.full(len(lens), _RANS_LOW, np.int64)
    words = np.zeros(len(freq), np.uint16)
    renorm = np.zeros(len(freq), bool)
    x_max = (_RANS_LOW >> _TF_SHIFT) << 16
    k = 0
    for t in range(int(lens_s[0]) - 1, -1, -1):
        while k < len(lens_s) and lens_s[k] > t:
            k += 1
        idx = start_s[:k] + t
        f = freq[idx]
        xs = x[:k]
        flush = xs >= x_max * f
        words[idx] = xs & 0xFFFF
        renorm[idx] = flush
        xs = np.where(flush, xs >> 16, xs)
        q, r = np.divmod(xs, f)
        x[:k] = (q << _TF_SHIFT) + r + cum[idx]
    final = np.empty_like(x)
    final[by_len] = x
    lane = 0
    for b, sz, lf in zip(base, sizes, coded):
        n_lanes = len(lf.lens)
        lf.states = final[lane:lane + n_lanes]
        lane += n_lanes
        lf.words = words[b:b + sz]
        lf.renorm = renorm[b:b + sz]


def encode_many(items: list[tuple[bytes, int, int]]) -> list[bytes]:
    """``[rans_nx16.encode(d, order=o, stripe=k) for d, o, k in items]``
    with every stream's rANS loop stepped together."""
    plans = []  # per item: (leaf indices, stripe lanes or 0, length)
    leaves: list[_Leaf] = []
    for data, order, stripe in items:
        subs = [data[j::stripe] for j in range(stripe)] if stripe \
            else [data]
        plans.append((list(range(len(leaves), len(leaves) + len(subs))),
                      stripe, len(data)))
        leaves += [_Leaf(s, order) for s in subs]
    _run_lockstep(leaves)
    enc = [lf.finish() for lf in leaves]
    out = []
    for idxs, stripe, n in plans:
        if not stripe:
            out.append(enc[idxs[0]])
            continue
        head = bytearray([rx.F_STRIPE]) + rx.write_uint7(n)
        head.append(stripe)
        for i in idxs:
            head += rx.write_uint7(len(enc[i]))
        out.append(bytes(head) + b"".join(enc[i] for i in idxs))
    return out


# ---- containers --------------------------------------------------------

def _comp_header_block() -> bytes:
    """The compression header CramWriter writes for these records: every
    series EXTERNAL in its own block, names stop-byte (tab) arrays."""
    comp = C.CompressionHeader(rn_included=True, ap_delta=True,
                               ref_required=False, tag_dict=[[]])
    for key, cid in C._W_IDS.items():
        if key == "RN":
            comp.encodings[key] = C.Encoding(C.E_BYTE_ARRAY_STOP,
                                             {"stop": 0x09, "id": cid})
        elif key in ("SC", "IN"):
            comp.encodings[key] = C.Encoding(C.E_BYTE_ARRAY_STOP,
                                             {"stop": 0x00, "id": cid})
        else:
            comp.encodings[key] = C.Encoding(C.E_EXTERNAL, {"id": cid})
    return C.write_block(C.M_RAW, C.CT_COMP_HEADER, 0, comp.serialize())


def _series(pos1, mapq, flag, quals, read_len, first):
    """External block payloads of one container, in block-id order."""
    n = len(pos1)
    ap = np.diff(np.concatenate([[pos1[0]], pos1]))
    names = b"".join(b"r%07d\t" % (first + i) for i in range(n))
    mf = np.where(flag & C.BAM_MREVERSE, C.MF_MATE_REVERSE, 0) \
        | np.where(flag & C.BAM_MUNMAP, C.MF_MATE_UNMAPPED, 0)
    ints = {
        "BF": flag & ~(C.BAM_MREVERSE | C.BAM_MUNMAP),
        "CF": np.full(n, C.CF_DETACHED | C.CF_NO_SEQ | C.CF_QS_STORED),
        "RL": np.full(n, read_len), "AP": ap, "RG": np.full(n, -1),
        "MF": mf, "NS": np.full(n, -1), "NP": np.zeros(n),
        "TS": np.zeros(n), "TL": np.zeros(n), "FN": np.zeros(n),
        "MQ": mapq,
    }
    out = {}
    for key, cid in C._W_IDS.items():
        if key in ints:
            out[cid] = itf8_concat(ints[key])
        elif key == "RN":
            out[cid] = names
        elif key == "QS":
            out[cid] = quals.tobytes()
    return out


def write_cram_files(files: list[dict], records_per_container: int =
                     10_000, read_len: int = 150) -> None:
    """Write each file of ``files`` and its ``.crai``. A file is a dict:
    ``path``, ``contig``, ``contig_len``, ``sample``, ``pos`` (sorted
    0-based int64), ``mapq``, ``flag`` (no unmapped reads), ``quals``
    ((n, read_len) uint8), ``order`` (0/1) and ``stripe`` (0 or lanes),
    the rANS-Nx16 settings of CramWriter."""
    comp_block = _comp_header_block()
    pending = []  # (file index, container pieces)
    items = []
    for fi, f in enumerate(files):
        pos1 = np.asarray(f["pos"], np.int64) + 1
        flag = np.asarray(f["flag"], np.int64)
        if (flag & 0x4).any():
            raise ValueError("bulk_cram writes mapped reads only")
        mapq = np.asarray(f["mapq"], np.int64)
        for a in range(0, len(pos1), records_per_container):
            b = min(a + records_per_container, len(pos1))
            payloads = _series(pos1[a:b], mapq[a:b], flag[a:b],
                               f["quals"][a:b], read_len, a)
            used = [cid for cid, p in payloads.items() if p]
            for cid in used:
                d = payloads[cid]
                items.append((d, f["order"] if len(d) >= 16 else 0,
                              f["stripe"] if len(d) >= 16 * max(
                                  f["stripe"], 1) else 0))
            pending.append((fi, a, b, pos1, used, payloads))
    enc = iter(encode_many(items))
    out = [bytearray() for _ in files]
    offsets = [[] for _ in files]
    for f, o in zip(files, out):
        sq = f"@SQ\tSN:{f['contig']}\tLN:{f['contig_len']}\n"
        text = (f"@HD\tVN:1.6\tSO:coordinate\n@RG\tID:r\tSM:{f['sample']}"
                f"\n{sq}").encode()
        block = C.write_block(C.M_RAW, C.CT_FILE_HEADER, 0,
                              struct.pack("<i", len(text)) + text)
        o += C.CRAM_MAGIC + bytes([3, 1]) \
            + b"goleft-tpu-cram\x00\x00\x00\x00\x00"
        o += C.ContainerHeader.build(len(block), 0, 0, 0, 0, 0, 0, 1, [0])
        o += block
    for fi, a, b, pos1, used, payloads in pending:
        first, n = int(pos1[a]), b - a
        span = int(pos1[a:b].max()) + read_len - first
        sl = C.SliceHeader(0, first, span, n, a, 1 + len(used), list(used),
                           -1, b"\x00" * 16)
        blocks = C.write_block(C.M_RAW, C.CT_SLICE_HEADER, 0, sl.serialize())
        blocks += C.write_block(C.M_RAW, C.CT_CORE, 0, b"")
        for cid in used:
            blocks += C._write_block_pre(C.M_RANSNX16, C.CT_EXTERNAL, cid,
                                         next(enc), len(payloads[cid]))
        body = comp_block + blocks
        o = out[fi]
        offsets[fi].append((0, first, span, len(o), len(comp_block)))
        o += C.ContainerHeader.build(len(body), 0, first, span, n, a,
                                     n * read_len, 2 + len(used),
                                     [len(comp_block)])
        o += body
    for f, o, offs in zip(files, out, offsets):
        with open(f["path"], "wb") as fh:
            fh.write(bytes(o) + C.EOF_CONTAINER)
        with gzip.open(f["path"] + ".crai", "wt") as fh:
            for seq, start, span, c_off, s_off in offs:
                fh.write(f"{seq}\t{start}\t{span}\t{c_off}\t{s_off}\t0\n")
