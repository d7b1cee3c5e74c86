"""fqzcomp quality codec (CRAM 3.1 block method 7), clean-room.

A copy of the JAX package's io/fqzcomp.py, with its C fast path.

CRAM 3.1's dedicated quality-score codec: the concatenated per-record
quality strings of a slice, compressed with the adaptive range coder
(io/arith.py) driven by a 16-bit mixing context of recent quality
history, in-record position, running delta count, and an optional
per-record selector. Implemented from the CRAM 3.1 codecs
specification's structure (the reference accepts 3.1 through htslib —
covstats.go:229 smoove NewReader); like the Nx16/arith codecs it is
not cross-validated against htslib, so the layout below is pinned by
documentation + an in-repo encoder twin with fuzzing (docs/cram.md).

Layout:

- byte 0: version (5)
- byte 1: gflags — MULTI_PARAM=0x01 (a parameter-set count byte
  follows), HAVE_STAB=0x02 (a max-selector byte + 256-entry selector→
  parameter-set table follow), DO_REV=0x04 (records may carry a
  reversal flag, applied after decode)
- per parameter set:
  - u16-le base context seed
  - pflags — DO_DEDUP=0x02, DO_LEN=0x04 (0 ⇒ all records share the
    first record's length), DO_SEL=0x08, HAVE_QMAP=0x10,
    HAVE_PTAB=0x20, HAVE_DTAB=0x40, HAVE_QTAB=0x80
  - max_sym byte (number of distinct quality symbols)
  - packed nibbles: qbits|qshift, pbits|pshift, dbits|dshift,
    qloc|sloc, ploc|dloc
  - HAVE_QMAP ⇒ max_sym bytes mapping model symbol → quality value
  - HAVE_QTAB ⇒ 256-entry context table, HAVE_PTAB ⇒ 1024-entry,
    HAVE_DTAB ⇒ 256-entry; each stored as (value uint7, run uint7)
    pairs until filled; absent tables default to shift-then-clamp
    (v >> shift, capped at 2^bits - 1)
- the coded stream: per record — selector (when MULTI_PARAM/STAB),
  4 length bytes through 4 dedicated models (when DO_LEN or first
  record), reversal bit (DO_REV), dedup bit (DO_DEDUP; 1 copies the
  previous record), then one quality symbol per base from the model
  at the mixed context:
    ctx = seed + (qhist & (2^qbits-1)) << qloc
              + ptab[min(remaining,1023)] << ploc
              + dtab[min(delta,255)] << dloc
              + sel << sloc            (all mod 2^16)
    qhist = (qhist << qshift) + qtab[q]; delta += (prev != q)
"""

from __future__ import annotations

from .arith import AdaptiveModel, RangeDecoder, RangeEncoder
from .rans_nx16 import read_uint7, write_uint7

VERSION = 5

G_MULTI_PARAM = 0x01
G_HAVE_STAB = 0x02
G_DO_REV = 0x04

P_DO_DEDUP = 0x02
P_DO_LEN = 0x04
P_DO_SEL = 0x08
P_HAVE_QMAP = 0x10
P_HAVE_PTAB = 0x20
P_HAVE_DTAB = 0x40
P_HAVE_QTAB = 0x80


# ------------------------------------------------------- table arrays


def _read_table(buf, pos: int, size: int) -> tuple[list[int], int]:
    """(value uint7, run uint7) pairs until ``size`` entries."""
    out: list[int] = []
    while len(out) < size:
        v, pos = read_uint7(buf, pos)
        r, pos = read_uint7(buf, pos)
        if r == 0 or len(out) + r > size:
            raise ValueError("fqzcomp: corrupt table run")
        out.extend([v] * r)
    return out, pos


def _write_table(vals) -> bytes:
    out = bytearray()
    i = 0
    n = len(vals)
    while i < n:
        j = i
        while j < n and vals[j] == vals[i]:
            j += 1
        out += write_uint7(int(vals[i]))
        out += write_uint7(j - i)
        i = j
    return bytes(out)


def _default_table(size: int, bits: int, shift: int) -> list[int]:
    cap = (1 << bits) - 1
    return [min(v >> shift, cap) for v in range(size)]


# ---------------------------------------------------------- parameters


class _Params:
    __slots__ = ("seed", "pflags", "max_sym", "qbits", "qshift",
                 "pbits", "pshift", "dbits", "dshift", "qloc", "sloc",
                 "ploc", "dloc", "qmap", "qtab", "ptab", "dtab")

    @classmethod
    def parse(cls, buf, pos: int) -> tuple["_Params", int]:
        p = cls()
        p.seed = buf[pos] | (buf[pos + 1] << 8)
        p.pflags = buf[pos + 2]
        p.max_sym = buf[pos + 3]
        nib = buf[pos + 4:pos + 9]
        pos += 9
        p.qbits, p.qshift = nib[0] >> 4, nib[0] & 15
        p.pbits, p.pshift = nib[1] >> 4, nib[1] & 15
        p.dbits, p.dshift = nib[2] >> 4, nib[2] & 15
        p.qloc, p.sloc = nib[3] >> 4, nib[3] & 15
        p.ploc, p.dloc = nib[4] >> 4, nib[4] & 15
        if p.pflags & P_HAVE_QMAP:
            p.qmap = list(buf[pos:pos + p.max_sym])
            if len(p.qmap) != p.max_sym:
                raise ValueError("fqzcomp: truncated qmap")
            pos += p.max_sym
        else:
            p.qmap = None
        if p.qbits and p.pflags & P_HAVE_QTAB:
            p.qtab, pos = _read_table(buf, pos, 256)
        else:
            p.qtab = _default_table(256, max(p.qbits, 1), p.qshift)
        if p.pbits and p.pflags & P_HAVE_PTAB:
            p.ptab, pos = _read_table(buf, pos, 1024)
        else:
            p.ptab = _default_table(1024, max(p.pbits, 1), p.pshift)
        if p.dbits and p.pflags & P_HAVE_DTAB:
            p.dtab, pos = _read_table(buf, pos, 256)
        else:
            p.dtab = _default_table(256, max(p.dbits, 1), p.dshift)
        return p, pos

    def serialize(self) -> bytes:
        out = bytearray()
        out += bytes([self.seed & 0xFF, self.seed >> 8, self.pflags,
                      self.max_sym])
        out.append((self.qbits << 4) | self.qshift)
        out.append((self.pbits << 4) | self.pshift)
        out.append((self.dbits << 4) | self.dshift)
        out.append((self.qloc << 4) | self.sloc)
        out.append((self.ploc << 4) | self.dloc)
        if self.pflags & P_HAVE_QMAP:
            out += bytes(self.qmap)
        if self.qbits and self.pflags & P_HAVE_QTAB:
            out += _write_table(self.qtab)
        if self.pbits and self.pflags & P_HAVE_PTAB:
            out += _write_table(self.ptab)
        if self.dbits and self.pflags & P_HAVE_DTAB:
            out += _write_table(self.dtab)
        return bytes(out)


class _Models:
    """Model bank shared (structurally) by both coder directions."""

    def __init__(self, nsym: int, max_sel: int) -> None:
        self.qual: dict[int, AdaptiveModel] = {}
        self.nsym = nsym
        self.sel = AdaptiveModel(max_sel + 1) if max_sel else None
        self.len = [AdaptiveModel(256) for _ in range(4)]
        self.rev = AdaptiveModel(2)
        self.dup = AdaptiveModel(2)

    def qmodel(self, ctx: int) -> AdaptiveModel:
        m = self.qual.get(ctx)
        if m is None:
            m = self.qual[ctx] = AdaptiveModel(self.nsym)
        return m


def _mix_context(p: _Params, qhist: int, remaining: int, delta: int,
                 sel: int) -> int:
    ctx = p.seed
    if p.qbits:
        ctx += (qhist & ((1 << p.qbits) - 1)) << p.qloc
    if p.pbits:
        ctx += p.ptab[min(remaining, 1023)] << p.ploc
    if p.dbits:
        ctx += p.dtab[min(delta, 255)] << p.dloc
    if p.pflags & P_DO_SEL:
        ctx += sel << p.sloc
    return ctx & 0xFFFF


# ----------------------------------------------------------- top level


def decode(data: bytes, expected_len: int) -> bytes:
    """Decode one fqzcomp stream into ``expected_len`` quality bytes
    (the CRAM block header's raw size is authoritative)."""
    if expected_len is not None:
        from . import native

        fast = native.fqzcomp_decode(data, expected_len)
        if fast is not None:
            return fast
    try:
        return _decode(data, expected_len)
    except IndexError:
        raise ValueError("fqzcomp: truncated stream") from None


def _decode(data: bytes, expected_len: int) -> bytes:
    if expected_len is None:
        raise ValueError("fqzcomp: needs the declared block size")
    buf = memoryview(data)
    if len(buf) < 2:
        raise ValueError("fqzcomp: truncated stream")
    if buf[0] != VERSION:
        raise ValueError(f"fqzcomp: unsupported version {buf[0]}")
    gflags = buf[1]
    pos = 2
    if gflags & G_MULTI_PARAM:
        nparam = buf[pos]
        pos += 1
    else:
        nparam = 1
    if nparam == 0:
        raise ValueError("fqzcomp: zero parameter sets")
    max_sel = nparam - 1
    if gflags & G_HAVE_STAB:
        max_sel = buf[pos]
        pos += 1
        stab, pos = _read_table(buf, pos, 256)
    else:
        stab = list(range(nparam)) + [nparam - 1] * (256 - nparam)
    params = []
    for _ in range(nparam):
        p, pos = _Params.parse(buf, pos)
        params.append(p)
    nsym = max(p.max_sym for p in params) + 1
    models = _Models(nsym, max_sel)
    rc = RangeDecoder(buf, pos)

    out = bytearray(expected_len)
    rev_flags: list[tuple[int, int]] = []  # (start, length) to reverse
    i = 0
    sel = 0
    p = params[0]
    rec_len = 0
    last_len = 0
    qhist = 0
    prevq = 0
    delta = 0
    remaining = 0
    while i < expected_len:
        if remaining == 0:
            if models.sel is not None:
                sel = models.sel.decode(rc)
                if sel > 255 or stab[sel] >= nparam:
                    raise ValueError("fqzcomp: selector out of range")
                p = params[stab[sel]]
            if (p.pflags & P_DO_LEN) or last_len == 0:
                rec_len = (models.len[0].decode(rc)
                           | (models.len[1].decode(rc) << 8)
                           | (models.len[2].decode(rc) << 16)
                           | (models.len[3].decode(rc) << 24))
                last_len = rec_len
            else:
                rec_len = last_len
            if rec_len == 0 or i + rec_len > expected_len:
                raise ValueError("fqzcomp: record overflows block")
            if gflags & G_DO_REV and models.rev.decode(rc):
                rev_flags.append((i, rec_len))
            if p.pflags & P_DO_DEDUP and models.dup.decode(rc):
                if i < rec_len:
                    raise ValueError("fqzcomp: dedup with no previous")
                out[i:i + rec_len] = out[i - rec_len:i]
                i += rec_len
                continue
            remaining = rec_len
            qhist = 0
            prevq = 0
            delta = 0
        ctx = _mix_context(p, qhist, remaining, delta, sel)
        q = models.qmodel(ctx).decode(rc)
        out[i] = p.qmap[q] if p.qmap is not None else q
        qhist = ((qhist << p.qshift) + p.qtab[q]) & 0xFFFFFFFF
        if p.dbits:
            delta += prevq != q
        prevq = q
        remaining -= 1
        i += 1
    for start, ln in rev_flags:
        out[start:start + ln] = out[start:start + ln][::-1]
    return bytes(out)


def default_params(max_sym: int) -> _Params:
    p = _Params()
    p.seed = 0
    p.pflags = P_DO_LEN | P_HAVE_QTAB
    p.max_sym = max_sym
    p.qbits, p.qshift = 9, 3
    p.pbits, p.pshift = 7, 0
    p.dbits, p.dshift = 0, 0
    p.qloc, p.sloc = 7, 0
    p.ploc, p.dloc = 0, 0
    p.qmap = None
    p.qtab = _default_table(256, p.qbits, p.qshift)
    p.ptab = _default_table(1024, p.pbits, p.pshift)
    p.dtab = _default_table(256, 1, 0)
    return p


def encode(lengths: list[int], quals: bytes,
           params: _Params | None = None, do_rev: bool = False,
           rev: list[bool] | None = None,
           param_sets: list[_Params] | None = None,
           selectors: list[int] | None = None) -> bytes:
    """Encode per-record quality strings (fixture writer + fuzz twin).

    ``lengths`` gives each record's quality-string length; their sum
    must equal ``len(quals)``. Passing ``param_sets`` (with a
    per-record ``selectors`` list) emits a MULTI_PARAM + HAVE_STAB
    stream with an identity selector table, exercising the decoder's
    selector machinery.
    """
    if param_sets is not None:
        return _encode_multi(lengths, quals, param_sets, selectors,
                             do_rev, rev)
    if sum(lengths) != len(quals):
        raise ValueError("fqzcomp: lengths do not sum to the payload")
    if any(ln <= 0 for ln in lengths):
        # the decoder treats a zero-length record as corruption (it
        # would otherwise never advance); refuse to encode one
        raise ValueError("fqzcomp: record lengths must be positive")
    max_sym = max(quals) if quals else 0
    p = params or default_params(max_sym)
    if p.qmap is None and max_sym > p.max_sym:
        raise ValueError("fqzcomp: symbol exceeds max_sym")
    gflags = G_DO_REV if do_rev else 0
    head = bytearray([VERSION, gflags])
    head += p.serialize()
    models = _Models(p.max_sym + 1, 0)
    rc = RangeEncoder()
    inv = None
    if p.qmap is not None:
        inv = {v: s for s, v in enumerate(p.qmap)}
    off = 0
    prev_rec = None
    for r, ln in enumerate(lengths):
        rec = quals[off:off + ln]
        off += ln
        rflag = bool(rev[r]) if (do_rev and rev) else False
        if rflag:
            rec = rec[::-1]
        if (p.pflags & P_DO_LEN) or r == 0:
            models.len[0].encode(rc, ln & 0xFF)
            models.len[1].encode(rc, (ln >> 8) & 0xFF)
            models.len[2].encode(rc, (ln >> 16) & 0xFF)
            models.len[3].encode(rc, (ln >> 24) & 0xFF)
        if do_rev:
            models.rev.encode(rc, 1 if rflag else 0)
        if p.pflags & P_DO_DEDUP:
            is_dup = rec == prev_rec
            models.dup.encode(rc, 1 if is_dup else 0)
            prev_rec = rec
            if is_dup:
                continue
        qhist = 0
        prevq = 0
        delta = 0
        remaining = ln
        for b in rec:
            q = inv[b] if inv is not None else b
            ctx = _mix_context(p, qhist, remaining, delta, 0)
            models.qmodel(ctx).encode(rc, q)
            qhist = ((qhist << p.qshift) + p.qtab[q]) & 0xFFFFFFFF
            if p.dbits:
                delta += prevq != q
            prevq = q
            remaining -= 1
    return bytes(head) + rc.finish()


def _encode_multi(lengths: list[int], quals: bytes,
                  param_sets: list["_Params"],
                  selectors: list[int] | None,
                  do_rev: bool, rev: list[bool] | None) -> bytes:
    """Multi-parameter twin: MULTI_PARAM + HAVE_STAB with an identity
    selector table, per-record selector through the selector model,
    the decoder's global last_len rule, and the selector term in the
    context mix when a set carries DO_SEL."""
    if sum(lengths) != len(quals):
        raise ValueError("fqzcomp: lengths do not sum to the payload")
    if any(ln <= 0 for ln in lengths):
        raise ValueError("fqzcomp: record lengths must be positive")
    nparam = len(param_sets)
    if not 1 <= nparam <= 255:
        raise ValueError("fqzcomp: 1..255 parameter sets")
    if selectors is None or len(selectors) != len(lengths):
        raise ValueError("fqzcomp: need one selector per record")
    if any(not 0 <= s < nparam for s in selectors):
        raise ValueError("fqzcomp: selector out of range")
    max_sel = nparam - 1
    stab = list(range(nparam)) + [nparam - 1] * (256 - nparam)
    gflags = G_MULTI_PARAM | G_HAVE_STAB | (G_DO_REV if do_rev else 0)
    head = bytearray([VERSION, gflags, nparam, max_sel])
    head += _write_table(stab)
    for p in param_sets:
        head += p.serialize()
    nsym = max(p.max_sym for p in param_sets) + 1
    models = _Models(nsym, max_sel)
    rc = RangeEncoder()
    invs = [({v: s for s, v in enumerate(p.qmap)}
             if p.qmap is not None else None) for p in param_sets]
    off = 0
    last_len = 0
    prev_rec = None
    for r, ln in enumerate(lengths):
        rec = quals[off:off + ln]
        off += ln
        sel = selectors[r]
        models.sel.encode(rc, sel)
        p = param_sets[stab[sel]]
        rflag = bool(rev[r]) if (do_rev and rev) else False
        if rflag:
            rec = rec[::-1]
        if (p.pflags & P_DO_LEN) or last_len == 0:
            models.len[0].encode(rc, ln & 0xFF)
            models.len[1].encode(rc, (ln >> 8) & 0xFF)
            models.len[2].encode(rc, (ln >> 16) & 0xFF)
            models.len[3].encode(rc, (ln >> 24) & 0xFF)
            last_len = ln
        elif ln != last_len:
            raise ValueError("fqzcomp: fixed-length set needs equal "
                             "record lengths")
        if do_rev:
            models.rev.encode(rc, 1 if rflag else 0)
        if p.pflags & P_DO_DEDUP:
            is_dup = rec == prev_rec
            models.dup.encode(rc, 1 if is_dup else 0)
            prev_rec = rec
            if is_dup:
                continue
        inv = invs[stab[sel]]
        qhist = 0
        prevq = 0
        delta = 0
        remaining = ln
        for b in rec:
            q = inv[b] if inv is not None else b
            ctx = _mix_context(p, qhist, remaining, delta, sel)
            models.qmodel(ctx).encode(rc, q)
            qhist = ((qhist << p.qshift) + p.qtab[q]) & 0xFFFFFFFF
            if p.dbits:
                delta += prevq != q
            prevq = q
            remaining -= 1
    return bytes(head) + rc.finish()
