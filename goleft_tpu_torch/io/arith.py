"""Adaptive arithmetic codec (CRAM 3.1 block method 6), clean-room.

A copy of the JAX package's io/arith.py on its Python path.

CRAM 3.1's general-purpose range coder: an adaptive byte-wise
arithmetic coder with the same meta-transform family as rANS-Nx16.
Implemented from the CRAM 3.1 codecs specification (the reference
accepts 3.1 through htslib — covstats.go:229 smoove NewReader; this
module is the repo's own clean-room implementation, validated by an
in-repo encoder/decoder pair + fuzzing like the Nx16 codec in
io/rans_nx16.py — it is not cross-validated against htslib, so the
layout below is pinned by documentation and twins; see docs/cram.md).

Layout:

- flags byte: ORDER=0x01, EXT=0x04 (payload is bzip2, no modelling),
  STRIPE=0x08, NOSZ=0x10 (no stored size), CAT=0x20 (stored raw),
  RLE=0x40 (run lengths coded through dedicated run models),
  PACK=0x80
- sizes are uint7 varints (shared with rans_nx16)
- the coded stream proper starts with one byte holding the alphabet
  size (max symbol + 1; 0 encodes 256), sizing every adaptive model
- range coder: 32-bit range, carry-counting encoder (64-bit low,
  cache + FF-run), 5-byte decoder preload whose first byte is the
  cache priming byte; renormalizes a byte at a time while
  range < 2^24
- adaptive model: per-symbol frequencies starting at 1, +16 per
  update, halved (rounding up) when the total would reach 2^16-16,
  with the classic adjacent-swap keeping hot symbols near the front
  — encoder and decoder mutate identically, so state never needs to
  be transmitted
- order-1 keys a separate model on the previous output byte
  (initially 0)
- RLE: each literal is coded once through the byte model, then its
  repeat count through run models: first part keyed by the literal,
  continuation parts (a part of 255 means "more follows") by a
  shared continuation context
- PACK / STRIPE / CAT / NOSZ: identical framing to rans_nx16

Decode order for combined transforms: range-decode (with integrated
RLE) innermost, then PACK expansion — the exact inverse of the
encoder's PACK → model+RLE."""

from __future__ import annotations

from .rans_nx16 import (
    F_CAT,
    F_NOSZ,
    F_ORDER1,
    F_PACK,
    F_RLE,
    F_STRIPE,
    _pack,
    _unpack,
    read_uint7,
    write_uint7,
)

F_EXT = 0x04

STEP = 16
MAX_TOTAL = (1 << 16) - STEP
TOP = 1 << 24
MASK32 = 0xFFFFFFFF

# continuation context for run-length parts beyond the first
RUN_MORE = 256


# -------------------------------------------------------- range coder


class RangeEncoder:
    """Carry-counting range encoder (32-bit range, byte renorm)."""

    __slots__ = ("low", "range", "cache", "ffnum", "out")

    def __init__(self) -> None:
        self.low = 0
        self.range = MASK32
        self.cache = 0
        self.ffnum = 0
        self.out = bytearray()

    def _shift_low(self) -> None:
        low = self.low
        if low < 0xFF000000 or low > MASK32:
            carry = low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            fill = (0xFF + carry) & 0xFF
            while self.ffnum:
                self.out.append(fill)
                self.ffnum -= 1
            self.cache = (low >> 24) & 0xFF
        else:
            self.ffnum += 1
        self.low = (low << 8) & MASK32

    def encode(self, cum: int, freq: int, total: int) -> None:
        r = self.range // total
        self.low += cum * r
        self.range = r * freq
        while self.range < TOP:
            self.range <<= 8
            self._shift_low()

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class RangeDecoder:
    __slots__ = ("buf", "pos", "code", "range")

    def __init__(self, buf, pos: int = 0) -> None:
        self.buf = buf
        self.pos = pos
        self.code = 0
        self.range = MASK32
        n = len(buf)
        for _ in range(5):
            b = buf[self.pos] if self.pos < n else 0
            self.pos += 1
            self.code = ((self.code << 8) | b) & MASK32

    def get_freq(self, total: int) -> int:
        self.range //= total
        return self.code // self.range

    def decode(self, cum: int, freq: int) -> None:
        self.code -= cum * self.range
        self.range *= freq
        buf, n = self.buf, len(self.buf)
        while self.range < TOP:
            b = buf[self.pos] if self.pos < n else 0
            self.pos += 1
            self.code = ((self.code << 8) | b) & MASK32
            self.range <<= 8


# ----------------------------------------------------- adaptive model


class AdaptiveModel:
    """Symbol-frequency model updated identically by both sides."""

    __slots__ = ("syms", "freqs", "total")

    def __init__(self, nsym: int) -> None:
        self.syms = list(range(nsym))
        self.freqs = [1] * nsym
        self.total = nsym

    def _bump(self, i: int) -> None:
        freqs = self.freqs
        freqs[i] += STEP
        self.total += STEP
        if self.total > MAX_TOTAL:
            total = 0
            for j, f in enumerate(freqs):
                f -= f >> 1
                freqs[j] = f
                total += f
            self.total = total
        if i and freqs[i] > freqs[i - 1]:
            freqs[i], freqs[i - 1] = freqs[i - 1], freqs[i]
            syms = self.syms
            syms[i], syms[i - 1] = syms[i - 1], syms[i]

    def encode(self, rc: RangeEncoder, sym: int) -> None:
        syms = self.syms
        freqs = self.freqs
        acc = 0
        i = 0
        while syms[i] != sym:
            acc += freqs[i]
            i += 1
        rc.encode(acc, freqs[i], self.total)
        self._bump(i)

    def decode(self, rc: RangeDecoder) -> int:
        f = rc.get_freq(self.total)
        if f >= self.total:
            raise ValueError("arith: corrupt stream (freq out of range)")
        freqs = self.freqs
        acc = 0
        i = 0
        while acc + freqs[i] <= f:
            acc += freqs[i]
            i += 1
        rc.decode(acc, freqs[i])
        sym = self.syms[i]
        self._bump(i)
        return sym


# ------------------------------------------------------- coded bodies


def _model_nsym(header_byte: int) -> int:
    return header_byte if header_byte else 256


def _decode_body(buf, pos: int, out_len: int, order: int,
                 rle: bool) -> bytes:
    nsym = _model_nsym(buf[pos])
    pos += 1
    rc = RangeDecoder(buf, pos)
    out = bytearray(out_len)
    if order:
        models: dict[int, AdaptiveModel] = {}

        def byte_model(ctx: int) -> AdaptiveModel:
            m = models.get(ctx)
            if m is None:
                m = models[ctx] = AdaptiveModel(nsym)
            return m
    else:
        m0 = AdaptiveModel(nsym)

        def byte_model(ctx: int) -> AdaptiveModel:
            return m0

    if not rle:
        prev = 0
        for i in range(out_len):
            s = byte_model(prev).decode(rc)
            out[i] = s
            prev = s
        return bytes(out)

    run_models: dict[int, AdaptiveModel] = {}

    def run_model(ctx: int) -> AdaptiveModel:
        m = run_models.get(ctx)
        if m is None:
            m = run_models[ctx] = AdaptiveModel(256)
        return m

    i = 0
    prev = 0
    while i < out_len:
        s = byte_model(prev).decode(rc)
        prev = s
        run = 0
        ctx = s
        while True:
            part = run_model(ctx).decode(rc)
            run += part
            if part != 255:
                break
            if run > out_len:
                # a truncated stream zero-pads the range coder, which
                # can loop on the continuation symbol forever — bound
                # the run INSIDE the loop, not just after it
                raise ValueError("arith: run overflows declared size")
            ctx = RUN_MORE
        if i + run + 1 > out_len:
            raise ValueError("arith: run overflows declared size")
        for j in range(i, i + run + 1):
            out[j] = s
        i += run + 1
    return bytes(out)


def _encode_body(data: bytes, order: int, rle: bool) -> bytes:
    max_sym = max(data) if data else 0
    nsym = max_sym + 1
    rc = RangeEncoder()
    if order:
        models: dict[int, AdaptiveModel] = {}

        def byte_model(ctx: int) -> AdaptiveModel:
            m = models.get(ctx)
            if m is None:
                m = models[ctx] = AdaptiveModel(nsym)
            return m
    else:
        m0 = AdaptiveModel(nsym)

        def byte_model(ctx: int) -> AdaptiveModel:
            return m0

    if not rle:
        prev = 0
        for s in data:
            byte_model(prev).encode(rc, s)
            prev = s
    else:
        run_models: dict[int, AdaptiveModel] = {}

        def run_model(ctx: int) -> AdaptiveModel:
            m = run_models.get(ctx)
            if m is None:
                m = run_models[ctx] = AdaptiveModel(256)
            return m

        i = 0
        n = len(data)
        prev = 0
        while i < n:
            s = data[i]
            j = i + 1
            while j < n and data[j] == s:
                j += 1
            byte_model(prev).encode(rc, s)
            prev = s
            run = j - i - 1
            ctx = s
            while True:
                part = min(run, 255)
                run_model(ctx).encode(rc, part)
                run -= part
                if part != 255:
                    break
                ctx = RUN_MORE
            i = j
    return bytes([nsym & 0xFF]) + rc.finish()


# ----------------------------------------------------------- top level


def decode(data: bytes, expected_len: int | None = None) -> bytes:
    """Decode one adaptive-arithmetic stream (the full block payload)."""
    try:
        return _decode(data, expected_len, 0)
    except IndexError:
        # header/meta reads past the end of a truncated or corrupt
        # stream surface as the module's typed error, never a crash
        raise ValueError("arith: truncated stream") from None
    except OSError as e:  # bz2 EXT payload corruption
        raise ValueError(f"arith: corrupt EXT payload ({e})") from None


def _decode(data: bytes, expected_len: int | None,
            depth: int = 0) -> bytes:
    buf = memoryview(data)
    pos = 0
    flags = buf[pos]
    pos += 1
    if flags & F_NOSZ:
        if expected_len is None:
            raise ValueError("arith: NOSZ stream needs external size")
        out_len = expected_len
    else:
        out_len, pos = read_uint7(buf, pos)
        if expected_len is not None and out_len != expected_len:
            # checked BEFORE any allocation, same as rans_nx16: the
            # block header's raw size is authoritative
            raise ValueError(
                f"arith: stored size {out_len} != declared block "
                f"size {expected_len}"
            )
    if flags & F_STRIPE:
        if depth:
            # the spec's composition never nests STRIPE; a crafted
            # chain of stripe headers must not turn into unbounded
            # recursion
            raise ValueError("arith: nested STRIPE stream")
        n_lanes = buf[pos]
        pos += 1
        if n_lanes == 0 and out_len > 0:
            raise ValueError("arith: stripe stream with 0 lanes")
        clens = []
        for _ in range(n_lanes):
            c, pos = read_uint7(buf, pos)
            clens.append(c)
        lanes = []
        for j in range(n_lanes):
            lane_len = (out_len - j + n_lanes - 1) // n_lanes
            lanes.append(_decode(bytes(buf[pos:pos + clens[j]]),
                                 lane_len, depth + 1))
            pos += clens[j]
        out = bytearray(out_len)
        for j, lane in enumerate(lanes):
            out[j::n_lanes] = lane
        return bytes(out)

    pack_map = None
    final_len = out_len
    if flags & F_PACK:
        nsym = buf[pos]
        pos += 1
        pack_map = [buf[pos + k] for k in range(nsym)]
        pos += nsym
        out_len, pos = read_uint7(buf, pos)  # packed byte count

    if flags & F_CAT:
        payload = bytes(buf[pos:pos + out_len])
        if len(payload) != out_len:
            raise ValueError("arith: truncated CAT payload")
    elif flags & F_EXT:
        import bz2

        payload = bz2.decompress(bytes(buf[pos:]))
        if len(payload) != out_len:
            raise ValueError("arith: EXT payload length mismatch")
    elif out_len == 0:
        payload = b""
    else:
        payload = _decode_body(buf, pos, out_len, flags & F_ORDER1,
                               bool(flags & F_RLE))

    if pack_map is not None:
        payload = _unpack(payload, pack_map, final_len)
    if len(payload) != final_len:
        raise ValueError("arith: output length mismatch")
    return payload


def encode(data: bytes, order: int = 0, use_rle: bool = False,
           use_pack: bool = False, stripe: int = 0,
           ext: bool = False) -> bytes:
    """Encode (fixture writer + fuzz twin for the decoder). Transforms
    apply PACK → model(+RLE), the exact inverse of decode's expansion
    order; tiny or degenerate bodies store CAT."""
    if stripe:
        lanes = [data[j::stripe] for j in range(stripe)]
        subs = [encode(ln, order=order, use_rle=use_rle) for ln in lanes]
        out = bytearray([F_STRIPE])
        out += write_uint7(len(data))
        out.append(stripe)
        for s in subs:
            out += write_uint7(len(s))
        for s in subs:
            out += s
        return bytes(out)
    flags = order & 1
    body = data
    meta = bytearray()
    final_len = len(data)
    if use_pack and body:
        res = _pack(body)
        if res is not None and len(res[0]) < len(body):
            packed, pmap = res
            flags |= F_PACK
            meta += bytes([len(pmap)]) + bytes(pmap)
            meta += write_uint7(len(packed))
            body = packed
    if ext and body:
        import bz2

        comp = bz2.compress(bytes(body))
        if len(comp) < len(body):
            flags |= F_EXT
            payload = comp
        else:
            flags |= F_CAT
            payload = bytes(body)
    elif len(body) < 16 or len(set(body)) <= 1 and not use_rle:
        flags |= F_CAT
        payload = bytes(body)
    else:
        if use_rle:
            flags |= F_RLE
        payload = _encode_body(bytes(body), flags & F_ORDER1,
                               bool(flags & F_RLE))
        if len(payload) >= len(body):
            flags &= ~(F_RLE | F_ORDER1)
            flags |= F_CAT
            payload = bytes(body)
    return bytes([flags]) + write_uint7(final_len) + bytes(meta) \
        + payload
