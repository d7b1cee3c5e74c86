"""Name-tokeniser codec (CRAM 3.1 block method 8), clean-room.

A copy of the JAX package's io/tok3.py on its Python path.

CRAM 3.1's read-name codec: each name is split into typed tokens
(alpha runs, digit runs with or without leading zeros, single chars)
and coded as a diff against an earlier name — identical tokens become
MATCH, numeric tokens with a small increment become a delta, whole
repeats become DUP. Token fields fan out into per-(position, field)
byte streams, each compressed independently with rANS-Nx16 or the
adaptive arithmetic coder. Implemented from the CRAM 3.1 codecs
specification's structure (the reference accepts 3.1 through htslib —
covstats.go:229 smoove NewReader); as with the other 3.1 codecs it is
not cross-validated against htslib, so the layout below is pinned by
documentation + an in-repo encoder twin with fuzzing (docs/cram.md).

Token types::

    TYPE=0 ALPHA=1 CHAR=2 DIGITS0=3 DZLEN=4 DUP=5 DIFF=6
    DIGITS=7 DDELTA=8 DDELTA0=9 MATCH=10 NOP=11 END=12

Layout:

- byte 0: flags — bit0 ARITH (streams use io/arith.py instead of
  rANS-Nx16), bit1 NEWLINE (names joined with '\\n' instead of '\\0')
- uint7 decoded byte length, uint7 name count
- a sequence of stream chunks, each ``[token position byte]
  [field-type byte] [uint7 compressed length] [compressed stream]``,
  in ascending (position, field) order:
  - position 0 / TYPE: one byte per name — DUP (whole-name repeat) or
    DIFF (diff follows); its distance stream (u32-le per name) tells
    how many names back the template is (0 ⇒ the previous name)
  - position t / TYPE: the token type each diffed name has at t
  - ALPHA: '\\0'-terminated strings; CHAR: single bytes; DIGITS /
    DIGITS0: u32-le values (DIGITS0 zero-padded to the DZLEN byte);
    DDELTA / DDELTA0: u8 increments over the template name's value at
    the same position (DDELTA0 keeps the template's zero-padded
    width); MATCH/END/NOP carry no payload
"""

from __future__ import annotations

import struct

from .rans_nx16 import read_uint7, write_uint7

F_ARITH = 0x01
F_NEWLINE = 0x02

(T_TYPE, T_ALPHA, T_CHAR, T_DIGITS0, T_DZLEN, T_DUP, T_DIFF,
 T_DIGITS, T_DDELTA, T_DDELTA0, T_MATCH, T_NOP, T_END) = range(13)

_MAX_TOKEN_VAL = (1 << 32) - 1


def _compress_stream(data: bytes, use_arith: bool) -> bytes:
    if use_arith:
        from .arith import encode
    else:
        from .rans_nx16 import encode
    if len(data) < 64:
        return encode(data, order=0)
    # token streams are often near-constant (all-DIFF type bytes,
    # zero distances, +1 deltas): let RLE compete with plain entropy
    # coding and keep the smaller stream
    best = encode(data, order=1)
    for kw in ({"order": 0}, {"order": 0, "use_rle": True},
               {"order": 1, "use_rle": True}):
        cand = encode(data, **kw)
        if len(cand) < len(best):
            best = cand
    return best


def _decompress_stream(data: bytes, use_arith: bool) -> bytes:
    if use_arith:
        from .arith import decode

        return decode(data)
    from .rans_nx16 import decode

    return decode(data)


# ---------------------------------------------------------- tokenizer


def _tokenize(name: bytes) -> list[tuple[int, bytes]]:
    """Split a name into (type, text) tokens: digit runs (DIGITS0 when
    zero-padded or too long for u32), alpha runs, single chars."""
    toks: list[tuple[int, bytes]] = []
    i = 0
    n = len(name)
    while i < n:
        c = name[i]
        if 0x30 <= c <= 0x39:
            j = i
            while j < n and 0x30 <= name[j] <= 0x39:
                j += 1
            run = name[i:j]
            if (run[0] == 0x30 and len(run) > 1) or \
                    int(run) > _MAX_TOKEN_VAL:
                toks.append((T_DIGITS0, run))
            else:
                toks.append((T_DIGITS, run))
            i = j
        elif (0x41 <= c <= 0x5A) or (0x61 <= c <= 0x7A):
            j = i
            while j < n and ((0x41 <= name[j] <= 0x5A)
                             or (0x61 <= name[j] <= 0x7A)):
                j += 1
            toks.append((T_ALPHA, name[i:j]))
            i = j
        else:
            toks.append((T_CHAR, name[i:i + 1]))
            i += 1
    return toks


class _Streams:
    """(position, field) → bytearray, created on demand."""

    def __init__(self) -> None:
        self.d: dict[tuple[int, int], bytearray] = {}

    def get(self, pos: int, field: int) -> bytearray:
        key = (pos, field)
        b = self.d.get(key)
        if b is None:
            b = self.d[key] = bytearray()
        return b


# ----------------------------------------------------------- encoding


def encode(names: list[bytes], use_arith: bool = False,
           newline_sep: bool = False) -> bytes:
    """Encode a list of read names (fixture writer + fuzz twin)."""
    st = _Streams()
    prev_toks: list[list[tuple[int, bytes]]] = []
    for n_idx, name in enumerate(names):
        toks = _tokenize(name)
        if n_idx and toks == prev_toks[n_idx - 1] \
                and name == names[n_idx - 1]:
            st.get(0, T_TYPE).append(T_DUP)
            st.get(0, T_DUP).extend(struct.pack("<I", 0))
            prev_toks.append(toks)
            continue
        st.get(0, T_TYPE).append(T_DIFF)
        st.get(0, T_DIFF).extend(struct.pack("<I", 0))
        tmpl = prev_toks[n_idx - 1] if n_idx else []
        for t, (typ, text) in enumerate(toks, start=1):
            ttyp, ttext = tmpl[t - 1] if t - 1 < len(tmpl) \
                else (None, b"")
            if ttyp == typ and ttext == text:
                st.get(t, T_TYPE).append(T_MATCH)
                continue
            if typ == T_DIGITS and ttyp == T_DIGITS:
                delta = int(text) - int(ttext)
                if 0 <= delta <= 255:
                    st.get(t, T_TYPE).append(T_DDELTA)
                    st.get(t, T_DDELTA).append(delta)
                    continue
            if typ == T_DIGITS0 and ttyp == T_DIGITS0 \
                    and len(text) == len(ttext) \
                    and int(text) <= _MAX_TOKEN_VAL:
                delta = int(text) - int(ttext)
                if 0 <= delta <= 255:
                    st.get(t, T_TYPE).append(T_DDELTA0)
                    st.get(t, T_DDELTA0).append(delta)
                    continue
            st.get(t, T_TYPE).append(typ)
            if typ == T_ALPHA:
                st.get(t, T_ALPHA).extend(text + b"\x00")
            elif typ == T_CHAR:
                st.get(t, T_CHAR).extend(text)
            elif typ == T_DIGITS:
                st.get(t, T_DIGITS).extend(struct.pack("<I", int(text)))
            else:  # T_DIGITS0
                if int(text) > _MAX_TOKEN_VAL:
                    # too wide for the u32 payload: store as ALPHA,
                    # and remember the degraded type so later names
                    # diff against what the decoder will reconstruct
                    st.get(t, T_TYPE)[-1] = T_ALPHA
                    st.get(t, T_ALPHA).extend(text + b"\x00")
                    toks[t - 1] = (T_ALPHA, text)
                else:
                    st.get(t, T_DIGITS0).extend(struct.pack("<I", int(text)))
                    st.get(t, T_DZLEN).append(len(text))
        st.get(len(toks) + 1, T_TYPE).append(T_END)
        prev_toks.append(toks)

    ulen = sum(len(n) + 1 for n in names)
    flags = (F_ARITH if use_arith else 0) \
        | (F_NEWLINE if newline_sep else 0)
    out = bytearray([flags])
    out += write_uint7(ulen)
    out += write_uint7(len(names))
    for (pos, field) in sorted(st.d):
        comp = _compress_stream(bytes(st.d[(pos, field)]), use_arith)
        out.append(pos)
        out.append(field)
        out += write_uint7(len(comp))
        out += comp
    return bytes(out)


# ----------------------------------------------------------- decoding


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("tok3: stream underrun")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def u32(self) -> int:
        if self.pos + 4 > len(self.data):
            raise ValueError("tok3: stream underrun")
        v = struct.unpack_from("<I", self.data, self.pos)[0]
        self.pos += 4
        return v

    def cstr(self) -> bytes:
        end = self.data.find(b"\x00", self.pos)
        if end < 0:
            raise ValueError("tok3: unterminated string")
        s = self.data[self.pos:end]
        self.pos = end + 1
        return s


def decode(data: bytes, expected_len: int | None = None) -> bytes:
    try:
        return _decode(data, expected_len)
    except (IndexError, struct.error):
        # header/stream reads past the end of a truncated or corrupt
        # stream (including inside an inner rANS stream) surface as
        # the module's typed error, never a crash
        raise ValueError("tok3: truncated stream") from None


def _decode(data: bytes, expected_len: int | None) -> bytes:
    buf = memoryview(data)
    if len(buf) < 3:
        raise ValueError("tok3: truncated stream")
    flags = buf[0]
    use_arith = bool(flags & F_ARITH)
    sep = b"\n" if flags & F_NEWLINE else b"\x00"
    pos = 1
    ulen, pos = read_uint7(buf, pos)
    n_names, pos = read_uint7(buf, pos)
    if expected_len is not None and ulen != expected_len:
        raise ValueError(
            f"tok3: stored size {ulen} != declared block size "
            f"{expected_len}"
        )
    raw_streams: dict[tuple[int, int], bytes] = {}
    while pos < len(buf):
        p = buf[pos]
        f = buf[pos + 1]
        pos += 2
        clen, pos = read_uint7(buf, pos)
        if pos + clen > len(buf):
            raise ValueError("tok3: truncated stream chunk")
        raw = _decompress_stream(bytes(buf[pos:pos + clen]), use_arith)
        raw_streams[(p, f)] = raw
        pos += clen

    streams = {k: _Reader(v) for k, v in raw_streams.items()}

    def stream(p: int, f: int) -> _Reader:
        r = streams.get((p, f))
        if r is None:
            raise ValueError(f"tok3: missing stream ({p},{f})")
        return r

    names: list[bytes] = []
    toks_per_name: list[list[tuple[int, bytes]]] = []
    for n_idx in range(n_names):
        t0 = stream(0, T_TYPE).byte()
        if t0 == T_DUP:
            dist = stream(0, T_DUP).u32()
            src = n_idx - 1 - dist
            if not 0 <= src < n_idx:
                raise ValueError("tok3: DUP distance out of range")
            names.append(names[src])
            toks_per_name.append(toks_per_name[src])
            continue
        if t0 != T_DIFF:
            raise ValueError("tok3: name must start with DUP or DIFF")
        dist = stream(0, T_DIFF).u32()
        src = n_idx - 1 - dist
        if n_idx and not 0 <= src < n_idx:
            raise ValueError("tok3: DIFF distance out of range")
        tmpl = toks_per_name[src] if n_idx else []
        toks: list[tuple[int, bytes]] = []
        t = 1
        while True:
            typ = stream(t, T_TYPE).byte()
            if typ == T_END:
                break
            if typ == T_NOP:
                t += 1
                continue
            ttyp, ttext = tmpl[t - 1] if t - 1 < len(tmpl) \
                else (None, b"")
            if typ == T_MATCH:
                if ttyp is None:
                    raise ValueError("tok3: MATCH without template")
                toks.append((ttyp, ttext))
            elif typ == T_ALPHA:
                toks.append((T_ALPHA, stream(t, T_ALPHA).cstr()))
            elif typ == T_CHAR:
                toks.append((T_CHAR,
                             bytes([stream(t, T_CHAR).byte()])))
            elif typ == T_DIGITS:
                v = stream(t, T_DIGITS).u32()
                toks.append((T_DIGITS, str(v).encode()))
            elif typ == T_DIGITS0:
                v = stream(t, T_DIGITS0).u32()
                z = stream(t, T_DZLEN).byte()
                s = str(v).encode().rjust(z, b"0")
                if len(s) != z:
                    raise ValueError("tok3: DIGITS0 width mismatch")
                toks.append((T_DIGITS0, s))
            elif typ == T_DDELTA:
                if ttyp not in (T_DIGITS, T_DIGITS0):
                    raise ValueError("tok3: DDELTA without digits")
                d = stream(t, T_DDELTA).byte()
                toks.append((T_DIGITS,
                             str(int(ttext) + d).encode()))
            elif typ == T_DDELTA0:
                if ttyp not in (T_DIGITS, T_DIGITS0):
                    raise ValueError("tok3: DDELTA0 without digits")
                d = stream(t, T_DDELTA0).byte()
                s = str(int(ttext) + d).encode().rjust(len(ttext),
                                                       b"0")
                if len(s) != len(ttext):
                    raise ValueError("tok3: DDELTA0 overflow")
                toks.append((T_DIGITS0, s))
            else:
                raise ValueError(f"tok3: unknown token type {typ}")
            t += 1
        names.append(b"".join(tx for _, tx in toks))
        toks_per_name.append(toks)

    out = sep.join(names) + sep if names else b""
    if len(out) != ulen:
        raise ValueError("tok3: output length mismatch")
    return out
