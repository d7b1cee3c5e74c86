"""rANS Nx16 codec (CRAM 3.1 block method 5), clean-room.

A copy of the JAX package's io/rans_nx16.py on its Python path: the
port has no C copy of the decode loops, so ``decode`` is the host
oracle the CUDA kernel (csrc/rans_kernel.cu) is held against, and
``parse_nx16`` is the layout the kernel consumes. The encoders' table
builders (``_rans0_table``, ``_rans1_table``) are split out for the
vectorised fixture writer (tools/bulk_cram.py).

CRAM 3.1's default byte-stream codec: interleaved rANS with 16-bit
renormalization and optional meta-transforms. Layout implemented from
the CRAM 3.1 codecs specification (the reference accepts 3.1 through
htslib — covstats.go:229 smoove NewReader; this module is the repo's
own clean-room implementation, validated by an in-repo encoder/decoder
pair + fuzzing like the 4x8 codec in io/cram.py):

- flags byte: ORDER=0x01, X32=0x04 (32-way interleave, else 4),
  STRIPE=0x08, NOSZ=0x10 (no stored size), CAT=0x20 (stored raw),
  RLE=0x40, PACK=0x80
- sizes are uint7 varints (big-endian 7-bit groups, 0x80 continuation)
- order-0: states decode round-robin (out[i] from state i%N), 12-bit
  frequencies normalized to 4096, one 16-bit renorm step per symbol
- order-1: shared alphabet, per-context frequency rows (shift bits in
  the table header's high nibble; low bit marks a rans-o0-compressed
  table), output split into N contiguous slices with the last state
  carrying the tail, per-slice context starts at 0
- PACK: ≤16 distinct symbols bit-packed LSB-first (0/1/2/4 bits)
- RLE: marked symbols appear once per run in the literal stream; run
  extensions live in the metadata as uint7s, consumed in order
- STRIPE: the stream splits into N' byte-interleaved lanes, each lane
  its own complete Nx16 stream

Decode order for combined transforms: rans/CAT innermost, then RLE
expansion, then PACK expansion, mirroring the encoder's PACK→RLE→rans.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

F_ORDER1 = 0x01
F_X32 = 0x04
F_STRIPE = 0x08
F_NOSZ = 0x10
F_CAT = 0x20
F_RLE = 0x40
F_PACK = 0x80

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT
RANS_LOW = 1 << 15


# ------------------------------------------------------------- varint

def read_uint7(buf, pos: int) -> tuple[int, int]:
    v = 0
    while True:
        b = buf[pos]
        pos += 1
        v = (v << 7) | (b & 0x7F)
        if not (b & 0x80):
            return v, pos


def write_uint7(v: int) -> bytes:
    out = bytearray([v & 0x7F])
    v >>= 7
    while v:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    return bytes(reversed(out))


# ----------------------------------------------------------- alphabet

def _read_alphabet(buf, pos: int) -> tuple[list[int], int]:
    """Ascending symbol list with adjacent-run RLE: a symbol equal to
    previous+1 is a run marker followed by the count of FURTHER
    consecutive symbols; terminated by a 0 symbol."""
    syms: list[int] = []
    rle = 0
    sym = buf[pos]
    pos += 1
    last = -2
    while True:
        syms.append(sym)
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            last = sym
            sym = buf[pos]
            pos += 1
            if sym == last + 1:
                rle = buf[pos]
                pos += 1
        if rle == 0 and sym == 0:
            break
    return syms, pos


def _write_alphabet(syms) -> bytearray:
    out = bytearray()
    i = 0
    while i < len(syms):
        run = 0
        while (i + run + 1 < len(syms)
               and syms[i + run + 1] == syms[i + run] + 1):
            run += 1
        out.append(int(syms[i]))
        if run:
            out.append(int(syms[i] + 1))
            out.append(run - 1)
        i += run + 1
    out.append(0)
    return out


def _normalize(freqs: np.ndarray, total: int, target: int) -> np.ndarray:
    """Counts → frequencies summing exactly to ``target`` (each present
    symbol ≥ 1); shared with the 4x8 codec."""
    from .cram import _normalize_freqs

    return _normalize_freqs(freqs, total, target)


# ------------------------------------------------------------ order 0

def _read_freqs0(buf, pos: int):
    syms, pos = _read_alphabet(buf, pos)
    freqs = np.zeros(256, dtype=np.int64)
    for s in syms:
        freqs[s], pos = read_uint7(buf, pos)
    tot = int(freqs.sum())
    if tot != TOTFREQ and tot > 0:
        freqs = _normalize(freqs, tot, TOTFREQ)
    return freqs, pos


def _slot_lut(freqs: np.ndarray, cum: np.ndarray) -> np.ndarray:
    """(4096,) slot → symbol table, exactly the per-slot coverage the
    scalar decoder uses (slots not covered by any present symbol stay
    0 — only reachable on corrupt tables)."""
    lut = np.zeros(TOTFREQ, dtype=np.uint8)
    for s in np.nonzero(freqs)[0]:
        lut[cum[s]:cum[s + 1]] = s
    return lut


#: lane count at or above which the vectorized state-stepping loop
#: beats the scalar loop. Measured with numpy at ~2µs per op
#: dispatch: X32 vectorized is 1.3-1.6x the scalar loop, but
#: N=4 rounds pay ~10 numpy dispatches for 4 symbols and LOSE ~3x —
#: the per-op overhead needs ≥ ~16 lanes to amortize. The device
#: decoder (ops/rans_device.py) is the real answer for N=4 blocks.
VEC_MIN_STATES = 32


def _rans0_loop_scalar(buf, pos, out_len, n_states, freqs, cum, lut):
    """Reference per-symbol loop (exact Python-int arithmetic)."""
    R = list(struct.unpack_from(f"<{n_states}I", buf, pos))
    pos += 4 * n_states
    out = bytearray(out_len)
    n = len(buf)
    mask = TOTFREQ - 1
    for i in range(out_len):
        j = i % n_states
        x = R[j]
        m = x & mask
        s = int(lut[m])
        out[i] = s
        x = int(freqs[s]) * (x >> TF_SHIFT) + m - int(cum[s])
        if x < RANS_LOW and pos + 1 < n:
            x = (x << 16) | buf[pos] | (buf[pos + 1] << 8)
            pos += 2
        R[j] = x
    return bytes(out)


def _rans0_loop_vec(buf, pos, out_len, n_states, freqs, cum, lut):
    """All N states stepped per iteration: one packed-table gather and
    a handful of (N,)-wide ops per round instead of N per-symbol Python
    steps. Byte-identical to the scalar loop on every stream: states
    are int64 (Python-int-exact — a corrupt initial state can reach
    ~2^32, never beyond cum growth bounds), and the renorm keeps the
    scalar loop's sequential byte order inside a round via the
    exclusive rank of each lane's pending 16-bit read — lane j's read
    lands at pos + 2·#(earlier lanes reading this round), and the
    bytes-left guard truncates at the same lane the scalar loop would
    stop at (a lane denied bytes leaves every later lane denied too,
    so the closed form needs no intra-round scan)."""
    R = np.array(struct.unpack_from(f"<{n_states}I", buf, pos),
                 dtype=np.int64)
    pos += 4 * n_states
    n = len(buf)
    mask = TOTFREQ - 1
    li = lut.astype(np.int64)
    # packed per-slot table: freq<<20 | (m - cum[sym])<<8 | sym — one
    # gather per round replaces three (bias = m - cum[sym] ≥ 0 because
    # lut only assigns a slot m inside [cum[s], cum[s+1]))
    T = ((freqs[li] << 20)
         | ((np.arange(TOTFREQ, dtype=np.int64) - cum[li]) << 8) | li)
    byts = np.frombuffer(buf, dtype=np.uint8).astype(np.int64)
    b16 = byts[:-1].copy() if n > 1 else np.zeros(0, np.int64)
    if n > 1:
        b16 |= byts[1:] << 8  # LE 16-bit word at every byte offset
    N = n_states
    rounds = out_len // N
    tail = out_len - rounds * N
    out2 = np.empty((max(rounds, 1), N), dtype=np.int64)
    for r in range(rounds):
        t = T[R & mask]
        R = (t >> 20) * (R >> TF_SHIFT) + ((t >> 8) & mask)
        out2[r] = t
        want = R < RANS_LOW
        nw = int(want.sum())
        if nw:
            avail = (n - pos) >> 1
            if nw > avail:
                want &= (np.cumsum(want) - want) < avail
                nw = int(want.sum())
            w = np.flatnonzero(want)
            R[w] = (R[w] << 16) | b16[pos + 2 * np.arange(nw)]
            pos += 2 * nw
    out = np.empty(out_len, dtype=np.uint8)
    out[:rounds * N] = (out2 & 0xFF).reshape(-1)[:rounds * N] \
        .astype(np.uint8)
    if tail:  # final partial round: lanes j < tail, scalar order
        base = rounds * N
        for j in range(tail):
            x = int(R[j])
            m = x & mask
            s = int(lut[m])
            out[base + j] = s
            x = int(freqs[s]) * (x >> TF_SHIFT) + m - int(cum[s])
            if x < RANS_LOW and pos + 1 < n:
                x = (x << 16) | buf[pos] | (buf[pos + 1] << 8)
                pos += 2
            R[j] = x
    return bytes(out)


def _decode_rans0(buf, pos: int, out_len: int, n_states: int) -> bytes:
    freqs, pos = _read_freqs0(buf, pos)
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(freqs, out=cum[1:])
    lut = _slot_lut(freqs, cum)
    loop = _rans0_loop_vec if n_states >= VEC_MIN_STATES \
        else _rans0_loop_scalar
    return loop(buf, pos, out_len, n_states, freqs, cum, lut)


def _rans0_table(arr: np.ndarray):
    """ORDER0 frequency table of a stream: (serialised table, norm[256],
    cum[257])."""
    counts = np.bincount(arr, minlength=256).astype(np.int64)
    norm = _normalize(counts, len(arr), TOTFREQ)
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(norm, out=cum[1:])
    table = _write_alphabet(np.nonzero(norm > 0)[0])
    for s in np.nonzero(norm > 0)[0]:
        table += write_uint7(int(norm[s]))
    return bytes(table), norm, cum


def _encode_rans0(data: bytes, n_states: int = 4) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8)
    table, norm, cum = _rans0_table(arr)
    R = [RANS_LOW] * n_states
    payload = bytearray()
    for i in range(len(arr) - 1, -1, -1):
        s = int(arr[i])
        j = i % n_states
        f = int(norm[s])
        x = R[j]
        x_max = ((RANS_LOW >> TF_SHIFT) << 16) * f
        if x >= x_max:
            payload.append((x >> 8) & 0xFF)
            payload.append(x & 0xFF)
            x >>= 16
        R[j] = ((x // f) << TF_SHIFT) + (x % f) + int(cum[s])
    states = b"".join(struct.pack("<I", R[j]) for j in range(n_states))
    # payload bytes were appended hi,lo per step walking backwards; the
    # decoder reads lo,hi forwards — reverse pairs then the sequence
    pay = bytes(payload)
    pairs = [pay[i:i + 2] for i in range(0, len(pay), 2)]
    fwd = b"".join(bytes([p[1], p[0]]) for p in reversed(pairs))
    return table + states + fwd


# ------------------------------------------------------------ order 1

def _read_freqs1_rows(tbuf, tpos: int, target: int):
    """The ORDER1 per-context frequency-row walk (shared by the host
    decoder and ``parse_nx16``): ascending context alphabet, one uint7
    row per context over the same alphabet, each row normalized to
    ``target``. Returns (syms, freqs(256,256), cums(256,257), luts,
    pos-after-rows)."""
    syms, tpos = _read_alphabet(tbuf, tpos)
    freqs = np.zeros((256, 256), dtype=np.int64)
    cums = np.zeros((256, 257), dtype=np.int64)
    luts = {}
    for c in syms:
        row = np.zeros(256, dtype=np.int64)
        for s in syms:
            row[s], tpos = read_uint7(tbuf, tpos)
        tot = int(row.sum())
        if tot not in (0, target):
            row = _normalize(row, tot, target)
        freqs[c] = row
        np.cumsum(row, out=cums[c][1:])
        lut = np.zeros(target, dtype=np.uint8)
        for s in np.nonzero(row)[0]:
            lut[cums[c][s]:cums[c][s + 1]] = s
        luts[c] = lut
    return syms, freqs, cums, luts, tpos


def _rans1_loop_scalar(buf, pos, out_len, n_states, shift, freqs,
                       cums, luts):
    """Reference ORDER1 loop (exact Python-int arithmetic): output
    split into N contiguous slices (the last state carries the tail),
    one symbol per state per round, each lane's previous symbol as its
    context (starting at 0)."""
    target = 1 << shift
    R = list(struct.unpack_from(f"<{n_states}I", buf, pos))
    pos += 4 * n_states
    out = bytearray(out_len)
    n = len(buf)
    mask = target - 1
    F = out_len // n_states
    idx = [j * F for j in range(n_states)]
    ends = [F * (j + 1) for j in range(n_states - 1)] + [out_len]
    last = [0] * n_states
    while True:
        done = True
        for j in range(n_states):
            if idx[j] >= ends[j]:
                continue
            done = False
            x = R[j]
            c = last[j]
            if c not in luts:
                raise ValueError("rans-nx16: missing order-1 context")
            m = x & mask
            s = int(luts[c][m])
            out[idx[j]] = s
            x = int(freqs[c][s]) * (x >> shift) + m - int(cums[c][s])
            if x < RANS_LOW and pos + 1 < n:
                x = (x << 16) | buf[pos] | (buf[pos + 1] << 8)
                pos += 2
            R[j] = x
            last[j] = s
            idx[j] += 1
        if done:
            break
    return bytes(out)


def _rans1_loop_vec(buf, pos, out_len, n_states, shift, freqs, cums,
                    luts):
    """ORDER1 twin of ``_rans0_loop_vec``: all N states stepped per
    round with one packed (ctx, slot) gather. The main ``F = out_len
    // N`` rounds keep every lane active (lane j writes out[j*F + r]);
    the tail — the last lane's extra ``out_len - N*F`` symbols — runs
    the scalar walk. Byte-identical to the scalar loop on every stream
    the gate admits: int64 states stay Python-int-exact because
    shift == TF_SHIFT bounds state growth (freq ≤ 2^12 and x ≥
    f·(x>>12) renorm-free adds ≤ 4095/step — the shift < 12 regime,
    where corrupt states could genuinely overflow int64, is gated to
    the scalar loop), and the renorm byte order inside a round uses
    the same exclusive-rank closed form."""
    target = 1 << shift
    mask = target - 1
    R = np.array(struct.unpack_from(f"<{n_states}I", buf, pos),
                 dtype=np.int64)
    pos += 4 * n_states
    n = len(buf)
    # packed (ctx, slot) table: freq<<20 | (m - cum[ctx][sym])<<8 | sym
    # (freq ≤ 4096 above bit 20, bias < 4096 in bits 8..19); absent
    # contexts keep a row of zeros and are caught by `valid` before
    # any lane consumes them — the scalar loop's missing-context raise
    valid = np.zeros(256, dtype=bool)
    T = np.zeros((256, target), dtype=np.int64)
    ms = np.arange(target, dtype=np.int64)
    for c, lut in luts.items():
        valid[c] = True
        li = lut.astype(np.int64)
        T[c] = (freqs[c][li] << 20) | ((ms - cums[c][li]) << 8) | li
    byts = np.frombuffer(buf, dtype=np.uint8).astype(np.int64)
    b16 = byts[:-1].copy() if n > 1 else np.zeros(0, np.int64)
    if n > 1:
        b16 |= byts[1:] << 8
    N = n_states
    F = out_len // N
    last = np.zeros(N, dtype=np.int64)
    out2 = np.empty((max(F, 1), N), dtype=np.int64)
    for r in range(F):
        if not valid[last].all():
            raise ValueError("rans-nx16: missing order-1 context")
        t = T[last, R & mask]
        R = (t >> 20) * (R >> shift) + ((t >> 8) & mask)
        last = t & 0xFF
        out2[r] = last
        want = R < RANS_LOW
        nw = int(want.sum())
        if nw:
            avail = (n - pos) >> 1
            if nw > avail:
                want &= (np.cumsum(want) - want) < avail
                nw = int(want.sum())
            w = np.flatnonzero(want)
            R[w] = (R[w] << 16) | b16[pos + 2 * np.arange(nw)]
            pos += 2 * nw
    out = np.empty(out_len, dtype=np.uint8)
    # out2[r, j] is out[j*F + r]: transpose to lane-major order
    out[:F * N] = out2[:F].T.reshape(-1).astype(np.uint8)[:F * N]
    # tail: only the last lane remains active, scalar order
    x = int(R[N - 1])
    c = int(last[N - 1]) if F > 0 else 0
    for p in range(N * F, out_len):
        if c not in luts:
            raise ValueError("rans-nx16: missing order-1 context")
        m = x & mask
        s = int(luts[c][m])
        out[p] = s
        x = int(freqs[c][s]) * (x >> shift) + m - int(cums[c][s])
        if x < RANS_LOW and pos + 1 < n:
            x = (x << 16) | buf[pos] | (buf[pos + 1] << 8)
            pos += 2
        c = s
    return bytes(out)


def _decode_rans1(buf, pos: int, out_len: int, n_states: int) -> bytes:
    head = buf[pos]
    pos += 1
    shift = head >> 4
    if head & 1:
        # compressed table: uncompressed size first, then its
        # compressed byte count, then a bare rans-o0 stream. A full
        # 256x256 uint7 table tops out well under 4MB — larger claims
        # are corruption, rejected before any allocation.
        ulen, pos = read_uint7(buf, pos)
        clen, pos = read_uint7(buf, pos)
        if ulen > 1 << 22:
            raise ValueError("rans-nx16: implausible o1 table size")
        table = _decode_rans0(buf, pos, ulen, 4)
        pos += clen
        tbuf, tpos = memoryview(table), 0
    else:
        tbuf, tpos = buf, pos
    target = 1 << shift
    syms, freqs, cums, luts, tpos = _read_freqs1_rows(tbuf, tpos,
                                                      target)
    if not (head & 1):
        pos = tpos
    # the vectorized loop is exact only in the shift == TF_SHIFT
    # regime (see its docstring); foreign shifts keep the scalar oracle
    loop = _rans1_loop_vec if (n_states >= VEC_MIN_STATES
                               and shift == TF_SHIFT) \
        else _rans1_loop_scalar
    return loop(buf, pos, out_len, n_states, shift, freqs, cums, luts)


def _rans1_table(arr: np.ndarray, n_states: int, shift: int = TF_SHIFT):
    """ORDER1 tables of a stream whose lane j holds [lo[j], hi[j]), rows
    normalised to 2^shift: (head byte + serialised table,
    norm[256][256], cums[256][257], shift)."""
    n = len(arr)
    F = n // n_states
    lo = [j * F for j in range(n_states)]
    hi = [F * (j + 1) for j in range(n_states - 1)] + [n]
    counts = np.zeros((256, 256), dtype=np.int64)
    for j in range(n_states):
        prevs = np.concatenate(([0], arr[lo[j]:hi[j] - 1]))
        np.add.at(counts, (prevs, arr[lo[j]:hi[j]]), 1)
    used = sorted(set(np.nonzero(counts.sum(axis=1))[0])
                  | set(np.unique(arr)))
    target = 1 << shift
    norm = np.zeros((256, 256), dtype=np.int64)
    cums = np.zeros((256, 257), dtype=np.int64)
    for c in used:
        tot = int(counts[c].sum())
        if tot > 0:
            norm[c] = _normalize(counts[c], tot, target)
        else:
            # context never used as predecessor: flat row over alphabet
            norm[c][used] = 1
            norm[c] = _normalize(norm[c], len(used), target)
        np.cumsum(norm[c], out=cums[c][1:])

    table = bytearray(_write_alphabet(used))
    for c in used:
        for s in used:
            table += write_uint7(int(norm[c][s]))
    head = shift << 4
    tbytes = bytes(table)
    if len(tbytes) >= 64:
        comp = _encode_rans0(tbytes, 4)
        framed = (write_uint7(len(tbytes)) + write_uint7(len(comp))
                  + comp)
        if len(framed) < len(tbytes):
            head |= 1  # compressed table
            tbytes = framed
    return bytes([head]) + tbytes, norm, cums, shift


def _encode_rans1(data: bytes, n_states: int = 4,
                  shift: int = TF_SHIFT) -> bytes:
    n = len(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    F = n // n_states
    lo = [j * F for j in range(n_states)]
    hi = [F * (j + 1) for j in range(n_states - 1)] + [n]
    table, norm, cums, shift = _rans1_table(arr, n_states, shift)

    def reverse_steps():
        tail = hi[n_states - 1] - lo[n_states - 1]
        for i in range(tail - 1, -1, -1):
            for j in range(n_states - 1, -1, -1):
                p = lo[j] + i
                if p < hi[j]:
                    yield j, p

    R = [RANS_LOW] * n_states
    payload = bytearray()
    for j, p in reverse_steps():
        s = int(arr[p])
        ctx = int(arr[p - 1]) if p > lo[j] else 0
        f = int(norm[ctx][s])
        x = R[j]
        x_max = ((RANS_LOW >> shift) << 16) * f
        if x >= x_max:
            payload.append((x >> 8) & 0xFF)
            payload.append(x & 0xFF)
            x >>= 16
        R[j] = ((x // f) << shift) + (x % f) + int(cums[ctx][s])
    states = b"".join(struct.pack("<I", R[j]) for j in range(n_states))
    pay = bytes(payload)
    pairs = [pay[i:i + 2] for i in range(0, len(pay), 2)]
    fwd = b"".join(bytes([p[1], p[0]]) for p in reversed(pairs))
    return table + states + fwd


# ------------------------------------------------------- PACK and RLE

def _pack_bits(nsym: int) -> int:
    if nsym <= 1:
        return 0
    if nsym <= 2:
        return 1
    if nsym <= 4:
        return 2
    return 4


def _unpack(data: bytes, pmap: list[int], out_len: int) -> bytes:
    if out_len == 0:
        return b""
    bits = _pack_bits(len(pmap))
    if bits == 0:
        return bytes([pmap[0]]) * out_len
    per = 8 // bits
    mask = (1 << bits) - 1
    out = bytearray(out_len)
    for i in range(out_len):
        b = data[i // per]
        out[i] = pmap[(b >> (bits * (i % per))) & mask]
    return bytes(out)


def _pack(data: bytes) -> tuple[bytes, list[int]] | None:
    syms = sorted(set(data))
    if len(syms) > 16:
        return None
    bits = _pack_bits(len(syms))
    if bits == 0:
        return b"", syms
    back = {s: i for i, s in enumerate(syms)}
    per = 8 // bits
    out = bytearray((len(data) + per - 1) // per)
    for i, v in enumerate(data):
        out[i // per] |= back[v] << (bits * (i % per))
    return bytes(out), syms


def _rle_encode(data: bytes):
    """(literals, runs-meta, rle symbol set): every run of a marked
    symbol stores the symbol once in the literal stream and the number
    of FURTHER repeats as a uint7 in the metadata."""
    arr = np.frombuffer(data, dtype=np.uint8)
    # mark symbols whose total run savings beat their metadata cost
    saves = np.zeros(256, dtype=np.int64)
    i = 0
    n = len(arr)
    while i < n:
        j = i
        while j < n and arr[j] == arr[i]:
            j += 1
        saves[arr[i]] += (j - i) - 2  # literal + ~1 meta byte per run
        i = j
    rle_syms = sorted(int(s) for s in np.nonzero(saves > 0)[0])
    if not rle_syms:
        return None
    marked = set(rle_syms)
    lits = bytearray()
    runs = bytearray()
    i = 0
    while i < n:
        s = int(arr[i])
        j = i
        while j < n and arr[j] == s:
            j += 1
        if s in marked:
            lits.append(s)
            runs += write_uint7(j - i - 1)
        else:
            lits += bytes(arr[i:j])
        i = j
    return bytes(lits), bytes(runs), rle_syms


def _rle_expand(lits: bytes, meta, mpos: int, rle_syms: set,
                out_len: int) -> bytes:
    out = bytearray()
    for b in lits:
        out.append(b)
        if b in rle_syms:
            r, mpos = read_uint7(meta, mpos)
            out += bytes([b]) * r
    if len(out) != out_len:
        raise ValueError("rans-nx16: rle expansion length mismatch")
    return bytes(out)


# ----------------------------------------------------------- top level

def decode(data: bytes, expected_len: int | None = None) -> bytes:
    """Decode one rANS-Nx16 stream (the full block payload)."""
    buf = memoryview(data)
    pos = 0
    flags = buf[pos]
    pos += 1
    if flags & F_NOSZ:
        if expected_len is None:
            raise ValueError("rans-nx16: NOSZ stream needs external size")
        out_len = expected_len
    else:
        out_len, pos = read_uint7(buf, pos)
        if expected_len is not None and out_len != expected_len:
            # the CRAM block header declares the raw size; a stored size
            # that disagrees is corruption — and checking BEFORE any
            # allocation stops a crafted varint from demanding memory
            raise ValueError(
                f"rans-nx16: stored size {out_len} != declared block "
                f"size {expected_len}"
            )
    if flags & F_STRIPE:
        n_lanes = buf[pos]
        pos += 1
        if n_lanes == 0 and out_len > 0:
            # would silently yield zeros; fail loudly like every other
            # corrupt-stream path
            raise ValueError("rans-nx16: stripe stream with 0 lanes")
        clens = []
        for _ in range(n_lanes):
            c, pos = read_uint7(buf, pos)
            clens.append(c)
        lanes = []
        for j in range(n_lanes):
            lane_len = (out_len - j + n_lanes - 1) // n_lanes
            lanes.append(decode(bytes(buf[pos:pos + clens[j]]), lane_len))
            pos += clens[j]
        out = bytearray(out_len)
        for j, lane in enumerate(lanes):
            out[j::n_lanes] = lane
        return bytes(out)
    n_states = 32 if flags & F_X32 else 4

    pack_map = None
    final_len = out_len
    if flags & F_PACK:
        nsym = buf[pos]
        pos += 1
        pack_map = [buf[pos + k] for k in range(nsym)]
        pos += nsym
        out_len, pos = read_uint7(buf, pos)  # packed byte count
    rle_syms = None
    rle_meta = None
    rle_out_len = out_len
    if flags & F_RLE:
        # [meta_len u7 (low bit: 1 = raw)] [literal count u7] [meta]
        mlen, pos = read_uint7(buf, pos)
        raw = mlen & 1
        body_len = mlen >> 1
        out_len, pos = read_uint7(buf, pos)  # literal count
        if raw:
            meta = bytes(buf[pos:pos + body_len])
            pos += body_len
        else:
            # meta itself is a bare rans-o0 stream: uncompressed size
            # first, then body_len compressed bytes. Size is bounded by
            # the output: at most one run varint per output byte, each
            # ≤ 10 bytes even when written non-minimally (0x80-padded —
            # the same spec lenience ITF8 parsing preserves), so meta
            # stays O(out_len); larger claims are corruption.
            um, pos = read_uint7(buf, pos)
            if um > 10 * rle_out_len + 4096:
                raise ValueError("rans-nx16: implausible RLE meta size")
            meta = _decode_rans0(buf, pos, um, 4)
            pos += body_len
        mpos = 0
        ns = meta[mpos]
        mpos += 1
        if ns == 0:
            ns = 256
        rle_syms = set(meta[mpos:mpos + ns])
        rle_meta = (meta, mpos + ns)

    if flags & F_CAT:
        payload = bytes(buf[pos:pos + out_len])
    elif flags & F_ORDER1:
        payload = _decode_rans1(buf, pos, out_len, n_states)
    else:
        payload = _decode_rans0(buf, pos, out_len, n_states)

    if rle_syms is not None:
        payload = _rle_expand(payload, rle_meta[0], rle_meta[1],
                              rle_syms, rle_out_len)
    if pack_map is not None:
        payload = _unpack(payload, pack_map, final_len)
    if len(payload) != final_len:
        raise ValueError("rans-nx16: output length mismatch")
    return payload


# ------------------------------------------------- parsed-stream access
#
# The device decoder (ops/rans_device.py) needs the stream's LAYOUT —
# table arrays, state seeds, transform metadata and the compressed
# payload span — without the bytes being decoded here. parse_nx16 is
# that surface: it performs exactly decode()'s header walk (varints,
# alphabet, frequency normalization, RLE metadata — all host-cheap,
# O(table) not O(payload)) and leaves the entropy-coded payload
# untouched for the wire.

@dataclass
class ParsedNx16:
    """Layout of one rANS-Nx16 stream whose flag combo the device
    decoder supports (ORDER0/ORDER1 × CAT × PACK × RLE × NOSZ,
    N=4/32, plus STRIPE containers of supported sub-streams).

    ``payload`` is the still-compressed byte span (the rANS renorm
    stream, or the raw bytes for CAT) — what actually crosses the
    wire under ``--decode-device``; ``freq``/``cum`` are the shipped
    int32 table arrays the device expands into its 4096-entry slot
    tables. ORDER1 ships the COMPACT per-context rows instead,
    compacted on BOTH axes: ``ctx_freq`` holds one int32 row per
    context present in the alphabet, its columns covering only the
    alphabet symbols (``alphabet[k]`` names column ``k`` — contexts
    and emitted symbols share the one alphabet, so the matrix is
    (n_ctx, n_ctx), not (n_ctx, 256)); ``ctx_index`` maps context
    symbol → row (−1 marks an
    absent context, the device diag for the host's missing-context
    error). A STRIPE stream is a container: ``children`` holds one
    ParsedNx16 per byte-interleaved lane. ``table_bytes`` counts the
    shipped table/metadata arrays for wire accounting — ORDER1 pays
    n_ctx² int16 cells (alphabet-compacted columns), not n_ctx·256."""

    flags: int
    n_states: int
    cat: bool
    final_len: int            # decode()'s return length
    inner_len: int            # rANS/CAT output length (pre-RLE/PACK)
    payload: np.ndarray       # (P,) uint8, compressed (or CAT raw)
    states: np.ndarray | None  # (N,) uint32 (None for CAT)
    freq: np.ndarray | None    # (256,) int32
    cum: np.ndarray | None     # (257,) int32
    rle: bool = False
    rle_tab: np.ndarray | None = None   # (256,) bool marked symbols
    rle_runs: np.ndarray | None = None  # (k,) int32 run extensions
    rle_out_len: int = 0      # post-RLE length
    pack: bool = False
    pack_bits: int = 0
    pack_map: np.ndarray | None = None  # (16,) int32 (padded)
    pack_nsym: int = 0
    order1: bool = False
    shift: int = TF_SHIFT     # ORDER1 frequency precision (target=2^s)
    n_ctx: int = 0            # contexts present in the alphabet
    ctx_index: np.ndarray | None = None  # (256,) int16 ctx → row | -1
    ctx_freq: np.ndarray | None = None   # (n_ctx, n_ctx) int32 rows
    alphabet: np.ndarray | None = None   # (n_ctx,) int16 col → symbol
    stripe: bool = False
    n_lanes: int = 0
    children: list["ParsedNx16"] | None = None

    @property
    def table_bytes(self) -> int:
        """Logical bytes of the table/metadata arrays as they ship
        over the wire: freq goes int16 and cum is expanded on device
        (a cumsum), so a non-CAT ORDER0 block pays ~0.5KB of table
        while an ORDER1 block pays 2·n_ctx² bytes for its doubly
        compact context rows plus the ctx→row map and the
        column→symbol alphabet — a 40-symbol quality stream ships
        ~3.2KB of rows instead of the 20KB a 256-wide row matrix
        would cost."""
        if self.stripe:
            return sum(ch.table_bytes for ch in self.children or [])
        n = 0
        if self.states is not None:
            n += int(self.states.nbytes)
        if self.freq is not None:
            n += 256 * 2  # int16 on the wire; cum derives on device
        if self.ctx_freq is not None:
            # compact int16 rows over compact columns + the int16
            # ctx→row map + the column→symbol alphabet; per-context
            # cum rows and slot tables derive on device
            n += (self.ctx_freq.shape[0] * self.ctx_freq.shape[1] * 2
                  + 256 * 2)
        if self.alphabet is not None:
            n += int(self.alphabet.shape[0]) * 2
        if self.rle_tab is not None:
            n += int(self.rle_tab.nbytes)
        if self.rle_runs is not None:
            n += int(self.rle_runs.nbytes)
        if self.pack_map is not None:
            n += int(self.pack_map.nbytes)
        return n

    @property
    def payload_bytes(self) -> int:
        """Compressed payload bytes crossing the wire (children's for
        a STRIPE container)."""
        if self.stripe:
            return sum(ch.payload_bytes for ch in self.children or [])
        return int(self.payload.nbytes)

    def payload_crc(self, crc: int = 0) -> int:
        if self.stripe:
            for ch in self.children or []:
                crc = ch.payload_crc(crc)
            return crc
        return zlib.crc32(self.payload, crc)

    def table_crc(self, crc: int = 0) -> int:
        """CRC over every shipped table/metadata array — joins the
        decode Step's content key so two blocks with identical
        payloads but different tables never alias."""
        if self.stripe:
            for ch in self.children or []:
                crc = ch.table_crc(crc)
            return crc
        for a in (self.states, self.freq, self.ctx_index,
                  self.ctx_freq, self.alphabet, self.rle_tab,
                  self.rle_runs, self.pack_map):
            if a is not None:
                crc = zlib.crc32(np.ascontiguousarray(a).tobytes(),
                                 crc)
        return crc


def parse_nx16(data: bytes,
               expected_len: int | None = None) -> ParsedNx16 | None:
    """Parse one stream's layout for device decode; None when the
    combo stays host-side (missing external size, shifts outside the
    device table range, or any inconsistency the host decoder would
    surface its own way — returning None always degrades to the host
    path, so a foreign or corrupt stream decodes (or fails) exactly
    as before). ORDER1 tables parse here (CRAM serializes them
    order-0-compressed — a host-cheap O(table) walk); STRIPE parses
    each byte-interleaved lane recursively and is supported exactly
    when every lane is."""
    try:
        buf = memoryview(data)
        pos = 0
        flags = buf[pos]
        pos += 1
        if flags & F_NOSZ:
            if expected_len is None:
                return None
            out_len = expected_len
        else:
            out_len, pos = read_uint7(buf, pos)
            if expected_len is not None and out_len != expected_len:
                return None  # host raises the canonical error
        if flags & F_STRIPE:
            # mirrors decode(): the stripe container ignores PACK/RLE
            # bits; each lane is its own complete Nx16 stream
            n_lanes = buf[pos]
            pos += 1
            if n_lanes == 0:
                return None  # host raises (or yields b"" for len 0)
            clens = []
            for _ in range(n_lanes):
                c, pos = read_uint7(buf, pos)
                clens.append(c)
            children = []
            for j in range(n_lanes):
                lane_len = (out_len - j + n_lanes - 1) // n_lanes
                ch = parse_nx16(bytes(buf[pos:pos + clens[j]]),
                                lane_len)
                if ch is None:
                    return None  # one host-side lane → whole block
                children.append(ch)
                pos += clens[j]
            return ParsedNx16(
                flags=flags, n_states=0, cat=False,
                final_len=out_len, inner_len=out_len,
                payload=np.zeros(0, np.uint8), states=None,
                freq=None, cum=None, stripe=True, n_lanes=n_lanes,
                children=children)
        n_states = 32 if flags & F_X32 else 4

        parsed = ParsedNx16(
            flags=flags, n_states=n_states, cat=bool(flags & F_CAT),
            final_len=out_len, inner_len=out_len,
            payload=np.zeros(0, np.uint8), states=None, freq=None,
            cum=None)
        if flags & F_PACK:
            nsym = buf[pos]
            pos += 1
            if nsym == 0 or nsym > 16:
                return None  # host path raises / spills past pmap[15]
            pmap = np.zeros(16, dtype=np.int32)
            pmap[:nsym] = np.frombuffer(buf[pos:pos + nsym], np.uint8)
            pos += nsym
            out_len, pos = read_uint7(buf, pos)  # packed byte count
            parsed.pack = True
            parsed.pack_bits = _pack_bits(nsym)
            parsed.pack_map = pmap
            parsed.pack_nsym = nsym
        if flags & F_RLE:
            mlen, pos = read_uint7(buf, pos)
            raw = mlen & 1
            body_len = mlen >> 1
            rle_out_len = out_len
            out_len, pos = read_uint7(buf, pos)  # literal count
            if raw:
                meta = bytes(buf[pos:pos + body_len])
                if len(meta) < body_len:
                    return None
                pos += body_len
            else:
                um, pos = read_uint7(buf, pos)
                if um > 10 * rle_out_len + 4096:
                    return None
                meta = _decode_rans0(buf, pos, um, 4)
                pos += body_len
            mpos = 0
            ns = meta[mpos]
            mpos += 1
            if ns == 0:
                ns = 256
            tab = np.zeros(256, dtype=bool)
            tab[list(meta[mpos:mpos + ns])] = True
            mpos += ns
            runs = []
            while mpos < len(meta):
                r, mpos = read_uint7(meta, mpos)
                runs.append(r)
            parsed.rle = True
            parsed.rle_tab = tab
            parsed.rle_runs = np.asarray(runs, dtype=np.int32)
            parsed.rle_out_len = rle_out_len
        parsed.inner_len = out_len

        if flags & F_CAT:
            payload = np.frombuffer(buf[pos:pos + out_len], np.uint8)
            if payload.shape[0] < out_len:
                return None  # truncated: host fails its own way
            parsed.payload = payload.copy()
        elif flags & F_ORDER1:
            head = buf[pos]
            pos += 1
            shift = head >> 4
            if not (1 <= shift <= TF_SHIFT):
                # target beyond 4096 (foreign) would blow the device
                # slot-table shape; host handles it
                return None
            target = 1 << shift
            if head & 1:
                ulen, pos = read_uint7(buf, pos)
                clen, pos = read_uint7(buf, pos)
                if ulen > 1 << 22:
                    return None  # host raises the canonical error
                table = _decode_rans0(buf, pos, ulen, 4)
                pos += clen
                syms, freqs, cums, _, _ = _read_freqs1_rows(
                    memoryview(table), 0, target)
            else:
                syms, freqs, cums, _, pos = _read_freqs1_rows(
                    buf, pos, target)
            ctx_index = np.full(256, -1, dtype=np.int16)
            alpha = np.asarray(syms, dtype=np.int64)
            rows = []
            for k, c in enumerate(syms):
                if int(cums[c][256]) != target:
                    # zero/degenerate row: the host's lut-of-zeros
                    # semantics aren't reproducible by the device
                    # searchsorted expansion — keep host semantics
                    return None
                ctx_index[c] = k
                # columns compacted to the alphabet: every nonzero
                # frequency lives on an alphabet symbol by
                # construction (_read_freqs1_rows only fills syms)
                rows.append(freqs[c][alpha])
            parsed.order1 = True
            parsed.shift = shift
            parsed.n_ctx = len(syms)
            parsed.ctx_index = ctx_index
            parsed.ctx_freq = np.stack(rows).astype(np.int32)
            parsed.alphabet = alpha.astype(np.int16)
            parsed.states = np.array(
                struct.unpack_from(f"<{n_states}I", buf, pos),
                dtype=np.uint32)
            pos += 4 * n_states
            parsed.payload = np.frombuffer(buf[pos:], np.uint8).copy()
        else:
            freqs, pos = _read_freqs0(buf, pos)
            cum = np.zeros(257, dtype=np.int64)
            np.cumsum(freqs, out=cum[1:])
            if int(cum[256]) != TOTFREQ:
                return None  # corrupt table: keep host semantics
            states = np.array(
                struct.unpack_from(f"<{n_states}I", buf, pos),
                dtype=np.uint32)
            pos += 4 * n_states
            parsed.freq = freqs.astype(np.int32)
            parsed.cum = cum.astype(np.int32)
            parsed.states = states
            parsed.payload = np.frombuffer(buf[pos:], np.uint8).copy()
        return parsed
    except (IndexError, ValueError, struct.error):
        return None


def encode(data: bytes, order: int = 0, use_rle: bool = False,
           use_pack: bool = False, stripe: int = 0,
           x32: bool = False, shift: int = TF_SHIFT) -> bytes:
    """Encode (fixture writer + fuzz twin for the decoder). Transforms
    apply PACK → RLE → rans, the exact inverse of decode's expansion
    order; tiny or degenerate bodies store CAT. ``shift`` is the ORDER1
    frequency precision (each context row sums to 2^shift)."""
    if stripe:
        lanes = [data[j::stripe] for j in range(stripe)]
        subs = [encode(ln, order=order, x32=x32, shift=shift)
                for ln in lanes]
        out = bytearray([F_STRIPE])
        out += write_uint7(len(data))
        out.append(stripe)
        for s in subs:
            out += write_uint7(len(s))
        for s in subs:
            out += s
        return bytes(out)
    flags = order & 1
    if x32:
        flags |= F_X32
    n_states = 32 if x32 else 4
    body = data
    meta = bytearray()
    final_len = len(data)
    if use_pack and body:
        res = _pack(body)
        if res is not None and (len(res[0]) < len(body) or not res[0]):
            packed, pmap = res
            flags |= F_PACK
            meta += bytes([len(pmap)]) + bytes(pmap)
            meta += write_uint7(len(packed))
            body = packed
    if use_rle:
        res = _rle_encode(body)
        if res is not None:
            lits, runs, rle_syms = res
            flags |= F_RLE
            m = bytes(bytearray([len(rle_syms) & 0xFF])
                      + bytes(rle_syms) + runs)
            mc = _encode_rans0(m, 4) if len(m) >= 32 else None
            if mc is not None and len(mc) + len(
                    write_uint7(len(m))) < len(m):
                meta += write_uint7(len(mc) << 1)  # low bit 0: compressed
                meta += write_uint7(len(lits))
                meta += write_uint7(len(m)) + mc
            else:
                meta += write_uint7((len(m) << 1) | 1)
                meta += write_uint7(len(lits))
                meta += m
            body = lits
    if len(body) < 4 * n_states or len(set(body)) <= 1:
        flags |= F_CAT
        payload = bytes(body)
    elif flags & F_ORDER1:
        payload = _encode_rans1(body, n_states, shift)
    else:
        payload = _encode_rans0(body, n_states)
    if not (flags & F_CAT) and len(payload) >= len(body):
        flags = (flags & ~F_ORDER1) | F_CAT
        payload = bytes(body)
    return bytes([flags]) + write_uint7(final_len) + bytes(meta) \
        + payload
