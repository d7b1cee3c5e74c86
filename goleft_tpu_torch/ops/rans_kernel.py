"""rANS-Nx16 ORDER0 / ORDER1 entropy stage: the hand-written CUDA kernel
(csrc/rans_kernel.cu), its wrapper, and its plain PyTorch version.

The counterpart of the JAX package's ops/rans_device.py::pallas_decode0
(the TPU kernel of the ORDER0 stage) and of the ORDER1 branch of its XLA
scan ``_decode_bucket_impl``. Inputs are one launch group of parsed
streams (io/rans_nx16.py::ParsedNx16): their payloads back to back at
16-byte-aligned offsets, their tables padded to a common shape; outputs
are the decoded symbols of each stream in linear order, zero past its
``inner_len``, and for ORDER1 the missing-context diagnostic. See the
source's header for the design.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back. The kernel
is compiled with ``nvcc`` for sm_90a at first use into ``build/torch/``
and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..device import KernelFault
from . import _nvcc

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT
RANS_LOW = 1 << 15
#: most contexts an ORDER1 table holds (csrc/rans_kernel.cu MAX_CTX)
MAX_CTX = 256
#: bytes a launch group's payload buffer runs on past every stream's end:
#: the kernel copies whole 4 KB chunks, two ahead (csrc/rans_kernel.cu RING)
PAYLOAD_TAIL = 8192
_M32 = 0xFFFFFFFF

NVCC_FLAGS = list(_nvcc.BASE_FLAGS)

_lock = threading.Lock()
_lib = None
#: ptxas report of the build (registers, shared memory, spills)
BUILD_LOG = ""
#: kernel launches per kernel name; incremented where the kernel is
#: launched and nowhere else
LAUNCHES = {"rans": 0}


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        lib, BUILD_LOG = _nvcc.build("rans_kernel.cu", NVCC_FLAGS,
                                     "rans kernel")
        p, i32, lng = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.rans_order0_launch.argtypes = [p, lng, p, p, p, p, p, i32,
                                           i32, p, lng, p]
        lib.rans_order0_launch.restype = ctypes.c_int
        lib.rans_order1_launch.argtypes = [p, lng, p, p, p, p, p, p, i32,
                                           p, i32, i32, i32, p, lng, p, p]
        lib.rans_order1_launch.restype = ctypes.c_int
        lib.rans_kernel_error_string.argtypes = [ctypes.c_int]
        lib.rans_kernel_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def rounds_needed(inner_len: torch.Tensor, n_states: int,
                  order1: bool) -> int:
    """Rounds the longest stream of a bucket needs: ceil(inner/N) for
    ORDER0, F + (inner - N·F) (the last lane's slice) for ORDER1, where
    a shorter stream can need more rounds than a longer one."""
    if inner_len.numel() == 0:
        return 0
    n = inner_len.to(torch.int64)
    if order1:
        return int((n // n_states + n % n_states).max())
    return int(((n + n_states - 1) // n_states).max())


def payload_rows(payload, poff, plen, width: int) -> torch.Tensor:
    """(B, width) u8: stream b's bytes, payload[16·poff[b]:][:plen[b]],
    zero past plen[b], from the ragged payload of a launch group. Reads
    nothing back from the device."""
    col = torch.arange(width, device=payload.device)[None, :]
    ok = col < plen[:, None]
    if payload.numel() == 0:
        return torch.zeros(ok.shape, dtype=torch.uint8, device=ok.device)
    rows = payload[torch.where(ok, poff.to(torch.int64)[:, None] * 16 + col,
                               0)]
    return torch.where(ok, rows, 0).to(torch.uint8)


# ---- plain PyTorch version -------------------------------------------
#
# uint32 arithmetic held in int64. With a table the parser accepts (every
# frequency <= 2^shift, each row summing to 2^shift) f·(R >> shift) + bias
# stays below 2^32 and a renormalising state below 2^31, so no step wraps.


def _words(payload: torch.Tensor) -> torch.Tensor:
    """(B, P) int64: the little-endian 16-bit word at every byte offset
    (the last offset pairs its byte with itself, as the reference's
    clipped gathers do; a granted read never reaches it)."""
    pay = payload.to(torch.int64)
    nxt = torch.cat([pay[:, 1:], pay[:, -1:]], 1)
    return pay | (nxt << 8)


def _renorm_plain(x, want, words, plen, pos):
    """Steps 3-4 of a round, batched over (B, N): exclusive rank by
    cumsum, bytes-left guard, 16-bit reads at pos + 2·rank. Returns
    (x, pos)."""
    wi = want.to(torch.int64)
    rank = torch.cumsum(wi, 1) - wi
    avail = torch.clamp_min((plen - pos) >> 1, 0)
    need = want & (rank < avail[:, None])
    offs = torch.clamp(pos[:, None] + 2 * rank, max=words.shape[1] - 1)
    xr = (x << 16) | words.gather(1, offs)
    return torch.where(need, xr, x), pos + 2 * need.sum(1)


def order0_plain(payload, plen, states, freq, inner_len, n_states: int,
                 out_len: int) -> torch.Tensor:
    """The ORDER0 branch of ``_decode_bucket_impl`` as a Python loop over
    rounds, batched over (B, N): the slot table by searchsorted over the
    freq row, packed as freq << 20 | bias << 8 | symbol. Returns
    (B, out_len) uint8, zero past each inner_len."""
    dev = payload.device
    B, N = payload.shape[0], n_states
    f = freq.to(torch.int64)
    cum = torch.cat([torch.zeros(B, 1, dtype=torch.int64, device=dev),
                     torch.cumsum(f, 1)], 1)
    ms = torch.arange(TOTFREQ, device=dev).expand(B, TOTFREQ).contiguous()
    sym = torch.clamp(torch.searchsorted(cum, ms, right=True) - 1, 0, 255)
    table = (f.gather(1, sym) << 20) | ((ms - cum.gather(1, sym)) << 8) | sym
    words = _words(payload)
    R = states.to(torch.int64) & _M32
    plen64 = plen.to(torch.int64)
    inner = inner_len.to(torch.int64)
    lim = inner[:, None] - torch.arange(N, device=dev)[None, :]
    pos = torch.zeros(B, dtype=torch.int64, device=dev)
    rounds = rounds_needed(inner_len, N, False)
    out = torch.zeros(B, max(rounds * N, out_len), dtype=torch.uint8,
                      device=dev)
    for r in range(rounds):
        active = lim > r * N
        t = table.gather(1, R & (TOTFREQ - 1))
        x = (t >> 20) * (R >> TF_SHIFT) + ((t >> 8) & (TOTFREQ - 1))
        x, pos = _renorm_plain(x, active & (x < RANS_LOW), words, plen64,
                               pos)
        R = torch.where(active, x, R)
        out[:, r * N:(r + 1) * N] = t & 0xFF
    out = out[:, :out_len]
    return torch.where(torch.arange(out_len, device=dev)[None, :]
                       < inner[:, None], out, 0).contiguous()


def order1_plain(payload, plen, states, ctx_index, ctx_freq, alphabet,
                 inner_len, n_states: int, shift: int, out_len: int):
    """The ORDER1 branch of ``_decode_bucket_impl`` as a Python loop over
    rounds, batched over (B, N): lane j decodes [j·F, (j+1)·F) (the last
    lane the tail) with its previous symbol as context; the slot of
    (row, m) is the searchsorted of m in the row's cumulative compact
    frequencies. Returns ((B, out_len) uint8 zero past inner_len,
    (B,) int32 missing-context diagnostic)."""
    dev = payload.device
    B, N = payload.shape[0], n_states
    C = ctx_freq.shape[1]
    cum1 = torch.cat([torch.zeros(B, C, 1, dtype=torch.int64, device=dev),
                      torch.cumsum(ctx_freq.to(torch.int64), 2)], 2)
    ci = ctx_index.to(torch.int64)
    alpha = alphabet.to(torch.int64)
    words = _words(payload)
    R = states.to(torch.int64) & _M32
    plen64 = plen.to(torch.int64)
    inner = inner_len.to(torch.int64)
    F = torch.div(inner, N, rounding_mode="floor")
    lanes = torch.arange(N, device=dev)[None, :]
    lens = F[:, None] + torch.where(lanes == N - 1,
                                    (inner - F * N)[:, None], 0)
    start = lanes * F[:, None]
    bidx = torch.arange(B, device=dev)[:, None].expand(B, N)
    pos = torch.zeros(B, dtype=torch.int64, device=dev)
    last = torch.zeros(B, N, dtype=torch.int64, device=dev)
    bad = torch.zeros(B, dtype=torch.bool, device=dev)
    mask = (1 << shift) - 1
    rounds = rounds_needed(inner_len, N, True)
    out = torch.zeros(B, max(int(inner.max()) if B else 0, out_len) + 1,
                      dtype=torch.uint8, device=dev)
    for r in range(rounds):
        active = lens > r
        row = ci.gather(1, last)
        bad |= (active & (row < 0)).any(1)
        rows = cum1[bidx, torch.clamp(row, 0, C - 1)]  # (B, N, C + 1)
        m = R & mask
        col = torch.clamp(torch.searchsorted(rows, m[..., None],
                                             right=True) - 1, 0, C - 1)
        lo_hi = rows.gather(2, torch.cat([col, col + 1], 2))
        lo = lo_hi[..., 0]
        s = alpha.gather(1, col[..., 0])
        x = (lo_hi[..., 1] - lo) * (R >> shift) + (m - lo)
        x, pos = _renorm_plain(x, active & (x < RANS_LOW), words, plen64,
                               pos)
        R = torch.where(active, x, R)
        last = torch.where(active, s, last)
        # inactive lanes write to the spare last column
        dst = torch.where(active, start + r, out.shape[1] - 1)
        out.scatter_(1, dst, (s & 0xFF).to(torch.uint8))
    out[:, -1] = 0
    return out[:, :out_len].contiguous(), bad.to(torch.int32)


# ---- wrapper ------------------------------------------------------------

def _check(t: torch.Tensor, dtype, name: str, shape: tuple):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected a contiguous {shape} tensor, "
                         f"got {tuple(t.shape)}")


def rans_decode(payload, poff, plen, states, inner_len, *, n_states: int,
                out_len: int, freq=None, ctx_index=None, ctx_freq=None,
                alphabet=None, shift: int = TF_SHIFT):
    """Decode the rANS stage of B streams of one launch group.

    payload u8 (P,), 16-byte aligned with P a multiple of 16, holds the
    streams back to back: stream b is plen[b] bytes from byte
    16·poff[b] on (poff i32 (B,), in 16-byte units: the kernel copies a
    stream into shared memory 16 bytes at a time, and reads its 16-bit
    words at even offsets only: the read pointer starts at 0 and moves
    by whole words), and the buffer runs on ``PAYLOAD_TAIL`` bytes past
    every stream's end (the kernel copies whole chunks; on the card a
    launch traps on a shorter buffer, and the wait on its stream,
    ``rans_device._sync``, raises ``KernelFault``);
    plen, inner_len i32 (B,); states i32 (B, N) holding the uint32 bits;
    ORDER0: freq i16 (B, 256); ORDER1: ctx_index i16 (B, 256), ctx_freq
    i16 (B, C, C), alphabet i16 (B, C) and ``shift``.
    ``out_len`` must cover every inner_len (the kernel drops symbols past
    it). Returns ((B, out_len) u8
    symbols, zero past each inner_len; (B,) i32 missing-context flags for
    ORDER1, None for ORDER0)."""
    order1 = ctx_freq is not None
    B = plen.shape[0]
    _check(payload, torch.uint8, "payload", (payload.numel(),))
    _check(poff, torch.int32, "poff", (B,))
    _check(plen, torch.int32, "plen", (B,))
    _check(inner_len, torch.int32, "inner_len", (B,))
    _check(states, torch.int32, "states", (B, n_states))
    if n_states not in (4, 32):
        raise ValueError(f"rans: n_states must be 4 or 32, not {n_states}")
    if payload.numel() % 16 or payload.data_ptr() % 16:
        raise ValueError("rans: the payload must start 16-byte aligned "
                         "and be a multiple of 16 bytes long (got "
                         f"{payload.numel()} bytes at {payload.data_ptr()})")
    if order1:
        C = ctx_freq.shape[1]
        if not 1 <= C <= MAX_CTX or not 1 <= shift <= TF_SHIFT:
            raise ValueError(f"rans: bad ORDER1 table ({C} contexts, "
                             f"shift {shift})")
        _check(ctx_index, torch.int16, "ctx_index", (B, 256))
        _check(ctx_freq, torch.int16, "ctx_freq", (B, C, C))
        _check(alphabet, torch.int16, "alphabet", (B, C))
        tables = (ctx_index, ctx_freq, alphabet)
    else:
        _check(freq, torch.int16, "freq", (B, 256))
        tables = (freq,)
    dev = payload.device
    if any(t.device != dev
           for t in (poff, plen, states, inner_len, *tables)):
        raise ValueError("rans kernel: inputs on different devices")
    if dev.type == "cpu":
        return rans_decode_plain(
            payload, poff, plen, states, inner_len, n_states=n_states,
            out_len=out_len, freq=freq, ctx_index=ctx_index,
            ctx_freq=ctx_freq, alphabet=alphabet, shift=shift)
    return _launch(order1, payload, poff, plen, states, inner_len, tables,
                   n_states, out_len, shift)


def rans_decode_plain(payload, poff, plen, states, inner_len, *,
                      n_states: int, out_len: int, freq=None,
                      ctx_index=None, ctx_freq=None, alphabet=None,
                      shift: int = TF_SHIFT):
    """The plain PyTorch version of :func:`rans_decode`, run where the
    tensors lie (the CPU path, and the card's comparisons): the streams
    cut out of the payload as rows as wide as the longest, rounded up to
    16 bytes."""
    end = poff.to(torch.int64) * 16 + plen + PAYLOAD_TAIL
    if plen.numel() and int(end.max()) > payload.numel():
        raise ValueError("rans: a stream runs past the end of the payload "
                         f"or its {PAYLOAD_TAIL}-byte tail")
    width = -(-max(int(plen.max()) if plen.numel() else 0, 1) // 16) * 16
    rows = payload_rows(payload, poff, plen, width)
    if ctx_freq is not None:
        return order1_plain(rows, plen, states, ctx_index, ctx_freq,
                            alphabet, inner_len, n_states, shift, out_len)
    return order0_plain(rows, plen, states, freq, inner_len, n_states,
                        out_len), None


def _launch(order1, payload, poff, plen, states, inner_len, tables,
            n_states, out_len, shift):
    lib = load_library()
    dev = payload.device
    B = plen.shape[0]
    # the kernel flushes symbols in 16-byte stores: a row stride that is
    # a multiple of 16, cut back to out_len for the caller
    stride = -(-out_len // 16) * 16
    out = torch.empty((B, stride), dtype=torch.uint8, device=dev)
    bad = torch.empty(B, dtype=torch.int32, device=dev) if order1 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if order1:
            ctx_index, ctx_freq, alphabet = tables
            rc = lib.rans_order1_launch(
                payload.data_ptr(), payload.numel(), poff.data_ptr(),
                plen.data_ptr(),
                states.data_ptr(), ctx_index.data_ptr(),
                ctx_freq.data_ptr(), alphabet.data_ptr(), ctx_freq.shape[1],
                inner_len.data_ptr(), n_states, shift, B, out.data_ptr(),
                stride, bad.data_ptr(), stream)
        else:
            rc = lib.rans_order0_launch(
                payload.data_ptr(), payload.numel(), poff.data_ptr(),
                plen.data_ptr(),
                states.data_ptr(), tables[0].data_ptr(),
                inner_len.data_ptr(), n_states, B, out.data_ptr(), stride,
                stream)
    if rc != 0:
        raise KernelFault("rans kernel launch failed: "
                          + lib.rans_kernel_error_string(rc).decode())
    with _lock:
        LAUNCHES["rans"] += 1
    return out[:, :out_len], bad
