"""Per-shard depth kernel: the hand-written CUDA kernel
(csrc/depth_kernel.cu), its wrappers, and its plain PyTorch version.

The counterpart of the JAX package's ops/pallas_coverage.py::pallas_depth,
extended to the whole device stage of ops/depth_pipeline.py: segment
endpoints in; window sums (f32) and 2-bit packed classes out, optionally
the dense capped depth and classes too. On the card a shard is one
memset of the workspace's head and two launches; see the source's
header for the design.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back. The kernel
is compiled with ``nvcc`` for sm_90a at first use into ``build/torch/``
and loaded with ctypes: the source includes no PyTorch header, so the
build is one short nvcc call (chip_smoke.py prints its seconds).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch

from ..device import KernelFault
from . import _nvcc
from .coverage import callable_classes

TILE = 1024  # positions per tile of the TPU kernel's host tiler
TILE_MAX = 4096  # positions per tile of launch B (csrc TILE_MAX)

NVCC_FLAGS = list(_nvcc.BASE_FLAGS)

_lock = threading.Lock()
_lib = None
#: ptxas report of the build (registers, shared memory, spills)
BUILD_LOG = ""
#: kernel launches per kernel name; incremented where the kernel is
#: launched and nowhere else
LAUNCHES = {"depth": 0}


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        lib, BUILD_LOG = _nvcc.build("depth_kernel.cu", NVCC_FLAGS,
                                     "depth kernel")
        p, i32, lng = ctypes.c_void_p, ctypes.c_int32, ctypes.c_long
        lib.depth_workspace_bytes.argtypes = [
            ctypes.c_int, lng, lng, lng, lng, lng, ctypes.POINTER(lng)]
        lib.depth_workspace_bytes.restype = lng
        lib.depth_pipeline_batch_launch.argtypes = [
            ctypes.c_int, p, p, p, p, p, lng, lng, i32, i32, i32, i32, i32,
            i32, i32, lng, lng, lng, p, p, p, lng, p, p, lng, p]
        lib.depth_pipeline_batch_launch.restype = ctypes.c_int
        lib.depth_kernel_error_string.argtypes = [ctypes.c_int]
        lib.depth_kernel_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


# ---- plain PyTorch version -------------------------------------------

def depth_plain(s: torch.Tensor, e: torch.Tensor,
                length: int) -> torch.Tensor:
    """int32 per-base depth over [0, length) from clipped endpoints in
    [0, length]; an endpoint equal to ``length`` contributes nothing.
    ``zeros(length+1).index_add_`` then ``cumsum``."""
    delta = torch.zeros(length + 1, dtype=torch.int32, device=s.device)
    ones = torch.ones(s.shape[0], dtype=torch.int32, device=s.device)
    delta.index_add_(0, s.long(), ones)
    delta.index_add_(0, e.long(), -ones)
    return torch.cumsum(delta[:length], 0, dtype=torch.int32)


def clip_endpoints_plain(seg_start, seg_end, keep, w0: int, rs: int,
                         re: int, length: int):
    """Region clip of _pipeline_body: shard-relative endpoints in
    [0, length], keep-masked segments sent to ``length``."""
    s = torch.clamp(torch.clamp_min(seg_start, rs) - w0, 0, length)
    e = torch.clamp(torch.clamp_max(seg_end, re) - w0, 0, length)
    return torch.where(keep, s, length), torch.where(keep, e, length)


def unpack_wire_plain(deltas, lens, base: int):
    """u16 wire (sorted start deltas + lengths) → absolute int32
    endpoints + keep mask; zero-length entries are padding/gap fillers."""
    seg_start = base + torch.cumsum(deltas.to(torch.int32), 0,
                                    dtype=torch.int32)
    lens32 = lens.to(torch.int32)
    return seg_start, seg_start + lens32, lens32 > 0


def pack_cls_2bit(cls: torch.Tensor, length: int) -> torch.Tensor:
    """int8 classes (0..3) → 2-bit packed uint8, low bits first."""
    pad = (-length) % 4
    c4 = torch.cat([cls, cls.new_zeros(pad)]).reshape(-1, 4).to(torch.uint8)
    return c4[:, 0] | (c4[:, 1] << 2) | (c4[:, 2] << 4) | (c4[:, 3] << 6)


def epilogue_plain(depth, w0: int, rs: int, re: int, cap: int,
                   min_cov: int, max_mean: int, window: int):
    """Cap, in-region mask, window sums (int64, cast once to f32),
    classes and the 2-bit pack → (sums, packed, cls, depth)."""
    length = depth.shape[0]
    d = torch.clamp_max(depth, cap)
    pos = torch.arange(length, dtype=torch.int32, device=d.device) + w0
    d = torch.where((pos >= rs) & (pos < re), d, 0)
    sums = d.to(torch.int64).reshape(-1, window).sum(dim=1).to(torch.float32)
    cls = callable_classes(d, min_cov, max_mean)
    return sums, pack_cls_2bit(cls, length), cls, d


def fused_depth_plain(seg_start, seg_end, keep, w0, rs, re, cap, min_cov,
                      max_mean, length, window):
    s, e = clip_endpoints_plain(seg_start, seg_end, keep, w0, rs, re, length)
    return epilogue_plain(depth_plain(s, e, length), w0, rs, re, cap,
                          min_cov, max_mean, window)


def fused_depth_wire_plain(deltas, lens, base, w0, rs, re, cap, min_cov,
                           max_mean, length, window):
    s, e, keep = unpack_wire_plain(deltas, lens, base)
    return fused_depth_plain(s, e, keep, w0, rs, re, cap, min_cov,
                             max_mean, length, window)


def fused_depth_batch_plain(a, b, offsets, w0, rs, re, cap, min_cov,
                            max_mean, length, window, keep=None,
                            bases=None):
    """The plain version of a batch: each sample's plain version (the
    u16 wire when ``bases`` is given, else the int32 wire with ``keep``)
    on its entries ``offsets[s]:offsets[s + 1]``, stacked →
    (sums (B, n_win), packed (B, ceil(length/4)), cls (B, length) i8,
    depth (B, length) i32)."""
    outs = []
    for s in range(len(offsets) - 1):
        lo, hi = int(offsets[s]), int(offsets[s + 1])
        if bases is not None:
            out = fused_depth_wire_plain(a[lo:hi], b[lo:hi], int(bases[s]),
                                         w0, rs, re, cap, min_cov,
                                         max_mean, length, window)
        else:
            out = fused_depth_plain(a[lo:hi], b[lo:hi], keep[lo:hi], w0, rs,
                                    re, cap, min_cov, max_mean, length,
                                    window)
        outs.append(out)
    return tuple(torch.stack(col) for col in zip(*outs))


# ---- wrappers ---------------------------------------------------------

def _check(t: torch.Tensor, dtype, name: str, n: int | None = None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.dim() != 1:
        raise ValueError(f"{name}: expected a contiguous 1-D tensor")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name}: expected {n} entries, got {t.shape[0]}")


def tile_positions(window: int) -> int:
    """Positions of one tile of the kernel's launch B: the largest
    multiple of lcm(window, 16) up to TILE_MAX, so that a tile holds
    whole windows and whole 16-position thread groups; TILE_MAX when
    lcm(window, 16) is wider (such windows are summed across tiles)."""
    step = math.lcm(window, 16)
    return TILE_MAX // step * step if step <= TILE_MAX else TILE_MAX


@functools.lru_cache(maxsize=64)
def _workspace(wire: int, n: int, length: int, window: int, batch: int = 1):
    """(tile, workspace bytes, bytes to zero) of one launch of ``batch``
    samples of at most ``n`` entries each."""
    tile = tile_positions(window)
    zeroed = ctypes.c_long()
    total = load_library().depth_workspace_bytes(
        wire, n, length, window, tile, batch, ctypes.byref(zeroed))
    return tile, total, zeroed.value


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _launch(wire: int, a, b, keep, base, w0, rs, re, cap, min_cov,
            max_mean, length: int, window: int, dense: bool,
            offsets=None):
    """One launch: a single shard (``offsets`` None; ``base`` an int)
    or a batch (``offsets`` the B + 1 host entry offsets; ``base`` the
    B u16-wire bases, None on the int32 wire), whose outputs gain a
    leading batch axis."""
    if length < 1 or length % window or length >= 2**31 - TILE_MAX:
        raise ValueError(f"depth kernel: bad length {length} / window "
                         f"{window}")
    dev = a.device
    if b.device != dev or (keep is not None and keep.device != dev):
        raise ValueError("depth kernel: inputs on different devices")
    batched = offsets is not None
    if batched:
        offsets = [int(o) for o in offsets]
        nb = len(offsets) - 1
        counts = np.diff(offsets)
        if nb < 1 or offsets[0] != 0 or offsets[-1] != a.shape[0] \
                or (counts < 0).any():
            raise ValueError("depth kernel: bad batch offsets")
        n = bucket_entries(int(counts.max()))
    else:
        nb, n = 1, a.shape[0]
    lib = load_library()
    tile, total, zeroed = _workspace(wire, n, length, window, nb)
    n_win, plen = length // window, (length + 3) // 4
    ld_packed, ld_pos = _align16(plen), _align16(length)
    ws = torch.empty(total, dtype=torch.uint8, device=dev)
    sums = torch.empty((nb, n_win), dtype=torch.float32, device=dev)
    packed = torch.empty((nb, ld_packed), dtype=torch.uint8, device=dev)
    depth = torch.empty((nb, ld_pos), dtype=torch.int32, device=dev) \
        if dense else None
    cls = torch.empty((nb, ld_pos), dtype=torch.int8, device=dev) \
        if dense else None
    offs_d = bases_d = None
    if batched:
        offs_d = torch.tensor(offsets, dtype=torch.int64).to(dev)
        if wire:
            bases_d = torch.tensor([int(x) for x in base],
                                   dtype=torch.int32).to(dev)
        base = 0

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    with torch.cuda.device(dev):
        ws[:zeroed].zero_()  # the one memset
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.depth_pipeline_batch_launch(
            wire, ptr(a), ptr(b), ptr(keep), ptr(offs_d), ptr(bases_d), n,
            nb, int(base), int(w0), int(rs), int(re), int(cap),
            int(min_cov), int(max_mean), length, window, tile, ptr(ws),
            ptr(sums), ptr(packed), ld_packed, ptr(depth), ptr(cls),
            ld_pos, stream)
    if rc != 0:
        raise KernelFault("depth kernel launch failed: "
                          + lib.depth_kernel_error_string(rc).decode())
    with _lock:
        LAUNCHES["depth"] += 1
    packed = packed[:, :plen]
    if dense:
        depth, cls = depth[:, :length], cls[:, :length]
    if batched:
        return sums, packed, cls, depth
    return (sums[0], packed[0], None if cls is None else cls[0],
            None if depth is None else depth[0])


def bucket_entries(n: int) -> int:
    """The entry count a batch's workspace is laid out for: the next
    power of two >= n (at least 1,024), so that batches of similar
    shards reuse one layout."""
    b = 1024
    while b < n:
        b <<= 1
    return b


def fused_depth(seg_start, seg_end, keep, w0, rs, re, cap, min_cov,
                max_mean, length: int, window: int, dense: bool = False):
    """int32 endpoints + bool keep mask → (sums f32 (length//window,),
    packed u8 (ceil(length/4),), cls i8 | None, depth i32 | None); the
    dense per-base outputs only when ``dense``."""
    n = seg_start.shape[0]
    _check(seg_start, torch.int32, "seg_start")
    _check(seg_end, torch.int32, "seg_end", n)
    _check(keep, torch.bool, "keep", n)
    if seg_start.device.type == "cpu":
        out = fused_depth_plain(seg_start, seg_end, keep, w0, rs, re, cap,
                                min_cov, max_mean, length, window)
        return out if dense else (out[0], out[1], None, None)
    return _launch(0, seg_start, seg_end, keep.view(torch.uint8), 0, w0,
                   rs, re, cap, min_cov, max_mean, length, window, dense)


def fused_depth_wire(deltas, lens, base, w0, rs, re, cap, min_cov,
                     max_mean, length: int, window: int,
                     dense: bool = False):
    """The packed u16 wire (sorted start deltas + lengths from ``base``)
    → the same outputs as :func:`fused_depth`."""
    _check(deltas, torch.uint16, "deltas")
    _check(lens, torch.uint16, "lens", deltas.shape[0])
    if deltas.device.type == "cpu":
        out = fused_depth_wire_plain(deltas, lens, int(base), w0, rs, re,
                                     cap, min_cov, max_mean, length, window)
        return out if dense else (out[0], out[1], None, None)
    return _launch(1, deltas, lens, None, base, w0, rs, re, cap, min_cov,
                   max_mean, length, window, dense)


def fused_depth_batch(a, b, offsets, w0, rs, re, cap, min_cov, max_mean,
                      length: int, window: int, keep=None, bases=None,
                      dense: bool = False):
    """B samples over one region in one launch. ``a``, ``b``: the
    samples' entries back to back, sample s's at ``offsets[s]:offsets[s
    + 1]`` (``offsets``: B + 1 host ints); the u16 wire (deltas, lens)
    when ``bases`` (B host ints) is given, else the int32 wire (seg_start,
    seg_end) with the bool ``keep``. → (sums f32 (B, length//window),
    packed u8 (B, ceil(length/4)), cls i8 (B, length) | None, depth i32
    (B, length) | None); row s equals :func:`fused_depth` (or
    :func:`fused_depth_wire`) on sample s alone."""
    wire = bases is not None
    dt = torch.uint16 if wire else torch.int32
    _check(a, dt, "a")
    _check(b, dt, "b", a.shape[0])
    if not wire:
        _check(keep, torch.bool, "keep", a.shape[0])
    if wire and len(bases) != len(offsets) - 1:
        raise ValueError("depth kernel: one base a sample")
    if a.device.type == "cpu":
        out = fused_depth_batch_plain(a, b, offsets, w0, rs, re, cap,
                                      min_cov, max_mean, length, window,
                                      keep=keep, bases=bases)
        return out if dense else (out[0], out[1], None, None)
    return _launch(int(wire), a, b,
                   None if wire else keep.view(torch.uint8), bases, w0, rs,
                   re, cap, min_cov, max_mean, length, window, dense,
                   offsets=offsets)


# ---- host tiler of the TPU kernel, for the tests ------------------------

SENTINEL = np.int32(2**31 - 1)
_CHUNK = 128


def bucket_endpoints(seg_start: np.ndarray, seg_end: np.ndarray,
                     keep: np.ndarray, length: int,
                     p_cap: int | None = None):
    """Host-side tiling of the TPU kernel (a copy of the JAX package's
    ops/pallas_coverage.py::bucket_endpoints): endpoints sorted and
    bucketed per TILE-base tile, padded to a fixed per-tile capacity with
    SENTINEL. Endpoints ≥ length are dropped. Returns (starts_tiled,
    ends_tiled, n_tiles). The port does not need it; the tests use it to
    feed the TPU kernel the same endpoints as the port."""
    n_tiles = (length + TILE - 1) // TILE
    ss = np.sort(seg_start[keep])
    ee = np.sort(seg_end[keep])
    ss = ss[(ss >= 0) & (ss < length)]
    ee = ee[(ee >= 0) & (ee < length)]
    bounds = np.arange(n_tiles + 1, dtype=np.int64) * TILE
    s_off = np.searchsorted(ss, bounds)
    e_off = np.searchsorted(ee, bounds)
    max_n = int(max(np.diff(s_off).max(initial=0),
                    np.diff(e_off).max(initial=0), 1))
    if p_cap is None:
        p_cap = _CHUNK
        while p_cap < max_n:
            p_cap *= 2
    elif max_n > p_cap:
        raise ValueError(f"p_cap {p_cap} < densest tile {max_n}")
    st = np.full((n_tiles, p_cap), SENTINEL, dtype=np.int32)
    et = np.full((n_tiles, p_cap), SENTINEL, dtype=np.int32)
    if len(ss):
        qs = ss // TILE
        st[qs, np.arange(len(ss)) - s_off[qs]] = ss
    if len(ee):
        qe = ee // TILE
        et[qe, np.arange(len(ee)) - e_off[qe]] = ee
    return st, et, n_tiles
