"""indexcov's cross-sample normalisation scan (pass 2): the hand-written
CUDA kernel (csrc/indexcov_norm.cu), its wrapper, and its plain PyTorch
version.

The counterpart of the JAX package's cohort/streaming.py::
apply_normalization, a ``jax.lax.scan`` over the bin axis (no Pallas
kernel). Eager PyTorch would pay about a dozen launches a bin (chr1 at
16 KB has 15,195 bins), and an associative scan would reorder the f32
additions, so the scan is one kernel: a block per 32 sample lanes, one
chain warp walking the bins (lane = sample) fed through a shared-memory
ring by producer warps that load coalesced along the bins and do the
divisions (the source's note has the design and its bounds).

The reference's source divides the 7-tap sum by 7.0, but XLA's
algebraic simplifier rewrites that as a multiply by float32(1/7), so the
reference's answer is the multiply; the plain version and the kernel
multiply by float32(1/7). (Pass 1, ``NormStats``, is the reference's f64
numpy and keeps its division.)

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back. The kernel
is compiled with ``nvcc -fmad=false`` for sm_90a at first use into
``build/torch/`` and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..device import KernelFault
from . import _nvcc

NVCC_FLAGS = [*_nvcc.BASE_FLAGS, "-fmad=false"]

_lock = threading.Lock()
_lib = None
#: ptxas report of the build (registers, shared memory, spills)
BUILD_LOG = ""
#: kernel launches per kernel name; incremented where the kernel is
#: launched and nowhere else
LAUNCHES = {"indexcov_norm": 0}

# the launch plan; the kernel is built for these and refuses another
#: sample lanes a block (the chain warp's lanes)
LANES = 32
#: bins a shared-memory stage holds
TILE_BINS = 64
#: producer warps a block (copies, divisions, flags, write-back)
PRODUCER_WARPS = 15
#: stages of the chain's ring (two named barriers each)
STAGES = 4
#: raw tiles of the producers' cp.async ring (three in flight)
LOAD_STAGES = 4


def stage_bytes() -> int:
    """Bytes of one stage of the chain's ring: (f, q1, q2, q3) float4s and
    the output floats as [bin][lane] rows of LANES + 1, and a flag word a
    32-bin chunk and lane."""
    return (TILE_BINS * (LANES + 1) * 16 + TILE_BINS * (LANES + 1) * 4
            + TILE_BINS // 32 * LANES * 4)


def load_stage_bytes() -> int:
    """Bytes of one raw tile: [bin][lane] rows of LANES + 1 floats for
    TILE_BINS + 3 bins (the look-ahead), and the tile's m and skip."""
    return (TILE_BINS + 3) * (LANES + 1) * 4 + TILE_BINS * 4 + TILE_BINS


def launch_plan(n: int, b: int) -> dict:
    """The launch of an (n samples, b bins) matrix: ceil(n / 32) blocks
    of a chain warp and PRODUCER_WARPS producer warps, ceil(b /
    TILE_BINS) tiles through LOAD_STAGES raw and STAGES chain stages of
    shared memory."""
    return {"blocks": -(-n // LANES), "lanes_per_block": LANES,
            "threads": 32 * (1 + PRODUCER_WARPS),
            "producer_warps": PRODUCER_WARPS, "tile_bins": TILE_BINS,
            "tiles": -(-b // TILE_BINS), "stages": STAGES,
            "load_stages": LOAD_STAGES,
            "smem_bytes": STAGES * stage_bytes()
            + LOAD_STAGES * load_stage_bytes()}


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        lib, BUILD_LOG = _nvcc.build("indexcov_norm.cu", NVCC_FLAGS,
                                     "indexcov_norm kernel")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.indexcov_norm_launch.argtypes = [p, p, p, p, p, *[i32] * 8, p]
        lib.indexcov_norm_launch.restype = ctypes.c_int
        lib.indexcov_norm_error_string.argtypes = [ctypes.c_int]
        lib.indexcov_norm_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def apply_normalization_plain(depths, lengths, m_all, skip_all):
    """The scan as a Python loop over the bins, batched over the sample
    lanes, in the reference's order of operations. ``depths`` (S, B)
    float32, ``lengths`` (S,) int32, ``m_all`` (B,) float32, ``skip_all``
    (B,) bool → (S, B) float32."""
    n, b = depths.shape
    raw_p = torch.cat([depths, depths.new_zeros(n, 3)], dim=1)
    out = torch.empty_like(depths)
    p0 = p1 = p2 = depths.new_zeros(n)
    # XLA rewrites the reference's ``/ 7.0`` as a multiply by float32(1/7)
    inv7 = torch.tensor(np.float32(1 / 7), device=depths.device)
    for j in range(b):
        m = m_all[j]
        col = raw_p[:, j]
        valid_j = lengths > j
        scaled = torch.where(valid_j, col / m, col)
        do_smooth = valid_j & (j > 2) & (j < lengths - 3)
        smoothed = (p0 + p1 + p2 + scaled + raw_p[:, j + 1] / m
                    + raw_p[:, j + 2] / m + raw_p[:, j + 3] / m) * inv7
        o = torch.where(do_smooth, smoothed, scaled)
        o = torch.where(skip_all[j], col, o)
        out[:, j] = o
        p0, p1, p2 = p1, p2, o
    return out


def _check(t: torch.Tensor, dtype, name: str, shape: tuple):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor of shape "
                         f"{shape}, got {tuple(t.shape)}")


def _launch(depths, lengths, m_all, skip_all):
    n, b = depths.shape
    dev = depths.device
    lib = load_library()
    out = torch.empty_like(depths)
    if n == 0 or b == 0:
        return out
    plan = launch_plan(n, b)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.indexcov_norm_launch(
            depths.data_ptr(), lengths.data_ptr(), m_all.data_ptr(),
            skip_all.data_ptr(), out.data_ptr(), n, b, plan["blocks"],
            plan["threads"], plan["tile_bins"], plan["stages"],
            plan["load_stages"], plan["smem_bytes"], stream)
    if rc != 0:
        raise KernelFault("indexcov_norm kernel launch failed: "
                          + lib.indexcov_norm_error_string(rc).decode())
    with _lock:
        LAUNCHES["indexcov_norm"] += 1
    return out


def norm_scan(depths, lengths, m_all, skip_all):
    """Pass-2 finalize of one sample chunk → (S, B) float32: ``depths``
    (S, B) float32 with each row's bins past ``lengths`` zero, ``lengths``
    (S,) int32, ``m_all`` (B,) float32 and ``skip_all`` (B,) bool, all
    contiguous and on one device. CPU tensors run the plain version; CUDA
    tensors launch the kernel (one launch a call, :func:`launch_plan`) or
    raise."""
    if depths.dim() != 2:
        raise ValueError(f"depths: expected (samples, bins), got "
                         f"{tuple(depths.shape)}")
    n, b = depths.shape
    _check(depths, torch.float32, "depths", (n, b))
    _check(lengths, torch.int32, "lengths", (n,))
    _check(m_all, torch.float32, "m_all", (b,))
    _check(skip_all, torch.bool, "skip_all", (b,))
    dev = depths.device
    if any(t.device != dev for t in (lengths, m_all, skip_all)):
        raise ValueError("indexcov_norm kernel: inputs on different "
                         "devices")
    if dev.type == "cpu":
        return apply_normalization_plain(depths, lengths, m_all, skip_all)
    if dev.type != "cuda":
        raise ValueError(f"indexcov_norm kernel: unsupported device {dev}")
    if skip_all.data_ptr() % 4:
        # the kernel copies skip 4 bytes at a time; a view at another
        # offset gets storage of its own
        skip_all = skip_all.clone()
    return _launch(depths, lengths, m_all, skip_all)
