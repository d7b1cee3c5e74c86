"""Banded Smith-Waterman wavefront of one bucket: the hand-written CUDA
kernel (csrc/swalign_kernel.cu) and its launch.

The counterpart of the JAX package's ops/swalign.py::_sw_bucket_impl, the
XLA program of the mapper's extend stage. The plain PyTorch version and
the wrapper that chooses between them live in ops/swalign.py
(``sw_bucket_plain``, ``sw_bucket``); this module builds the kernel with
``nvcc`` for sm_90a at first use into ``build/torch/``, loads it with
ctypes and launches it. Nothing here falls back.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..device import KernelFault
from . import _nvcc

#: integer operations a lane-step, for the compute bound: the window
#: column, its clip, base and validity (7), the match test and
#: substitution (4), h_diag, E and F (8), H (3), the source and the two
#: extend bits (7), the masking (3) and the best-cell compare (1)
OPS_PER_LANE_STEP = 33

NVCC_FLAGS = list(_nvcc.BASE_FLAGS)

_lock = threading.Lock()
_lib = None
#: ptxas report of the build (registers, shared memory, spills)
BUILD_LOG = ""
#: kernel launches per kernel name; incremented where the kernel is
#: launched and nowhere else
LAUNCHES = {"swalign": 0}


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        lib, BUILD_LOG = _nvcc.build("swalign_kernel.cu", NVCC_FLAGS,
                                     "swalign kernel")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.swalign_plan.argtypes = [i32, ctypes.POINTER(i32),
                                     ctypes.POINTER(i32)]
        lib.swalign_plan.restype = None
        lib.swalign_launch.argtypes = [p, p, p, p, p, i32, i32, i32,
                                       p, p, p, p, p, p]
        lib.swalign_launch.restype = ctypes.c_int
        lib.swalign_kernel_error_string.argtypes = [ctypes.c_int]
        lib.swalign_kernel_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def launch_plan(r1: int) -> tuple[int, int]:
    """(threads a block, int32 of device scratch a pair) for a bucket of
    ``r1`` read lanes, as the kernel's ``swalign_plan`` decides them:
    the scratch is 0 when the wavefront rows live in shared memory."""
    threads, scratch = ctypes.c_int(), ctypes.c_int()
    load_library().swalign_plan(r1, ctypes.byref(threads),
                                ctypes.byref(scratch))
    return threads.value, scratch.value


def launch(reads_p, rlens, wins, wlens, scores):
    """Run the kernel on CUDA tensors the caller has checked → (best,
    bi, bj (B,) int32, dirs (B, r1 + w_pad, r1) uint8)."""
    b, r1 = reads_p.shape
    wcap = wins.shape[1]
    dev = reads_p.device
    lib = load_library()
    _, scratch = launch_plan(r1)
    best = torch.empty(b, dtype=torch.int32, device=dev)
    bi = torch.empty(b, dtype=torch.int32, device=dev)
    bj = torch.empty(b, dtype=torch.int32, device=dev)
    dirs = torch.empty((b, r1 + wcap, r1), dtype=torch.uint8, device=dev)
    state = None
    if scratch:
        state = torch.empty(b * scratch, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.swalign_launch(
            reads_p.data_ptr(), rlens.data_ptr(), wins.data_ptr(),
            wlens.data_ptr(), scores.data_ptr(), b, r1, wcap,
            None if state is None else state.data_ptr(), best.data_ptr(),
            bi.data_ptr(), bj.data_ptr(), dirs.data_ptr(), stream)
    if rc != 0:
        raise KernelFault("swalign kernel launch failed: "
                          + lib.swalign_kernel_error_string(rc).decode())
    with _lock:
        LAUNCHES["swalign"] += 1
    return best, bi, bj, dirs
