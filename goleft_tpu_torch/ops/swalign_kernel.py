"""Banded Smith-Waterman of one bucket: the hand-written CUDA kernel
(csrc/swalign_kernel.cu) and its launch.

The counterpart of the JAX package's ops/swalign.py::_sw_bucket_impl, the
XLA program of the mapper's extend stage, and of the host traceback that
followed it. The plain PyTorch versions and the wrappers that choose
between them live in ops/swalign.py (``sw_align_plain``, ``sw_align``,
``sw_bucket``); this module builds the kernel with ``nvcc`` for sm_90a at
first use into ``build/torch/``, loads it with ctypes and launches it.
Nothing here falls back.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from ..device import KernelFault
from . import _nvcc

#: int32 instructions a cell that the recurrence, its direction bits and
#: the best cell need at the least, for the compute bound: the match
#: test and the substitution's select (2), h_diag (1), E and F with
#: their extend bits (3 each: two adds and one __vibmax_s32), H (1,
#: __vimax3_s32_relu), H's source (3: two equality tests and the stop
#: test), the nibble into the plane's word (2) and the best-cell compare
#: (1). A DPX instruction that fuses an add and a max counts once.
OPS_PER_CELL = 16

NVCC_FLAGS = list(_nvcc.BASE_FLAGS)

_lock = threading.Lock()
_lib = None
#: ptxas report of the build (registers, shared memory, spills)
BUILD_LOG = ""
#: kernel launches per kernel name; incremented where the kernel is
#: launched and nowhere else
LAUNCHES = {"swalign": 0}


class Plan(NamedTuple):
    """A bucket's launch plan, as the kernel's ``swalign_plan`` decides
    it."""

    rows_per_lane: int   # R: read rows a lane, in registers
    bands: int           # bands of 32 R rows, one after the other
    pairs_per_block: int  # one warp a pair
    scratch_ints: int    # int32 of device scratch a pair (band rows)
    plane_steps: int     # plane words a lane a band: r1 + w_pad + 29


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        lib, BUILD_LOG = _nvcc.build("swalign_kernel.cu", NVCC_FLAGS,
                                     "swalign kernel")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.swalign_plan.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 5
        lib.swalign_plan.restype = None
        lib.swalign_launch.argtypes = [p, p, p, p, p, i32, i32, i32,
                                       p, p, p, p, p]
        lib.swalign_launch.restype = ctypes.c_int
        lib.swalign_kernel_error_string.argtypes = [ctypes.c_int]
        lib.swalign_kernel_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


@functools.lru_cache(maxsize=None)
def launch_plan(r1: int, wcap: int) -> Plan:
    """The plan of a bucket of ``r1`` read lanes and ``wcap`` window
    columns, as the kernel's ``swalign_plan`` decides it."""
    out = [ctypes.c_int() for _ in Plan._fields]
    load_library().swalign_plan(r1, wcap, *map(ctypes.byref, out))
    return Plan(*(x.value for x in out))


def launch(reads_p, rlens, wins, wlens, scores):
    """Run the kernel on CUDA tensors the caller has checked → (meta
    (6, B) int32: best, bi, bj, read_start, win_start, runs; runs
    (r1 + w_pad, B) int32, a pair's first meta[5] rows its CIGAR's
    run-length ops; plane (B, bands, plane_steps, 32) int32, the
    direction bits in the kernel's layout, on the card; the plan)."""
    b, r1 = reads_p.shape
    wcap = wins.shape[1]
    dev = reads_p.device
    lib = load_library()
    plan = launch_plan(r1, wcap)
    meta = torch.empty((6, b), dtype=torch.int32, device=dev)
    runs = torch.empty((r1 + wcap, b), dtype=torch.int32, device=dev)
    plane = torch.empty((b, plan.bands, plan.plane_steps, 32),
                        dtype=torch.int32, device=dev)
    scratch = None
    if plan.scratch_ints:
        scratch = torch.empty(b * plan.scratch_ints, dtype=torch.int32,
                              device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.swalign_launch(
            reads_p.data_ptr(), rlens.data_ptr(), wins.data_ptr(),
            wlens.data_ptr(), scores.data_ptr(), b, r1, wcap,
            None if scratch is None else scratch.data_ptr(),
            plane.data_ptr(), meta.data_ptr(), runs.data_ptr(), stream)
    if rc != 0:
        raise KernelFault("swalign kernel launch failed: "
                          + lib.swalign_kernel_error_string(rc).decode())
    with _lock:
        LAUNCHES["swalign"] += 1
    return meta, runs, plane, plan
