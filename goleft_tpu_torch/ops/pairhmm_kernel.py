"""Pair-HMM forward wavefront of one length bucket: the hand-written CUDA
kernel (csrc/pairhmm_kernel.cu), its wrapper, and its plain PyTorch
version.

The counterpart of the JAX package's ops/pairhmm.py::pallas_forward_bucket
(the TPU kernel) and _forward_bucket_impl (the XLA wavefront the
reference runs). Inputs are a bucket in the layout of ``_pack_bucket``;
outputs are the per-step final-row contributions and their scale
counters, (B, r1 + hcap) each, for the host's exact f64 fold.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back. The kernel
is compiled with ``nvcc -fmad=false`` for sm_90a at first use into
``build/torch/`` and loaded with ctypes. float32 runs rescaled and
float64 unscaled, as the reference ties them (``rescale = dtype ==
float32``).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..device import KernelFault
from . import _nvcc

#: a row renormalises by 2^±SCALE_EXP when its max leaves
#: [2^-SCALE_EXP, 2^SCALE_EXP] (the reference's SCALE_EXP)
SCALE_EXP = 30
#: cross-row scale differences are clipped to [_DMIN, _DMAX]
_DMIN, _DMAX = -4, 3
N_CODE = 4
#: a warp runs one pair; lane L holds R consecutive read rows of a strip
#: of 32 R rows, R at most MAX_ROWS_PER_LANE (csrc/pairhmm_kernel.cu
#: LANES, MAX_R); longer reads run as strips of 256 rows
LANES = 32
MAX_ROWS_PER_LANE = 8
#: float operations per cell of the recurrence, for the compute bound;
#: built with -fmad=false, each is an instruction of its own (no FMA).
#: float32 (rescaled): M 3 mul + 2 add + prior mul + scale mul, I 2 mul
#: + add + scale mul, D 2 mul + add, the two scale factors, rescale 2 max
#: + 3 compares + 3 mul. float64 (unscaled): M 3 mul + 2 add + prior
#: mul, I 2 mul + add, D 2 mul + add.
OPS_PER_CELL = {"float32": 24, "float64": 12}

NVCC_FLAGS = [*_nvcc.BASE_FLAGS, "-fmad=false"]

_lock = threading.Lock()
_lib = None
#: ptxas report of the build (registers, shared memory, spills)
BUILD_LOG = ""
#: kernel launches per kernel name; incremented where the kernel is
#: launched and nowhere else
LAUNCHES = {"pairhmm": 0}


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        lib, BUILD_LOG = _nvcc.build("pairhmm_kernel.cu", NVCC_FLAGS,
                                     "pairhmm kernel")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pairhmm_forward_launch.argtypes = [
            i32, p, p, p, p, p, p, p, i32, i32, i32, i32, p, p, p, p, p]
        lib.pairhmm_forward_launch.restype = ctypes.c_int
        lib.pairhmm_kernel_error_string.argtypes = [ctypes.c_int]
        lib.pairhmm_kernel_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


# ---- plain PyTorch version -------------------------------------------

def forward_bucket_plain(reads_p, pm, px, rlens, haps, hlens, trans,
                         rescale: bool):
    """The wavefront as a Python loop over the r1 + hcap anti-diagonals,
    batched over pairs: the counterpart of ``_forward_bucket_impl``,
    with its order of operations. Returns (contribs (B, steps) in pm's
    dtype, shifts (B, steps) int32)."""
    dtype, dev = pm.dtype, pm.device
    b, r1 = reads_p.shape
    hcap = haps.shape[1]
    steps = r1 + hcap
    t_mm, t_mi, t_im, t_ii = (trans[n].to(dtype) for n in range(4))
    scal = dict(dtype=dtype, device=dev)
    below = torch.tensor(2.0 ** -SCALE_EXP, **scal)
    above = torch.tensor(2.0 ** SCALE_EXP, **scal)
    one = torch.tensor(1.0, **scal)
    zero = torch.tensor(0.0, **scal)
    ii = torch.arange(r1, dtype=torch.int32, device=dev)[None, :]
    rl = rlens.to(torch.int32)
    hl = hlens.to(torch.int32)
    rows = torch.arange(b, device=dev)
    at_r = rl.long()
    inv_h = one / hl.to(dtype)

    def shift1(x):
        # x[i-1] with a zero entering at i = 0
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)

    def scale_fix(s_to, s_from):
        d = torch.clamp(s_to - s_from, _DMIN, _DMAX)
        return torch.exp2((SCALE_EXP * d).to(dtype))

    z = torch.zeros(b, r1, **scal)
    zi = torch.zeros(b, r1, dtype=torch.int32, device=dev)
    m1, i1, d1, s1 = z, z, z.clone(), zi
    d1[:, 0] = inv_h  # diagonal 0: cell (0, 0)
    m2, i2, d2, s2 = z, z, z, zi
    contribs = torch.zeros(b, steps, **scal)
    shifts = torch.zeros(b, steps, dtype=torch.int32, device=dev)
    for k in range(1, steps):
        jj = k - ii
        in_h = (jj >= 1) & (jj <= hl[:, None])
        col = torch.clamp(jj - 1, 0, hcap - 1).long().expand(b, r1)
        hb = torch.where(in_h, haps.gather(1, col), N_CODE)
        valid = (ii >= 1) & (ii <= rl[:, None]) & in_h
        is_match = (reads_p == hb) | (reads_p == N_CODE) | (hb == N_CODE)
        prior = torch.where(is_match, pm, px)
        mterm = (t_mm * shift1(m2) + t_im * shift1(i2)
                 + t_im * shift1(d2))
        iterm = t_mi * shift1(m1) + t_ii * shift1(i1)
        if rescale:
            mterm = mterm * scale_fix(s1, shift1(s2))
            iterm = iterm * scale_fix(s1, shift1(s1))
        mk = prior * mterm
        ik = iterm
        dk = t_mi * m1 + t_ii * d1
        mk = torch.where(valid, mk, zero)
        ik = torch.where(valid, ik, zero)
        dk = torch.where(valid, dk, zero)
        # boundary row i = 0: D[0, j] = 1/|hap| (free start), M = I = 0
        dk[:, 0] = torch.where(k <= hl, inv_h, zero)
        live = (k - rl >= 1) & (k - rl <= hl)
        contribs[:, k] = torch.where(live, mk[rows, at_r] + ik[rows, at_r],
                                     zero)
        if rescale:
            shifts[:, k] = s1[rows, at_r]
            mx = torch.maximum(torch.maximum(mk, ik), dk)
            grow = ((mx > zero) & (mx < below)).to(torch.int32)
            shrink = (mx > above).to(torch.int32)
            f = torch.where(grow == 1, above,
                            torch.where(shrink == 1, below, one))
            mk, ik, dk = mk * f, ik * f, dk * f
            s_base = s1 + grow - shrink
            # an all-zero row's counter means nothing: it takes its left
            # neighbour's, so a row enters the sweep at its feeder's scale
            s_new = torch.where(mx > zero, s_base, shift1(s_base))
        else:
            s_new = s1
        m2, i2, d2, s2 = m1, i1, d1, s1
        m1, i1, d1, s1 = mk, ik, dk, s_new
    return contribs, shifts


# ---- wrapper ----------------------------------------------------------

def launch_geometry(r1: int) -> tuple[int, int]:
    """(R, strips) of a bucket of ``r1`` read rows: the rows each lane
    holds, ceil(r1 / 32) clamped to [1, 8], and the strips of 32 R rows
    a pair's warp runs for its longest possible read (a pair runs
    rlen // 32R + 1 of them); more than one only at R = 8."""
    rows = min(MAX_ROWS_PER_LANE, max(1, -(-r1 // LANES)))
    return rows, -(-r1 // (LANES * rows))


def _check(t: torch.Tensor, dtypes, name: str, shape: tuple):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected {dtypes}, got {t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor of shape "
                         f"{shape}, got {tuple(t.shape)}")


def _launch(reads_p, pm, px, rlens, haps, hlens, trans):
    b, r1 = reads_p.shape
    hcap = haps.shape[1]
    steps = r1 + hcap
    dev = pm.device
    lib = load_library()
    contribs = torch.empty(b, steps, dtype=pm.dtype, device=dev)
    shifts = torch.empty(b, steps, dtype=torch.int32, device=dev)
    rows, strips = launch_geometry(r1)
    rec_v = torch.empty(b * 6 * steps if strips > 1 else 0,
                        dtype=pm.dtype, device=dev)
    rec_s = torch.empty(b * 4 * steps if strips > 1 else 0,
                        dtype=torch.int32, device=dev)

    def ptr(t):
        return t.data_ptr() if t.numel() else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pairhmm_forward_launch(
            int(pm.dtype == torch.float64), ptr(reads_p), ptr(pm), ptr(px),
            ptr(rlens), ptr(haps), ptr(hlens), ptr(trans), b, r1, hcap,
            rows, ptr(contribs), ptr(shifts), ptr(rec_v), ptr(rec_s),
            stream)
    if rc != 0:
        raise KernelFault("pairhmm kernel launch failed: "
                           + lib.pairhmm_kernel_error_string(rc).decode())
    with _lock:
        LAUNCHES["pairhmm"] += 1
    return contribs, shifts


def forward_bucket(reads_p, pm, px, rlens, haps, hlens, trans,
                   rescale: bool):
    """One bucket through the wavefront → (contribs (B, r1 + hcap),
    shifts (B, r1 + hcap) int32). ``reads_p`` (B, r1) uint8 with index 0
    the N sentinel, ``pm``/``px`` (B, r1) float32 or float64, ``rlens``
    (B,) int32 in [1, r1), ``haps`` (B, hcap) uint8, ``hlens`` (B,) int32
    in [1, hcap], ``trans`` (5,) in pm's dtype. On CUDA tensors the kernel
    runs float32 rescaled or float64 unscaled, and raises for other
    pairings of dtype and ``rescale``."""
    b, r1 = reads_p.shape
    hcap = haps.shape[1]
    fl = (torch.float32, torch.float64)
    _check(reads_p, (torch.uint8,), "reads_p", (b, r1))
    _check(pm, fl, "pm", (b, r1))
    _check(px, (pm.dtype,), "px", (b, r1))
    _check(rlens, (torch.int32,), "rlens", (b,))
    _check(haps, (torch.uint8,), "haps", (b, hcap))
    _check(hlens, (torch.int32,), "hlens", (b,))
    _check(trans, (pm.dtype,), "trans", (trans.shape[0],))
    if r1 < 2 or hcap < 1 or trans.shape[0] < 4:
        raise ValueError(f"pairhmm: bad bucket geometry r1={r1} "
                         f"hcap={hcap} trans={trans.shape[0]}")
    dev = pm.device
    if any(t.device != dev for t in (reads_p, px, rlens, haps, hlens,
                                     trans)):
        raise ValueError("pairhmm kernel: inputs on different devices")
    if dev.type == "cpu":
        return forward_bucket_plain(reads_p, pm, px, rlens, haps, hlens,
                                    trans, rescale)
    if rescale != (pm.dtype == torch.float32):
        raise ValueError("pairhmm kernel: float32 runs rescaled and "
                         "float64 unscaled")
    return _launch(reads_p, pm, px, rlens, haps, hlens, trans)
