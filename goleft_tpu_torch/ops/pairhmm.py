"""Pair-HMM forward likelihood, host layer: the counterpart of the JAX
package's ops/pairhmm.py (encoding, transitions, length buckets, packing,
the exact f64 fold and the per-bucket dispatch).

P(read | haplotype) over three DP matrices (M, I, D) with the free-start
first row D[0, j] = 1/|hap|, transitions from phred gap-open/extend
scores and emission priors from per-base qualities (match 1-err,
mismatch err/3, N always matches). The device stage is one kernel launch
per length bucket (ops/pairhmm_kernel.py): it returns per-step final-row
contributions with their scale counters, which :func:`_fold_contribs`
folds into log10 L in exact f64 on the host.

Pairs group by lengths rounded up to BUCKET, and every bucket is one
plan Step at the ``pairhmm`` fault site, retried under a RetryPolicy. A
pair's result is bitwise independent of its bucket's padding and of its
neighbours: padding rows and steps are masked to exact zeros.

Stages (``utils/profiling.py::StageTimer``, summed into the CLI's
``--metrics-out`` manifest's ``spans``): ``encode-pack`` (encoding and packing),
``device-h2d``, ``device-kernel``, ``device-d2h`` and ``host-fold``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import obs
from ..device import KernelFault, resolve_device
from ..obs import get_registry
from ..plan import Executor, Step
from ..utils.profiling import StageTimer
from . import pairhmm_kernel

BUCKET = 32  # length-bucket granularity (pads lengths up to this)
SCALE_EXP = pairhmm_kernel.SCALE_EXP
_LOG10_2 = math.log10(2.0)

# base codes: A C G T = 0..3, N/other = 4 (always treated as a match)
_ENCODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ENCODE[_b] = _i
    _ENCODE[ord(chr(_b).lower())] = _i
N_CODE = np.uint8(4)

DEFAULT_GAP_OPEN = 45.0  # phred; δ = 10^-4.5 ≈ 3.2e-5
DEFAULT_GAP_EXT = 10.0   # phred; ε = 0.1

#: stage clock of this module's host and device work
TIMER = StageTimer()


def encode_seq(seq) -> np.ndarray:
    """str/bytes → uint8 base codes (A=0 C=1 G=2 T=3, other=N=4)."""
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8)
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _ENCODE[np.frombuffer(bytes(seq), dtype=np.uint8)]


def phred_to_err(quals) -> np.ndarray:
    """Phred qualities → base error probabilities, f64."""
    q = np.asarray(quals, dtype=np.float64)
    return np.power(10.0, -q / 10.0)


def transition_probs(gap_open: float = DEFAULT_GAP_OPEN,
                     gap_ext: float = DEFAULT_GAP_EXT) -> np.ndarray:
    """(5,) f64 [tMM, tMI=tMD, tIM=tDM, tII=tDD, delta-unused-pad],
    computed once in f64; the bucket casts to its compute dtype."""
    delta = 10.0 ** (-float(gap_open) / 10.0)
    eps = 10.0 ** (-float(gap_ext) / 10.0)
    return np.array([1.0 - 2.0 * delta, delta, 1.0 - eps, eps, delta],
                    dtype=np.float64)


def _fold_contribs(contribs: np.ndarray, shifts: np.ndarray
                   ) -> np.ndarray:
    """(B, steps) per-step contributions at per-step scales → (B,)
    log10 likelihood, folded in f64 (exact log-sum-exp; a pair with no
    surviving mass comes back -inf)."""
    c = np.asarray(contribs, dtype=np.float64)
    s = np.asarray(shifts, dtype=np.float64)
    with np.errstate(divide="ignore"):
        logv = np.where(c > 0.0,
                        np.log10(np.where(c > 0.0, c, 1.0))
                        - s * (SCALE_EXP * _LOG10_2),
                        -np.inf)
    m = np.max(logv, axis=1)
    safe_m = np.where(np.isfinite(m), m, 0.0)
    tot = np.sum(np.where(np.isfinite(logv),
                          np.power(10.0, logv - safe_m[:, None]), 0.0),
                 axis=1)
    with np.errstate(divide="ignore"):
        return np.where(np.isfinite(m), safe_m + np.log10(tot),
                        -np.inf)


def _pad_up(n: int, to: int = BUCKET) -> int:
    return max(to, ((n + to - 1) // to) * to)


def bucket_pairs(reads, haps, bucket: int = BUCKET):
    """Group pairs by padded-length signature → {(r_pad, h_pad):
    [indices]}."""
    groups: dict[tuple[int, int], list[int]] = {}
    for n, (r, h) in enumerate(zip(reads, haps)):
        key = (_pad_up(len(r), bucket), _pad_up(len(h), bucket))
        groups.setdefault(key, []).append(n)
    return groups


def _pack_bucket(idxs, reads, errs, haps, r_pad, h_pad, dtype):
    """Pad one bucket's pairs into the kernel's array layout."""
    b = len(idxs)
    r1 = r_pad + 1  # diag index 0 is the boundary row
    reads_p = np.full((b, r1), N_CODE, dtype=np.uint8)
    pm = np.zeros((b, r1), dtype=dtype)
    px = np.zeros((b, r1), dtype=dtype)
    rlens = np.zeros(b, dtype=np.int32)
    haps_p = np.full((b, h_pad), N_CODE, dtype=np.uint8)
    hlens = np.zeros(b, dtype=np.int32)
    for row, n in enumerate(idxs):
        r, e, h = reads[n], errs[n], haps[n]
        rl, hl = len(r), len(h)
        reads_p[row, 1:rl + 1] = r
        pm[row, 1:rl + 1] = (1.0 - e).astype(dtype)
        px[row, 1:rl + 1] = (e / 3.0).astype(dtype)
        rlens[row] = rl
        haps_p[row, :hl] = h
        hlens[row] = hl
    return reads_p, pm, px, rlens, haps_p, hlens


def forward_bucket_device(packed, trans: np.ndarray, rescale: bool,
                          device) -> tuple[np.ndarray, np.ndarray]:
    """One packed bucket: H2D, the kernel (or, on the CPU, its plain
    version), D2H → (contribs, shifts) numpy arrays. On the card the
    kernel stage ends in a synchronize, so each stage's clock holds its
    own work; an error the kernel left on the card surfaces there as a
    :class:`KernelFault`. Under device events (``--trace-out``) the launch
    is one fenced ``device.pairhmm`` span."""
    with TIMER.stage("device-h2d"):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
             for a in (*packed, trans)]
    with TIMER.stage("device-kernel"):
        contribs, shifts = obs.dispatch(
            "pairhmm", pairhmm_kernel.forward_bucket, *t, rescale=rescale)
        if device.type == "cuda":
            try:
                torch.cuda.current_stream(device).synchronize()
            except RuntimeError as e:
                raise KernelFault(f"pairhmm kernel failed on the card: "
                                  f"{e}") from e
    with TIMER.stage("device-d2h"):
        return contribs.cpu().numpy(), shifts.cpu().numpy()


def forward_pairs(reads, quals, haps, *,
                  gap_open: float = DEFAULT_GAP_OPEN,
                  gap_ext: float = DEFAULT_GAP_EXT,
                  dtype=np.float32, bucket: int = BUCKET,
                  device=None) -> np.ndarray:
    """log10 P(read|hap) for N (read, qual, hap) triples → (N,) f64.
    A permanently failing bucket raises
    :class:`~goleft_tpu_torch.resilience.policy.RetriesExhausted`."""
    vals, _ = forward_pairs_partial(
        reads, quals, haps, gap_open=gap_open, gap_ext=gap_ext,
        dtype=dtype, bucket=bucket, allow_partial=False,
        device=device)
    return vals


def forward_pairs_partial(reads, quals, haps, *,
                          gap_open: float = DEFAULT_GAP_OPEN,
                          gap_ext: float = DEFAULT_GAP_EXT,
                          dtype=np.float32, bucket: int = BUCKET,
                          allow_partial: bool = True, device=None):
    """Like :func:`forward_pairs` but returns ``(log10 (N,) f64,
    failed_error_by_index dict)``: when ``allow_partial`` and a bucket's
    dispatch fails permanently (retries exhausted), its pairs' slots hold
    NaN and map to the causing exception. A :class:`KernelFault` is
    raised as it is. ``device`` None means the CUDA card (raises without
    one); ``"cpu"`` runs the plain version."""
    if not (len(reads) == len(quals) == len(haps)):
        raise ValueError(
            f"forward_pairs: {len(reads)} reads, {len(quals)} quals, "
            f"{len(haps)} haps — lengths must match")
    dev = resolve_device(device)
    n = len(reads)
    out = np.full(n, np.nan, dtype=np.float64)
    failed: dict[int, BaseException] = {}
    if n == 0:
        return out, failed
    with TIMER.stage("encode-pack"):
        enc_reads, errs, enc_haps = [], [], []
        for r, q, h in zip(reads, quals, haps):
            er = encode_seq(r)
            if len(er) == 0:
                raise ValueError("forward_pairs: empty read")
            eh = encode_seq(h)
            if len(eh) == 0:
                raise ValueError("forward_pairs: empty haplotype")
            enc_reads.append(er)
            errs.append(
                phred_to_err(np.broadcast_to(np.asarray(q), (len(er),))))
            enc_haps.append(eh)

    dtype = np.dtype(dtype)
    rescale = dtype == np.float32
    trans = transition_probs(gap_open, gap_ext).astype(dtype)
    reg = get_registry()
    reg.counter("pairhmm.pairs_total").inc(n)

    pex = Executor()
    groups = bucket_pairs(enc_reads, enc_haps, bucket)
    for (r_pad, h_pad), idxs in sorted(groups.items()):
        with TIMER.stage("encode-pack"):
            packed = _pack_bucket(idxs, enc_reads, errs, enc_haps,
                                  r_pad, h_pad, dtype)
        key = ("pairhmm", r_pad, h_pad, len(idxs))

        def thunk(packed=packed):
            return forward_bucket_device(packed, trans, rescale, dev)

        reg.counter("pairhmm.buckets_total").inc()
        # one bucket dispatch = one plan Step at the 'pairhmm' fault
        # site, retried under the default policy
        outcome = pex.run_step(Step(key=key, fn=thunk, site="pairhmm"))
        if outcome.error is not None:
            if not allow_partial:
                raise outcome.retries_exhausted
            for i in idxs:
                failed[i] = outcome.error
            reg.counter("pairhmm.buckets_failed_total").inc()
            continue
        with TIMER.stage("host-fold"):
            contribs, shifts = outcome.value
            out[np.asarray(idxs)] = _fold_contribs(contribs, shifts)
    return out, failed


def total_cells(reads, haps) -> int:
    """DP cell count Σ |read|·|hap|: the GCUPS numerator."""
    return int(sum(len(r) * len(h) for r, h in zip(reads, haps)))
