"""Coverage helpers: host-side segment packing, window geometry and
run-length encoding, plus plain PyTorch forms of the per-base ops.

The counterpart of the JAX package's ops/coverage.py. Depth is a
segmented prefix sum over segment endpoints::

    delta[p] += 1 for each segment start, delta[p] -= 1 for each end
    depth = cumsum(delta)

On the card that computation is the hand-written kernel in
ops/depth_kernel.py; the torch functions here are its plain forms and
run wherever their tensors live.
"""

from __future__ import annotations

import numpy as np
import torch

# class codes match getCovClass strings (goleft depth/depth.go:223-234)
CLASS_NAMES = ("NO_COVERAGE", "LOW_COVERAGE", "CALLABLE", "EXCESSIVE_COVERAGE")


def bucket_size(n: int, minimum: int = 1024) -> int:
    """Next power of two ≥ n (≥ minimum) — pad target for segment arrays."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def pack_segments_u16(seg_start: np.ndarray, seg_end: np.ndarray,
                      keep: np.ndarray):
    """Packed wire format for host→device segment transfer: 4 bytes per
    segment (u16 start-delta + u16 length) instead of 9 (two i32 + bool).

    Host applies the keep filter and sorts; the device reconstructs
    absolute endpoints with one prefix sum. Gaps > 65535 insert filler
    entries (delta=65535, len=0) and padding is (0, 0) — zero-length
    entries contribute nothing. Returns (deltas u16, lens u16, base i32,
    n_entries) — arrays are unpadded; callers bucket-pad with zeros.
    Returns None when any segment is ≥ 65536 bases (ultra-long reads ride
    the unpacked wire).
    """
    s = seg_start[keep].astype(np.int64)
    e = seg_end[keep].astype(np.int64)
    if len(s) == 0:
        return (np.zeros(0, np.uint16), np.zeros(0, np.uint16),
                np.int32(0), 0)
    if np.any(s[:-1] > s[1:]):
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
    lens = e - s
    if int(lens.max()) > 0xFFFF:
        return None
    base = int(s[0])
    deltas = np.empty(len(s), np.int64)
    deltas[0] = 0
    np.subtract(s[1:], s[:-1], out=deltas[1:])
    q = deltas // 0xFFFF  # fillers of 65535 each
    nq = int(q.sum())
    if nq == 0:
        return (deltas.astype(np.uint16), lens.astype(np.uint16),
                np.int32(base), len(s))
    total = len(s) + nq
    out_d = np.full(total, 0xFFFF, np.uint16)
    out_l = np.zeros(total, np.uint16)
    last = np.cumsum(q + 1) - 1
    out_d[last] = (deltas % 0xFFFF).astype(np.uint16)
    out_l[last] = lens.astype(np.uint16)
    return out_d, out_l, np.int32(base), total


def depth_from_segments(seg_start: torch.Tensor, seg_end: torch.Tensor,
                        keep: torch.Tensor, length: int,
                        region_start: int = 0,
                        depth_cap: int = 0x7FFFFFFF) -> torch.Tensor:
    """Per-base int32 depth over [region_start, region_start+length).

    ``keep`` masks padded/filtered segments. Segments are clipped to the
    region; fully-outside segments contribute +1/-1 at the same clipped
    index and cancel. The cap mirrors samtools' ``-d`` limit.
    """
    from .depth_kernel import depth_plain

    s = torch.clamp(seg_start.to(torch.int32) - region_start, 0, length)
    e = torch.clamp(seg_end.to(torch.int32) - region_start, 0, length)
    s = torch.where(keep, s, length)
    e = torch.where(keep, e, length)
    return torch.clamp_max(depth_plain(s, e, length), depth_cap)


def windowed_sums(depth: torch.Tensor, length: int, window: int,
                  lpad: int, rpad: int) -> torch.Tensor:
    """Sum per absolute-coordinate-aligned window, accumulated in int64.

    Windows cover [i*W, (i+1)*W) clipped to the region, so the caller
    passes lpad = region_start - floor(region_start/W)*W and rpad to
    complete the final window (see :func:`window_bounds`).
    """
    assert depth.shape[0] == length
    padded = torch.cat([
        depth.new_zeros(lpad), depth, depth.new_zeros(rpad)])
    return padded.to(torch.int64).reshape(-1, window).sum(dim=1)


def window_count(region_start: int, region_end: int, window: int) -> int:
    """The absolute-aligned windows that overlap a region."""
    w0 = region_start // window * window
    return (region_end - w0 + window - 1) // window


def window_bounds(
    region_start: int, region_end: int, window: int
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """(starts, ends, lpad, rpad) for absolute-aligned windows over a region."""
    w0 = region_start // window * window
    n_win = window_count(region_start, region_end, window)
    starts = np.maximum(region_start, w0 + np.arange(n_win) * window)
    ends = np.minimum(region_end, w0 + (np.arange(n_win) + 1) * window)
    lpad = region_start - w0
    rpad = n_win * window - (region_end - w0)
    return starts, ends, lpad, rpad


def callable_classes(depth: torch.Tensor, min_cov: int,
                     max_mean_depth: int) -> torch.Tensor:
    """Per-base class codes 0..3; max_mean_depth <= 0 disables class 3
    (EXCESSIVE_COVERAGE)."""
    excessive = (depth >= max_mean_depth) if max_mean_depth > 0 \
        else torch.zeros_like(depth, dtype=torch.bool)
    cls = torch.where(
        depth == 0, 0,
        torch.where(depth < min_cov, 1, torch.where(excessive, 3, 2)))
    return cls.to(torch.int8)


def run_length_encode(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(starts, ends, values) of equal-value runs — how the reference's
    streaming state machine collapses per-base classes
    (goleft depth/depth.go:307-323)."""
    arr = np.asarray(arr)
    if arr.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z
    change = np.flatnonzero(arr[1:] != arr[:-1]) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [arr.size]))
    return starts, ends, arr[starts]
