"""Fused per-shard depth pipeline: segments → per-base depth → window
sums + callable classes, the counterpart of the JAX package's
ops/depth_pipeline.py.

Shards are computed relative to w0 = floor(region_start/W)*W so the window
grid is always aligned; the region bounds (rs, re) only mask. ``length``
must be a multiple of ``window`` and ≥ region_end - w0. Every function
takes tensors and runs where they live: on the card through the kernel
of ops/depth_kernel.py, on the CPU through its plain version.
"""

from __future__ import annotations

import numpy as np

from .depth_kernel import fused_depth, fused_depth_batch, fused_depth_wire


def shard_depth_pipeline(seg_start, seg_end, keep, w0, region_start,
                         region_end, depth_cap, min_cov, max_mean_depth,
                         length: int, window: int):
    """(window_sums f32, per-base classes i8, per-base depth i32) over
    [w0, w0+length); bases outside [region_start, region_end) are zeroed
    (samtools -r only counts in-region bases)."""
    sums, _, cls, depth = fused_depth(
        seg_start, seg_end, keep, w0, region_start, region_end, depth_cap,
        min_cov, max_mean_depth, length, window, dense=True)
    return sums, cls, depth


def shard_depth_pipeline_cls_packed(seg_start, seg_end, keep, w0,
                                    region_start, region_end, depth_cap,
                                    min_cov, max_mean_depth, length: int,
                                    window: int):
    """(window_sums, 2-bit packed classes) — the depth CLI's fetch set."""
    sums, packed, _, _ = fused_depth(
        seg_start, seg_end, keep, w0, region_start, region_end, depth_cap,
        min_cov, max_mean_depth, length, window)
    return sums, packed


def shard_depth_pipeline_packed_cls_packed(deltas, lens, base, w0,
                                           region_start, region_end,
                                           depth_cap, min_cov,
                                           max_mean_depth, length: int,
                                           window: int):
    """Packed u16 wire in, 2-bit packed classes out."""
    sums, packed, _, _ = fused_depth_wire(
        deltas, lens, base, w0, region_start, region_end, depth_cap,
        min_cov, max_mean_depth, length, window)
    return sums, packed


def shard_depth_pipeline_packed(deltas, lens, base, w0, region_start,
                                region_end, depth_cap, min_cov,
                                max_mean_depth, length: int, window: int):
    """Same as :func:`shard_depth_pipeline`, fed by the packed u16 wire
    (4 bytes/segment instead of 9: sorted start deltas + lengths, see
    ops/coverage.py::pack_segments_u16)."""
    sums, _, cls, depth = fused_depth_wire(
        deltas, lens, base, w0, region_start, region_end, depth_cap,
        min_cov, max_mean_depth, length, window, dense=True)
    return sums, cls, depth


def shard_depth_pipeline_batch_cls_packed(a, b, offsets, w0, region_start,
                                          region_end, depth_cap, min_cov,
                                          max_mean_depth, length: int,
                                          window: int, keep=None,
                                          bases=None):
    """B samples' segments over one region in one launch → (window_sums
    (B, n_win), 2-bit packed classes (B, ceil(length/4))): the serve
    daemon's coalesced depth pass. The u16 wire when ``bases`` is given,
    else the int32 wire with ``keep`` (ops/depth_kernel.py::
    fused_depth_batch)."""
    sums, packed, _, _ = fused_depth_batch(
        a, b, offsets, w0, region_start, region_end, depth_cap, min_cov,
        max_mean_depth, length, window, keep=keep, bases=bases)
    return sums, packed


def unpack_cls_2bit(packed: np.ndarray, length: int) -> np.ndarray:
    """Host inverse of the 2-bit class pack → int8 (length,)."""
    bits = (packed[:, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3
    return bits.reshape(-1)[:length].astype(np.int8)
