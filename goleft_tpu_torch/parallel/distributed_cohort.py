"""The cohort matrix across processes: the counterpart of the JAX
package's parallel/distributed_cohort.py.

Process i of a world of P (parallel/mesh.py::init_distributed) decodes
``bams[i::P]`` with the ordinary cohort machinery
(commands/cohortdepth.py::cohort_matrix_blocks, on its own card or the
CPU), then one Gloo ``all_gather`` of fixed shape moves the (windows x
local samples) int32 means between the processes, and every process
reassembles the full matrix in the original sample order. What crosses
is the reduced matrix, never per-read data. Only process 0 generates a
missing ``.fai``; a barrier holds the others until it exists. fd 1 goes
to stderr around every collective: process 0 writes its matrix there.
"""

from __future__ import annotations

import os

import numpy as np

from .mesh import all_gather, barrier, rank_device, world

_NAME_BYTES = 256  # fixed-width utf-8 slot per sample name for the gather


def cohort_coords(fai_path: str, chrom: str, window: int,
                  bed: str | None = None):
    """(chroms, starts, ends) for every window of the cohort matrix,
    derived from the .fai alone — exactly the coordinates
    cohort_matrix_blocks emits (same regions, same window_bounds), so a
    process holding zero local samples can still label the gathered
    matrix."""
    from ..commands.cohortdepth import cohort_regions
    from ..io.fai import read_fai
    from ..ops.coverage import window_bounds

    regions = cohort_regions(read_fai(fai_path), chrom, window, bed)
    ch, st, en = [], [], []
    for c, s, e in regions:
        starts, ends, _, _ = window_bounds(s, e, window)
        ch.extend([c] * len(starts))
        st.append(starts)
        en.append(ends)
    if not st:
        return np.empty(0, object), np.empty(0, np.int64), \
            np.empty(0, np.int64)
    return (np.array(ch, dtype=object), np.concatenate(st),
            np.concatenate(en))


def _local_matrix(local_bams, n_win, reference, fai, window, mapq,
                  chrom, processes, engine, bed, prefetch_depth=0,
                  decode_device=False, device=None):
    """Drain cohort_matrix_blocks for this process's sample shard into
    an int32 (n_win, n_local) matrix of round-half-up window means."""
    from ..commands.cohortdepth import cohort_matrix_blocks

    if not local_bams:
        return [], np.zeros((n_win, 0), dtype=np.int32)
    names, blocks = cohort_matrix_blocks(
        local_bams, reference=reference, fai=fai, window=window,
        mapq=mapq, chrom=chrom, processes=processes, engine=engine,
        bed=bed, prefetch_depth=prefetch_depth, quarantine=None,
        decode_device=decode_device, device=device)
    mat = np.empty((n_win, len(names)), dtype=np.int32)
    row = 0
    for _, starts, _, vals in blocks:
        k = len(starts)
        mat[row : row + k] = vals.T
        row += k
    assert row == n_win, (row, n_win)
    return names, mat


def _pack_names(names, pad_to: int) -> np.ndarray:
    out = np.zeros((pad_to, _NAME_BYTES), dtype=np.uint8)
    for i, nm in enumerate(names):
        b = nm.encode("utf-8")[:_NAME_BYTES]
        # a hard byte cut can split a multi-byte codepoint and make
        # _unpack_name's decode raise mid-assembly; re-truncate on a
        # codepoint boundary instead
        b = b.decode("utf-8", errors="ignore").encode("utf-8")
        out[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return out


def _unpack_name(row: np.ndarray) -> str:
    return bytes(row[row != 0]).decode("utf-8")


def distributed_cohort_matrix(
    bams: list[str],
    reference: str | None = None,
    fai: str | None = None,
    window: int = 250,
    mapq: int = 1,
    chrom: str = "",
    processes: int = 8,
    engine: str = "auto",
    bed: str | None = None,
    prefetch_depth: int = 0,
    decode_device: bool = False,
    device=None,
):
    """(names, chroms, starts, ends, matrix) with matrix int32
    (n_windows, n_samples) of round-half-up window means, identical to
    a single-process cohortdepth run over the same inputs, on every
    process. ``device``: this process's device (:func:`rank_device`:
    ``cuda:{rank % cards}`` unless the caller names one)."""
    from ..io.fai import write_fai

    fai_path = fai or (reference + ".fai" if reference else None)
    if fai_path is None:
        raise SystemExit("cohortdepth: need -r reference or --fai")
    P, pid = world()
    dev = rank_device(device, pid)
    if pid == 0 and reference and not os.path.exists(fai_path):
        write_fai(reference)
    if P > 1:
        # only process 0 may generate the index, and only its view of
        # the file decides: every rank enters the barrier, which keeps
        # the others from reading a half-written file
        barrier()
    chroms, starts, ends = cohort_coords(fai_path, chrom, window, bed=bed)
    n_win = len(starts)
    if n_win == 0:
        raise SystemExit("cohortdepth: no regions (chromosome "
                         f"{chrom!r} not in {fai_path}?)")
    kw = dict(reference=reference, fai=fai_path, window=window, mapq=mapq,
              chrom=chrom, processes=processes, engine=engine, bed=bed,
              prefetch_depth=prefetch_depth, decode_device=decode_device,
              device=dev)
    if P == 1:
        names, mat = _local_matrix(bams, n_win, **kw)
        return names, chroms, starts, ends, mat

    import torch

    names_l, mat_l = _local_matrix(bams[pid::P], n_win, **kw)
    # fixed-shape padding: the gather needs identical shapes everywhere
    pad = (len(bams) + P - 1) // P
    mat_pad = np.zeros((n_win, pad), dtype=np.int32)
    mat_pad[:, : mat_l.shape[1]] = mat_l
    g_mat = [t.numpy() for t in all_gather(torch.from_numpy(mat_pad))]
    g_names = [t.numpy() for t in all_gather(
        torch.from_numpy(_pack_names(names_l, pad)))]

    # global sample k was decoded by process k % P at local slot k // P
    n = len(bams)
    mat = np.empty((n_win, n), dtype=np.int32)
    names = []
    for k in range(n):
        mat[:, k] = g_mat[k % P][:, k // P]
        names.append(_unpack_name(g_names[k % P][k // P]))
    return names, chroms, starts, ends, mat
