"""Warm start: replay a warmup manifest's signatures before the port
binds.

The counterpart of the JAX package's serve/warmstart.py. There each
signature is a program to compile; the port's kernels are built once a
source (ops/_nvcc.py), so a signature here is a launch geometry, and
``serve --warmup PATH`` makes one launch of each of the manifest's top-K
signatures on zero-filled inputs of that geometry: the depth kernel's
batch, a pair-HMM bucket, a swalign extend bucket. The first request of
each geometry then pays no first launch (allocator growth, library
load). Each replay runs under the compile observatory's ``observe``
with the parsed signature, so ``/debug/compiles`` shows it.

Entries the port has no launch for are skipped, never fatal: families
without a replayer (``indexcov``, ``rans``, ``unattributed``, ...),
signatures without geometry (""), and seed-stage swalign entries (their
tables belong to a reference, which only a request names). A manifest
that a JAX worker exported loads here: the schema is shared.
"""

from __future__ import annotations

import json
import time

import numpy as np

from ..obs import get_logger, get_registry
from ..obs.compiles import TRACKER, load_warmup_manifest

log = get_logger("serve.warmstart")

#: default number of top-ranked manifest entries to replay
DEFAULT_TOP_K = 8


class _Skip(Exception):
    """An entry that is legitimately not replayable (not a failure)."""


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _warm_depth(sig: dict, device) -> None:
    import torch

    from ..ops.depth_kernel import fused_depth_batch

    b, bucket = int(sig["b"]), int(sig["bucket"])
    length, window = int(sig["length"]), int(sig["window"])
    z = torch.zeros(b * bucket, dtype=torch.uint16, device=device)
    fused_depth_batch(z, z, [i * bucket for i in range(b + 1)], 0, 0,
                      min(256, length), 2500, 4, 0, length, window,
                      bases=[0] * b)
    _sync(device)


def _warm_pairhmm(sig: dict, device) -> None:
    from ..ops import pairhmm

    b, r_pad, h_pad = int(sig["b"]), int(sig["r_pad"]), int(sig["h_pad"])
    dtype = np.dtype(sig.get("dtype", "float32"))
    reads = [np.zeros(r_pad, np.uint8)] * b
    errs = [np.full(r_pad, 0.001, np.float64)] * b
    haps = [np.zeros(h_pad, np.uint8)] * b
    packed = pairhmm._pack_bucket(list(range(b)), reads, errs, haps,
                                  r_pad, h_pad, dtype)
    trans = pairhmm.transition_probs().astype(dtype)
    pairhmm.forward_bucket_device(packed, trans, bool(sig["rescale"]),
                                  device)


def _warm_swalign(sig: dict, device) -> None:
    if sig.get("stage") != "extend":
        raise _Skip("seed-stage signature is reference-bound")
    from ..ops import swalign

    b, r_pad, w_pad = int(sig["b"]), int(sig["r_pad"]), int(sig["w_pad"])
    reads_p = np.full((b, r_pad + 1), swalign.N_CODE, np.uint8)
    wins_p = np.full((b, w_pad), swalign.N_CODE, np.uint8)
    ones = np.ones(b, np.int32)
    swalign.align_bucket(reads_p, ones, wins_p, ones, device=device)


_REPLAYERS = {
    "depth": _warm_depth,
    "pairhmm": _warm_pairhmm,
    "swalign": _warm_swalign,
}


def warm_start(path: str, top_k: int = DEFAULT_TOP_K,
               device=None) -> dict:
    """Replay the manifest's top-K signatures on ``device`` (the card
    unless ``"cpu"``). Returns ``{"warmed", "skipped", "failed",
    "seconds"}``; raises only on an unreadable or invalid manifest (a
    bad ``--warmup`` argument is the operator's error, a stale entry is
    not)."""
    from ..device import resolve_device

    t0 = time.monotonic()
    dev = resolve_device(device)
    manifest = load_warmup_manifest(path)
    reg = get_registry()
    warmed = skipped = failed = 0
    for entry in manifest["signatures"][:top_k]:
        family = entry["family"]
        replay = _REPLAYERS.get(family)
        sig_str = entry.get("signature") or ""
        if replay is None or not sig_str:
            skipped += 1
            reg.counter("serve.warmstart_skipped_total").inc()
            continue
        try:
            sig = json.loads(sig_str)
            with TRACKER.observe(family, signature=sig,
                                 trigger="warmstart"):
                replay(sig, dev)
            warmed += 1
            reg.counter("serve.warmstart_compiles_total").inc()
        except _Skip as e:
            skipped += 1
            reg.counter("serve.warmstart_skipped_total").inc()
            log.info("warmstart: skipped %s entry: %s", family, e)
        except Exception as e:  # noqa: BLE001 — a stale entry must never
            # block admission; the worker just meets it cold
            failed += 1
            reg.counter("serve.warmstart_failed_total").inc()
            log.warning("warmstart: failed to replay %s %s: %r",
                        family, sig_str, e)
    seconds = time.monotonic() - t0
    log.info("warmstart: %d replayed, %d skipped, %d failed in %.2fs "
             "(%s)", warmed, skipped, failed, seconds, path)
    return {"warmed": warmed, "skipped": skipped, "failed": failed,
            "seconds": seconds}
