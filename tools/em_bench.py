#!/usr/bin/env python3
"""Time the layers of the EM copy-number caller at cohort width on one
CUDA card.

    python3 tools/em_bench.py [--windows 64445] [--samples 2504]
                              [--reps 3] [--out FILE] [--pkg DIR]

On chip_smoke.py's int16 matrix (chr20 at 1 kb x the 2,504 samples of
the 1000 Genomes phase-3 cohort by default), for the first
``EM_CHUNK``-window chunk: the H2D copy of its int16 rows, the whole
``_norm_chunk`` (that copy, then the f64 scaling on the card),
``em_depth_batch``, ``cn_batch``, the D2H of λ and the int8 CN, and
cn.mops (``mops_batch``, then
``posterior_cn`` and ``information_gain``), each the median of
``--reps`` by CUDA events; then the
kernels of one EM + CN chunk by ``torch.profiler`` (CUDA time by
kernel name, the top 12), the whole ``_batched_em`` by the host
clock (its first call in the process, then ``--reps`` more), and the
host's streaming merge (``Cache.add`` over the first
``--merge-windows`` windows, as ``call_cnvs`` runs it) in ms a window.
Prints the card's ``nvidia-smi`` name and power limit first.

``--pkg DIR`` imports ``goleft_tpu_torch`` from the checkout at DIR
instead of this one, with the same data and timing code: to compare two
trees on one card, run parent, change, change, parent in one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=64_445)
    ap.add_argument("--samples", type=int, default=2_504)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--merge-windows", type=int, default=1000)
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--pkg", help="checkout whose goleft_tpu_torch to time")
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.pkg or ROOT))
    import torch

    if not torch.cuda.is_available():
        print("em_bench: no CUDA device is visible", file=sys.stderr)
        return 2
    # this checkout's chip_smoke.py (fixture, timing), whatever --pkg is
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cuda_median_ms, em_matrix = cs.cuda_median_ms, cs.em_matrix
    from goleft_tpu_torch.commands import emdepth_cmd as ec
    from goleft_tpu_torch.obs.provenance import nvidia_smi_line
    from goleft_tpu_torch.models import emdepth as em
    from goleft_tpu_torch.models import mops

    print(nvidia_smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    depths = em_matrix(np.random.default_rng(2504), a.windows, a.samples)
    med, medmed = ec.sample_medians(depths)
    B = min(ec.EM_CHUNK, a.windows)

    res = {"card": nvidia_smi_line(), "pkg": os.path.abspath(a.pkg or ROOT),
           "windows": a.windows, "samples": a.samples, "chunk": B}
    res["h2d_int16_ms"] = cuda_median_ms(
        lambda: torch.from_numpy(depths[:B]).to(dev), a.reps)
    res["norm_chunk_ms"] = cuda_median_ms(
        lambda: ec._norm_chunk(depths[:B], med, medmed, np.float64, dev),
        a.reps)
    d = ec._norm_chunk(depths[:B], med, medmed, np.float64, dev)
    res["em_ms"] = cuda_median_ms(lambda: em.em_depth_batch(d), a.reps)
    lam = em.em_depth_batch(d)
    res["cn_ms"] = cuda_median_ms(lambda: em.cn_batch(lam, d), a.reps)
    cn = em.cn_batch(lam, d)
    res["d2h_ms"] = cuda_median_ms(lambda: (lam.cpu(), cn.cpu()), a.reps)

    def mops_chunk():
        r = mops.mops_batch(d)
        mops.posterior_cn(r["aik"]).cpu()
        mops.information_gain(r["aik"]).cpu()

    res["mops_ms"] = cuda_median_ms(mops_chunk, a.reps)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        em.cn_batch(em.em_depth_batch(d), d)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t and ev.key and not ev.key.startswith(("aten::", "cuda")):
            rows.append((t / 1e3, ev.count, ev.key[:90]))
    rows.sort(reverse=True)
    res["profile_device_ms"] = sum(r[0] for r in rows)
    res["profile_top"] = rows[:12]
    t0 = time.perf_counter()
    ec._batched_em(depths, med, medmed, device=dev)
    torch.cuda.synchronize()
    res["batched_em_s"] = time.perf_counter() - t0
    res["batched_em_reps_s"] = []
    for _ in range(a.reps):
        t0 = time.perf_counter()
        ec._batched_em(depths, med, medmed, device=dev)
        torch.cuda.synchronize()
        res["batched_em_reps_s"].append(time.perf_counter() - t0)
    res["window_samples_per_s"] = a.windows * a.samples / res["batched_em_s"]
    n = min(a.merge_windows, B)
    lam_h, cn_h = lam[:n].cpu().numpy(), cn[:n].cpu().numpy()
    scaled = depths[:n] / med * medmed
    cache = em.Cache()
    t0 = time.perf_counter()
    for b in range(n):
        cache.add(em.EMD(lam_h[b], scaled[b], b * 1000, b * 1000 + 1000,
                         cn_h[b]))
    cache.clear(None)
    res["merge_ms_per_window"] = (time.perf_counter() - t0) * 1e3 / n
    for k, v in res.items():
        if k != "profile_top":
            print(f"{k}: {v}")
    for t, n, name in res["profile_top"]:
        print(f"  {t:10.3f} ms {n:5d}x {name}")
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
