"""Benchmark suite of the port: the JAX package's bench.py on the port's
own modules and the CUDA card.

    python -m goleft_tpu_torch bench [--quick] [--kernels-only]
        [--suite-host] [--no-probe] [--pin-baseline] [--out-dir DIR]

Prints ONE JSON line, the headline:
  {"metric": "torch_cohort_depth_e2e_gbases_per_sec", "value": N,
   "unit": "Gbases/s", "vs_baseline": N, ...}

The headline is the full ``cohortdepth`` path (open, BAI load, the native
decode and window reduction, matrix formatting) over a fabricated
low-pass cohort, warm wall clock, divided by the single-core numpy
windowing baseline (charged no decode work). The entries, each merged
into ``<out-dir>/details.json`` as soon as it exists and each guarded so
that one failure costs only itself:

  torch_device_kernels        the depth kernel resident on the card, on
                              the int32 wire with transfer and on the
                              packed u16 wire with transfer; its roofline
                              against the H100's HBM rate; numpy baseline
  torch_indexcov_cohort       indexcov's per-chromosome QC on the card
  torch_kernel_vs_plain_depth the depth kernel against its plain PyTorch
                              version on the same shards, outputs equal
  torch_emdepth_em            the batched EM + CN at the product chunk
  torch_depth_wholegenome     ``run_depth`` over uneven chromosomes:
                              kernel launches and nvcc builds cold and
                              warm (obs/compiles.py)
  torch_indexcov_e2e_wholegenome  the indexcov command end to end
  torch_cohort_scan           cohortscan against one-shot indexcov and an
                              incremental append, one process a leg
  torch_cohort_e2e_device     the device cohort engine beside the hybrid
                              one, their matrices asserted byte-identical
  torch_cohort_e2e            the headline
  torch_decode_thread_scaling the native window reduction under 1..N
                              decode threads (host work)
  torch_cram31_codec_decode   the CRAM 3.1 block codecs' decode MB/s, each
                              output held equal to its input (host work)
  torch_serve_throughput      the serve daemon under concurrent /v1/depth
                              load, cold and session-cache warm
  torch_fleet_throughput      the fleet router + 2 workers against one
                              daemon on the same load
  torch_fleet_restart_recovery_s   SIGKILL a supervised serve worker →
                              full capacity again
  torch_fleet_failover_recovery_s  SIGKILL a fleet router behind the
                              federation → failover, then recovery home
  torch_cohort_resume_overhead  cohortdepth plain vs checkpointed vs
                              resumed
  torch_pairhmm_forward       the pair-HMM forward, GCUPS
  torch_wire_decode           rANS-Nx16 decode on the host and on the
                              rANS kernel (ORDER0, ORDER1, STRIPE), each
                              lane byte-verified, and the wire bytes
  torch_read_mapping          seeding alone and the whole mapper, reads/s,
                              tuples held against the CPU path first
  torch_remote_fetch          object-store staging against the loopback
                              stub (host work)
  torch_profiler_overhead, torch_memory_overhead   the samplers' cost
                              (host work)

Every entry that does device work runs on the card (``platform``
"cuda") unless ``--suite-host`` asks for the CPU (``platform`` "cpu",
the plain version of every kernel); each carries the card's name and
``nvidia-smi``'s name and power limit. Host entries keep the JAX
package's labels. The two recovery entries start real ``serve``
processes, which run only on the card: under ``--suite-host`` they use
the card when there is one and are recorded as skipped (``NO_CARD_SKIP``)
when there is none. There is no probe and no fallback: without a card
and without ``--suite-host`` the command raises ``NoCudaDevice`` before
any entry runs (``--no-probe`` is accepted for the reference's flag set
and does nothing). An entry that raises is recorded as
``{"error": ...}``, the suite goes on, and the command exits 1 after
printing its headline.

Every file goes under ``--out-dir`` (default ``build/torch/bench``):
``details.json``, ``lastgood.json`` (this run's card entries, pinned),
``baseline_pinned.json`` (``--pin-baseline``) and the ledger
``ledger.jsonl`` that ``goleft-tpu-torch perf`` reads. Entry names and
the headline carry a ``torch_`` prefix so the ledger never files a
card's number under a TPU series.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np

from .obs.ledger import DEFAULT_OUT_DIR, LASTGOOD_NAME, LEDGER_NAME

HEADLINE = "torch_cohort_depth_e2e_gbases_per_sec"
DETAILS_NAME = "details.json"
PINNED_NAME = "baseline_pinned.json"

#: the H100's published peaks (NVIDIA's data sheet, SXM part): HBM3 and
#: float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

#: entries pinned into lastgood.json after a run on the card, in the
#: order the run records them
LASTGOOD_KEYS = ("torch_device_kernels", "torch_indexcov_cohort",
                 "torch_kernel_vs_plain_depth", "torch_emdepth_em",
                 "torch_depth_wholegenome", "torch_cohort_e2e_device")

def make_workload(length: int, coverage: int, read_len: int, seed: int):
    n = length * coverage // read_len
    rng = np.random.default_rng(seed)
    seg_s = rng.integers(0, length - read_len, size=n, dtype=np.int64)
    seg_s = np.sort(seg_s).astype(np.int32)
    seg_e = (seg_s + read_len).astype(np.int32)
    mapq = rng.integers(0, 61, size=n).astype(np.int32)
    keep = mapq >= 20
    return seg_s, seg_e, keep


def numpy_pipeline(seg_s, seg_e, keep, length, window, cap=2500,
                   min_cov=4):
    delta = np.zeros(length + 1, dtype=np.int32)
    np.add.at(delta, seg_s[keep], 1)
    np.add.at(delta, seg_e[keep], -1)
    depth = np.minimum(np.cumsum(delta[:length]), cap)
    wsums = depth.reshape(-1, window).sum(axis=1)
    cls = np.where(depth == 0, 0, np.where(depth < min_cov, 1, 2))
    return wsums, cls


# ---- the device and its provenance ----

def _sync(dev) -> None:
    """Wait for the card (a no-op on the CPU): every timed region ends
    here, since a launch returns before the kernel has run."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def provenance(dev) -> dict:
    """An entry's platform ("cuda" on the card, "cpu" under
    --suite-host), the card's name and ``nvidia-smi``'s name and power
    limit."""
    import torch

    from .obs.provenance import nvidia_smi_line

    cuda = dev.type == "cuda"
    return {"platform": "cuda" if cuda else "cpu",
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "nvidia_smi": nvidia_smi_line() if cuda else "not available"}


def roofline(bytes_moved: float, seconds: float, flops: float = 0.0,
             model: str = "") -> dict:
    """One roofline block against the H100's published peaks: achieved
    GB/s under the stated traffic model and its share of HBM3's 3.35
    TB/s, and (when ``flops``) achieved GFLOP/s against float32's 67
    TFLOP/s. The traffic model counts each input byte read once and each
    output byte written once."""
    gbps = bytes_moved / seconds / 1e9
    out = {
        "model": model,
        "bytes_moved_gb": round(bytes_moved / 1e9, 3),
        "achieved_gb_per_sec": round(gbps, 1),
        "hbm_peak_gb_per_sec": HBM_BYTES_PER_S / 1e9,
        "pct_of_hbm_peak": round(100 * gbps * 1e9 / HBM_BYTES_PER_S, 2),
        "bound_seconds": max(bytes_moved / HBM_BYTES_PER_S,
                             flops / FP32_FLOPS_PER_S),
    }
    if flops > 0:
        gflops = flops / seconds / 1e9
        out["achieved_gflop_per_sec"] = round(gflops, 1)
        out["pct_of_fp32_peak"] = round(
            100 * gflops * 1e9 / FP32_FLOPS_PER_S, 2)
    return out


def _timed(fn, *a, **kw) -> float:
    t0 = time.perf_counter()
    fn(*a, **kw)
    return time.perf_counter() - t0


# ---- the output directory ----

class OutDir:
    """The bench's files, all under one directory: details, the
    last-good pin, the pinned baseline and the ledger."""

    def __init__(self, path: str = DEFAULT_OUT_DIR):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def file(self, name: str) -> str:
        return os.path.join(self.path, name)

    @property
    def details(self) -> str:
        return self.file(DETAILS_NAME)

    @property
    def lastgood(self) -> str:
        return self.file(LASTGOOD_NAME)

    @property
    def pinned(self) -> str:
        return self.file(PINNED_NAME)

    @property
    def ledger(self) -> str:
        return self.file(LEDGER_NAME)


def _write_json(path: str, doc) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1)
    os.replace(tmp, path)


def _read_json(path: str):
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def merge_details(out: OutDir, details: dict) -> dict:
    """Merge entries into details.json (keeping entries other modes
    wrote) and echo each to stderr as ``name: {...}``."""
    prev = _read_json(out.details)
    prev = prev if isinstance(prev, dict) else {}
    prev.update(details)
    _write_json(out.details, prev)
    for k in details:
        print(f"{k}: {prev[k]}", file=sys.stderr)
    return prev


def _device_platform(entry: dict) -> bool:
    """True when an entry's own platform field proves a card run: only
    such an entry may be pinned with fresh device provenance."""
    return entry.get("platform") == "cuda"


def save_lastgood(out: OutDir, kernels_only: bool = False) -> bool:
    """Pin this run's card entries (each whose own platform is a device,
    without an error) and their provenance into lastgood.json. Pins
    nothing in --kernels-only mode, where the other entries were not
    refreshed, and nothing without a card entry of the depth kernel."""
    if kernels_only:
        return False
    det = _read_json(out.details)
    if not isinstance(det, dict):
        return False
    entries = {k: det[k] for k in LASTGOOD_KEYS
               if isinstance(det.get(k), dict)
               and "error" not in det[k] and _device_platform(det[k])}
    kern = entries.get("torch_device_kernels", {})
    if not kern:
        return False
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, timeout=10).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        sha = None
    _write_json(out.lastgood, {
        "provenance": {
            "ts": datetime.datetime.now(
                datetime.timezone.utc).isoformat(timespec="seconds"),
            "git_sha": sha, "device": kern.get("device"),
            "platform": kern.get("platform"),
            "nvidia_smi": kern.get("nvidia_smi"),
        },
        "entries": entries,
    })
    return True


def load_lastgood(out: OutDir):
    doc = _read_json(out.lastgood)
    if not isinstance(doc, dict) or "entries" not in doc:
        return None
    return doc


def drop_details(out: OutDir, keys) -> None:
    """Remove keys from details.json."""
    det = _read_json(out.details)
    if isinstance(det, dict) and any(k in det for k in keys):
        for k in keys:
            det.pop(k, None)
        _write_json(out.details, det)


# ---- the depth kernel ----

def bench_kernels(quick: bool, dev) -> dict:
    """The depth kernel per shard: resident on the card (inputs staged
    first), on the int32 wire with the host-to-card copy of each shard,
    and on the packed u16 wire with the host packing and its copy; the
    roofline of the resident rate and the numpy single-core baseline."""
    import torch

    from .ops.coverage import bucket_size, pack_segments_u16
    from .ops.depth_pipeline import (
        shard_depth_pipeline_cls_packed,
        shard_depth_pipeline_packed_cls_packed,
    )

    length = 2_500_000 if quick else 10_000_000
    window = 250
    coverage, read_len = 30, 150
    iters = 3 if quick else 10
    works = [make_workload(length, coverage, read_len, s)
             for s in range(iters + 1)]
    args = (0, 0, length, 2500, 4, 0, length, window)

    def put(w):
        return tuple(torch.from_numpy(a).to(dev) for a in w)

    def run(t):
        return shard_depth_pipeline_cls_packed(*t, *args)

    run(put(works[0]))  # first launch (and the build, if not built)
    staged = [put(w) for w in works]
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(iters):
        run(staged[i + 1])
    _sync(dev)
    dt = time.perf_counter() - t0
    del staged

    t0 = time.perf_counter()
    for i in range(iters):
        run(put(works[i + 1]))
    _sync(dev)
    e2e_dt = time.perf_counter() - t0

    def run_packed(w):
        d, ln, base, n_ent = pack_segments_u16(*w)
        b = bucket_size(max(n_ent, 1))
        dd = np.zeros(b, np.uint16)
        ll = np.zeros(b, np.uint16)
        dd[:n_ent] = d
        ll[:n_ent] = ln
        return shard_depth_pipeline_packed_cls_packed(
            torch.from_numpy(dd).to(dev), torch.from_numpy(ll).to(dev),
            int(base), *args)

    run_packed(works[0])
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(iters):
        run_packed(works[i + 1])
    _sync(dev)
    packed_dt = time.perf_counter() - t0

    # the bytes a dense=False call must move: 9 B a segment in (two
    # int32 endpoints and the keep byte), the f32 window sums and the
    # 2-bit classes out
    n_segs_avg = sum(len(w[0]) for w in works[1:]) / iters
    n_win = length // window
    per_iter = n_segs_avg * 9 + n_win * 4 + (length + 3) // 4
    seg_s, seg_e, keep = works[0]
    numpy_pipeline(seg_s, seg_e, keep, length, window)
    np_dt = min(_timed(numpy_pipeline, seg_s, seg_e, keep, length, window)
                for _ in range(3))
    return {
        "window": window, **provenance(dev),
        "kernel_device_resident_gbases_per_sec": round(
            length * iters / dt / 1e9, 4),
        "kernel_e2e_incl_transfer_gbases_per_sec": round(
            length * iters / e2e_dt / 1e9, 4),
        "kernel_e2e_packed_wire_gbases_per_sec": round(
            length * iters / packed_dt / 1e9, 4),
        "kernel_shard_bp": length, "kernel_coverage": coverage,
        "kernel_read_len": read_len, "kernel_iters": iters,
        "roofline": roofline(
            per_iter * iters, dt,
            model="per segment 9 B in (int32 endpoints + keep byte); "
                  "per window 4 B out (f32 sum); per base 2 bits out "
                  "(packed class): the dense=False call's inputs read "
                  "once and outputs written once"),
        "numpy_single_core_gbases_per_sec": round(length / np_dt / 1e9, 4),
    }


def bench_kernel_vs_plain(quick: bool, dev) -> dict:
    """The depth kernel against its plain PyTorch version on the same
    device and shards (three workloads each): every output equal, then
    the time of one shard each way."""
    import torch

    from .ops.depth_kernel import fused_depth, fused_depth_plain

    length = 2_500_000 if quick else 10_000_000
    window = 250
    works = [tuple(torch.from_numpy(a).to(dev)
                   for a in make_workload(length, 30, 150, 100 + s))
             for s in range(3)]
    args = (0, 0, length, 2500, 4, 0, length, window)

    def kern(w):
        return fused_depth(*w, *args, dense=True)

    def plain(w):
        return fused_depth_plain(*w, *args)

    for w in works:
        for g, p in zip(kern(w), plain(w)):
            if g.dtype != p.dtype or not torch.equal(g, p):
                raise AssertionError(
                    "depth kernel differs from its plain version")

    def per_shard(fn):
        fn(works[0])
        _sync(dev)
        t0 = time.perf_counter()
        for w in works:
            fn(w)
        _sync(dev)
        return (time.perf_counter() - t0) / len(works)

    t_kern = per_shard(kern)
    t_plain = per_shard(plain)
    return {
        "shard_bp": length, "coverage": 30, **provenance(dev),
        "kernel_ms": round(t_kern * 1e3, 3),
        "plain_ms": round(t_plain * 1e3, 3),
        "kernel_over_plain": round(t_kern / t_plain, 3),
        "identical_output": True,  # a difference raises above
        "note": "csrc/depth_kernel.cu (dense outputs) against "
                "ops/depth_kernel.py::fused_depth_plain on the same "
                "tensors; depth, window sums, classes and packed "
                "classes asserted equal before the clock",
    }


# ---- indexcov and the EM ----

def _ix_cohort_qc(d, v, n_t) -> float:
    """indexcov's per-chromosome QC (histogram, ROC, counters, CN) —
    one definition for the card entry and the host check; the scalar
    fetch waits for the device."""
    from .ops import indexcov_ops as ic

    rocs = ic.counts_roc(ic.counts_at_depth(d, v))
    cnt = ic.bin_counters(d, v, n_t)
    cn = ic.get_cn(d, v)
    return (float(rocs.sum()) + float(cnt["in"].sum())
            + float(cn.sum()))


def _em_chunk_run(m) -> int:
    """The EM and CN of one chunk — shared like _ix_cohort_qc."""
    from .models.emdepth import cn_batch, em_depth_batch

    return int(cn_batch(em_depth_batch(m), m).to("cpu").sum())


def bench_indexcov_cohort(quick: bool, dev, rng) -> dict:
    import torch

    n_samples = 100 if quick else 500
    n_tiles = 30_000 if quick else 190_000
    reps = 3
    mats = [torch.from_numpy(rng.gamma(20, 0.05, size=(
        n_samples, n_tiles)).astype(np.float32)).to(dev)
        for _ in range(reps + 1)]
    v = torch.ones((n_samples, n_tiles), dtype=torch.bool, device=dev)
    _ix_cohort_qc(mats[0], v, n_tiles)
    t0 = time.perf_counter()
    for r in range(reps):
        _ix_cohort_qc(mats[r + 1], v, n_tiles)
    dt = (time.perf_counter() - t0) / reps
    return {
        "samples": n_samples, "tiles": n_tiles, "seconds": round(dt, 4),
        "samples_per_sec": round(n_samples / dt, 1), **provenance(dev),
        "note": "hist+ROC+counters+CN on the device (excl. index parse)",
        "roofline": roofline(
            n_samples * n_tiles * (4 + 1), dt,
            model="the (samples x tiles) f32 matrix and bool mask read "
                  "once; O(samples) outputs ignored"),
    }


def bench_emdepth_em(quick: bool, dev, rng) -> dict:
    import torch

    from .commands.emdepth_cmd import EM_CHUNK
    from .models.emdepth import MAX_ITER, N_LAMBDA

    n_s = 500 if quick else 2504
    n_w = 2048 if quick else EM_CHUNK
    em_reps = 2
    ems = [torch.from_numpy(rng.gamma(30, 1.0, size=(n_w, n_s)).astype(
        np.float32)).to(dev) for _ in range(em_reps + 1)]
    _em_chunk_run(ems[0])
    t0 = time.perf_counter()
    for r in range(em_reps):
        _em_chunk_run(ems[r + 1])
    dt = (time.perf_counter() - t0) / em_reps
    per_iter_flops = n_s * N_LAMBDA * 6
    wgs_windows = 3_000_000
    return {
        "windows": n_w, "samples": n_s, "seconds": round(dt, 4),
        "window_calls_per_sec": round(n_w / dt, 1),
        "wgs_extrapolated_minutes": round(
            wgs_windows / (n_w / dt) / 60, 2),
        **provenance(dev),
        "note": "EM + CN of one chunk on the device (f32 tensor ops, no "
                "kernel of the port's own)",
        "roofline": roofline(
            float(n_w) * n_s * 4, dt,
            flops=float(n_w) * per_iter_flops * MAX_ITER,
            model=f"the (B, S) f32 chunk read once; ~{N_LAMBDA * 6} "
                  f"flops a sample a step, {MAX_ITER} steps"),
    }


def _fabricate_bai_cohort(d: str, n_ix: int, chrom_lens, rng) -> list:
    """Write n_ix whole-genome .bai files + ref.fa.fai into d."""
    import glob
    import struct

    with open(f"{d}/ref.fa.fai", "w") as fh:
        for i, ln in enumerate(chrom_lens):
            fh.write(f"chr{i + 1}\t{ln}\t6\t60\t61\n")
    for s in range(n_ix):
        blob = bytearray(b"BAI\x01") + struct.pack("<i", len(chrom_lens))
        for ln in chrom_lens:
            n_t = ln // 16384
            blob += struct.pack("<i", 1)
            blob += struct.pack("<Ii", 0x924A, 2)
            blob += struct.pack("<QQ", 0, 0)
            blob += struct.pack("<QQ", 40_000_000, 80_000)
            base = int(rng.integers(0, 1 << 30))
            deltas = rng.integers(20_000, 60_000, size=n_t).astype(
                np.int64)
            ivs = ((base + np.cumsum(deltas)).astype(np.uint64)
                   * np.uint64(1 << 16))
            blob += struct.pack("<i", n_t) + ivs.astype("<u8").tobytes()
        blob += struct.pack("<Q", 0)
        with open(f"{d}/s{s:03d}.bai", "wb") as fh:
            fh.write(bytes(blob))
    return sorted(glob.glob(f"{d}/*.bai"))


def bench_indexcov_e2e(quick: bool, dev, rng, n_ix: int | None = None,
                       chrom_lens=None) -> dict:
    """indexcov end to end at the reference's headline scale (README:
    "30 samples x 60X WGS in ~30s"): fabricated whole-genome .bai files
    through the command (bed.gz, ped, roc, html, png), with the stages
    split by runs with features turned off."""
    import shutil
    import tempfile

    from .commands.indexcov import run_indexcov
    from .io.sampleindex import SampleIndex

    d = tempfile.mkdtemp(prefix="goleft_torch_ixc_")
    try:
        n_ix = n_ix or (10 if quick else 30)
        chrom_lens = chrom_lens or [int(2.5e8 * (1 - i * 0.03))
                                    for i in range(25)]
        bais = _fabricate_bai_cohort(d, n_ix, chrom_lens, rng)
        kw = dict(fai=f"{d}/ref.fa.fai", exclude_patt="", sex="",
                  device=dev)
        run_indexcov(bais, directory=f"{d}/w", **kw)  # warm-up
        t0 = time.perf_counter()
        run_indexcov(bais, directory=f"{d}/out", **kw)
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        for b in bais:
            SampleIndex(b)
        t_parse = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_indexcov(bais, directory=f"{d}/o2", write_html=False,
                     write_png=False, **kw)
        t_core = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_indexcov(bais, directory=f"{d}/o3", write_png=False, **kw)
        t_html = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {
        "samples": n_ix, "chromosomes": len(chrom_lens),
        "genome_gb": round(sum(chrom_lens) / 1e9, 2),
        "seconds_warm": round(dt, 2),
        "stage_seconds": {
            "bai_parse": round(t_parse, 2),
            "qc_bed_roc_ped": round(t_core - t_parse, 2),
            "html": round(t_html - t_core, 2),
            "png": round(dt - t_html, 2),
        },
        **provenance(dev),
        "note": "full command path: .bai parse -> QC on the device -> "
                "bed.gz/ped/roc/html/png; the reference's README cites "
                "~30s for 30 samples",
    }


# ---- whole-genome depth ----

def wholegenome_fixture(d: str, n_chrom: int, base_len: int):
    """One BAM (+BAI) over ``n_chrom`` chromosomes of uneven length, 4x
    of 100 bp reads with MAPQ 0-60, and its .fai → (bam, fai, lengths)."""
    from .io.bai import build_bai, write_bai
    from .io.bam import BamWriter

    coverage, read_len = 4, 100
    chrom_lens = [int(base_len * (1 - 0.055 * i)) for i in range(n_chrom)]
    names = [f"chr{i + 1}" for i in range(n_chrom)]
    rng = np.random.default_rng(2)
    bam = f"{d}/wg.bam"
    hdr = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in zip(names, chrom_lens))
    with open(bam, "wb") as fh:
        with BamWriter(fh, hdr, names, chrom_lens, level=1) as w:
            for tid, ln in enumerate(chrom_lens):
                n_reads = ln * coverage // read_len
                starts = np.sort(rng.integers(0, ln - read_len, size=n_reads))
                mapqs = rng.integers(0, 61, size=n_reads)
                for i, (s, q) in enumerate(zip(starts, mapqs)):
                    w.write_record(tid, int(s), [(read_len, 0)],
                                   mapq=int(q), name=f"r{tid}_{i}")
    write_bai(build_bai(bam), bam + ".bai")
    fai = f"{d}/ref.fa.fai"
    with open(fai, "w") as fh:
        for n, ln in zip(names, chrom_lens):
            fh.write(f"{n}\t{ln}\t6\t60\t61\n")
    return bam, fai, chrom_lens


def bench_depth_wholegenome(quick: bool, dev, n_chrom: int | None = None,
                            base_len: int | None = None) -> dict:
    """Whole-genome depth: one BAM over uneven chromosomes, 250 bp
    windows, MAPQ >= 20, through ``run_depth``, cold and warm. The port
    builds each kernel source once (nvcc) and launches one geometry for
    every shard, so a warm repeat of the genome must build nothing and
    meet no new launch signature: its launches are shards, not
    compiles."""
    import shutil
    import tempfile

    from .commands.depth import run_depth
    from .obs.compiles import TRACKER
    from .ops import depth_kernel

    n_chrom = n_chrom or (6 if quick else 12)
    base_len = base_len or (600_000 if quick else 1_800_000)
    d = tempfile.mkdtemp(prefix="goleft_torch_wg_")
    try:
        bam, fai, chrom_lens = wholegenome_fixture(d, n_chrom, base_len)

        def run(tag):
            stages: dict = {}
            launches0 = depth_kernel.LAUNCHES["depth"]
            builds0 = len(TRACKER.builds())
            compiles0 = TRACKER.compiles_total
            t0 = time.perf_counter()
            try:
                run_depth(bam, f"{d}/{tag}", fai=fai, window=250,
                          mapq=20, stage_totals=stages, device=dev)
            except SystemExit as e:
                # a failed shard's exit must cost this entry, not the
                # suite
                raise RuntimeError(
                    f"run_depth failed (exit {e.code})") from e
            dt = time.perf_counter() - t0
            built = [b for b in TRACKER.builds()[builds0:]
                     if not b["cached"]]
            return (dt, stages, depth_kernel.LAUNCHES["depth"] - launches0,
                    len(built), TRACKER.compiles_total - compiles0)

        t_cold, _, l_cold, b_cold, c_cold = run("cold")
        t_warm, st_warm, l_warm, b_warm, c_warm = run("warm")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    total_bp = sum(chrom_lens)
    return {
        "chromosomes": n_chrom, "genome_bp": total_bp,
        "coverage": 4, "window": 250, "mapq_min": 20,
        **provenance(dev),
        "seconds_cold": round(t_cold, 3),
        "seconds_warm": round(t_warm, 3),
        "gbases_per_sec_warm": round(total_bp / t_warm / 1e9, 4),
        "extrapolated_3gb_minutes": round(
            3e9 / (total_bp / t_warm) / 60, 2),
        "stage_seconds": {k: round(v, 3)
                          for k, v in sorted(st_warm.items())},
        "stage_note": "per-thread sums from the shard pool "
                      "(overlapping threads can exceed wall)",
        "kernel_launches_cold": l_cold,
        "kernel_launches_warm_repeat": l_warm,
        "nvcc_builds_cold": b_cold,
        "nvcc_builds_warm_repeat": b_warm,
        "first_launch_signatures_cold": c_cold,
        "first_launch_signatures_warm_repeat": c_warm,
        "no_rebuild_across_chroms": b_warm == 0 and c_warm == 0,
        "note": f"{n_chrom} uneven chromosomes through run_depth "
                "(decode -> depth kernel -> bed writers); the kernel is "
                "built once per source (nvcc, cached on disk) and a warm "
                "repeat adds launches only",
    }


# ---- the cohorts ----

def _build_cohort_fixture(n_samples: int, ref_len: int, coverage: int,
                          read_len: int = 100):
    """One coordinate-sorted BAM (+BAI) replicated n_samples times, and
    a .fai that declares the contig's length → (tmp dir, bams, fai,
    read starts)."""
    import shutil
    import tempfile

    from .io.bai import build_bai, write_bai
    from .io.bam import BamWriter

    n_reads = ref_len * coverage // read_len
    d = tempfile.mkdtemp(prefix="goleft_torch_cohort_")
    rng = np.random.default_rng(0)
    starts = np.sort(rng.integers(0, ref_len - read_len, size=n_reads))
    base = f"{d}/s000.bam"
    with open(base, "wb") as fh:
        with BamWriter(
            fh, "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:"
            f"{ref_len}\n@RG\tID:r\tSM:s000\n", ["chr1"], [ref_len],
            level=1,
        ) as w:
            for i, s in enumerate(starts):
                w.write_record(0, int(s), [(read_len, 0)], mapq=60,
                               name=f"r{i}")
    write_bai(build_bai(base), base + ".bai")
    with open(f"{d}/ref.fa.fai", "w") as fh:
        fh.write(f"chr1\t{ref_len}\t6\t60\t61\n")
    bams = [base]
    for i in range(1, n_samples):
        p = f"{d}/s{i:03d}.bam"
        shutil.copyfile(base, p)
        shutil.copyfile(base + ".bai", p + ".bai")
        bams.append(p)
    return d, bams, f"{d}/ref.fa.fai", starts


class _Null:
    def write(self, *_):
        pass


def bench_cohort(n_samples: int = 50, ref_len: int = 10_000_000,
                 coverage: int = 4, dev=None) -> dict:
    """The headline: ``run_cohortdepth`` end to end over a fabricated
    cohort (the hybrid engine: the native decode and window reduction
    on the host, which is where a BAM cohort's work is), cold at the
    default pool and warm at the measured best pool, with a stage split
    and the numpy single-core windowing baseline."""
    import shutil

    from .commands.cohortdepth import cohort_matrix_blocks, matrix_rows
    from .commands.cohortdepth import run_cohortdepth
    from .io import native
    from .resilience.policy import Quarantine
    from .utils.decode_scaling import (
        auto_processes, measure_scaling_curve, optimal_threads,
    )

    read_len = 100
    d, bams, fai, starts = _build_cohort_fixture(
        n_samples, ref_len, coverage, read_len)
    kw = dict(fai=fai, window=500, out=_Null(), device=dev)
    # the headline measures the strict default: no inherited skip-CRC
    prev_skip = os.environ.pop("GOLEFT_TPU_SKIP_CRC", None)
    try:
        t0 = time.perf_counter()
        run_cohortdepth(bams, processes=auto_processes(), **kw)
        cold = time.perf_counter() - t0
        n_probe = min(n_samples, max(4, 2 * auto_processes()))
        dec_curve = measure_scaling_curve(bams[:n_probe], ref_len,
                                          window=500, repeats=2)
        n_dec = optimal_threads(dec_curve)
        wall = min(_timed(run_cohortdepth, bams, processes=n_dec, **kw)
                   for _ in range(2))
        os.environ["GOLEFT_TPU_SKIP_CRC"] = "1"
        wall_nocrc = _timed(run_cohortdepth, bams, processes=n_dec, **kw)
    finally:
        if prev_skip is None:
            os.environ.pop("GOLEFT_TPU_SKIP_CRC", None)
        else:
            os.environ["GOLEFT_TPU_SKIP_CRC"] = prev_skip

    try:
        t0 = time.perf_counter()
        _, blocks = cohort_matrix_blocks(bams, fai=fai, window=500,
                                         quarantine=Quarantine(),
                                         device=dev)
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        kept = list(blocks)
        t_reduce = time.perf_counter() - t0
        t0 = time.perf_counter()
        for blk in kept:
            matrix_rows(*blk)
        t_format = time.perf_counter() - t0
        # the decode floor: the same file through the product's ring
        # driver with a no-op walk; the inflate(+CRC) share of the
        # decode stage is libdeflate's per-core floor, the rest the
        # record walk
        floor = None
        if native.get_lib() is not None:
            comp = np.fromfile(bams[0], dtype=np.uint8)
            total = native.bgzf_stream_inflate_only(comp)
            t_crc = min(_timed(native.bgzf_stream_inflate_only, comp)
                        for _ in range(3))
            t_nocrc = min(_timed(native.bgzf_stream_inflate_only, comp,
                                 check_crc=False) for _ in range(3))
            per_sample = t_reduce / n_samples
            floor = {
                "uncompressed_mb": round(total / 1e6, 1),
                "ring_inflate_crc_ms": round(t_crc * 1e3, 2),
                "ring_inflate_ms": round(t_nocrc * 1e3, 2),
                "full_decode_reduce_ms": round(per_sample * 1e3, 2),
                "record_walk_ms": round(
                    max(per_sample - t_crc, 0.0) * 1e3, 2),
                "inflate_crc_share": round(min(t_crc / per_sample, 1.0),
                                           3),
                "note": "per sample; identical ring driver minus the "
                        "walk: the inflate+CRC share is libdeflate at "
                        "hardware rates (the per-core decode floor)",
            }
    finally:
        shutil.rmtree(d, ignore_errors=True)

    seg_s = starts.astype(np.int32)
    seg_e = (seg_s + read_len).astype(np.int32)
    keep = np.ones(len(seg_s), bool)
    np_one = _timed(numpy_pipeline, seg_s, seg_e, keep, ref_len, 500)
    gbases = n_samples * ref_len / 1e9
    return {
        "samples": n_samples, "ref_bp": ref_len, "coverage": coverage,
        **provenance(dev),
        "wall_seconds_warm": round(wall, 3),
        "wall_seconds_cold": round(cold, 3),
        "decode_threads_used": n_dec,
        "decode_thread_probe": {str(k): round(v, 4)
                                for k, v in sorted(dec_curve.items())},
        "cold_note": "cold run uses the product-default pool "
                     "(auto_processes) and includes library load + "
                     "first touch; warm runs use the probed optimum",
        "gbases_per_sec": round(gbases / wall, 4),
        "gbases_per_sec_skip_crc": round(gbases / wall_nocrc, 4),
        "stage_seconds": {
            "open_and_index": round(t_load, 3),
            "decode_window_reduce": round(t_reduce, 3),
            "format_matrix": round(t_format, 3),
        },
        "decode_floor": floor,
        "numpy_kernel_only_seconds": round(np_one * n_samples, 2),
        "numpy_kernel_gbases_per_sec": round(
            gbases / (np_one * n_samples), 4),
        "note": "end to end incl. open, BAI load, the native decode + "
                "window reduce on the host (the hybrid engine: a BAM "
                "cohort launches no kernel), matrix formatting (C when "
                "the host library is loaded); the numpy baseline is "
                "charged no decode work",
    }


def overlap_efficiency(totals: dict, wall: float,
                       compute_stage: str = "compute") -> float | None:
    """How much of the non-compute stage seconds the pipeline hid behind
    ``compute_stage``, in [0, 1] (the reference's
    utils/profiling.py::overlap_efficiency over stage totals); None when
    nothing hideable was recorded."""
    hideable = sum(v for k, v in totals.items() if k != compute_stage)
    if hideable <= 0.0:
        return None
    hidden = sum(totals.values()) - wall
    return max(0.0, min(1.0, hidden / hideable))


def bench_cohort_device(n_samples: int = 20, ref_len: int = 4_000_000,
                        coverage: int = 4, dev=None) -> dict:
    """The device cohort engine (segments to the depth kernel) beside
    the hybrid engine at the same scale: both matrices through
    ``run_cohortdepth``, asserted byte-identical; rates per core
    (processes=1), the prefetched pipeline's stage spans, and the
    crossover: how many cards the segment path needs to beat the host
    cores on the hybrid engine."""
    import io as _io
    import shutil

    from .commands.cohortdepth import run_cohortdepth
    from .io.bam import BamFile
    from .utils.decode_scaling import auto_processes, effective_cores
    from .utils.profiling import process_spans

    d, bams, fai, _ = _build_cohort_fixture(n_samples, ref_len, coverage)
    try:
        def run(engine, prefetch_depth=0, processes=1):
            buf = _io.StringIO()
            run_cohortdepth(bams, fai=fai, window=500, out=buf,
                            engine=engine, processes=processes,
                            prefetch_depth=prefetch_depth, device=dev)
            return buf.getvalue()

        out_h = run("hybrid")
        t_h = min(_timed(run, "hybrid") for _ in range(2))
        out_d = run("device")
        t_d = min(_timed(run, "device") for _ in range(2))
        if out_h != out_d:
            raise RuntimeError(
                "device engine output diverged from hybrid "
                f"({len(out_h)} vs {len(out_d)} bytes)")

        n_proc = auto_processes()
        run("device", prefetch_depth=2, processes=n_proc)
        before = process_spans()
        t0 = time.perf_counter()
        out_p = run("device", prefetch_depth=2, processes=n_proc)
        t_p = time.perf_counter() - t0
        if out_p != out_d:
            raise RuntimeError(
                "prefetched device engine output diverged from the "
                f"serial path ({len(out_p)} vs {len(out_d)} bytes)")
        spans = {k: {"seconds": round(v["seconds"] - before.get(
                     k, {}).get("seconds", 0.0), 4),
                     "calls": v["calls"] - before.get(k, {}).get(
                         "calls", 0)}
                 for k, v in sorted(process_spans().items())}
        spans = {k: v for k, v in spans.items() if v["calls"]}
        prefetch_entry = {
            "prefetch_depth": 2, "decode_workers": n_proc,
            "seconds": round(t_p, 3),
            "identical_output": True,  # divergence raises above
            "stage_spans": spans,
            "overlap_efficiency": overlap_efficiency(
                {k: v["seconds"] for k, v in spans.items()}, t_p,
                compute_stage="device-compute"),
            "note": "per-stage span totals of the run; overlap_efficiency "
                    "= hidden non-compute seconds / hideable non-compute "
                    "seconds (None = nothing recorded)",
        }

        def extract_all():
            for p in bams:
                BamFile.from_file(p).read_segments(0, 0, ref_len, 1,
                                                   0x704)

        extract_all()
        t_extract = min(_timed(extract_all) for _ in range(2))
    finally:
        shutil.rmtree(d, ignore_errors=True)

    gbases = n_samples * ref_len / 1e9
    cores = effective_cores()
    r_hybrid = gbases / t_h
    r_extract = gbases / t_extract
    t_chip = t_d - t_extract
    resolvable = t_chip > max(0.002, 0.02 * t_d)
    r_chip = gbases / t_chip if resolvable else None
    chips_needed = (int(np.ceil(cores * r_hybrid / r_chip))
                    if resolvable else 1)
    statement = (
        f"the device engine needs >= {chips_needed} card(s) at the "
        f"measured segment-path rate ({r_chip:.3f} Gbases/s per card) "
        f"to beat {cores} host core(s) running the hybrid engine "
        f"({r_hybrid:.3f} Gbases/s/core); its ceiling is the host "
        f"extraction rate ({r_extract:.3f} Gbases/s/core)"
        if resolvable else
        f"the card's share of the device wall is below measurement "
        f"noise on this run (t_d={t_d:.3f}s ~ t_extract="
        f"{t_extract:.3f}s): the segment path is extraction-bound here, "
        f"so 1 card suffices wherever extraction ({r_extract:.3f} "
        f"Gbases/s/core) outpaces the hybrid reduce ({r_hybrid:.3f} "
        f"Gbases/s/core)")
    return {
        "samples": n_samples, "ref_bp": ref_len, "coverage": coverage,
        **provenance(dev),
        "hybrid_seconds": round(t_h, 3),
        "device_seconds": round(t_d, 3),
        "hybrid_gbases_per_sec": round(r_hybrid, 4),
        "device_gbases_per_sec": round(gbases / t_d, 4),
        "identical_output": True,  # divergence raises above
        "stage_seconds": {
            "host_segment_extract": round(t_extract, 3),
            "pack_transfer_compute": round(max(t_chip, 0.0), 3),
        },
        "prefetch": prefetch_entry,
        "crossover": {
            "effective_cores": cores,
            "per_core_hybrid_gbases_per_sec": round(r_hybrid, 4),
            "per_core_extract_gbases_per_sec": round(r_extract, 4),
            "per_chip_segment_path_gbases_per_sec": (
                round(r_chip, 4) if resolvable else None),
            "chips_needed_to_beat_hybrid": chips_needed,
            "statement": statement,
        },
        "note": "both engines through run_cohortdepth, serial "
                "(processes=1) so every rate is per core; divergent "
                "outputs raise instead of recording",
    }


_COHORT_SCAN_LEG = '''\
import json, resource, sys, time

spec = json.load(open(sys.argv[1]))
if spec["mode"] == "monolithic":
    from goleft_tpu_torch.commands.indexcov import run_indexcov as _run
else:
    from goleft_tpu_torch.cohort.scan import run_cohortscan as _run

t0 = time.perf_counter()
if spec["mode"] == "monolithic":
    _run(spec["bams"], spec["out"], fai=spec["fai"], write_html=False,
         write_png=False, device=spec["device"])
    qc = None
else:
    res = _run(spec["bams"], spec["out"], fai=spec["fai"],
               chunk_samples=spec["chunk_samples"],
               resume=spec["resume"], device=spec["device"])
    qc = res["qc"]
dt = time.perf_counter() - t0
print(json.dumps({
    "seconds": dt, "qc": qc,
    "peak_rss_kb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}))
'''


def bench_cohort_scan(quick: bool = False, dev=None) -> dict:
    """cohortscan against one-shot indexcov on the same 3-chromosome
    cohort: (a) ``run_indexcov``, (b) streaming chunked
    ``run_cohortscan``, (c) an incremental ``resume`` append of k new
    samples. Each leg runs in its own process, so ``ru_maxrss`` is that
    leg's peak, and the append leg's QC counters are asserted: it
    computed only the k new samples' columns."""
    import shutil
    import tempfile

    from .cohort.biobank_smoke import REFS, make_biobank_cohort

    n = 8 if quick else 16
    k = 2 if quick else 4
    chunk = 4
    d = tempfile.mkdtemp(prefix="goleft_torch_cscan_")
    try:
        bams, fai = make_biobank_cohort(d, n=n)
        leg_py = os.path.join(d, "leg.py")
        with open(leg_py, "w") as fh:
            fh.write(_COHORT_SCAN_LEG)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=repo)
        env.pop("GOLEFT_TPU_FAULTS", None)

        def leg(mode, leg_bams, out, resume=False):
            spec = {"mode": mode, "bams": leg_bams, "out": out,
                    "fai": fai, "chunk_samples": chunk, "resume": resume,
                    "device": str(dev)}
            sp = os.path.join(d, f"{mode}{'_r' if resume else ''}.json")
            with open(sp, "w") as fh:
                json.dump(spec, fh)
            rc = subprocess.run([sys.executable, leg_py, sp], env=env,
                                capture_output=True, text=True,
                                timeout=600)
            if rc.returncode != 0:
                raise RuntimeError(f"cohort_scan {mode} leg failed: "
                                   f"{rc.stderr[-2000:]}")
            return json.loads(rc.stdout.splitlines()[-1])

        mono = leg("monolithic", bams, os.path.join(d, "m", "out"))
        cold = leg("cohortscan", bams, os.path.join(d, "c", "out"))
        inc = os.path.join(d, "i", "out")
        leg("cohortscan", bams[: n - k], inc)  # prefill (untimed)
        app = leg("cohortscan", bams, inc, resume=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    n_chroms = len(REFS)
    if app["qc"] != {"computed": k * n_chroms,
                     "resumed": (n - k) * n_chroms}:
        raise RuntimeError(f"append leg QC counters off: {app['qc']} "
                           f"(want {k}x{n_chroms} computed)")

    def _leg_out(r, n_done):
        return {"seconds": round(r["seconds"], 3),
                "samples_per_sec": round(n_done / r["seconds"], 2),
                "peak_rss_mb": round(r["peak_rss_kb"] / 1024, 1)}

    return {
        "samples": n, "chromosomes": n_chroms, "chunk_samples": chunk,
        **provenance(dev),
        "monolithic": _leg_out(mono, n),
        "chunked": _leg_out(cold, n),
        "incremental_append": dict(
            _leg_out(app, k), samples_appended=k,
            qc_computed=app["qc"]["computed"],
            qc_resumed=app["qc"]["resumed"]),
        "peak_rss_delta_mb": round(
            cold["peak_rss_kb"] / 1024 - mono["peak_rss_kb"] / 1024, 1),
        "note": "one process a leg (its ru_maxrss, torch's import "
                "included); the append leg's QC counters asserted",
    }


# ---- pair-HMM and mapping ----

def pairhmm_batch(n_pairs: int):
    """Synthetic (reads, quals, haps): reads of 100 and 150 bp taken
    from haplotypes 100 bp longer, a mismatch every 17 bases."""
    rng = np.random.default_rng(11)
    bases = list("ACGT")
    reads, quals, haps = [], [], []
    for i in range(n_pairs):
        rl = 100 if i % 2 else 150
        hap = "".join(rng.choice(bases, rl + 100))
        start = int(rng.integers(0, 100))
        rd = list(hap[start:start + rl])
        for kk in range(0, rl, 17):  # sprinkle mismatches
            rd[kk] = bases[int(rng.integers(4))]
        reads.append("".join(rd))
        quals.append(rng.integers(10, 41, rl))
        haps.append(hap)
    return reads, quals, haps


#: the pair-HMM entry's gate: the most the card's log10 likelihoods may
#: differ from the plain version's on the CPU
PAIRHMM_ATOL = 5e-5


def bench_pairhmm_forward(quick: bool, dev, n_pairs: int | None = None
                          ) -> dict:
    """The pair-HMM forward on a synthetic read x haplotype batch of two
    read lengths (two length buckets): warm throughput and GCUPS (DP
    cell updates a second). The clock starts only after the warm-up's
    likelihoods agree with the CPU path's (the plain version) within
    PAIRHMM_ATOL log10."""
    from .ops import pairhmm as ph

    n_pairs = n_pairs or (128 if quick else 512)
    reads, quals, haps = pairhmm_batch(n_pairs)
    warm = ph.forward_pairs(reads, quals, haps, device=dev)
    oracle = ph.forward_pairs(reads, quals, haps, device="cpu")
    err = float(np.max(np.abs(warm - oracle)))
    if not err <= PAIRHMM_ATOL:
        raise AssertionError(
            f"pairhmm forward on the device differs from the CPU path by "
            f"{err} log10 (tolerance {PAIRHMM_ATOL})")
    t0 = time.perf_counter()
    ll = ph.forward_pairs(reads, quals, haps, device=dev)
    dt = time.perf_counter() - t0
    if not np.all(np.isfinite(ll)):
        raise RuntimeError("pairhmm forward produced non-finite "
                           "likelihoods")
    cells = ph.total_cells(reads, haps)
    return {
        "pairs": n_pairs, "read_lens": [100, 150], "hap_lens": [200, 250],
        "cells": cells, "seconds_warm": round(dt, 4),
        "pairs_per_sec": round(n_pairs / dt, 1),
        "gcups": round(cells / dt / 1e9, 4), "max_abs_err_vs_plain": err,
        **provenance(dev),
        "likelihoods": ll,
        "note": "rescaled f32 forward (csrc/pairhmm_kernel.cu on the "
                "card), two length buckets, warm; GCUPS = DP cells/s",
    }


def mapping_inputs(d: str, ref_bp: int, n_reads: int, rlen: int = 100):
    """A random reference written to ``d``/ref.fa and ``n_reads``
    (name, seq, qual) reads of ``rlen`` bp from it, two substitutions
    each, half reverse-complemented → (fasta path, reads)."""
    rng = np.random.default_rng(23)
    bases = b"ACGT"
    refseq = bytes(rng.choice(list(bases), size=ref_bp).tolist())
    fa = f"{d}/ref.fa"
    with open(fa, "wb") as fh:
        fh.write(b">chr1\n")
        for i in range(0, ref_bp, 60):
            fh.write(refseq[i:i + 60] + b"\n")
    reads = []
    for i in range(n_reads):
        s = int(rng.integers(0, ref_bp - rlen))
        frag = bytearray(refseq[s:s + rlen])
        for _ in range(2):
            j = int(rng.integers(0, rlen))
            frag[j] = bases[int(rng.integers(0, 4))]
        if rng.random() < 0.5:
            frag = bytearray(bytes(frag).translate(
                bytes.maketrans(b"ACGT", b"TGCA"))[::-1])
        reads.append((f"r{i}", bytes(frag), b"I" * rlen))
    return fa, reads


def bench_read_mapping(quick: bool, dev, ref_bp: int | None = None,
                       n_reads: int | None = None) -> dict:
    """Read mapping: reads/s of seeding alone (one pre-packed bucket)
    and of the whole mapper (seed, chain, the swalign kernel's extension,
    traceback) over simulated reads against a synthetic reference. The
    clock starts only after a subset's tuples equal the CPU path's
    (every kernel's plain version) exactly."""
    import shutil
    import tempfile

    import torch

    from .io.fastq import FastqRecord
    from .mapping import build_index, map_reads
    from .mapping import pipeline as mp
    from .ops.pairhmm import encode_seq

    ref_bp = ref_bp or (100_000 if quick else 250_000)
    n_reads = n_reads or (500 if quick else 2000)
    rlen = 100
    d = tempfile.mkdtemp(prefix="goleft_torch_map_")
    try:
        fa, reads = mapping_inputs(d, ref_bp, n_reads, rlen)
        t0 = time.perf_counter()
        index = build_index(fa)
        index_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    recs = [FastqRecord(*r) for r in reads]

    res = map_reads(index, recs, device=dev)
    if res.failed:
        raise RuntimeError(f"read mapping: {len(res.failed)} reads failed")
    nv = 100 if quick else 200
    oracle = map_reads(index, recs[:nv], device="cpu")
    if res.tuples[:nv] != oracle.tuples:
        raise AssertionError(
            "read mapping on the device differs from the CPU path")

    codes_list = [encode_seq(r.seq) for r in recs]
    r_pad = mp._pad_up(rlen, mp.BUCKET)
    smax = mp._smax(r_pad, index.k, index.w)
    pk, nm, rl = (torch.from_numpy(a).to(dev) for a in mp._pack_reads_2bit(
        list(range(n_reads)), codes_list, r_pad))
    tables = index.device_tables(dev)

    def seed():
        out = mp.seed_bucket(pk, nm, rl, tables, r_pad=r_pad, k=index.k,
                             w=index.w, max_occ=index.max_occ,
                             band=mp.DEFAULT_BAND, smax=smax)
        _sync(dev)
        return out

    seed()
    seed_rps = n_reads / sorted(_timed(seed) for _ in range(3))[1]
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        r2 = map_reads(index, recs, device=dev)
        ts.append(time.perf_counter() - t0)
    if r2.tuples != res.tuples:
        raise AssertionError("read mapping: warm repeats differ")
    full_rps = n_reads / sorted(ts)[1]
    return {
        "reads": n_reads, "read_len": rlen, "ref_bp": ref_bp,
        "minimizers": index.n_minimizers,
        "index_build_s": round(index_s, 3),
        "mapped_frac": round(res.stats["mapped"] / n_reads, 4),
        "seed_only_reads_s": round(seed_rps, 1),
        "seed_extend_reads_s": round(full_rps, 1),
        **provenance(dev), "tuples": res.tuples,
        "note": "tuples held against the CPU path (plain versions) on a "
                "subset before timing; the seed lane is one warm bucket, "
                "the extend lane the whole mapper incl. host traceback",
    }


def host_scale_validation(dev, ix_shape=(500, 190_000),
                          em_samples=2504,
                          em_windows: int | None = None) -> dict:
    """indexcov's QC at 500 x 190,000 and the EM at 2,504 samples x one
    product chunk, one run each on the CPU (--suite-host, not --quick):
    proof they run at scale without a card. ``ix_shape``, ``em_samples``
    and ``em_windows`` exist for the tests."""
    import torch

    from .commands.emdepth_cmd import EM_CHUNK

    out = {}
    note = ("host execution at the reference's shape — scale "
            "validation only; card rates are the card entries'")
    rng = np.random.default_rng(0)

    def _ix():
        n_s, n_t = ix_shape
        d = torch.from_numpy(rng.gamma(20, 0.05, size=(n_s, n_t)).astype(
            np.float32)).to(dev)
        v = torch.ones((n_s, n_t), dtype=torch.bool, device=dev)
        t0 = time.perf_counter()
        _ix_cohort_qc(d, v, n_t)
        return {"samples": n_s, "tiles": n_t,
                "seconds_incl_compile": round(time.perf_counter() - t0, 1),
                **provenance(dev), "note": note}

    def _em():
        n_w = EM_CHUNK if em_windows is None else em_windows
        m = torch.from_numpy(rng.gamma(30, 1.0, size=(
            n_w, em_samples)).astype(np.float32)).to(dev)
        t0 = time.perf_counter()
        _em_chunk_run(m)
        return {"windows": n_w, "samples": em_samples,
                "seconds_incl_compile": round(time.perf_counter() - t0, 1),
                **provenance(dev), "note": note}

    for key, fn in (("torch_indexcov_cohort_hostcheck", _ix),
                    ("torch_emdepth_em_hostcheck", _em)):
        out[key] = _guarded(fn)
    return out


# ---- host services, codecs and the wire ----

#: the CLI the two recovery entries start their ``serve`` workers with
#: (``serve`` runs on the card; the tests pass a CPU shim instead)
WORKER_CMD = (sys.executable, "-m", "goleft_tpu_torch")


def bench_decode_thread_scaling(n_files: int = 4,
                                ref_len: int = 2_000_000) -> dict:
    """Decode-thread scaling (pure host work): the speedup-vs-workers
    curve of one native window reduction per file under 1..N-thread
    pools, and the optimal count a cohort run should use."""
    import tempfile

    from .utils.decode_scaling import (
        build_cohort, effective_cores, measure_scaling_curve,
        optimal_threads,
    )

    with tempfile.TemporaryDirectory(prefix="goleft_torch_thr_") as td:
        paths, rl = build_cohort(td, n_files=n_files, ref_len=ref_len)
        curve = measure_scaling_curve(paths, rl)
    t_ser = curve[1]
    opt = optimal_threads(curve)
    # a full-width pool (one worker per task), the reference's point
    peak = len(paths)
    return {
        "threads": peak,
        "effective_cores": effective_cores(),
        "serial_seconds": round(t_ser, 4),
        "threaded_seconds": round(curve[peak], 4),
        "threaded_over_serial": round(curve[peak] / t_ser, 3),
        "curve_seconds": {str(n): round(t, 4)
                          for n, t in sorted(curve.items())},
        "optimal_threads": opt,
        "speedup_at_optimal": round(t_ser / curve[opt], 3),
        "platform": "host (no device work)",
        "note": f"{peak} native window_reduce tasks on distinct files "
                "under 1..N-thread pools; on a 1-core host the ratio "
                "bounds GIL-release overhead, on multi-core the curve "
                "must fall toward serial/min(workers, cores)",
    }


def bench_cram31_codec_decode(quick: bool, n: int | None = None) -> dict:
    """Decode throughput of the CRAM 3.1 block codecs through their
    product entry points (the C fast path when the host library is
    loaded, else Python); every decode is held equal to its input
    before it is timed."""
    from .io import arith, native, tok3
    from .io import fqzcomp as fqz
    from .io import rans_nx16 as rx

    if n is None:
        n = 262_144 if quick else 1_048_576
    rng = np.random.default_rng(3)
    data = bytes(rng.choice([65, 67, 71, 84], p=[.4, .3, .2, .1],
                            size=n).astype(np.uint8))
    lens, quals = [], bytearray()
    while len(quals) < n:
        ln = int(rng.integers(60, 151))
        lens.append(ln)
        quals += bytes(np.clip(np.cumsum(rng.integers(-2, 3, ln)) + 30,
                               0, 45).astype(np.uint8))
    quals = bytes(quals)
    names = [(f"A00111:123:HXXYZ:1:{1101 + int(rng.integers(0, 4))}:"
              f"{int(rng.integers(1000, 30000))}:"
              f"{int(rng.integers(1000, 30000))}").encode()
             for _ in range(n // 35)]
    names_raw = b"\x00".join(names) + b"\x00"
    cases = [
        ("rans_nx16_o0", rx.encode(data, order=0), rx.decode, data),
        ("rans_nx16_o1", rx.encode(data, order=1), rx.decode, data),
        ("arith_o0", arith.encode(data, order=0), arith.decode, data),
        ("arith_o1", arith.encode(data, order=1), arith.decode, data),
        ("fqzcomp", fqz.encode(lens, quals), fqz.decode, quals),
        ("tok3_names", tok3.encode(names), tok3.decode, names_raw),
    ]
    native_lib = native.get_lib() is not None
    # best of 3 after a checked warm-up; one rep on the Python path
    reps = 3 if native_lib else 1
    entries = {}
    for name, enc, dec, want in cases:
        if dec(enc, len(want)) != want:
            raise AssertionError(f"codec bench mismatch: {name}")
        dt = min(_timed(dec, enc, len(want)) for _ in range(reps))
        entries[name] = {
            "payload_mb": round(len(want) / 1e6, 2),
            "ratio": round(len(enc) / len(want), 3),
            "decode_mb_per_sec": round(len(want) / dt / 1e6, 1),
        }
    return {
        "native_lib": native_lib,
        "payload": "ACGT-skewed bytes / correlated quality strings / "
                   "instrument-style read names (tok3)",
        "codecs": entries,
        "note": "CRAM 3.1 block methods 5-8 via their product decode "
                "entry points (csrc/fastio.cpp fast path incl. the tok3 "
                "name assembler, Python without the host library); each "
                "output held equal to its input before the clock",
    }


def _depth_burst(url: str, bams, fai, n_requests: int, n_clients: int,
                 times: list) -> float:
    """``n_requests`` depth requests from ``n_clients`` threads, request
    i on bams[i % len(bams)] with cache_buster=i → wall seconds; each
    request's latency appended to ``times``."""
    import threading

    from .serve.client import ServeClient

    lock = threading.Lock()
    todo = list(range(n_requests))
    errors: list = []

    def worker():
        client = ServeClient(url, timeout_s=300.0)
        while True:
            with lock:
                if not todo or errors:
                    return
                i = todo.pop()
            t0 = time.perf_counter()
            try:
                r = client.depth(bams[i % len(bams)], fai=fai,
                                 cache_buster=i)
                if not r["depth_bed"]:
                    raise RuntimeError(f"request {i}: empty depth_bed")
            except Exception as e:  # noqa: BLE001 — raised below
                with lock:
                    errors.append(e)
                return
            with lock:
                times.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    threads = []
    for _ in range(n_clients):
        t = threading.Thread(target=worker)
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return time.perf_counter() - t0


def _serve_sizes(quick, n_clients, n_requests, ref_len):
    return (n_clients or (4 if quick else 8),
            n_requests or (16 if quick else 48),
            ref_len or (200_000 if quick else 1_000_000))


def bench_serve_throughput(quick: bool, dev, n_clients: int | None = None,
                           n_requests: int | None = None,
                           ref_len: int | None = None) -> dict:
    """The serve daemon on ``dev`` under a concurrent depth load: an
    in-process server (real HTTP loopback, micro-batcher, the depth
    kernel's batch axis) driven by client threads. req/s and latency
    percentiles for a cold burst (every request computed, coalesced into
    batched passes) and a warm one (the same keys, session-cache
    replays), and the batch-size histogram."""
    import shutil

    from .serve.client import ServeClient
    from .serve.server import ServeApp, ServerThread
    from .utils.profiling import percentiles

    n_clients, n_requests, ref_len = _serve_sizes(
        quick, n_clients, n_requests, ref_len)
    d, bams, fai, _ = _build_cohort_fixture(min(n_requests, 8), ref_len, 4)
    app = ServeApp(batch_window_s=0.05, max_batch=n_clients,
                   max_queue=4 * n_requests,
                   cache_dir=f"{d}/session-cache", device=dev)
    lat: dict[str, list] = {"cold": [], "warm": []}
    walls = {}
    try:
        with ServerThread(app) as url:
            # one request first: bring-up, not steady-state serving
            ServeClient(url, timeout_s=300.0).depth(bams[0], fai=fai)
            for phase in ("cold", "warm"):
                walls[phase] = _depth_burst(url, bams, fai, n_requests,
                                            n_clients, lat[phase])
            snap = app.metrics_snapshot()
    finally:
        app.close()
        shutil.rmtree(d, ignore_errors=True)
    out = {
        **provenance(dev),
        "clients": n_clients, "requests_per_phase": n_requests,
        "ref_bp": ref_len,
        "batch_size_hist": snap["batch_size_hist"],
        "cache": snap.get("cache"),
        "note": "in-process daemon, real HTTP loopback; cold = computed "
                "(micro-batched passes of the depth kernel), warm = "
                "session-cache replays on unchanged files",
    }
    for phase in ("cold", "warm"):
        out[phase] = {
            "req_per_sec": round(n_requests / walls[phase], 2),
            "latency_s": percentiles(lat[phase]),
        }
    return out


def bench_fleet_throughput(quick: bool, dev, n_clients: int | None = None,
                           n_requests: int | None = None,
                           ref_len: int | None = None) -> dict:
    """The fleet router in front of 2 in-process workers against one
    daemon alone, on the same concurrent depth load (real HTTP loopback,
    real routing, one process and one card): router overhead and
    affinity, not horizontal scaling."""
    import shutil

    from .fleet.router import RouterApp, RouterThread
    from .serve.client import ServeClient
    from .serve.server import ServeApp, ServerThread
    from .utils.profiling import percentiles

    n_clients, n_requests, ref_len = _serve_sizes(
        quick, n_clients, n_requests, ref_len)
    d, bams, fai, _ = _build_cohort_fixture(min(n_requests, 8), ref_len, 4)
    out = {
        **provenance(dev),
        "clients": n_clients, "requests_per_phase": n_requests,
        "workers": 2, "ref_bp": ref_len,
        "note": "in-process router + 2 workers vs single daemon, real "
                "HTTP loopback; same-process workers share one GIL and "
                "one card, so this is router overhead + affinity "
                "evidence, not horizontal scaling",
    }
    try:
        app = ServeApp(max_batch=n_clients, max_queue=4 * n_requests,
                       device=dev)
        lat_single: list = []
        try:
            with ServerThread(app) as url:
                ServeClient(url, timeout_s=300.0).depth(bams[0], fai=fai)
                wall = _depth_burst(url, bams, fai, n_requests, n_clients,
                                    lat_single)
        finally:
            app.close()
        out["single"] = {"req_per_sec": round(n_requests / wall, 2),
                         "latency_s": percentiles(lat_single)}

        w_apps = [ServeApp(max_batch=n_clients, max_queue=4 * n_requests,
                           device=dev) for _ in range(2)]
        w_threads = [ServerThread(wa) for wa in w_apps]
        lat_fleet: list = []
        try:
            w_urls = [st.__enter__() for st in w_threads]
            router = RouterApp(w_urls, poll_interval_s=1.0,
                               max_inflight=2 * n_clients)
            with RouterThread(router) as rurl:
                ServeClient(rurl, timeout_s=300.0).depth(bams[0], fai=fai)
                wall = _depth_burst(rurl, bams, fai, n_requests,
                                    n_clients, lat_fleet)
                rm = router.metrics_snapshot()
        finally:
            for st, wa in zip(w_threads, w_apps):
                st.__exit__(None, None, None)
                wa.close()
        routed = {k.rsplit(".", 2)[-2]: v
                  for k, v in rm["counters"].items()
                  if k.startswith("fleet.routed_total.")}
        out["fleet"] = {
            "req_per_sec": round(n_requests / wall, 2),
            "latency_s": percentiles(lat_fleet),
            "routed_per_worker": routed,
            "affinity_hits": rm["counters"].get(
                "fleet.affinity_hits_total.depth", 0),
            "retries": rm["counters"].get("fleet.retries_total", 0),
        }
        out["router_overhead_frac"] = round(
            1.0 - out["fleet"]["req_per_sec"]
            / out["single"]["req_per_sec"], 4)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


def _worker_env() -> dict:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("GOLEFT_TPU_FAULTS", None)
    return env


def _spawn_serve_workers(worker_cmd, env, n: int = 1,
                         timeout_s: float = 300.0) -> list:
    """``n`` ``serve --port 0 --no-warmup`` children of ``worker_cmd``,
    started together (each pays its own ``import torch``) →
    [(process, url)]."""
    from .fleet.supervisor import read_announce

    procs = []
    for _ in range(n):
        proc = subprocess.Popen(
            [*worker_cmd, "serve", "--port", "0", "--no-warmup"],
            stdout=subprocess.PIPE, text=True, env=env)
        procs.append(proc)
    out = []
    try:
        for proc in procs:
            url = read_announce(proc, timeout_s)
            if url is None:
                raise RuntimeError(f"serve worker never announced within "
                                   f"{timeout_s:g}s")
            out.append((proc, url.rstrip("/")))
    except BaseException:
        for proc in procs:
            _stop(proc, 10)
        raise
    return out


def _stop(proc, timeout_s: float = 60.0) -> None:
    """SIGTERM, then SIGKILL after ``timeout_s``; reap and close."""
    if proc.poll() is None:
        proc.terminate()
    try:
        proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
    if proc.stdout is not None:
        proc.stdout.close()


def bench_fleet_restart_recovery(quick: bool, dev,
                                 worker_cmd=WORKER_CMD) -> dict:
    """The fleet's MTTR for a worker death: SIGKILL a worker of a
    supervised 2-worker fleet (real ``serve`` processes: their bring-up,
    ``import torch`` included, is the cost measured) and time kill →
    router-observed full capacity (the restart counted, both workers
    eligible, a routed request answered)."""
    import shutil

    from .fleet.router import RouterApp, RouterThread
    from .fleet.supervisor import Supervisor
    from .obs.metrics import MetricsRegistry
    from .serve.client import ServeClient

    n_trials = 1 if quick else 3
    d, bams, fai, _ = _build_cohort_fixture(2, 200_000, 4)
    env = _worker_env()
    registry = MetricsRegistry()
    # the two first workers start together (set-up, not the span
    # measured); a respawn starts one of its own
    ready = []

    def spawn(_index):
        return ready.pop() if ready else _spawn_serve_workers(
            worker_cmd, env)[0]

    sup = Supervisor(spawn_fn=spawn, min_workers=2, max_workers=2,
                     registry=registry, interval_s=0.1, crash_limit=100,
                     crash_window_s=1.0)
    trials = []
    try:
        ready.extend(_spawn_serve_workers(worker_cmd, env, 2))
        urls = sup.spawn_initial(2)
        app = RouterApp(urls, poll_interval_s=0.25, down_after=1,
                        registry=registry)
        sup.bind(app)
        with RouterThread(app) as rurl:
            sup.start()
            client = ServeClient(rurl, timeout_s=300.0, retries=4,
                                 retry_cap_s=1.0)
            client.depth(bams[0], fai=fai)  # warm: bring-up + route
            for trial in range(n_trials):
                victim = sup.slots()[trial % 2]
                restarts0 = registry.snapshot()["counters"].get(
                    "fleet.restarts_total", 0)
                t0 = time.perf_counter()
                victim.proc.kill()
                deadline = t0 + 300.0
                while time.perf_counter() < deadline:
                    snap = registry.snapshot()["counters"]
                    if snap.get("fleet.restarts_total", 0) > restarts0 \
                            and sup.capacity == 2 \
                            and len(app.pool.eligible("depth")) == 2:
                        break
                    time.sleep(0.02)
                else:
                    raise RuntimeError("capacity not restored within 300s")
                r = client.depth(bams[0], fai=fai,
                                 cache_buster=f"trial{trial}")
                if not r["depth_bed"]:
                    raise RuntimeError("empty depth_bed after recovery")
                trials.append(round(time.perf_counter() - t0, 3))
    finally:
        sup.close()
        for proc, _url in ready:
            _stop(proc)
        shutil.rmtree(d, ignore_errors=True)
    trials_sorted = sorted(trials)
    return {
        "workers": 2, "trials": n_trials,
        "recovery_seconds": trials_sorted[len(trials_sorted) // 2],
        "recovery_s_each": trials,
        **provenance(dev),
        "note": "SIGKILL -> supervisor respawn -> router-observed full "
                "capacity (restart counted, both workers eligible, "
                "routed request answered); dominated by worker process "
                "bring-up (import torch included)",
    }


def bench_fleet_failover_recovery(quick: bool, dev,
                                  worker_cmd=WORKER_CMD) -> dict:
    """The federation tier's MTTR for losing a whole fleet: SIGKILL one
    of two ``fleet`` router processes (each in front of its own ``serve``
    worker) behind an in-process FederationRouter, and time

      - ``failover_seconds``: kill → a request for the dead fleet's
        affinity key answered byte-identically through the other fleet;
      - ``recovery_seconds``: router restart over the worker that
        survived it → the fleet half-open probed, rejoined, and the
        key routed home again."""
    import json as _json
    import shutil
    import urllib.request

    from .fleet.federation import FederationRouter, FederationThread
    from .serve.client import ServeClient

    n_trials = 1 if quick else 3
    d, bams, fai, _ = _build_cohort_fixture(2, 200_000, 4)
    env = _worker_env()
    fleet_cmd = [sys.executable, "-m", "goleft_tpu_torch", "fleet",
                 "--poll-interval-s", "0.25", "--down-after", "1"]

    def spawn_fleet(port, worker_url):
        proc = subprocess.Popen(
            [*fleet_cmd, "--port", str(port), "--worker", worker_url],
            stdout=subprocess.PIPE, text=True, env=env)
        deadline = time.monotonic() + 300
        line = ""
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line or "listening on " in line:
                break
        if "listening on " not in line:
            _stop(proc, 10)
            raise RuntimeError("fleet never announced")
        return proc, line.rsplit("listening on ", 1)[1].strip().rstrip("/")

    workers: list = []
    fleets: dict[str, dict] = {}
    failovers: list[float] = []
    recoveries: list[float] = []
    try:
        workers = _spawn_serve_workers(worker_cmd, env, 2)
        for _w, w_url in workers:
            proc, url = spawn_fleet(0, w_url)
            fleets[url] = {"proc": proc, "worker_url": w_url,
                           "port": url.rsplit(":", 1)[-1]}
        app = FederationRouter(list(fleets), poll_interval_s=0.25,
                               down_after=1)
        with FederationThread(app) as fed_url:
            client = ServeClient(fed_url, timeout_s=300.0, retries=6,
                                 retry_cap_s=1.0)
            r0 = client.depth(bams[0], fai=fai)  # warm + home key
            home = client.route_plan("depth", bam=bams[0], fai=fai)[0]
            port = fleets[home]["port"]
            for trial in range(n_trials):
                rec = fleets[home]
                t0 = time.perf_counter()
                rec["proc"].kill()
                rec["proc"].wait(timeout=30)
                rec["proc"].stdout.close()
                r = client.depth(bams[0], fai=fai)
                if r["depth_bed"] != r0["depth_bed"]:
                    raise RuntimeError("failover answer differs")
                failovers.append(round(time.perf_counter() - t0, 3))
                t1 = time.perf_counter()
                routed0 = app.registry.snapshot()["counters"].get(
                    f"federation.routed_total.{port}.depth", 0)
                rec["proc"], _ = spawn_fleet(port, rec["worker_url"])
                deadline = time.perf_counter() + 300
                while time.perf_counter() < deadline:
                    if app.pool.snapshot()[home]["state"] \
                            in ("probe", "up"):
                        break
                    time.sleep(0.02)
                else:
                    raise RuntimeError("fleet never half-opened")
                # the probe request: it must land home, byte-identical
                r = client.depth(bams[0], fai=fai,
                                 cache_buster=f"t{trial}")
                if r["depth_bed"] != r0["depth_bed"]:
                    raise RuntimeError("recovered answer differs")
                snap = app.registry.snapshot()["counters"]
                if snap.get(f"federation.routed_total.{port}.depth",
                            0) <= routed0:
                    raise RuntimeError("probe did not route home")
                recoveries.append(round(time.perf_counter() - t1, 3))
    finally:
        for rec in fleets.values():
            _stop(rec["proc"])
        for proc, _url in workers:
            _stop(proc)
        shutil.rmtree(d, ignore_errors=True)
    fs, rs = sorted(failovers), sorted(recoveries)
    return {
        "fleets": 2, "workers_per_fleet": 1, "trials": n_trials,
        "failover_seconds": fs[len(fs) // 2],
        "recovery_seconds": rs[len(rs) // 2],
        "failover_s_each": failovers,
        "recovery_s_each": recoveries,
        **provenance(dev),
        "note": "SIGKILL a fleet router behind the federation: failover "
                "= kill -> byte-identical 200 via the surviving fleet; "
                "recovery = router restart over the surviving worker -> "
                "half-open probe -> affinity key routed home; dominated "
                "by fleet process bring-up",
    }


def bench_cohort_resume_overhead(quick: bool, dev, **kw) -> dict:
    """Checkpointing's happy-path cost: ``run_cohortdepth`` on ``dev``
    plain vs --checkpoint-dir vs --resume replay on a multi-region
    cohort (resilience/overhead.py; ``kw`` sizes it)."""
    from .resilience.overhead import measure_resume_overhead

    return {**measure_resume_overhead(quick=quick, device=dev, **kw),
            **provenance(dev)}


def bench_wire_decode(quick: bool, dev, bs: int | None = None,
                      nb: int | None = None) -> dict:
    """rANS-Nx16 entropy decode across its lanes: the host decoder (the
    scalar and the vectorised loop, both interleave widths; the C loops
    when the host library is loaded) and the rANS kernel on ``dev``
    through ``ops/rans_device.decode_streams``, for ORDER0, ORDER1 and
    STRIPE, with the wire accounting (compressed payload + tables
    against the inflated bytes). Every lane's output is held equal to
    its input before its clock and after; all lanes median-of-3."""
    from .io import rans_nx16 as rx
    from .ops import rans_device as rd

    rng = np.random.default_rng(17)
    if bs is None:
        bs = 32_768 if quick else 65_536
    if nb is None:
        nb = 6 if quick else 12
    datas = []
    for i in range(nb):
        kind = i % 3
        if kind == 0:  # sequence-like (ACGT-skewed)
            d = rng.choice([65, 67, 71, 84], p=[.4, .3, .2, .1],
                           size=bs).astype(np.uint8)
        elif kind == 1:  # correlated quality strings
            d = np.clip(np.cumsum(rng.integers(-2, 3, bs)) + 30,
                        0, 45).astype(np.uint8)
        else:  # low-alphabet run-heavy
            d = np.repeat(rng.integers(0, 8, bs // 8 + 1),
                          8).astype(np.uint8)[:bs]
        datas.append(bytes(d))
    total = nb * bs

    def median3(fn) -> float:
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[1]

    def time_host(encs, vec_min):
        old = rx.VEC_MIN_STATES
        rx.VEC_MIN_STATES = vec_min
        try:
            if [rx.decode(e, bs) for e in encs] != datas:
                raise AssertionError("host lane diverged")
            dt = median3(lambda: [rx.decode(e, bs) for e in encs])
        finally:
            rx.VEC_MIN_STATES = old
        return total / dt / 1e6

    def host_lanes(encs):
        out = {
            "scalar_n4_mb_s": round(time_host(encs["n4"], 1 << 30), 2),
            "scalar_x32_mb_s": round(time_host(encs["x32"], 1 << 30), 2),
            "vectorized_x32_mb_s": round(time_host(encs["x32"], 4), 2),
        }
        out["vectorized_over_scalar_x32"] = round(
            out["vectorized_x32_mb_s"] / out["scalar_x32_mb_s"], 2)
        return out

    def time_device(encs, want):
        lens = [bs] * len(encs)
        if rd.decode_streams(encs, lens, device=dev) != want:
            raise AssertionError("device lane diverged from the host "
                                 "oracle (or stayed on the host)")
        dt = median3(lambda: rd.decode_streams(encs, lens, device=dev))
        if rd.decode_streams(encs, lens, device=dev) != want:
            raise AssertionError("device lane diverged after its clock")
        return dt

    corp = {lab: [rx.encode(d, order=0, x32=x32) for d in datas]
            for lab, x32 in (("n4", False), ("x32", True))}
    host = host_lanes(corp)
    all_encs = corp["n4"] + corp["x32"]
    dt_scan = time_device(all_encs, datas + datas)

    corp1 = {lab: [rx.encode(d, order=1, x32=x32) for d in datas]
             for lab, x32 in (("n4", False), ("x32", True))}
    o1_encs = corp1["n4"] + corp1["x32"]
    order1 = {**host_lanes(corp1),
              "device_scan_mb_s": round(
                  2 * total / time_device(o1_encs, datas + datas) / 1e6,
                  2)}

    st_encs = [rx.encode(d, stripe=4) for d in datas]
    if [rx.decode(e, bs) for e in st_encs] != datas:
        raise AssertionError("host stripe lane diverged")
    dt_host_st = median3(lambda: [rx.decode(e, bs) for e in st_encs])
    stripe = {
        "host_mb_s": round(total / dt_host_st / 1e6, 2),
        "device_scan_mb_s": round(
            total / time_device(st_encs, datas) / 1e6, 2),
    }

    wire_c = 0
    for e in all_encs + o1_encs + st_encs:
        p = rx.parse_nx16(e, bs)
        wire_c += p.payload_bytes + p.table_bytes
    wire_u = len(all_encs + o1_encs + st_encs) * bs
    prov = provenance(dev)
    return {
        "blocks": len(all_encs), "block_bytes": bs,
        "payload": "ACGT-skewed / correlated quals / run-heavy "
                   "low-alphabet, pure entropy-coded "
                   "(order-0/order-1/stripe)",
        "host": host,
        "order1": order1,
        "stripe": stripe,
        "device_scan_mb_s": round(2 * total / dt_scan / 1e6, 2),
        "device_scan_gbases_s": round(2 * total / dt_scan / 1e9, 4),
        "wire_bytes_compressed": wire_c,
        "wire_bytes_uncompressed": wire_u,
        "wire_ratio": round(wire_c / wire_u, 4),
        **prov, "device_kind": prov["device"],
        "note": "device_scan_* = the rANS kernel (csrc/rans_kernel.cu) "
                "through decode_streams, stage + launch + D2H; every "
                "lane byte-verified against its input; the host lanes "
                "time the C loops when the host library is loaded",
    }


def bench_remote_fetch(quick: bool, size_mb: int | None = None) -> dict:
    """Object-store staging throughput (io/remote.py): one blob read
    whole through the local ByteSource and through the HTTP Range
    backend against the loopback stub store, and the sub-block
    sequential walk with and without read-ahead."""
    import tempfile

    from .io import remote
    from .io.remote_stub import StubServer

    if size_mb is None:
        size_mb = 8 if quick else 32
    blob = np.random.default_rng(11).bytes(size_mb << 20)
    step = 256 << 10  # sub-block consumer stride

    def _mb_s(dt):
        return round(size_mb / max(dt, 1e-9), 1)

    def _seq(url, readahead):
        prev = os.environ.get("GOLEFT_TPU_FETCH_READAHEAD")
        os.environ["GOLEFT_TPU_FETCH_READAHEAD"] = str(readahead)
        try:
            t0 = time.perf_counter()
            with remote.open_source(url) as src:
                for off in range(0, len(blob), step):
                    src.read(off, step)
            return time.perf_counter() - t0
        finally:
            if prev is None:
                os.environ.pop("GOLEFT_TPU_FETCH_READAHEAD", None)
            else:
                os.environ["GOLEFT_TPU_FETCH_READAHEAD"] = prev

    with tempfile.TemporaryDirectory(prefix="goleft_torch_rf_") as d:
        p = os.path.join(d, "blob.bin")
        with open(p, "wb") as fh:
            fh.write(blob)
        with StubServer() as srv:
            url = srv.put("blob.bin", blob)
            t0 = time.perf_counter()
            if remote.fetch_bytes(p) != blob:
                raise RuntimeError("local staging corrupted")
            t_local = time.perf_counter() - t0
            t0 = time.perf_counter()
            if remote.fetch_bytes(url) != blob:
                raise RuntimeError("remote staging corrupted")
            t_remote = time.perf_counter() - t0
            t_ra = _seq(url, 4)
            t_no = _seq(url, 0)
    return {
        "size_mb": size_mb,
        "local_mb_per_s": _mb_s(t_local),
        "remote_mb_per_s": _mb_s(t_remote),
        "readahead_mb_per_s": _mb_s(t_ra),
        "no_readahead_mb_per_s": _mb_s(t_no),
        "overlap_efficiency": round(t_no / max(t_ra, 1e-9), 2),
        "platform": "cpu",
        "note": "loopback stub object store; remote = HTTP Range "
                "ByteSource (block cache + coalesced read-ahead), "
                "overlap_efficiency = sub-block sequential walk "
                "no-readahead/readahead wall ratio",
    }


def _pipeline_runner(quick: bool, length: int | None, reps: int | None):
    """A function timing ``reps`` runs of the numpy depth pipeline (the
    kind of host work a serve decode stage does) at ``length`` bp."""
    if length is None:
        length = 1_000_000 if quick else 4_000_000
    if reps is None:
        reps = 6 if quick else 10
    seg_s, seg_e, keep = make_workload(length, 8, 100, seed=7)

    def run_once() -> float:
        t0 = time.perf_counter()
        for _ in range(reps):
            numpy_pipeline(seg_s, seg_e, keep, length, 250)
        return time.perf_counter() - t0

    run_once()  # warm the allocator and caches so both arms compare
    return run_once


def bench_profiler_overhead(quick: bool, length: int | None = None,
                            reps: int | None = None) -> dict:
    """The sampling profiler's cost: the numpy depth pipeline with the
    sampler off, then on at 100 Hz."""
    from .obs.metrics import MetricsRegistry
    from .obs.profiler import SamplingProfiler

    run_once = _pipeline_runner(quick, length, reps)
    t_off = run_once()
    prof = SamplingProfiler(hz=100.0, registry=MetricsRegistry()).start()
    try:
        t_on = run_once()
        snap = prof.snapshot()
    finally:
        prof.close()
    overhead = max(0.0, t_on - t_off) / t_off if t_off > 0 else 0.0
    return {
        "hz": 100.0,
        "seconds_off": round(t_off, 4),
        "seconds_on": round(t_on, 4),
        "overhead_frac": round(overhead, 4),
        "samples": snap["samples_total"],
        "distinct_stacks": len(snap["stacks"]),
        "note": "numpy depth pipeline with/without 100 Hz sampling",
    }


def bench_memory_overhead(quick: bool, length: int | None = None,
                          reps: int | None = None) -> dict:
    """The memory sampler's cost: its duty cycle (the measured per-tick
    cost over the 0.1 s interval, with an armed pressure band), beside
    the numpy depth pipeline's wall with the sampler off and on."""
    from .obs.memplane import MemorySampler
    from .obs.metrics import MetricsRegistry

    run_once = _pipeline_runner(quick, length, reps)
    # min of 3 per arm: the uncontended time of each
    t_off = min(run_once() for _ in range(3))
    reg = MetricsRegistry()
    interval_s = 0.1
    sampler = MemorySampler(interval_s=interval_s, registry=reg,
                            high_water_bytes=1 << 60).start()
    try:
        t_on = min(run_once() for _ in range(3))
        samples = int(reg.counter("memory.samples_total").value)
        ticks = 200
        t0 = time.perf_counter()
        for _ in range(ticks):
            sampler.sample_once()
        per_tick_s = (time.perf_counter() - t0) / ticks
    finally:
        sampler.close()
    return {
        "interval_s": interval_s,
        "seconds_off": round(t_off, 4),
        "seconds_on": round(t_on, 4),
        "sample_cost_us": round(per_tick_s * 1e6, 1),
        "overhead_frac": round(per_tick_s / interval_s, 5),
        "samples": samples,
        "note": "memory sampler duty cycle (per-tick cost / 0.1 s "
                "interval); seconds_off/on are the informational wall "
                "A/B around the numpy depth pipeline",
    }


# ---- the run ----

def _guarded(fn) -> dict:
    """One entry: its dict, or {"error": ...} when it raised (the suite
    goes on)."""
    try:
        return fn()
    except (Exception, SystemExit) as e:  # noqa: BLE001 — keep entries
        import traceback

        traceback.print_exc(file=sys.stderr)
        return {"error": repr(e)}


def _baseline_block(cohort: dict, out: OutDir):
    """(baseline Gbases/s, info) for the headline: the pinned constant in
    baseline_pinned.json when there is one, else this run's numpy
    measurement."""
    live = cohort["numpy_kernel_gbases_per_sec"]
    what = ("single-core numpy scatter+cumsum+window pipeline, charged "
            "NO decode work; ours includes open+decode+reduce+format end "
            "to end")
    pin = _read_json(out.pinned)
    try:
        pinned = float(pin["numpy_kernel_gbases_per_sec"])
    except (KeyError, TypeError, ValueError):
        return live, {"what": what, "gbases_per_sec": live,
                      "pinned": False}
    return pinned, {
        "what": what, "gbases_per_sec": pinned, "pinned": True,
        "pinned_ts": pin.get("provenance", {}).get("ts"),
        "measured_this_run_gbases_per_sec": live,
    }


def pin_baseline(out: OutDir) -> dict:
    """``--pin-baseline``: the numpy baseline as the median of 9 runs on
    the non-quick cohort workload, written to baseline_pinned.json."""
    import platform

    from .utils.decode_scaling import effective_cores

    ref_len, coverage, read_len, window = 10_000_000, 4, 100, 500
    n_reads = ref_len * coverage // read_len
    rng = np.random.default_rng(0)
    starts = np.sort(rng.integers(0, ref_len - read_len, size=n_reads))
    seg_s = starts.astype(np.int32)
    seg_e = (seg_s + read_len).astype(np.int32)
    keep = np.ones(len(seg_s), bool)
    numpy_pipeline(seg_s, seg_e, keep, ref_len, window)  # first touch
    runs = sorted(_timed(numpy_pipeline, seg_s, seg_e, keep, ref_len,
                         window) for _ in range(9))
    med = runs[len(runs) // 2]
    doc = {
        "numpy_kernel_gbases_per_sec": round(ref_len / med / 1e9, 4),
        "provenance": {
            "ts": datetime.datetime.now(
                datetime.timezone.utc).isoformat(timespec="seconds"),
            "method": "median of 9 timed numpy_pipeline runs on the "
                      "non-quick cohort workload after a first-touch "
                      "run; regenerate with `goleft-tpu-torch bench "
                      "--pin-baseline`",
            "runs_seconds": [round(r, 4) for r in runs],
            "workload": {"ref_bp": ref_len, "coverage": coverage,
                         "read_len": read_len, "window": window},
            "host": {"machine": platform.machine(),
                     "effective_cores": effective_cores(),
                     "numpy": np.__version__},
        },
    }
    _write_json(out.pinned, doc)
    return doc


def append_ledger(out: OutDir, headline: dict | None) -> None:
    """Append this run's entries (details.json as merged) and headline to
    ``<out-dir>/ledger.jsonl`` as a ``live-<ts>`` round; a failure is
    reported and does not fail the bench."""
    from .obs import ledger

    try:
        recs = ledger.live_run_records(_read_json(out.details) or {},
                                       headline)
        ledger.append_records(out.ledger, recs)
        print(f"bench: appended {len(recs)} record(s) to {out.ledger}",
              file=sys.stderr)
    except (OSError, ValueError, TypeError) as e:
        print(f"bench: ledger append failed: {e!r}", file=sys.stderr)


#: the entries' scale under --quick and without it: (n_samples, ref_len,
#: coverage) of the headline cohort and of the engine side-by-side
COHORT_SIZES = {True: (20, 2_000_000, 3), False: (50, 10_000_000, 4)}
COHORT_DEVICE_SIZES = {True: (8, 1_000_000, 3), False: (20, 4_000_000, 4)}


#: the record of a recovery entry on a host with no card: its ``serve``
#: workers run only on the card, so it starts none
NO_CARD_SKIP = {"platform": "cpu",
                "skipped": "no CUDA card: the entry spawns goleft-tpu-torch "
                           "serve workers, which run only on the card"}


def _worker_card(dev):
    """The card the recovery entries' ``serve`` workers run on: ``dev``
    itself, the first card under --suite-host, None without a card."""
    import torch

    if dev.type == "cuda":
        return dev
    return torch.device("cuda", 0) if torch.cuda.is_available() else None


def run_suite(out: OutDir, dev, quick: bool = False,
              kernels_only: bool = False, suite_host: bool = False
              ) -> tuple[dict, list[str]]:
    """Run the entries on ``dev``, merging each into details.json as it
    lands → (headline, names of the entries that recorded an error)."""
    errors: list[str] = []
    rng = np.random.default_rng(0)

    def rec(key, fn):
        val = _guarded(fn)
        # the per-item outputs of the correctness gates stay out of the
        # record
        if isinstance(val, dict):
            val = {k: v for k, v in val.items()
                   if k not in ("likelihoods", "tuples")}
        if "error" in val:
            errors.append(key)
        merge_details(out, {key: val})
        return val

    if not suite_host:
        kern = rec("torch_device_kernels", lambda: bench_kernels(quick, dev))
        if not kernels_only:
            rec("torch_indexcov_cohort",
                lambda: bench_indexcov_cohort(quick, dev, rng))
            rec("torch_kernel_vs_plain_depth",
                lambda: bench_kernel_vs_plain(quick, dev))
            rec("torch_emdepth_em",
                lambda: bench_emdepth_em(quick, dev, rng))
    if not kernels_only:
        rec("torch_depth_wholegenome",
            lambda: bench_depth_wholegenome(quick, dev))
        rec("torch_indexcov_e2e_wholegenome",
            lambda: bench_indexcov_e2e(quick, dev, rng))
        if not suite_host:
            rec("torch_cohort_scan", lambda: bench_cohort_scan(quick, dev))
        rec("torch_cohort_e2e_device", lambda: bench_cohort_device(
            *COHORT_DEVICE_SIZES[quick], dev=dev))
    if not suite_host:
        save_lastgood(out, kernels_only=kernels_only)
    cohort = rec("torch_cohort_e2e", lambda: bench_cohort(
        *COHORT_SIZES[quick], dev=dev))
    if not kernels_only:
        rec("torch_decode_thread_scaling", bench_decode_thread_scaling)
        rec("torch_cram31_codec_decode",
            lambda: bench_cram31_codec_decode(quick))
        rec("torch_serve_throughput",
            lambda: bench_serve_throughput(quick, dev))
        rec("torch_fleet_throughput",
            lambda: bench_fleet_throughput(quick, dev))
        card = _worker_card(dev)
        for key, fn in (
                ("torch_fleet_restart_recovery_s",
                 bench_fleet_restart_recovery),
                ("torch_fleet_failover_recovery_s",
                 bench_fleet_failover_recovery)):
            rec(key, (lambda fn=fn: fn(quick, card)) if card is not None
                else lambda: dict(NO_CARD_SKIP))
        rec("torch_cohort_resume_overhead",
            lambda: bench_cohort_resume_overhead(quick, dev))
        rec("torch_pairhmm_forward",
            lambda: bench_pairhmm_forward(quick, dev))
        rec("torch_wire_decode", lambda: bench_wire_decode(quick, dev))
        rec("torch_read_mapping", lambda: bench_read_mapping(quick, dev))
        rec("torch_remote_fetch", lambda: bench_remote_fetch(quick))
        rec("torch_profiler_overhead",
            lambda: bench_profiler_overhead(quick))
        rec("torch_memory_overhead", lambda: bench_memory_overhead(quick))
        if suite_host and not quick:
            for key, val in host_scale_validation(dev).items():
                rec(key, lambda val=val: val)
    if "error" in cohort:
        return {"metric": HEADLINE, "value": 0.0, "unit": "Gbases/s",
                "vs_baseline": 0.0, "error": cohort["error"]}, errors
    base_v, base_info = _baseline_block(cohort, out)
    headline = {
        "metric": HEADLINE, "value": cohort["gbases_per_sec"],
        "unit": "Gbases/s",
        "vs_baseline": round(cohort["gbases_per_sec"] / base_v, 2),
        "baseline": base_info,
        "config": {"cohort": {k: cohort[k] for k in (
            "samples", "ref_bp", "coverage", "wall_seconds_warm",
            "stage_seconds")}, "platform": cohort["platform"],
            "device": cohort["device"], "nvidia_smi": cohort["nvidia_smi"]},
    }
    if not suite_host and "error" not in kern:
        headline["config"].update(
            {k: v for k, v in kern.items() if k.startswith("kernel_")})
    return headline, errors


def _parser(**kw) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "goleft-tpu-torch bench",
        description="the port's benchmark suite on the CUDA card", **kw)
    p.add_argument("--quick", action="store_true",
                   help="the reference's smaller sizes")
    p.add_argument("--kernels-only", action="store_true",
                   help="only the depth kernel entry and the headline")
    p.add_argument("--suite-host", action="store_true",
                   help="run on the CPU (every kernel's plain version); "
                        "entries are labelled platform cpu")
    p.add_argument("--no-probe", action="store_true",
                   help="accepted for the reference's flag set; the port "
                        "never probes")
    p.add_argument("--pin-baseline", action="store_true",
                   help="measure the numpy baseline and pin it into "
                        "<out-dir>/baseline_pinned.json")
    p.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                   help="where every file of the bench goes (default "
                        f"{DEFAULT_OUT_DIR})")
    return p


def run_device(argv) -> str | None:
    """The device a run with ``argv`` asks for (the run manifest's
    backend): "cuda", "cpu" under --suite-host, None for --pin-baseline
    (numpy only) or flags that do not parse."""
    try:
        a, _ = _parser(add_help=False, exit_on_error=False
                       ).parse_known_args(argv)
    except argparse.ArgumentError:
        return None
    if a.pin_baseline:
        return None
    return "cpu" if a.suite_host else "cuda"


def main(argv=None) -> int:
    a = _parser().parse_args(argv)
    out = OutDir(a.out_dir)
    if a.pin_baseline:
        print(json.dumps(pin_baseline(out)))
        return 0
    from .device import resolve_device

    # no probe and no fallback: without a card this raises NoCudaDevice
    # before any entry runs; --suite-host is the one way to the CPU
    dev = resolve_device("cpu" if a.suite_host else None)
    headline, errors = run_suite(out, dev, quick=a.quick,
                                 kernels_only=a.kernels_only,
                                 suite_host=a.suite_host)
    print(json.dumps(headline), flush=True)
    append_ledger(out, headline)
    if errors:
        print(f"bench: {len(errors)} entr{'y' if len(errors) == 1 else 'ies'}"
              f" recorded an error: {', '.join(errors)}", file=sys.stderr)
        return 1
    return 0
