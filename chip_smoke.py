#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (goleft_tpu_torch).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--out FILE] [--trace-dir DIR]

1. prints the card's provenance (torch / CUDA versions, name, power limit);
2. builds the five hand-written kernels (csrc/depth_kernel.cu,
   csrc/pairhmm_kernel.cu, csrc/rans_kernel.cu, csrc/indexcov_norm.cu,
   csrc/swalign_kernel.cu) from the checkout, one nvcc each, started
   together, and prints the build seconds and the ptxas reports; beside
   the builds and phases 3-3b, the script's first probe of the card
   (goleft_tpu_torch/utils/device_guard.py: a child process that brings
   CUDA up and runs one op), whose cached success, kept for the whole
   run (GOLEFT_TPU_PROBE_TTL_SECONDS=3600), stands for every device
   command the script starts;
3. holds the depth kernel against its plain PyTorch version on the card at
   one full production shard (10 Mb, 2,000,000 segments of 150 bp, window
   250, max mean depth 100, cap 2600), on both wires and on the u16 wire
   with one 65,535-base segment more (the tile kernel's widest halo),
   with edge cases (a 10,000-segment hotspot in one 1024-base region,
   endpoints at 0 and at the shard end, keep-masked segments, a region
   strictly inside the shard, segments of 65,536 bases and more, a gap
   that needs u16 fillers), then the small cases of DEPTH_EDGES on both
   wires (no segments, all in one tile past the cap, a length that is no
   multiple of the tile, windows of 7, 251 and 250, one window wider
   than a tile, window sums above 2^24, ...). Depth, window sums,
   classes and packed classes must be bitwise equal; prints the
   kernel's time per shard by CUDA events around one call and as device
   time (a CUDA graph of 20 calls), the plain version's, the bound, and
   the bytes a dense=False call allocates (it fails on the u16 wire if
   they could hold a per-base int32 buffer); then the kernel's batch
   axis (``fused_depth_batch``, one launch for B samples over a region,
   serve's coalesced /v1/depth pass) at the same shard: B = 1, 3, 8 and
   16 samples of uneven segment counts (one empty, one with a
   65,535-base segment), on the u16 wire and on the int32 wire with a
   70,000-base segment, dense outputs bitwise against its plain version
   and against B single launches; the bytes a dense=False batch of 16
   allocates beyond its outputs (under one per-base int32 buffer); the
   time of one batch of 8 against 8 single launches, and its bound;
4. fabricates a coordinate-sorted 25 Mb BAM + BAI (5,000,000 reads of
   150 bp, MAPQ 0 / DUP / SECONDARY reads, D / N / S / I CIGARs, a pileup
   above the cap), runs ``python -m goleft_tpu_torch depth`` on it in a
   fresh process (launch counts start at 0 there and come back in its
   ``--metrics-out`` run manifest) and compares both BED files byte for byte
   with an independent numpy oracle;
4b. beside phase 5, the bring-up guard and obs/provenance.py: with the
   probe's caches cleared, ``depth -b`` over chr1:0-1,000,000 of that BAM
   in a fresh process (the probe's child, CUDA's bring-up under the
   watchdog, the oracle's rows), then again (the probe cached); a run
   whose probe sleeps past a 3 s timeout must exit 1 with one stderr
   line naming where its traceback went, no kernel launched, within 13
   s; ``backend_provenance("cuda")`` must name the card as nvidia-smi
   does, and both runs' manifests and the traced run's device spans carry
   its values; prints the probe's first and cached costs and the
   bring-up seconds;
5. holds the pair-HMM kernel against its plain version on the card, f32
   rescaled and f64 unscaled, contribs and shifts bitwise: one bucket of
   4,096 pairs of 150 bp reads (quals 2-41, mismatches, indels, N) x
   416 bp haplotypes, edge buckets (read longer than hap, a 1-base read,
   a q93 read, 300 bp junk reads below 1e-100), a bucket of 1,100 bp
   reads (r1 1,121: five strips of 256 rows), buckets of r1 = 32 R and
   32 R + 1 rows for every compiled R = 1..8 (256 | 257: the strip edge)
   and the adoption trap (pm = 0 where each read's first base meets its
   hap's first base, zero priors in other rows); the ptxas registers and
   spills of every instantiation (no spills allowed); padding invariance on
   the card (a pair alone = in its bucket; bucket 32 = bucket 128 over
   each pair's live steps); 16 pairs against a copy of the test suite's
   numpy f64 log-space oracle and the long bucket against a row-at-a-time
   f64 oracle checked against it (1e-4 log10 in f32, 1e-9 in f64); prints the kernel's and the
   plain version's median ms, GCUPS and the compute bound;
6. fabricates a windows document of 80 windows (4 haplotypes of
   350-452 bp, 80 reads of 150 bp each), runs ``python -m
   goleft_tpu_torch pairhmm --candidates`` on ~80% of it in a fresh
   process, checks the table, the launch count (one per length bucket)
   and 20 windows' genotype, GQ and PL (+-1) against the oracle, prints
   the seconds, pairs/s, GCUPS and stage split; then a run with a
   permanent injected fault must exit 3 with a quarantine manifest;
7. fabricates a CRAM cohort with tools/bulk_cram.py: 4 samples of
   50,000 reads of 150 bp with quality strings (3% MAPQ 0, 2%
   duplicates) on one 2,000,000 bp contig, 10,000 records per container,
   rANS-Nx16 blocks ORDER0, ORDER1, ORDER1 and STRIPE 4 (the JAX
   package's make_cram_cohort with a second ORDER1 sample, so two sample
   threads launch ORDER1 at once), in a worker process started before
   phase 5 that runs beside phases 5-6; and the matrix from the
   generated reads;
8. holds the rANS kernel against its plain version bitwise: N = 4 and X32
   x ORDER0 and ORDER1 x plain, RLE, PACK and RLE+PACK at the sizes of
   tests/test_rans_device.py up to 20,000 bytes, and STRIPE with uneven
   lanes (the plain version on the host CPU, in a worker process);
   eight threads, each on its own CUDA stream,
   launching ORDER1 groups of seven table sizes at once, each launch
   against the plain version; then every launch of one real 10,000-record
   container of each codec (ORDER0, ORDER1, STRIPE 4) against the plain
   version run on the host CPU on copies of the same inputs (in worker
   processes that run on beside phases 9-13; held once phase 13 ends);
   the device decode (kernel, expansions, interleave) against the data
   and the host decoder; a missing ORDER1 context must raise; prints the
   kernel's and the plain version's time per container of each codec,
   its cycles a
   round (ms x the SM clock / the longest stream's rounds; that stream
   alone too) and both bounds;
9. runs ``python -m goleft_tpu_torch cohortdepth --decode-device`` on the
   cohort in fresh processes, with the hybrid engine (the main path), the
   device engine, and ``GOLEFT_TPU_FAULTS=decode:after=1:transient`` (the
   last two side by side);
   every matrix must equal the oracle byte for byte, with no decode
   fallback and exactly the rans launches counted on the host from the
   files (per shard, the containers it decodes; per container, its
   launch groups), whose split it prints; prints the seconds, import
   seconds, stage seconds and samples x contig bp per second;
10. the flags: ``depth --cache DIR`` twice on phase 4's BAM (3 depth
   launches, then 0 with a cache hit per shard; both BEDs byte-identical
   to the oracle each time), ``depth --profile DIR`` (torch.profiler's
   Chrome trace holds each shard's ``wire_starts`` and ``depth_tiles``),
   ``cohortdepth --decode-device`` and ``pairhmm`` under ``--trace-out``
   (output bytes unchanged; one ``run.<command>`` root, every span
   parented, one fenced ``device.<kernel>`` span per launch, the
   manifest's trace id; prints the fenced-kernel share beside the
   untraced command's seconds), and ``cohortdepth --checkpoint-dir``
   on a four-region BED killed by ``--inject-faults
   shard:after=2:kill`` (SIGKILL), resumed (the oracle's bytes, fewer
   rans launches than an uninterrupted run) and resumed again over the
   complete store (0 rans launches, the same bytes); the kill and resume
   runs, the pairhmm trace and the profile go on beside the cache runs
   and the cohortdepth trace;
11. the EM at cohort width: an int16 matrix of 64,445 windows (chr20 at
   1 kb) x 2,504 samples (the 1000 Genomes phase-3 cohort; Poisson
   counts drawn on the card from a seed) with planted deletions and
   duplications, through ``call_cnvs``'s normalisation and
   ``_batched_em`` on the card (four 16,384-window f64 chunks); λ of 64
   sampled windows within rtol = atol = 1e-9 of tests/oracle_emdepth.py
   and their CN equal to its CN clamped at 8; cn.mops on one chunk
   against the port's CPU path on 64 of its rows; prints the ms a chunk
   (CUDA events), the peak of ``torch.cuda.max_memory_allocated`` and
   window-samples a second;
12. ``python -m goleft_tpu_torch cnv -w 1000 --vcf --matrix-out`` on 8
   BAMs of 400,000 150 bp reads (15x) on one 4 Mb contig, a 200 kb het
   deletion in one sample and a 150 kb duplication in another, under
   ``--engine device`` (depth-kernel launches from its manifest) and the
   default engine: both byte-identical to the port's
   ``run_cnv(device="cpu")``, both planted events called; the
   ``cohortdepth -w 1000`` window-mean matrix of the same BAMs under
   ``--engine device`` (one depth launch a sample) byte-identical to the
   hybrid engine's; then ``emdepth --mops-out --gain-out`` on that
   matrix, on the card against the CPU (the differing windows are
   printed on a failure); prints samples x contig bp a second;
13. holds indexcov's normalisation kernel (csrc/indexcov_norm.cu)
   against its plain version on the card, bitwise: NORM_EDGES (lanes of
   length 0-8 and ending 0-5 bins early, widths 1, 3, 7 and a tile's
   width - 1, + 0, + 1 and + 3, 1, 31 and 33 lanes, lengths ending 0-3
   bins either side of a tile edge, non-zero padding, every skip of
   NormStats, a 5-sample cohort); then the first 32, 500 and 2,504
   samples (the 1000 Genomes phase-3 cohort) x 15,195 bins (chr1 at 16
   KB), samples ending 1-5 bins early, a length-0 sample, a run of
   m < 0.1 bins, the scalars from the port's NormStats; prints ptxas's
   registers, shared memory and spills, the kernel's time at each width
   (CUDA events, median of 20) and its cycles a bin, the plain
   version's, the bytes bound and the dependence chain's
   (NORM_CYCLES_PER_BIN);
14. fabricates 30 whole-genome .bai files (hg38's 24 chromosomes at
   their GRCh38 lengths, 188,457 bins a sample, sex planted, three latent
   factors a sample planted: IC_FACTORS) with an
   .fai, and runs ``python -m goleft_tpu_torch indexcov`` in fresh
   processes: run A, the first 30 samples with the default flags and
   the reports, against a numpy oracle from the raw indexes (bed.gz,
   CN of chrX and chrY, bin counters, sex) and the port's CPU path
   (byte-identical but the PCA columns and charts, equal up to sign);
   run B, all 30 with ``-n --no-html`` (22 indexcov_norm launches), its
   chr21 rows of bed.gz and ROC against the CPU path's ``-c chr21 -n``;
   a 30-sample ``-n`` run killed by ``shard:after=5:kill``, resumed
   (byte-identical to an uninterrupted run, fewer launches) and resumed
   again (0 launches), these beside the checks of runs A and B; prints
   each run's seconds, import seconds, seven stage totals and samples/s;
15. runs ``python -m goleft_tpu_torch cohortscan`` on phase 14's 30
   .bai files in fresh processes, in chunks of 8
   samples: run S with ``-n`` (22 x 4 indexcov_norm launches), its
   bed.gz and ROC byte-identical to phase 14's run B and its .ped too
   but the PC columns, equal up to sign; run P without ``-n``, its PCs
   against a float64 oracle from the raw indexes on the card; the first
   27 samples killed by ``shard:after=5:kill`` (the QC blocks of chr1's
   four chunks committed) and resumed, then all 30 under ``--resume``
   with ``--pca sharded``: exactly 3 x 24 QC blocks computed, the bytes
   of run P but the PCs, and its PCs against the oracle and run P's
   (each component that 32 power iterations resolve, within its
   tolerance), the kill and append runs beside run P; prints each run's
   seconds, import seconds, stage totals and samples/s;
16. holds the depth kernel against its plain version on the card at
   multidepth's shapes (one 5 Mb chunk of phase 4's BAM, dense, window
   1, on both wires), then runs ``python -m goleft_tpu_torch multidepth``
   on phase 12's 8 BAMs (one chunk: 8 depth launches) and on phase 4's
   25 Mb BAM given twice (5 chunks: 10 launches, runs crossing chunk
   boundaries), each byte-identical to the port's CPU path; prints the
   seconds and sample-bp a second;
17. holds the swalign kernel (csrc/swalign_kernel.cu, the mapper's
   banded Smith-Waterman: a warp a pair, the direction plane kept on the
   card and walked there) against its plain version on the card, one
   counted launch a bucket: bitwise in best score, best cell and every
   byte of its unpacked direction plane, and its run-length CIGARs equal
   to the host traceback on every pair, on a bucket of 4,096 pairs of
   150 bp reads at the reference's band 32 (r1 161, w_pad 256), 8 pairs
   of 1,100 bp and 2 pairs of 2,000 bp (bands of 256 rows), B = 1, an
   all-N read, an all-mismatch pair, a tie and a window length past the
   bucket's width, and 64 pairs against ``sw_oracle``; prints the
   kernel's time, the plain version's, the copy of what ``align_bucket``
   brings to the host, the plane's bytes, the bound recounted on the
   cells these inputs need, and ptxas's registers and spills;
18. runs ``python -m goleft_tpu_torch map --depth-out`` on 20,480
   fabricated reads of 100-150 bp (both strands, substitutions, indels,
   N's) against a 6 + 4 Mb reference at the reference's defaults: ≥ 95%
   placed within ±5 bp on their strand, the first batch byte-identical
   to the CPU path, the ``--from-tuples`` bed identical, the depth
   kernel bitwise equal to its plain version at map's inputs (segments
   in read order, int32 wire, dense, window 1) and the card's bed
   byte-identical to the CPU path's on the same tuples, a transient
   ``map`` fault retried to the same bytes, a corrupt FASTQ exit 3;
   seeding on the card against the host oracle on 4,096 reads; prints
   the command's time split (import, index build, seed, extend kernel
   and walk, the alignments' copy, CIGAR formatting, depth) and
   launches; then runs goleft's
   six host tools (anonymize, samplename, covstats, indexsplit,
   depthwed, cnveval) once each;
19. starts ``python -m goleft_tpu_torch serve --port 0 --cache DIR``
   (--max-batch 16, continuous batching) and sends it /v1/depth on
   phase 4's BAM (the oracle's BEDs), a burst of 8 concurrent /v1/depth
   requests on phase 12's BAMs (at most 2 batched launches a region,
   each response the BAM served alone, one the one-shot CLI's),
   /v1/pairhmm (phase 6's table), /v1/cohortdepth --decode-device
   (phase 9's matrix), /v1/cohortscan -n on 30 of phase 14's .bai
   (phase 14's 30-sample -n run), /v1/map with window on phase 18's
   first batch (the CLI's tuples), the depth request again (cached, no
   launch); checks /healthz (platform gpu), /debug/compiles (the five
   builds), /debug/memory (device bytes), Prometheus /metrics, SIGTERM
   → exit 0, and the launches of its manifest; prints per-endpoint
   p50/p99, the burst's requests/s and batch sizes, launches, warmup
   and import seconds;
20. starts ``python -m goleft_tpu_torch fleet --workers 2 --shared-cache
   DIR --events-journal J``: its supervisor spawns two ``serve`` workers
   on the card (each /healthz platform gpu; the router process maps no
   torch); /v1/depth on phase 4's BAM through the router (the oracle's
   BEDs; /fleet/plan names the worker that answered), phase 19's burst
   of 8 through it (each body phase 19's; the ring's split and each
   worker's batched launches), SIGKILL of that BAM's home worker (the
   supervisor respawns it; ``fleet events`` lists the death and the
   restart; the same request answered from the shared cache, no
   launch), ``trace`` across the router and a worker (``--perfetto``
   JSON), ``warmup --router`` (a valid manifest with the depth family),
   ``memory --router --json`` (device bytes on both workers),
   ``profile --router --seconds 2 --collapsed`` (stacks), ``federation
   --fleet URL`` in front of it (the same bytes; ``trace`` over three
   levels; no torch mapped), SIGTERM to both → exit 0 with no worker
   left; prints the up, announce and restart seconds and each
   request's latency beside phase 19's direct one;
21. multi-device, two processes of one Gloo world on the one card:
   ``cohortdepth`` and ``cnv --vcf --matrix-out`` (``--engine device``)
   on phase 12's 8 BAMs, process 0's output byte-identical to phase 12's
   single-process runs and process 1 silent on stdout (four depth
   launches a process); ``sharded_depth_fn`` on a (1, 2) grid, 2 samples
   of ``shard_segments`` over 2 x 10 Mb, both carry modes, the assembled
   depth and window sums bitwise the plain version's over the whole 20
   Mb; ``run_prefetched_cohort`` on that grid (4 chunks, all of those
   segments, no depth to the host) at prefetch depth 0 and 2 and in a
   world of one in this process, λ, CN and window means bitwise,
   the window means the plain version's; the split over ``cuda:0``
   twice: ``_batched_em`` on phase 11's matrix bitwise, the PCA's Gram
   step within ``pca_tolerances``; ``measure_resume_overhead(quick=True)``
   and ``bisect_bench.measure()``; prints the phase's seconds and its
   depth launches;
22. the port's benchmark suite, lint and perf: ``python -m
   goleft_tpu_torch bench --quick --out-dir DIR --metrics-out DIR/m.json``
   in a fresh process must exit 0 with its 22 entries, each named
   ``torch_*`` and without an error: the entries with device work
   (the serve and fleet entries, whose recovery entries start real
   ``serve`` and ``fleet`` processes, the resume overhead and the wire
   lanes on the rANS kernel) on platform ``cuda`` and the card's name,
   the host entries with the JAX package's labels; the CRAM 3.1 codec
   entry on the C library (``native_lib``), every codec and wire lane
   having decoded its input; the headline's decode floor measured; and
   its manifest must count depth, pair-HMM, swalign and rANS launches;
   ``perf ingest --root DIR`` twice (the second adds 0 records), ``perf
   check`` (exit 0) and ``perf report`` over its files, and beside them
   ``lint --stats --max-seconds 90`` over the port (0 findings); and the
   sha256 of
   PERF_LEDGER.jsonl, BENCH_details.json, BENCH_lastgood.json,
   BASELINE_PINNED.json and .gtlint_baseline.json must be the same
   after the phase as before it; prints the headline, the depth
   kernel's Gbases/s, the phase's seconds and the card;
23. prints the kernels line, the card's ``nvidia-smi`` name and power
   limit, and as the last line ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, without a CUDA device, outside a
checkout, or when any phase fails.
"""

from __future__ import annotations

import argparse
import base64
import gzip
import json
import multiprocessing as mp
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SHARD = 10_000_000  # one production shard (commands/depth.py STEP)
WINDOW = 250
MAX_MEAN = 100
CAP = MAX_MEAN + 2500
MIN_COV = 4
READ_LEN = 150
# H100 SXM peaks: HBM bytes/s (data sheet), and the int32 rate that the
# depth, rANS, and swalign bounds divide their integer operations by:
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost (the data sheet's 67e12
# float32 rate counts 128 lanes and two operations an FMA)
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9

E2E_LEN = 25_000_000
E2E_READS = 5_000_000
E2E_CIGARS = ["150M", "70M10D80M", "60M300N90M", "20S130M", "130M20S",
              "75M5I70M"]
E2E_CIGAR_P = [0.70, 0.06, 0.06, 0.06, 0.06, 0.06]
# (start, end) offsets of each CIGAR's M blocks from the read position
E2E_BLOCKS = [[(0, 150)], [(0, 70), (80, 160)], [(0, 60), (360, 450)],
              [(0, 130)], [(0, 130)], [(0, 75), (75, 145)]]
PILE_POS, PILE_READS = 12_345_678, 3_000


_T0 = time.perf_counter()


def log(*a):
    """A progress line, stamped with the seconds since the script
    started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *a, flush=True)


def cuda_median_ms(fn, reps: int = 20) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def shard_segments(rng):
    """Absolute endpoints for one shard at w0 = 30,000,000: reads that
    overhang both shard ends (endpoints clip to 0 and to the shard
    length), a hotspot tile, zero- and one-base segments, a gap."""
    w0 = 30_000_000
    n = 2_000_000
    s = rng.integers(w0 - 500, w0 + SHARD + 500, n)
    e = s + READ_LEN
    hot_lo = w0 + 4884 * 1024  # one 1024-base tile of the shard
    hot = rng.integers(hot_lo, hot_lo + 1024, 10_000)
    edges_s = np.array([w0, w0, w0 + SHARD - 100, w0 + SHARD - 1, w0 + 7])
    edges_e = np.array([w0 + 100, w0 + 1, w0 + SHARD, w0 + SHARD, w0 + 7])
    s = np.concatenate([s, hot, edges_s])
    e = np.concatenate([e, hot + rng.integers(600, 1200, len(hot)),
                        edges_e])
    # a 200 kb gap, bridged on the u16 wire by 65535-base fillers
    gap = (s >= w0 + 6_000_000) & (s < w0 + 6_200_000)
    s, e = s[~gap], e[~gap]
    keep = rng.random(len(s)) > 0.05
    longs = (np.array([w0 + 3_000_000, w0 - 10]),
             np.array([w0 + 3_000_000 + 70_000, w0 + SHARD + 10]))
    return w0, (s.astype(np.int32), e.astype(np.int32), keep), longs


def cuda_graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    replayed between two events (median of ``reps``), divided by
    ``calls``. Unlike :func:`cuda_median_ms` the host's enqueue of each
    call (allocations, argument marshalling) is not inside the window."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


def u16_wire(s, e, keep):
    """The packed u16 wire of ``commands/depth.py`` (kept segments sorted,
    bucket-padded with zero entries; no entries when there are no
    segments) → (deltas, lens, base), or None for a segment of 65,536
    bases or more."""
    from goleft_tpu_torch.ops.coverage import bucket_size, pack_segments_u16

    order = np.argsort(s, kind="stable")
    packed = pack_segments_u16(s[order], e[order], keep[order])
    if packed is None:
        return None
    d, ln, base, n_ent = packed
    b = bucket_size(n_ent) if n_ent else 0
    dd = np.zeros(b, np.uint16)
    ll = np.zeros(b, np.uint16)
    dd[:n_ent], ll[:n_ent] = d, ln
    return dd, ll, int(base)


def depth_main_cases(dev, dk):
    """The kernel phase's 10 Mb shard (seed 2024) for ``dk``, a
    goleft_tpu_torch.ops.depth_kernel module: name → (kernel(dense),
    plain(), wire entries, wire bytes an entry). "int32": every segment,
    the ultra-long ones included, over the whole shard; "u16": the kept
    segments under 65,536 bases, a region strictly inside the shard;
    "u16_halo": the same plus one 65,535-base segment (the widest halo
    of the tile kernel)."""
    import torch

    from goleft_tpu_torch.ops.coverage import bucket_size

    rng = np.random.default_rng(2024)
    w0, (s, e, keep), (ls, le) = shard_segments(rng)
    full = (w0, w0, w0 + SHARD, CAP, MIN_COV, MAX_MEAN, SHARD, WINDOW)
    inner = (w0, w0 + 130, w0 + SHARD - 100, CAP, MIN_COV, MAX_MEAN, SHARD,
             WINDOW)

    # int32 wire: bucket-padded with keep=False
    s32 = np.concatenate([s, ls.astype(np.int32)])
    e32 = np.concatenate([e, le.astype(np.int32)])
    k32 = np.concatenate([keep, [True, True]])
    pad = bucket_size(len(s32)) - len(s32)
    s32 = np.concatenate([s32, np.zeros(pad, np.int32)])
    e32 = np.concatenate([e32, np.zeros(pad, np.int32)])
    k32 = np.concatenate([k32, np.zeros(pad, bool)])
    ts, te, tk = (torch.from_numpy(x).to(dev) for x in (s32, e32, k32))
    cases = {"int32": (
        lambda dense: dk.fused_depth(ts, te, tk, *full, dense=dense),
        lambda: dk.fused_depth_plain(ts, te, tk, *full), len(s32), 9)}

    halo_s = w0 + 4_000_000
    for name, (ss, ee) in (
            ("u16", (s, e)),
            ("u16_halo", (np.append(s, np.int32(halo_s)),
                          np.append(e, np.int32(halo_s + 0xFFFF))))):
        kk = np.append(keep, True) if len(ss) > len(s) else keep
        dd, ll, base = u16_wire(ss, ee, kk)
        assert (dd == 0xFFFF).any() and (ll == 0).any(), \
            "the u16 case must hold gap fillers"
        td, tl = (torch.from_numpy(x).to(dev) for x in (dd, ll))
        cases[name] = (
            lambda dense, td=td, tl=tl, base=base: dk.fused_depth_wire(
                td, tl, base, *inner, dense=dense),
            lambda td=td, tl=tl, base=base: dk.fused_depth_wire_plain(
                td, tl, base, *inner), len(dd), 4)
    return cases


def _edge_random(rng, n, lo, hi, max_len=400):
    s = np.sort(rng.integers(lo, hi, n)).astype(np.int32)
    e = (s + rng.integers(0, max_len, n)).astype(np.int32)
    return s, e, rng.random(n) < 0.9


def _edge_halo(rng):
    s, e, k = _edge_random(rng, 20_000, -300, 100_300)
    return (np.append(s, np.int32(5_000)), np.append(e, np.int32(70_535)),
            np.append(k, True), (0, 0, 100_000, CAP, MIN_COV, 40, 100_000,
                                 WINDOW))


def _edge_gap(rng):
    s, e, k = _edge_random(rng, 6_000, 0, 300_000)
    gap = (s >= 20_000) & (s < 220_000)
    s, e, k = s[~gap], e[~gap], k[~gap]
    return s, e, k, (0, 0, 300_000, CAP, MIN_COV, 40, 300_000, WINDOW)


def _edge_one_tile(rng):
    # 3,000 segments inside the tile [8,000, 12,000), all covering
    # [9,000, 11,000): the depth passes the cap of 2,600
    s = rng.integers(8_000, 9_000, 3_000).astype(np.int32)
    e = rng.integers(11_000, 12_000, 3_000).astype(np.int32)
    return s, e, np.ones(3_000, bool), (0, 0, 40_000, CAP, MIN_COV,
                                        MAX_MEAN, 40_000, WINDOW)


def _edge_empty(rng):
    z = np.zeros(0, np.int32)
    return z, z, np.zeros(0, bool), (0, 0, 40_000, CAP, MIN_COV, 40,
                                     40_000, WINDOW)


def _edge_inner(rng):
    w0 = 30_000_000
    s, e, k = _edge_random(rng, 8_000, w0 - 500, w0 + 40_500)
    return s, e, k, (w0, w0 + 130, w0 + 40_000 - 100, 60, MIN_COV, 40,
                     40_000, WINDOW)


def _edge_ragged(rng):
    s, e, k = _edge_random(rng, 2_000, -100, 10_350)
    return s, e, k, (0, 0, 10_250, 60, MIN_COV, 40, 10_250, WINDOW)


def _edge_window(w):
    def build(rng):
        length = w * (20_000 // w)
        s, e, k = _edge_random(rng, 3_000, -100, length + 100)
        return s, e, k, (0, 5, length - 3, 60, MIN_COV, 40, length, w)
    return build


def _edge_wide_window(rng):
    # DepthEngine's single window when window >= max_span (300,000 bp)
    s, e, k = _edge_random(rng, 5_000, 0, 300_000)
    return s, e, k, (0, 130, 299_930, 60, MIN_COV, 5, 300_032, 300_032)


def _edge_big_sums(rng):
    # 300-deep everywhere: a window sums 19,660,800 > 2**24
    length = 2 * 65_536
    s = np.arange(0, length, 60_000, dtype=np.int32).repeat(300)
    e = np.minimum(s + 0xFFFF, length).astype(np.int32)
    return s, e, np.ones(len(s), bool), (0, 0, length, CAP, MIN_COV,
                                         MAX_MEAN, length, 65_536)


def _edge_seq_shard(window, max_len):
    def build(rng):
        # the local step of a seq shard (parallel/sharded_coverage.py):
        # the start and end lists hold this shard's endpoints only, each
        # slot padded with the shard's top, so a read that began in a
        # shard to the left adds its -1 here alone and the local depth
        # goes below zero before the carry is added
        lo, length = 300_000, 100_000
        hi = lo + length
        s = rng.integers(lo - 50_000, hi + 50_000, 6_000)
        e = s + rng.integers(0, max_len, 6_000)
        ss = np.where((s >= lo) & (s < hi), s, hi)
        ee = np.where((e >= lo) & (e < hi), e, hi)
        ss[0], ee[0] = lo, hi  # one slot over the whole shard
        keep = (ss < hi) | (ee < hi)
        keep[1::97] = False
        return (ss.astype(np.int32), ee.astype(np.int32), keep,
                (lo, lo, hi, 2**31 - 1, MIN_COV, 0, length, window))
    return build


#: the depth kernel's edge cases: name → builder(rng) → (seg_start,
#: seg_end, keep, (w0, rs, re, cap, min_cov, max_mean, length, window));
#: tests/test_torch_cuda.py runs them on the card and
#: tests/test_torch_depth_pipeline.py against the JAX package
DEPTH_EDGES = {
    "halo_65535": _edge_halo,
    "gap_200kb": _edge_gap,
    "one_tile_to_cap": _edge_one_tile,
    "empty": _edge_empty,
    "inner_region": _edge_inner,
    "ragged_length": _edge_ragged,
    "window_7": _edge_window(7),
    "window_251": _edge_window(251),
    "window_250": _edge_window(250),
    "window_wider_than_tile": _edge_wide_window,
    "sums_above_2e24": _edge_big_sums,
    "zero_crossing_seq_shard": _edge_seq_shard(WINDOW, 3_000),
    "zero_crossing_wide_window": _edge_seq_shard(5_000, 20_000),
}
#: the cases the u16 wire cannot carry: a seq shard's start and end
#: lists are not segments (an end may precede its slot's start), and one
#: slot spans the whole 100,000-base shard
DEPTH_EDGES_INT32_ONLY = ("zero_crossing_seq_shard",
                          "zero_crossing_wide_window")


def depth_edge_case(name: str):
    """One edge case of :data:`DEPTH_EDGES` (its own seed) → (case, the
    u16 wire or None)."""
    seed = sorted(DEPTH_EDGES).index(name) + 70
    case = DEPTH_EDGES[name](np.random.default_rng(seed))
    return case, u16_wire(*case[:3])


def depth_edges_on_card(dev, dk) -> int:
    """Every edge case on both wires (the u16 wire where it can carry
    the segments), dense outputs, bitwise against the plain version.
    Returns the number of kernel calls checked."""
    import torch

    checked = 0
    for name in DEPTH_EDGES:
        (s, e, keep, args), wire = depth_edge_case(name)
        runs = [("int32", [torch.from_numpy(x).to(dev) for x in (s, e,
                                                                 keep)],
                 dk.fused_depth, dk.fused_depth_plain)]
        if wire is not None:
            dd, ll, base = wire
            runs.append(("u16", [torch.from_numpy(dd).to(dev),
                                 torch.from_numpy(ll).to(dev), base],
                         dk.fused_depth_wire, dk.fused_depth_wire_plain))
        for wname, t, kern, plain in runs:
            got = kern(*t, *args, dense=True)
            want = plain(*t, *args)
            torch.cuda.synchronize()
            for nm, g, w in zip(("sums", "packed", "cls", "depth"), got,
                                want):
                if g.dtype != w.dtype or g.shape != w.shape \
                        or not torch.equal(g, w):
                    raise AssertionError(
                        f"depth kernel edge case {name} ({wname} wire): "
                        f"{nm} differs from the plain version")
            checked += 1
    return checked


def depth_scratch_bytes(dev, kern) -> int:
    """Bytes a ``dense=False`` call allocates on the card beyond what is
    already there (its inputs): workspace and outputs, at their peak."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    out = kern(False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - before
    del out
    return int(peak)


def kernel_phase(dev):
    """Phase 3: kernel vs plain version at one full shard, both wires,
    and the edge cases."""
    import torch

    from goleft_tpu_torch.ops import depth_kernel as dk

    out = {}
    max_err = 0
    cases = depth_main_cases(dev, dk)
    for wire, (kern, plain, n_in, bytes_per) in cases.items():
        got = kern(True)
        want = plain()
        torch.cuda.synchronize()
        names = ("sums", "packed", "cls", "depth")
        for nm, g, w in zip(names, got, want):
            if g.dtype != w.dtype or g.shape != w.shape \
                    or not torch.equal(g, w):
                bad = (g.to(torch.float64) - w.to(torch.float64)).abs()
                raise AssertionError(
                    f"depth kernel ({wire} wire): {nm} differs from the "
                    f"plain version (max abs err {bad.max().item()})")
            max_err = max(max_err, (g.to(torch.float64)
                                    - w.to(torch.float64)).abs().max()
                          .item())
        assert int(got[3].max()) == CAP, "the hotspot must reach the cap"
        assert int((got[2] == 3).sum()) > 0, "class 3 must occur"
        ms = cuda_median_ms(lambda: kern(False))
        device_ms = cuda_graph_ms(lambda: kern(False))
        plain_ms = cuda_median_ms(plain)
        scratch = depth_scratch_bytes(dev, kern)
        n_win = SHARD // WINDOW
        bytes_moved = n_in * bytes_per + 4 * n_win + (SHARD + 3) // 4
        ops = 8 * SHARD + 10 * n_in
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT_OPS_PER_S * 1e3
        out[wire] = {
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "segments": n_in,
            "scratch_bytes": scratch,
        }
        log(f"depth kernel {wire} wire: bitwise equal to the plain version "
            f"(depth, sums, classes, packed); {n_in} entries, median "
            f"{ms:.4f} ms/shard by events around a call, {device_ms:.4f} "
            f"ms device time (CUDA graph of 20 calls), {plain_ms:.4f} ms "
            f"plain, bound {out[wire]['bound_ms']:.4f} ms "
            f"({out[wire]['bound_by']}); a dense=False call allocates "
            f"{scratch} bytes (workspace + outputs)")
    # the u16 wire must not allocate a per-base int32 buffer
    for wire in ("u16", "u16_halo"):
        assert out[wire]["scratch_bytes"] < 4 * SHARD, out[wire]
    out["edge_calls"] = depth_edges_on_card(dev, dk)
    log(f"depth kernel edge cases: {len(DEPTH_EDGES)} cases, "
        f"{out['edge_calls']} kernel calls bitwise equal to the plain "
        f"version ({', '.join(DEPTH_EDGES)})")
    out["max_abs_err"] = max_err
    return out


DB_SIZES = (1, 3, 8, 16)  # the batch sizes of the batched depth launch
DB_TIMED = 8  # the batch timed against as many single launches
DB_EMPTY = 2  # the sample without segments
DB_HALO = 0  # the sample that carries one 65,535-base segment


def depth_batch_samples(rng, n_samples: int, shard: int = SHARD,
                        most: int = 2_000_000):
    """``n_samples`` samples of one shard at w0 = 30,000,000, as
    run_segments_batch gets them (kept, sorted endpoints): uneven counts
    from a quarter of ``most`` to all of it, sample DB_EMPTY without
    segments, sample DB_HALO with one 65,535-base segment more → (w0,
    [(s, e)], the 70,000-base segment that forces the int32 wire)."""
    w0 = 30_000_000
    out = []
    for k in range(n_samples):
        if k == DB_EMPTY:
            out.append((np.zeros(0, np.int32), np.zeros(0, np.int32)))
            continue
        n = int(most * (0.25 + 0.75 * ((k * 7) % 16) / 15))
        s = np.sort(rng.integers(w0 - 500, w0 + shard + 500, n))
        e = s + rng.integers(1, 2 * READ_LEN, n)
        if k == DB_HALO:
            at = w0 + shard // 3
            i = np.searchsorted(s, at)
            s, e = np.insert(s, i, at), np.insert(e, i, at + 0xFFFF)
        out.append((s.astype(np.int32), e.astype(np.int32)))
    long_seg = (np.int32(w0 + shard // 2), np.int32(w0 + shard // 2 + 70_000))
    return w0, out, long_seg


def _batch_inputs(dev, samples, wire16: bool):
    """The batch's back-to-back entries on the card, as
    DepthEngine.run_segments_batch lays them out → (a, b, offsets, keep,
    bases)."""
    import torch

    from goleft_tpu_torch.ops.coverage import pack_segments_u16

    if wire16:
        packs = [pack_segments_u16(s, e, slice(None)) for s, e in samples]
        assert all(p is not None for p in packs)
        cols = [(p[0], p[1]) for p in packs]
        bases = [int(p[2]) for p in packs]
    else:
        cols, bases = samples, None
    counts = [len(x) for x, _ in cols]
    offsets = [0] + list(np.cumsum([(n + 7) // 8 * 8 for n in counts]))
    a = np.zeros(offsets[-1], np.uint16 if wire16 else np.int32)
    b = np.zeros_like(a)
    keep = np.zeros(len(a), bool)
    for (x, y), lo, n in zip(cols, offsets, counts):
        a[lo:lo + n], b[lo:lo + n], keep[lo:lo + n] = x, y, True
    put = [torch.from_numpy(x).to(dev) for x in (a, b, keep)]
    return put[0], put[1], [int(o) for o in offsets], \
        (None if wire16 else put[2]), bases


def depth_batch_phase(dev, shard: int = SHARD, most: int = 2_000_000,
                      sizes=DB_SIZES, timed: int | None = DB_TIMED) -> dict:
    """Phase 3b: the batched depth launch (fused_depth_batch, one launch
    for B samples over one region) bitwise against its plain version and
    against B single launches, dense outputs, at B in ``sizes`` on both
    wires (the int32 one with a 70,000-base segment in sample 1,
    over the whole shard; the u16 one over a region strictly inside it);
    the bytes a dense=False batch allocates beyond its outputs (fails at
    a per-base int32 buffer); the time of one batch of ``timed`` against
    as many single launches, and its bound."""
    import torch

    from goleft_tpu_torch.ops import depth_kernel as dk

    rng = np.random.default_rng(77)
    w0, pool, (ls, le) = depth_batch_samples(rng, max(sizes), shard, most)
    full = (w0, w0, w0 + shard, CAP, MIN_COV, MAX_MEAN, shard, WINDOW)
    inner = (w0, w0 + 130, w0 + shard - 100, CAP, MIN_COV, MAX_MEAN, shard,
             WINDOW)
    out = {"checked": 0, "max_abs_err": 0}
    for wire in ("u16", "int32"):
        for nb in sizes:
            samples = list(pool[:nb])
            if wire == "int32":  # into sample 1 (sample 0 alone)
                j = min(1, nb - 1)
                s, e = samples[j]
                samples[j] = (np.append(s, ls), np.append(e, le))
            args = inner if wire == "u16" else full
            a, b, offsets, keep, bases = _batch_inputs(dev, samples,
                                                       wire == "u16")
            before = dict(dk.LAUNCHES)
            got = dk.fused_depth_batch(a, b, offsets, *args, keep=keep,
                                       bases=bases, dense=True)
            assert dk.LAUNCHES["depth"] == before["depth"] + 1, \
                "a batch is one counted launch"
            want = dk.fused_depth_batch_plain(a, b, offsets, *args,
                                              keep=keep, bases=bases)
            singles = []
            for i in range(nb):
                lo, hi = offsets[i], offsets[i + 1]
                if wire == "u16":
                    singles.append(dk.fused_depth_wire(
                        a[lo:hi], b[lo:hi], bases[i], *args, dense=True))
                else:
                    singles.append(dk.fused_depth(
                        a[lo:hi], b[lo:hi], keep[lo:hi], *args, dense=True))
            torch.cuda.synchronize()
            for nm, g, w in zip(("sums", "packed", "cls", "depth"), got,
                                want):
                if g.dtype != w.dtype or g.shape != w.shape \
                        or not torch.equal(g, w):
                    raise AssertionError(
                        f"batched depth launch ({wire} wire, B = {nb}): "
                        f"{nm} differs from the plain version")
                for i, one in enumerate(singles):
                    if not torch.equal(g[i], one[("sums", "packed", "cls",
                                                  "depth").index(nm)]):
                        raise AssertionError(
                            f"batched depth launch ({wire} wire, B = "
                            f"{nb}): sample {i}'s {nm} differs from its "
                            "single launch")
            if nb > DB_EMPTY:
                assert int(got[3][DB_EMPTY].abs().sum()) == 0
            out["checked"] += 1
            del got, want, singles
    # bytes beyond the outputs: no per-base int32 buffer on the u16 wire
    nb = max(sizes)
    a, b, offsets, keep, bases = _batch_inputs(dev, pool[:nb], True)
    n_win, plen = shard // WINDOW, (shard + 3) // 4
    outputs = nb * (4 * n_win + (plen + 15) // 16 * 16)
    scratch = depth_scratch_bytes(dev, lambda dense: dk.fused_depth_batch(
        a, b, offsets, *inner, bases=bases, dense=dense))
    out["scratch_bytes"] = scratch
    out["output_bytes"] = outputs
    assert scratch - outputs < 4 * shard, \
        f"a dense=False batch of {nb} allocates {scratch} bytes"
    log(f"batched depth launch: B = {', '.join(map(str, sizes))} on both "
        f"wires ({out['checked']} launches), bitwise equal to the plain "
        f"version and to B single launches (sums, packed, classes, "
        f"depth); a dense=False batch of {nb} allocates {scratch} bytes, "
        f"{outputs} of them outputs")
    if timed:
        a, b, offsets, keep, bases = _batch_inputs(dev, pool[:timed], True)
        views = [(a[offsets[i]:offsets[i + 1]], b[offsets[i]:offsets[i + 1]],
                  bases[i]) for i in range(timed)]

        def singles():
            for x, y, base in views:
                dk.fused_depth_wire(x, y, base, *inner)

        ms = cuda_median_ms(lambda: dk.fused_depth_batch(
            a, b, offsets, *inner, bases=bases))
        single_ms = cuda_median_ms(singles)
        n_in = offsets[-1]
        bytes_moved = 4 * n_in + timed * (4 * n_win + plen)
        ops = timed * 8 * shard + 10 * n_in
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT_OPS_PER_S * 1e3
        out.update(b=timed, ms=ms, singles_ms=single_ms, entries=n_in,
                   bytes=bytes_moved, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"batched depth launch, B = {timed} on the u16 wire ({n_in} "
            f"entries): median {ms:.4f} ms by events around one launch "
            f"against {single_ms:.4f} ms for {timed} single launches; bound "
            f"{out['bound_ms']:.4f} ms ({out['bound_by']}, {bytes_moved} "
            f"bytes)")
    return out


def fabricate(workdir: str, rng):
    """Phase 4 input: reads, BAM + BAI, FASTA."""
    from goleft_tpu_torch.io.bai import write_bai
    from tools.bulk_bam import write_bam_bulk

    n = E2E_READS
    pos = rng.integers(0, E2E_LEN - 500, n - PILE_READS)
    pos = np.sort(np.concatenate([pos, np.full(PILE_READS, PILE_POS)]))
    cig = rng.choice(len(E2E_CIGARS), n, p=E2E_CIGAR_P)
    mapq = np.where(rng.random(n) < 0.03, 0, 60).astype(np.uint8)
    flag = rng.choice([0, 0x400, 0x100], n, p=[0.95, 0.03, 0.02]) \
        .astype(np.uint16)
    bam = os.path.join(workdir, "smoke.bam")
    idx = write_bam_bulk(bam, "chr1", E2E_LEN, pos, cig, E2E_CIGARS, mapq,
                         flag)
    write_bai(idx, bam + ".bai")
    fa = os.path.join(workdir, "ref.fa")
    write_fasta(fa, rng, E2E_LEN)
    return bam, fa, (pos, cig, mapq, flag)


def write_fasta(path: str, rng, length: int) -> bytes:
    """A random ACGT contig ``chr1`` in 60-base lines → its bases."""
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)]
    full = length // 60 * 60
    rows = np.concatenate([seq[:full].reshape(-1, 60),
                           np.full((full // 60, 1), 10, np.uint8)], axis=1)
    with open(path, "wb") as fh:
        fh.write(b">chr1\n" + rows.tobytes())
        if length > full:
            fh.write(seq[full:].tobytes() + b"\n")
    return seq.tobytes()


def oracle_beds(reads) -> tuple[str, str]:
    """Both BED files from the generated read list: np.add.at-style
    bincount + cumsum, cap, %.4g window means, per-shard class runs."""
    pos, cig, mapq, flag = reads
    kept = (mapq >= 1) & ((flag & 0x704) == 0)
    starts, ends = [], []
    for t, blocks in enumerate(E2E_BLOCKS):
        p = pos[kept & (cig == t)]
        for a, b in blocks:
            starts.append(p + a)
            ends.append(p + b)
    starts = np.concatenate(starts)
    ends = np.concatenate(ends)
    delta = (np.bincount(starts, minlength=E2E_LEN + 1)
             - np.bincount(ends, minlength=E2E_LEN + 1))
    depth = np.minimum(np.cumsum(delta[:E2E_LEN]), CAP)
    cls = np.where(depth == 0, 0, np.where(
        depth < MIN_COV, 1, np.where(depth >= MAX_MEAN, 3, 2)))
    names = ("NO_COVERAGE", "LOW_COVERAGE", "CALLABLE", "EXCESSIVE_COVERAGE")
    sums = depth.reshape(-1, WINDOW).sum(axis=1)
    drows = [f"chr1\t{i * WINDOW}\t{(i + 1) * WINDOW}\t{s / WINDOW:.4g}\n"
             for i, s in enumerate(sums.tolist())]
    crows = []
    for lo in range(0, E2E_LEN, SHARD):
        c = cls[lo:lo + SHARD]
        cut = np.flatnonzero(c[1:] != c[:-1]) + 1
        rs = np.concatenate([[0], cut])
        re = np.concatenate([cut, [len(c)]])
        crows += [f"chr1\t{lo + a}\t{lo + b}\t{names[v]}\n"
                  for a, b, v in zip(rs.tolist(), re.tolist(),
                                     c[rs].tolist())]
    assert (cls == 3).any() and (depth == CAP).any()
    return "".join(drows), "".join(crows)


def import_breakdown(root: str, env: dict) -> dict:
    """Cumulative import seconds of torch, numpy and the depth command's
    module, from ``python -X importtime`` in a fresh process."""
    r = subprocess.run(
        [sys.executable, "-X", "importtime", "-c",
         "import goleft_tpu_torch.commands.depth"],
        cwd=root, env=env, capture_output=True, text=True, check=True)
    want = ("torch", "numpy", "goleft_tpu_torch.commands.depth")
    out = {}
    for line in r.stderr.splitlines():
        parts = line.split("|")
        if len(parts) == 3 and parts[2].strip() in want:
            out[parts[2].strip()] = int(parts[1]) / 1e6
    return out


def e2e_phase(root: str, workdir: str):
    """→ (results, (bam, fasta, the oracle's depth BED, callable BED))."""
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    bam, fa, reads = fabricate(workdir, rng)
    log(f"fabricated {E2E_READS} reads on a {E2E_LEN} bp contig in "
        f"{time.perf_counter() - t0:.1f} s")
    prefix = os.path.join(workdir, "out")
    report = os.path.join(workdir, "report.json")
    cmd = [sys.executable, "-m", "goleft_tpu_torch", "--metrics-out",
           report, "depth", "--prefix", prefix, "-r", fa, "-w",
           str(WINDOW), "-m", str(MAX_MEAN), bam]
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                       text=True)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"depth CLI failed ({r.returncode}):\n"
                             f"{r.stderr[-4000:]}")
    rep, cmd_s, stages = read_manifest(report, "depth")
    assert rep["native_io"], "the native host decoder was not loaded"
    launches = rep["kernel_launches"]["depth"]
    assert launches >= 1, "the depth CLI never launched the depth kernel"
    want_d, want_c = oracle_beds(reads)
    for path, want in ((prefix + ".depth.bed", want_d),
                       (prefix + ".callable.bed", want_c)):
        with open(path) as fh:
            _same_bytes(f"{os.path.basename(path)} (against the numpy "
                        "oracle)", fh.read(), want)
    log(f"depth CLI: {E2E_LEN} bp, {E2E_READS} reads; process wall "
        f"{wall:.3f} s = {E2E_LEN / wall / 1e9:.4f} Gbases/s, command "
        f"{cmd_s:.3f} s = {E2E_LEN / cmd_s / 1e9:.4f} Gbases/s end to end; "
        f"both BEDs byte-identical to the numpy oracle; kernel launches "
        f"{launches} for {-(-E2E_LEN // SHARD)} shards")
    imports = rep["import_seconds"]
    rest = cmd_s - imports - stages.get("setup", 0.0) \
        - stages.get("shard-loop", 0.0)
    log(f"stage seconds: interpreter start {wall - cmd_s:.3f}, command "
        f"import {imports:.3f}, unattributed {rest:.3f}, " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(stages.items()))
        + " (setup and shard-loop are wall clock; host-decode, "
        "device-compute and write-output are summed over shard threads)")
    # the import breakdown's process runs beside the pair-HMM kernel
    # phase (the card's work; main reads it after phase 5)
    import_split = _BG.submit(import_breakdown, root, env)
    return {"wall_s": wall, "command_s": cmd_s, "import_s": imports,
            "unattributed_s": rest, "import_breakdown": import_split,
            "gbases_per_s": E2E_LEN / cmd_s / 1e9,
            "gbases_per_s_process": E2E_LEN / wall / 1e9,
            "launches": launches, "stage_seconds": stages,
            "backend": rep["backend"]}, (bam, fa, want_d, want_c)


# ---- the bring-up guard and provenance (phase 4b) --------------------

GUARD_REGION = 1_000_000  # the depth runs' bed region: chr1:0-1,000,000
GUARD_HANG_S = 3  # the hung probe's timeout
GUARD_HANG_SLACK_S = 10  # interpreter start-up and the manifest, at most
#: a probe command line standing in for a wedged card: a child that
#: sleeps past the timeout (and exits on its own 3 s later)
_GUARD_HANG_CLI = """\
import functools, sys
sys.path.insert(0, {root!r})
from goleft_tpu_torch.utils import device_guard as g
g.ensure_card = functools.partial(g.ensure_card, probe_argv=[
    sys.executable, "-c",
    g.arm_traceback_snippet("import time; time.sleep({sleep})", {t})])
from goleft_tpu_torch import cli
sys.exit(cli.main(sys.argv[1:]))
"""


def first_probe() -> dict:
    """The script's first probe of the card (utils/device_guard.py), run
    beside the kernel builds; the device commands this script starts
    find it in the probe's cache → {mode, seconds}."""
    from goleft_tpu_torch.utils import device_guard

    t0 = time.perf_counter()
    mode = device_guard.ensure_card()
    return {"mode": mode, "seconds": time.perf_counter() - t0}


def _guard_depth(root, workdir, name, env, bam, fa, bed, trace=False):
    """``depth -b`` on phase 4's BAM over GUARD_REGION in a fresh process
    → (result, its manifest)."""
    prefix = os.path.join(workdir, f"guard_{name}")
    report = prefix + ".json"
    args = ["--metrics-out", report]
    if trace:
        args += ["--trace-out", prefix + ".trace.json"]
    r, wall = _run_cli(root, args + [
        "depth", "--prefix", prefix, "-r", fa, "-w", str(WINDOW), "-m",
        str(MAX_MEAN), "-b", bed, bam], env)
    if r.returncode != 0:
        raise AssertionError(f"guard phase: depth ({name}) failed "
                             f"({r.returncode}):\n{r.stderr[-4000:]}")
    rep, _, _ = read_manifest(report, "depth")
    return {"wall_s": wall, "prefix": prefix,
            "counters": rep["metrics"]["counters"],
            "spans": {k: v["seconds"] for k, v in rep["spans"].items()},
            "launches": rep["kernel_launches"]["depth"]}, rep


def guard_phase(root: str, workdir: str, depth_fixture) -> dict:
    """Phase 4b: the bring-up guard and obs/provenance.py on the card.
    With the probe's caches cleared, ``depth -b`` on phase 4's BAM
    probes the card (a child process), brings CUDA up under the watchdog
    and writes the oracle's rows; a second run finds the probe cached;
    a run whose probe sleeps past GUARD_HANG_S must exit 1 with one
    stderr line, no kernel launched, within GUARD_HANG_S +
    GUARD_HANG_SLACK_S. ``backend_provenance("cuda")`` must name the card
    as nvidia-smi does, and the manifest and the device spans of the
    depth run carry its values."""
    import torch

    from goleft_tpu_torch.obs.provenance import (backend_provenance,
                                                nvidia_smi_line)
    from goleft_tpu_torch.utils import device_guard

    t_phase = time.perf_counter()
    bam, fa, want_d, _ = depth_fixture
    bed = os.path.join(workdir, "guard.bed")
    with open(bed, "w") as fh:
        fh.write(f"chr1\t0\t{GUARD_REGION}\n")
    want_rows = "".join(want_d.splitlines(True)[:GUARD_REGION // WINDOW])
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GOLEFT_TPU_PROBE", None)
    for kind in ("ok", "fail"):
        try:
            os.remove(device_guard._probe_cache_path(kind))
        except FileNotFoundError:
            pass
    runs = {}
    for name in ("first", "cached"):
        run, rep = _guard_depth(root, workdir, name, env, bam, fa, bed,
                                trace=name == "cached")
        c = run["counters"]
        probed = (c.get("device.probe_total", 0),
                  c.get("device.probe_cached_total", 0))
        assert probed == ((1, 0) if name == "first" else (0, 1)), \
            f"guard phase: the {name} run's probe counters {probed}"
        assert run["launches"] >= 1, f"guard phase: {name} run launched " \
            "no depth kernel"
        with open(run["prefix"] + ".depth.bed") as fh:
            _same_bytes(f"guard phase {name} depth.bed (against the "
                        "oracle's rows)", fh.read(), want_rows)
        run["probe_s"] = run["spans"].get("device-probe")
        run["bringup_s"] = run["spans"]["device-bringup"]
        run["backend"] = rep["backend"]
        runs[name] = run
    # the card's provenance, as the depth runs' manifests and spans say it
    prov = backend_provenance("cuda")
    smi = nvidia_smi_line()
    assert prov["platform"] == "gpu" and prov["device_count"] >= 1, prov
    assert prov["device_kind"] == torch.cuda.get_device_name(0), prov
    assert prov["nvidia_smi"] == smi and smi.startswith(prov["device"]), \
        (prov, smi)
    for name, run in runs.items():
        assert run["backend"] == prov, (name, run["backend"], prov)
    tr = load_trace(runs["cached"]["prefix"] + ".trace.json")
    assert tr["device"], "guard phase: the traced run has no device span"
    for e in tr["device"]:
        got = {k: e["args"][k] for k in ("platform", "device_kind",
                                         "device_count")}
        assert got == {k: prov[k] for k in got}, (e["name"], got)
    # a probe that hangs: one line, exit 1, no kernel, on time
    runner = os.path.join(workdir, "guard_hang.py")
    with open(runner, "w") as fh:
        fh.write(_GUARD_HANG_CLI.format(root=root, sleep=GUARD_HANG_S + 3,
                                        t=GUARD_HANG_S))
    report = os.path.join(workdir, "guard_hang.json")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, runner, "--metrics-out", report, "depth",
         "--prefix", os.path.join(workdir, "guard_hang"), "-r", fa, "-b",
         bed, bam], cwd=root, capture_output=True, text=True,
        env=dict(env, GOLEFT_TPU_DEVICE_WATCHDOG_SECONDS=str(GUARD_HANG_S)))
    hang_s = time.perf_counter() - t0
    lines = r.stderr.strip().splitlines()
    assert r.returncode == 1 and len(lines) == 1 \
        and f"hung past {GUARD_HANG_S}s" in lines[0], (r.returncode,
                                                      r.stderr[-2000:])
    assert hang_s < GUARD_HANG_S + GUARD_HANG_SLACK_S, hang_s
    from goleft_tpu_torch.obs.manifest import load_manifest

    hrep = load_manifest(report)
    assert not any(hrep["kernel_launches"].values()), hrep["kernel_launches"]
    assert "error" in hrep["backend"], hrep["backend"]
    tail = lines[0].rsplit(" ", 1)[-1]
    with open(tail) as fh:
        assert "Timeout" in fh.read(), "no traceback in the hung probe's tail"
    os.remove(tail)
    t0 = time.perf_counter()
    cached = device_guard.ensure_card()
    cached_s = time.perf_counter() - t0
    assert cached == "cached", cached
    first, again = runs["first"], runs["cached"]
    log(f"guard: first depth -b run {first['wall_s']:.3f} s with its probe "
        f"{first['probe_s']:.3f} s (a child: torch import, CUDA init, one "
        f"op) and CUDA bring-up under the watchdog {first['bringup_s']:.3f} "
        f"s; the second {again['wall_s']:.3f} s, probe cached (the check "
        f"{cached_s * 1e3:.3f} ms in this process), bring-up "
        f"{again['bringup_s']:.3f} s; a probe hung past {GUARD_HANG_S} s: "
        f"exit 1 in {hang_s:.3f} s, one line, no launch: {lines[0]}")
    log("provenance: backend_provenance('cuda') = " + json.dumps(prov)
        + f"; the manifests and {len(tr['device'])} device spans agree")
    return {"first": {k: first[k] for k in ("wall_s", "probe_s",
                                            "bringup_s", "launches")},
            "cached": {k: again[k] for k in ("wall_s", "probe_s",
                                             "bringup_s", "launches")},
            "cached_check_s": cached_s, "hang_s": hang_s,
            "hang_line": lines[0], "provenance": prov,
            "phase_s": time.perf_counter() - t_phase}


# ---- pair-HMM phases ---------------------------------------------------

PH_B = 4096  # pairs of the kernel phase's main bucket
PH_READ, PH_HAP = 150, 416  # r_pad 160 (r1 161), h_pad 416
PH_LONG = (1100, 1200, 8)  # read bp, hap bp, pairs: r1 1121, two strips
PH_WINDOWS, PH_WINDOW_READS = 80, 80
PH_ORACLE_WINDOWS = 20
PH_FAULT_SPEC = "pairhmm:every=1:permanent:times=99"
# r1 values that reach each compiled R (r1 = 32 R) and the first r1 of
# the next (32 R + 1); 256 | 257 is the strip edge
PH_GEOMETRY_R1 = [r1 for rows in range(1, 9) for r1 in (32 * rows,
                                                        32 * rows + 1)]
# float32 / float64 instruction rates outside the tensor cores, counting
# a multiply or an add as one operation: 132 SMs x 128 (f32) or 64 (f64)
# lanes x 1.98 GHz. The data sheet's 67 / 34 TFLOP/s count an FMA as two
# operations, but the kernel is built with -fmad=false and issues every
# multiply and add on its own, so these are its peak rates.
F32_OPS_PER_S = 132 * 128 * 1.98e9
F64_OPS_PER_S = 132 * 64 * 1.98e9
_CODES = np.frombuffer(b"ACGTN", np.uint8)
_LN10 = np.log(10.0)


def oracle_log10(r, err, h, gap_open=45.0, gap_ext=10.0):
    """Row-major log-space forward, one cell at a time: a copy of
    tests/test_pairhmm.py::oracle_log10 taking base codes and error
    probabilities."""
    delta = 10.0 ** (-gap_open / 10.0)
    eps = 10.0 ** (-gap_ext / 10.0)
    l_mm = np.log(1 - 2 * delta)
    l_gap_open = np.log(delta)       # M→I and M→D
    l_gap_to_m = np.log1p(-eps)      # I→M and D→M
    l_gap_ext = np.log(eps)          # I→I and D→D
    R, H = len(r), len(h)
    M = np.full((R + 1, H + 1), -np.inf)
    I = np.full((R + 1, H + 1), -np.inf)
    D = np.full((R + 1, H + 1), -np.inf)
    D[0, :] = -np.log(H)
    lse = np.logaddexp
    for i in range(1, R + 1):
        lm = np.log1p(-err[i - 1])
        lx = np.log(err[i - 1] / 3.0)
        for j in range(1, H + 1):
            match = (r[i - 1] == h[j - 1]) or r[i - 1] == 4 \
                or h[j - 1] == 4
            prior = lm if match else lx
            M[i, j] = prior + lse(
                l_mm + M[i - 1, j - 1],
                lse(l_gap_to_m + I[i - 1, j - 1],
                    l_gap_to_m + D[i - 1, j - 1]))
            I[i, j] = lse(l_gap_open + M[i - 1, j],
                          l_gap_ext + I[i - 1, j])
            D[i, j] = lse(l_gap_open + M[i, j - 1],
                          l_gap_ext + D[i, j - 1])
    tot = -np.inf
    for j in range(1, H + 1):
        tot = lse(tot, lse(M[R, j], I[R, j]))
    return tot / np.log(10.0)


def oracle_log10_rows(reads, errs, h, gap_open=45.0, gap_ext=10.0):
    """The same forward for n reads of one length ((n, R) codes and
    errors) against one haplotype, row-major in f64 with each row scaled
    by its max and the log of the scales kept: M and I of row i from row
    i-1 as vectors, D along the row as the linear recurrence
    D[j] = δ M[j-1] + ε D[j-1] (scipy.signal.lfilter). → (n,) log10."""
    from scipy.signal import lfilter

    n, R = reads.shape
    H = len(h)
    delta = 10.0 ** (-gap_open / 10.0)
    eps = 10.0 ** (-gap_ext / 10.0)
    t_mm, t_gm = 1.0 - 2.0 * delta, 1.0 - eps
    M = np.zeros((n, H + 1))
    I = np.zeros((n, H + 1))
    D = np.full((n, H + 1), 1.0 / H)
    log_scale = np.zeros(n)
    for i in range(R):
        rb = reads[:, i][:, None]
        e = errs[:, i][:, None]
        match = (rb == h[None, :]) | (rb == 4) | (h[None, :] == 4)
        prior = np.where(match, 1.0 - e, e / 3.0)
        Mn = np.zeros((n, H + 1))
        In = np.zeros((n, H + 1))
        Mn[:, 1:] = prior * (t_mm * M[:, :-1]
                             + t_gm * (I[:, :-1] + D[:, :-1]))
        In[:, 1:] = delta * M[:, 1:] + eps * I[:, 1:]
        Dn = np.zeros((n, H + 1))
        Dn[:, 1:] = lfilter([delta], [1.0, -eps], Mn[:, :-1], axis=1)
        top = np.maximum(np.maximum(Mn.max(axis=1), In.max(axis=1)),
                         Dn.max(axis=1))[:, None]
        M, I, D = Mn / top, In / top, Dn / top
        log_scale += np.log(top[:, 0])
    return (np.log(np.sum(M[:, 1:] + I[:, 1:], axis=1)) + log_scale) \
        / _LN10


def oracle_genotype(ll):
    """(R, H) log10 → (genotype "a/b", GQ, PLs): diploid likelihoods over
    a ≤ b in VCF order, PL = rint(-10 (gl - max)) capped 99999, GQ the
    second-smallest PL capped 99."""
    gl, pairs = [], []
    for b in range(ll.shape[1]):
        for a in range(b + 1):
            pairs.append((a, b))
            gl.append(float(np.sum(
                np.logaddexp(ll[:, a] * _LN10, ll[:, b] * _LN10) / _LN10
                - np.log10(2.0))))
    gl = np.array(gl)
    best = int(np.argmax(gl))
    pl = np.clip(np.rint(-10.0 * (gl - gl[best])), 0, 99999).astype(int)
    gq = int(min(np.sort(pl)[1], 99)) if len(pl) > 1 else 0
    return f"{pairs[best][0]}/{pairs[best][1]}", gq, pl.tolist()


def ph_read(rng, hap, read_len, quals, indels=True):
    """Base codes of a read drawn from ``hap``: maybe a 1-3 bp insertion
    or deletion, base errors at each base's quality, N at 0.5%."""
    src = hap
    u = rng.random() if indels else 1.0
    if u < 0.2 and len(hap) > 4:
        v = int(rng.integers(1, len(hap) - 3))
        k = int(rng.integers(1, 4))
        src = (np.concatenate([hap[:v], rng.integers(0, 4, k), hap[v:]])
               if u < 0.1 else np.concatenate([hap[:v], hap[v + k:]]))
    st = int(rng.integers(0, max(1, len(src) - read_len + 1)))
    r = np.resize(src[st:st + read_len], read_len).astype(np.uint8)
    err = rng.random(read_len) < 10.0 ** (-np.asarray(quals) / 10.0)
    r[err] = (r[err] + rng.integers(1, 4, int(err.sum()))) % 4
    r[rng.random(read_len) < 0.005] = 4
    return r


def ph_pairs(rng, n, read_len, hap_len, qual=None, junk=False):
    """n (read codes, phred quals, hap codes) triples."""
    reads, quals, haps = [], [], []
    for _ in range(n):
        h = rng.integers(0, 4, hap_len).astype(np.uint8)
        q = np.full(read_len, qual) if qual is not None \
            else rng.integers(2, 42, read_len)
        r = rng.integers(0, 4, read_len).astype(np.uint8) if junk \
            else ph_read(rng, h, read_len, q)
        reads.append(r)
        quals.append(q)
        haps.append(h)
    return reads, quals, haps


def ph_packed(rng, n, r1, hap_len, dtype, qual=None, junk=False):
    """n pairs of (r1 - 1) bp reads x ``hap_len`` bp haps packed at
    exactly r1 rows (``_pack_bucket`` with r_pad = r1 - 1)."""
    from goleft_tpu_torch.ops import pairhmm as tph

    reads, quals, haps = ph_pairs(rng, n, r1 - 1, hap_len, qual, junk)
    return tph._pack_bucket(list(range(n)), reads,
                            [tph.phred_to_err(q) for q in quals], haps,
                            r1 - 1, tph._pad_up(hap_len), dtype)


def ph_trap_bucket(rng, n, read_len, hap_len, dtype):
    """The adoption trap, packed: junk q20 reads whose first base is
    their hap's first base, at pm = 0, so cell (1, 1) is all zero inside
    the valid area, and 3% of the other rows' pm and px zeroed. Such
    zero cells meet rows that renormalise on the same diagonal, where
    an all-zero cell must adopt the counter its upper neighbour has just
    computed."""
    from goleft_tpu_torch.ops import pairhmm as tph

    reads, quals, haps = ph_pairs(rng, n, read_len, hap_len, qual=20,
                                  junk=True)
    for r, h in zip(reads, haps):
        r[0] = h[0]
    reads_p, pm, px, rlens, haps_p, hlens = tph._pack_bucket(
        list(range(n)), reads, [tph.phred_to_err(q) for q in quals], haps,
        tph._pad_up(read_len), tph._pad_up(hap_len), dtype)
    pm[:, 1] = 0
    pm[:, 2:][rng.random(pm[:, 2:].shape) < 0.03] = 0
    px[:, 2:][rng.random(px[:, 2:].shape) < 0.03] = 0
    return reads_p, pm, px, rlens, haps_p, hlens


def _pairhmm_key(name: str):
    m = re.search(r"pairhmm_forward_kernelI([fd])Lb[01]ELi(\d)E", name)
    return m and f"{'float32' if m[1] == 'f' else 'float64'} R{m[2]}"


def kernel_resources(build_log: str, key=_pairhmm_key) -> dict:
    """ptxas's report → {key: {"registers", "spill_stores", "spill_loads"}}
    (and "smem_bytes" where ptxas prints static shared memory) for each
    compiled kernel whose mangled name ``key`` maps to a key (None skips
    it); by default the pair-HMM kernel's instantiations, "float32 R6",
    ..."""
    out, k = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = key(m[1])
            if k:
                out[k] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if k and m:
            out[k].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if k and m:
            out[k]["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                out[k]["smem_bytes"] = int(m[1])
            k = None
    return out


#: the pair-HMM kernel phase's pairs held against the log-space oracle:
#: 8 of the main bucket and 2 of each edge case
PH_ORACLE_PICKS = [("main", i) for i in range(8)] + [
    (n, i) for n in ("read>hap", "1-base", "q93", "junk300")
    for i in range(2)]


def pairhmm_oracles(picked, long_pairs):
    """The log-space oracle on ``picked`` ((name, i, read, errors, hap)),
    the row oracle checked against it on each case's first pair, and the
    row oracle on ``long_pairs`` ((read, errors, hap)) → ({(name, i):
    log10}, [log10])."""
    want = {}
    for name, i, r, e, h in picked:
        want[name, i] = oracle_log10(r, e, h)
        if i == 0:
            rows = oracle_log10_rows(r[None, :], e[None, :], h)[0]
            assert abs(rows - want[name, i]) < 1e-9, (name, rows,
                                                       want[name, i])
    return want, [oracle_log10_rows(r[None, :], e[None, :], h)[0]
                  for r, e, h in long_pairs]


def pairhmm_kernel_phase(dev, pool):
    """Kernel vs plain version on the card (f32 rescaled, f64 unscaled):
    one full bucket of 4,096 pairs, edge buckets, a 1,100 bp bucket;
    padding invariance; 16 pairs against the log-space oracle and the
    long bucket against the row oracle (both computed in a worker process
    of ``pool`` beside the card's checks); the main bucket's times and
    bound."""
    import torch

    from goleft_tpu_torch.ops import pairhmm as tph
    from goleft_tpu_torch.ops import pairhmm_kernel as pk

    resources = kernel_resources(pk.BUILD_LOG)
    if resources:
        log("pairhmm kernel instantiations (ptxas): " + json.dumps(resources))
        spills = {k: v for k, v in resources.items()
                  if v.get("spill_stores") or v.get("spill_loads")}
        assert len(resources) == 16 and not spills, spills
    rng = np.random.default_rng(150)
    cases = {
        "main": ph_pairs(rng, PH_B, PH_READ, PH_HAP),
        "read>hap": ph_pairs(rng, 8, PH_READ, 100),
        "1-base": ph_pairs(rng, 8, 1, PH_HAP),
        "q93": ph_pairs(rng, 8, PH_READ, PH_HAP, qual=93),
        "junk300": ph_pairs(rng, 4, 300, PH_HAP, qual=35, junk=True),
        "long1100": ph_pairs(rng, PH_LONG[2], PH_LONG[0], PH_LONG[1]),
    }
    oracle = pool.apply_async(pairhmm_oracles, (
        [(n, i, cases[n][0][i], tph.phred_to_err(cases[n][1][i]),
          cases[n][2][i]) for n, i in PH_ORACLE_PICKS],
        [(r, tph.phred_to_err(q), h)
         for r, q, h in zip(*cases["long1100"])]))
    folded = {}
    max_err = 0.0
    out = {}
    for name, (reads, quals, haps) in cases.items():
        errs = [tph.phred_to_err(q) for q in quals]
        r_pad = tph._pad_up(len(reads[0]))
        h_pad = tph._pad_up(len(haps[0]))
        idxs = list(range(len(reads)))
        for dtype in (np.float32, np.float64):
            rescale = dtype == np.float32
            packed = tph._pack_bucket(idxs, reads, errs, haps, r_pad, h_pad,
                                      dtype)
            trans = tph.transition_probs().astype(dtype)
            t = [torch.from_numpy(a).to(dev) for a in (*packed, trans)]
            got = pk.forward_bucket(*t, rescale=rescale)
            want = pk.forward_bucket_plain(*t, rescale=rescale)
            torch.cuda.synchronize()
            err = (got[0].double() - want[0].double()).abs().max().item()
            max_err = max(max_err, err)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(
                    f"pairhmm kernel ({name}, {np.dtype(dtype).name}): "
                    f"differs from the plain version (contribs max abs "
                    f"err {err}, shifts equal "
                    f"{torch.equal(got[1], want[1])})")
            lg = tph._fold_contribs(got[0].cpu().numpy(),
                                    got[1].cpu().numpy())
            lw = tph._fold_contribs(want[0].cpu().numpy(),
                                    want[1].cpu().numpy())
            assert np.abs(lg - lw).max() <= 1e-6 and np.isfinite(lg).all()
            if not rescale:
                assert not got[1].any(), "f64 shifts must stay 0"
            folded[name, rescale] = lg
            if name == "main":
                # padding invariance: pair 7 alone in a bucket of its own
                solo = tph._pack_bucket([7], reads, errs, haps, r_pad,
                                        h_pad, dtype)
                ts = [torch.from_numpy(a).to(dev) for a in (*solo, trans)]
                one = pk.forward_bucket(*ts, rescale=rescale)
                assert torch.equal(one[0][0], got[0][7]) and \
                    torch.equal(one[1][0], got[1][7]), \
                    "a pair alone differs from the same pair in its bucket"
                ms = cuda_median_ms(
                    lambda: pk.forward_bucket(*t, rescale=rescale))
                plain_ms = cuda_median_ms(
                    lambda: pk.forward_bucket_plain(*t, rescale=rescale),
                    reps=3)
                out[np.dtype(dtype).name] = {"ms": ms, "plain_ms": plain_ms}
        log(f"pairhmm kernel {name}: {len(reads)} pairs, r1 {r_pad + 1} "
            f"(R, strips: {pk.launch_geometry(r_pad + 1)}), h_pad {h_pad}: "
            f"contribs and shifts bitwise equal to the plain version in f32 "
            f"and f64")

    # every compiled R and its edges, the strip edge, and the adoption
    # trap: packed arrays straight to the kernel, bitwise
    grng = np.random.default_rng(32)
    geometry = {f"r1={r1}": lambda dtype, r1=r1: ph_packed(
        grng, 16, r1, 120, dtype, qual=40 if r1 % 2 else None,
        junk=bool(r1 % 2)) for r1 in PH_GEOMETRY_R1}
    geometry["trap"] = lambda dtype: ph_trap_bucket(grng, 64, PH_READ,
                                                    PH_HAP, dtype)
    for name, make in geometry.items():
        for dtype in (np.float32, np.float64):
            rescale = dtype == np.float32
            packed = make(dtype)
            trans = tph.transition_probs().astype(dtype)
            t = [torch.from_numpy(a).to(dev) for a in (*packed, trans)]
            got = pk.forward_bucket(*t, rescale=rescale)
            want = pk.forward_bucket_plain(*t, rescale=rescale)
            torch.cuda.synchronize()
            err = (got[0].double() - want[0].double()).abs().max().item()
            max_err = max(max_err, err)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(
                    f"pairhmm kernel ({name}, {np.dtype(dtype).name}): "
                    f"differs from the plain version (contribs max abs "
                    f"err {err}, shifts equal "
                    f"{torch.equal(got[1], want[1])})")
    log("pairhmm kernel geometry cases, (R, strips) by r1: " + ", ".join(
        f"{r1} {pk.launch_geometry(r1)}" for r1 in PH_GEOMETRY_R1)
        + "; and the adoption trap (64 pairs, 150 x 416): contribs and "
        "shifts bitwise equal to the plain version in f32 and f64")

    # padding invariance at bucket 32 vs bucket 128: each pair's kernel
    # outputs over its live steps bitwise; the host fold's np.sum runs
    # over the padded step count, whose pairwise order can move the last
    # bit, so the folded values are held within 1e-12
    sel = [(cases["main"], i) for i in range(min(480, PH_B))] + [
        (cases[n], i) for n in ("read>hap", "1-base", "q93", "junk300")
        for i in range(len(cases[n][0]))]
    reads = [c[0][i] for c, i in sel]
    quals = [c[1][i] for c, i in sel]
    haps = [c[2][i] for c, i in sel]
    errs = [tph.phred_to_err(q) for q in quals]
    trans = tph.transition_probs().astype(np.float32)
    per_bucket = []
    for bucket in (32, 128):
        outs = {}
        for (rp, hp), idxs in tph.bucket_pairs(reads, haps,
                                               bucket).items():
            packed = tph._pack_bucket(idxs, reads, errs, haps, rp, hp,
                                      np.float32)
            c, s = tph.forward_bucket_device(packed, trans, True, dev)
            for row, n in enumerate(idxs):
                live = len(reads[n]) + len(haps[n]) + 1
                outs[n] = (c[row, :live], s[row, :live],
                           tph._fold_contribs(c[row:row + 1],
                                              s[row:row + 1])[0])
        per_bucket.append(outs)
    fold_ulps = 0
    for n in range(len(reads)):
        (c32, s32, f32), (c128, s128, f128) = (o[n] for o in per_bucket)
        assert np.array_equal(c32, c128) and np.array_equal(s32, s128), \
            f"pair {n}: kernel outputs differ at bucket 32 and 128"
        assert abs(f32 - f128) <= 1e-12, (n, f32, f128)
        fold_ulps += int(f32 != f128)
    log(f"pairhmm padding invariance on the card: a pair alone = in its "
        f"bucket (f32, f64); {len(reads)} pairs' kernel outputs bitwise "
        f"equal at bucket 32 and bucket 128 ({fold_ulps} folded values "
        f"differ in the last bits through the host fold's summation "
        f"order, all within 1e-12)")

    # the log-space oracle (the test suite's, cell by cell) on 8 main
    # pairs + 2 of each edge case; the row oracle, checked against it,
    # on the long bucket
    worst = {True: 0.0, False: 0.0}
    oracle_want, long_want = oracle.get()
    for (name, i), want in oracle_want.items():
        if name == "junk300":
            assert want < -100, f"the junk read's log10 is {want}"
        for rescale in (True, False):
            worst[rescale] = max(worst[rescale],
                                 abs(folded[name, rescale][i] - want))
    assert worst[True] < 1e-4 and worst[False] < 1e-9, worst
    reads = cases["long1100"][0]
    long_err = {True: 0.0, False: 0.0}
    for i, want in enumerate(long_want):
        for rescale in (True, False):
            long_err[rescale] = max(long_err[rescale], abs(
                folded["long1100", rescale][i] - want))
    assert long_err[True] < 1e-4 and long_err[False] < 1e-9, long_err
    log(f"pairhmm vs the log-space oracle: 16 pairs max |err| "
        f"{worst[True]:.3e} (f32) / {worst[False]:.3e} (f64); "
        f"{len(reads)} pairs of 1,100 bp: {long_err[True]:.3e} / "
        f"{long_err[False]:.3e}")

    # times and bound of the main bucket
    reads, quals, haps = cases["main"]
    cells = sum(len(r) * len(h) for r, h in zip(reads, haps))
    r1, h_pad = tph._pad_up(PH_READ) + 1, tph._pad_up(PH_HAP)
    # cells the kernel sweeps: 32 R row slots a pair x r1 + hap diagonals
    row_slots = PH_B * pk.LANES * pk.launch_geometry(r1)[0] * (r1 + h_pad)
    bytes_moved = PH_B * (r1 * 9 + h_pad + 8 + (r1 + h_pad) * 8) + 20
    res = {"cells": cells, "row_slots": row_slots, "bytes": bytes_moved,
           "ops_per_cell": pk.OPS_PER_CELL, "max_abs_err": max_err,
           "oracle_err_f32": worst[True], "oracle_err_f64": worst[False],
           "geometry": {n: pk.launch_geometry(n)
                        for n in (r1, tph._pad_up(PH_LONG[0]) + 1)},
           "resources": resources}
    for name, rate in (("float32", F32_OPS_PER_S),
                       ("float64", F64_OPS_PER_S)):
        t_ops = pk.OPS_PER_CELL[name] * cells / rate * 1e3
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        m = out[name]
        m.update(bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 gcups=cells / m["ms"] / 1e6,
                 gcups_row_slots=row_slots / m["ms"] / 1e6)
        res[name] = m
        log(f"pairhmm kernel {name}, {PH_B} pairs of {PH_READ} x {PH_HAP}: "
            f"median {m['ms']:.4f} ms kernel, {m['plain_ms']:.4f} ms "
            f"plain; {m['gcups']:.2f} GCUPS over {cells} useful cells, "
            f"{m['gcups_row_slots']:.2f} over {row_slots} row slots swept; "
            f"bound {m['bound_ms']:.4f} ms ({m['bound_by']}: "
            f"{pk.OPS_PER_CELL[name]} ops/cell at {rate:.3g}/s; "
            f"{bytes_moved} bytes at {HBM_BYTES_PER_S:.3g}/s); "
            f"library: none")
    return res


def fabricate_windows(rng, n_windows: int, n_reads: int) -> dict:
    """A goleft-tpu.pairhmm-windows/1 document: per window 4 haplotypes
    of 350-452 bp (ref, a SNP, a 2 bp insertion, a 3 bp deletion) and
    ``n_reads`` 150 bp reads drawn from a diploid genotype of ref and one
    alt, with base errors at their qualities (85% q25-41, 15% q2-24) and
    phred+33 quality strings."""
    windows = []
    for w in range(n_windows):
        L = int(rng.integers(350, 451))
        ref = rng.integers(0, 4, L).astype(np.uint8)
        v = int(rng.integers(L // 3, 2 * L // 3))
        snp = ref.copy()
        snp[v] = (ref[v] + rng.integers(1, 4)) % 4
        ins = np.concatenate([ref[:v], rng.integers(0, 4, 2), ref[v:]])
        dele = np.concatenate([ref[:v], ref[v + 3:]])
        haps = [ref, snp, ins.astype(np.uint8), dele]
        alt = int(rng.integers(1, 4))
        gt = [(0, 0), (0, alt), (alt, alt)][int(rng.integers(3))]
        reads = []
        for k in range(n_reads):
            q = np.where(rng.random(PH_READ) < 0.85,
                         rng.integers(25, 42, PH_READ),
                         rng.integers(2, 25, PH_READ))
            r = ph_read(rng, haps[gt[k % 2]], PH_READ, q, indels=False)
            reads.append({"seq": _CODES[r].tobytes().decode(),
                          "quals": (q + 33).astype(np.uint8).tobytes()
                          .decode()})
        start = 100_000 * (w % 250)
        windows.append({"chrom": f"chr{1 + w // 250}", "start": start,
                        "end": start + L,
                        "haplotypes": [_CODES[h].tobytes().decode()
                                       for h in haps],
                        "reads": reads})
    return {"schema": "goleft-tpu.pairhmm-windows/1", "windows": windows}


def _write_candidates_bed(path: str, windows) -> None:
    with open(path, "w") as fh:
        fh.write("#goleft-tpu-candidates=1 source=chip_smoke\n")
        fh.write("#chrom\tstart\tend\tsample\tCN\tlog2FC\n")
        for w in windows:
            fh.write(f"{w['chrom']}\t{w['start']}\t{w['end']}\tsmoke\t1\t"
                     "-1.0000\n")


def _run_cli(root: str, args: list[str], env: dict):
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "goleft_tpu_torch", *args],
                       cwd=root, env=env, capture_output=True, text=True)
    return r, time.perf_counter() - t0


#: the runs that only check outputs (faults, kills and resumes, traces,
#: second engines) go on in these threads beside their phase's other
#: work; the runs whose seconds are the phase's measurements run alone.
#: Each phase waits for its own before it returns.
_BG = ThreadPoolExecutor(6, thread_name_prefix="chip-smoke-bg")


def read_manifest(path: str, prog: str):
    """A CLI run's ``--metrics-out`` run manifest, validated
    (obs/manifest.py) → (manifest, the command's seconds: its
    ``run.<prog>`` span, {stage: seconds} of the other spans)."""
    from goleft_tpu_torch.obs.manifest import load_manifest

    rep = load_manifest(path)
    spans = {k: v["seconds"] for k, v in rep["spans"].items()}
    return rep, spans.pop(f"run.{prog}"), spans


def pairhmm_window_oracles(windows) -> list:
    """(genotype, GQ, PLs) of each window from the f64 row oracle; a
    window is (read codes (n, R), their errors, [haplotype codes])."""
    out = []
    for reads, errs, haps in windows:
        ll = np.stack([oracle_log10_rows(reads, errs, h) for h in haps],
                      axis=1)
        out.append(oracle_genotype(ll))
    return out


def pairhmm_e2e_phase(root: str, workdir: str, pool):
    """``python -m goleft_tpu_torch pairhmm`` at full width in a fresh
    process: 80 windows x 4 haplotypes x 80 reads of 150 bp, ~80% of
    them selected by a candidates BED; table rows, launch count; then a
    permanent fault quarantines and the run exits 3 → (results, check):
    ``check()`` holds a 20-window subset against the oracle, which runs
    in a worker process of ``pool`` beside the phases after this one."""
    rng = np.random.default_rng(80)
    t0 = time.perf_counter()
    doc = fabricate_windows(rng, PH_WINDOWS, PH_WINDOW_READS)
    wpath = os.path.join(workdir, "windows.json")
    with open(wpath, "w") as fh:
        json.dump(doc, fh)
    keep = rng.random(PH_WINDOWS) < 0.8
    kept = [w for w, k in zip(doc["windows"], keep) if k]
    cpath = os.path.join(workdir, "candidates.bed")
    _write_candidates_bed(cpath, kept)
    n_pairs = sum(len(w["reads"]) * len(w["haplotypes"]) for w in kept)
    cells = sum(len(r["seq"]) * len(h) for w in kept for r in w["reads"]
                for h in w["haplotypes"])
    log(f"fabricated {PH_WINDOWS} windows ({len(kept)} selected: "
        f"{n_pairs} pairs, {cells} cells) in "
        f"{time.perf_counter() - t0:.1f} s")

    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GOLEFT_TPU_FAULTS", None)
    report = os.path.join(workdir, "pairhmm_report.json")
    table = os.path.join(workdir, "table.tsv")
    r, wall = _run_cli(root, ["--metrics-out", report, "pairhmm",
                              "--candidates", cpath, "--out", table, wpath],
                       env)
    if r.returncode != 0:
        raise AssertionError(f"pairhmm CLI failed ({r.returncode}):\n"
                             f"{r.stderr[-4000:]}")
    rep, cmd_s, stages = read_manifest(report, "pairhmm")
    launches = rep["kernel_launches"]["pairhmm"]
    counters = rep["metrics"]["counters"]
    buckets = counters["pairhmm.buckets_total"]
    assert launches >= 1 and launches == buckets, (launches, buckets)
    assert counters["pairhmm.pairs_total"] == n_pairs
    with open(table) as fh:
        rows = fh.read().splitlines()
    assert rows[0].startswith("#chrom\tstart\tend"), rows[0]
    assert len(rows) - 1 == len(kept), (len(rows) - 1, len(kept))
    by_key = {(t[0], int(t[1])): t for t in (x.split("\t")
                                             for x in rows[1:])}

    # degraded run, beside the oracle subset: every bucket fails
    # permanently → quarantine, exit 3
    small = dict(doc, windows=[dict(w, reads=w["reads"][:10])
                               for w in doc["windows"][:5]])
    spath = os.path.join(workdir, "small.json")
    with open(spath, "w") as fh:
        json.dump(small, fh)
    qpath = os.path.join(workdir, "quarantine.json")
    freport = os.path.join(workdir, "fault_report.json")
    fault = _BG.submit(_run_cli, root, [
        "--metrics-out", freport, "pairhmm", "--quarantine-out", qpath,
        "--out", os.path.join(workdir, "fault.tsv"), spath],
        dict(env, GOLEFT_TPU_FAULTS=PH_FAULT_SPEC))

    from goleft_tpu_torch.ops.pairhmm import encode_seq, phred_to_err

    t_oracle = time.perf_counter()
    picked = [kept[wi] for wi in np.linspace(
        0, len(kept) - 1, PH_ORACLE_WINDOWS).astype(int)]
    oracle = pool.apply_async(pairhmm_window_oracles, ([(
        np.stack([encode_seq(x["seq"]) for x in w["reads"]]),
        np.stack([phred_to_err(np.frombuffer(
            x["quals"].encode(), np.uint8).astype(np.int64) - 33)
            for x in w["reads"]]),
        [encode_seq(h) for h in w["haplotypes"]]) for w in picked],))

    def check() -> int:
        t0 = time.perf_counter()
        worst_pl = 0
        for w, (gt, gq, pl) in zip(picked, oracle.get()):
            row = by_key[w["chrom"], w["start"]]
            got_pl = [int(x) for x in row[7].split(",")]
            worst_pl = max(worst_pl, max(abs(a - b)
                                         for a, b in zip(got_pl, pl)))
            if row[5] != gt or int(row[6]) != gq \
                    or len(got_pl) != len(pl) or worst_pl > 1:
                raise AssertionError(
                    f"window {w['chrom']}:{w['start']}: port {row[5:]} vs "
                    f"oracle {gt} {gq} {pl}")
        log(f"pairhmm oracle subset: {PH_ORACLE_WINDOWS} windows, genotype "
            f"and GQ equal, PL max |diff| {worst_pl} (in a worker process "
            f"beside phases 7-13; waited {time.perf_counter() - t0:.1f} s "
            f"of {time.perf_counter() - t_oracle:.1f})")
        return worst_pl

    rest = cmd_s - rep["import_seconds"] - sum(stages.values())
    log(f"pairhmm CLI: {len(kept)} windows, {n_pairs} pairs, {cells} cells; "
        f"process wall {wall:.3f} s, command {cmd_s:.3f} s, import "
        f"{rep['import_seconds']:.3f} s; {n_pairs / cmd_s:.1f} pairs/s, "
        f"{cells / cmd_s / 1e9:.4f} GCUPS end to end; kernel launches "
        f"{launches} = {buckets} length buckets; stage seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items()))
        + f", unattributed {rest:.3f}")

    r, _ = fault.result()
    assert r.returncode == 3, (r.returncode, r.stderr[-2000:])
    with open(qpath) as fh:
        q = json.load(fh)["quarantined"]
    assert len(q) == 5 and all(e["phase"] == "pairhmm" for e in q), q
    with open(os.path.join(workdir, "fault.tsv")) as fh:
        assert fh.read().count("\n") == 1
    frep = read_manifest(freport, "pairhmm")[0]
    assert frep["exit_code"] == 3
    assert frep["metrics"]["counters"]["pairhmm.buckets_failed_total"] >= 1
    log(f"pairhmm with {PH_FAULT_SPEC}: exit 3, {len(q)} windows "
        "quarantined, manifest written")
    return {"wall_s": wall, "command_s": cmd_s,
            "import_s": rep["import_seconds"], "windows": len(kept),
            "pairs": n_pairs, "cells": cells,
            "pairs_per_s": n_pairs / cmd_s, "gcups": cells / cmd_s / 1e9,
            "unattributed_s": rest,
            "launches": launches, "stage_seconds": stages,
            "fixture": {"windows": wpath, "candidates": cpath,
                        "table": table}}, check

# ---- rANS-Nx16 and cohortdepth phases --------------------------------

RANS_SIZES = [0, 1, 3, 17, 63, 64, 65, 127, 4095, 4097, 8191, 20000]
RANS_STRIPE_SIZES = (20000, 19999, 19998, 4097, 101, 7)
RANS_O1_SHIFTS = (10, 7)
# the dependent chain of one N = 4 round of csrc/rans_kernel.cu, in SM
# cycles (assumed from its instructions, see PERF.md §6). ORDER0: the next
# slot's address (mask, shift-add, ~8), the 64-bit shared slot load (~30),
# the frequency mask and the multiply-add (~9), the compare and the rank
# adds (~9), the word permute, the merge permute and the select (~12).
# ORDER1: the entry's address from the previous entry and the slot (~12),
# the 64-bit entry load (~30), the bounds' extraction and the step check
# (~12), the multiply-add (~9), then as ORDER0 (~21). STRIPE lanes are
# ORDER0.
RANS_CYCLES_PER_ROUND = {"ORDER0": 68, "ORDER1": 84, "STRIPE4": 68}
CO_SAMPLES, CO_LEN, CO_READS = 4, 2_000_000, 50_000
CO_RPC, CO_WINDOW = 10_000, 500
# (rANS order, stripe lanes) per sample, as the JAX package's
# ops/decode_smoke.py::make_cram_cohort (ORDER0, ORDER0, ORDER1, STRIPE 4)
# with its second sample ORDER1 too: the sample threads then launch
# ORDER1 groups of different table sizes at once
CO_CODECS = [(0, 0), (1, 0), (1, 0), (0, 4)]
CO_FAULT = "decode:after=1:transient"


def rans_flag_matrix(rng):
    """(data, stream) cases: N = 4 and X32 x ORDER0 and ORDER1 x plain,
    RLE, PACK and RLE+PACK at tests/test_rans_device.py's sizes, ORDER1
    at shifts 10 and 7 and with 256 contexts, and STRIPE with uneven lanes
    (ORDER0, X32 and ORDER1 lanes)."""
    from goleft_tpu_torch.io import rans_nx16 as rx

    ramp = (np.cumsum(rng.choice([0, 0, 0, 1, 2, 5], 20000)) % 120) \
        .astype(np.uint8)
    cases = []
    for x32 in (False, True):
        for order in (0, 1):
            for rle, pack in ((False, False), (True, False), (False, True),
                              (True, True)):
                for sz in RANS_SIZES:
                    if order:
                        d = ramp[:sz] % 11 if pack else ramp[:sz]
                    else:
                        a = 7 if pack else int(rng.integers(2, 48))
                        d = rng.integers(0, a, sz).astype(np.uint8)
                    d = d.tobytes()
                    cases.append((d, rx.encode(d, order=order, use_rle=rle,
                                               use_pack=pack, x32=x32)))
        for shift in RANS_O1_SHIFTS:
            for sz in RANS_SIZES[-4:]:
                d = ramp[:sz].tobytes()
                cases.append((d, rx.encode(d, order=1, x32=x32,
                                           shift=shift)))
    # 256 contexts: the widest ORDER1 table
    wide = (np.cumsum(rng.choice([0, 1, 2, 3, 255], RANS_SIZES[-1])) % 256) \
        .astype(np.uint8).tobytes()
    for x32 in (False, True):
        cases.append((wide, rx.encode(wide, order=1, x32=x32)))
        assert cases[-1][1][0] & rx.F_ORDER1
    for sz in RANS_STRIPE_SIZES:
        for kw in (dict(stripe=4), dict(stripe=3), dict(stripe=4, x32=True),
                   dict(stripe=2, order=1)):
            d = ramp[:sz].tobytes()
            cases.append((d, rx.encode(d, **kw)))
    assert sum(bool(e[0] & rx.F_ORDER1) for _, e in cases) > 20
    return cases


def rans_groups(plans, dev):
    """The launch groups of ops/rans_device.py (rans_device.launch_groups)
    with their tensors on ``dev``: [(key, streams, tensors)]."""
    import torch

    from goleft_tpu_torch.ops import rans_device as rd

    return [(key, grp, {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                        for k, v in host.items()})
            for key, grp, host in rd.launch_groups(plans)]


def rans_abs_err(got, want) -> int:
    """Largest |kernel - plain| over the symbols and, for ORDER1, the
    missing-context flags of one group."""
    err = int((got[0].cpu().int() - want[0].cpu().int()).abs().max())
    if got[1] is not None:
        err = max(err, int((got[1].cpu() - want[1].cpu()).abs().max()))
    return err


def rans_bitwise(groups, what: str, wants=None) -> tuple:
    """Kernel vs plain version on every group, bitwise: the plain version
    runs on the card, or ``wants`` holds its results from the host CPU
    (:func:`rans_plain_on_host`). Returns (groups held, max abs err)."""
    from goleft_tpu_torch.ops import rans_device as rd
    from goleft_tpu_torch.ops import rans_kernel as rk

    err = 0
    for i, (key, grp, t) in enumerate(groups):
        got = rd.group_stage(key, grp, t)
        want = wants[i] if wants is not None else rd.group_stage(
            key, grp, t, rk.rans_decode_plain)
        e = rans_abs_err(got, want)
        if e:
            raise AssertionError(
                f"rans kernel ({what}, group {key}): differs from the "
                f"plain version (max abs err {e})")
        err = max(err, e)
    return len(groups), err


def rans_plain_on_host(groups) -> tuple:
    """The plain version of every launch group, on host-CPU copies of its
    inputs; run in a worker process, so the three real containers'
    comparisons (minutes each: a Python loop over 375,000 rounds) run at
    once. Returns ([(symbols, flags)], seconds)."""
    import torch

    from goleft_tpu_torch.ops import rans_device as rd
    from goleft_tpu_torch.ops import rans_kernel as rk

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = [rd.group_stage(key, grp, t, rk.rans_decode_plain)
           for key, grp, t in groups]
    return out, time.perf_counter() - t0


def rans_threads_check(dev) -> tuple:
    """Eight threads, each on its own CUDA stream as the cohort's sample
    threads are, launch ORDER1 groups of seven table sizes (2 to 256
    contexts: 4 KB to 199 KB of dynamic shared memory) at once, 42 each;
    every launch against the plain version on the host CPU. Returns
    (launches, max abs err)."""
    import torch

    from goleft_tpu_torch.io import rans_nx16 as rx
    from goleft_tpu_torch.ops import rans_device as rd
    from goleft_tpu_torch.ops import rans_kernel as rk

    rng = np.random.default_rng(61)
    ramp = np.cumsum(rng.choice([0, 1, 2, 3, 255], 6000)) % 256
    groups = []
    for a in (2, 3, 13, 39, 77, 150, 256):
        d = (ramp % a).astype(np.uint8).tobytes()
        p = rx.parse_nx16(rx.encode(d, order=1), len(d))
        assert p.order1 and p.n_ctx == a, (a, p.n_ctx)
        (key, grp, t), = rans_groups([p], dev)
        want = rd.group_stage(key, grp, {k: v.cpu() for k, v in t.items()},
                              rk.rans_decode_plain)
        groups.append((key, grp, t, want))
    torch.cuda.synchronize()

    def work(i):
        # launches queued back to back, one wait at the end: the threads'
        # launches then overlap on the host
        s = torch.cuda.Stream(dev)
        with torch.cuda.stream(s):
            order = [(i + r) % len(groups) for r in range(42)]
            outs = [rd.group_stage(*groups[g][:3]) for g in order]
        s.synchronize()
        return max(rans_abs_err(got, groups[g][3])
                   for g, got in zip(order, outs))

    with ThreadPoolExecutor(8) as pool:
        err = max(pool.map(work, range(8)))
    if err:
        raise AssertionError("rans kernel: ORDER1 launches from eight "
                             "threads differ from the plain version "
                             f"(max abs err {err})")
    return 8 * 42, err


class BlockRecorder:
    """A CRAM block decoder that keeps the raw blocks it is handed and
    decodes them on the host (io/cram.py's codecs)."""

    def __init__(self):
        self.raws = []

    def decode_blocks(self, raws):
        from goleft_tpu_torch.io.cram import decode_raw_block

        self.raws.append(list(raws))
        return [decode_raw_block(rb).data for rb in raws]


def first_container_blocks(path: str):
    """The raw blocks of a CRAM file's first container (the one its
    .crai lists first)."""
    from goleft_tpu_torch.io.crai import load_crai_entries
    from goleft_tpu_torch.io.cram import CramFile

    start = load_crai_entries(path + ".crai")[0][1]  # 1-based
    cf = CramFile.from_file(path)
    rec = BlockRecorder()
    cf.set_block_decoder(rec)
    cf.read_columns(tid=0, start=start - 1, end=start)
    return rec.raws[0]


def sm_clock_hz() -> float:
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=30)
    return float(r.stdout.strip().splitlines()[0]) * 1e6


def _host_copies(groups) -> list:
    """Launch groups with their tensors copied to the host CPU, for
    :func:`rans_plain_on_host` in a worker process."""
    return [(key, grp, {n: v.cpu() for n, v in t.items()})
            for key, grp, t in groups]


def rans_kernel_checks(dev, pool) -> tuple:
    """The rANS kernel on the flag matrix and on eight threads' ORDER1
    launches, bitwise against its plain version; the device decode
    against the data; a missing ORDER1 context must raise → (the max abs
    error so far, the flag matrix's (groups, future of their plain
    version)): the plain version of the flag matrix runs in one of
    ``pool``'s worker processes on the host CPU (on the card each of its
    rounds is a few dozen small launches, ~20 s), and the caller holds
    the groups against it once it is done."""
    from goleft_tpu_torch.io import rans_nx16 as rx
    from goleft_tpu_torch.ops import rans_device as rd
    from goleft_tpu_torch.ops import rans_kernel as rk

    rng = np.random.default_rng(57)
    t0 = time.perf_counter()
    cases = rans_flag_matrix(rng)
    plans = [rx.parse_nx16(e, len(d)) for d, e in cases]
    assert all(p is not None for p in plans)
    flag_groups = rans_groups(plans, dev)
    flag_plain = pool.apply_async(rans_plain_on_host,
                                  (_host_copies(flag_groups),))
    got = rd.decode_parsed(plans, device=dev)
    bad = [i for i, ((d, _), g) in enumerate(zip(cases, got)) if g != d]
    assert not bad, f"device decode differs from the data in cases {bad}"
    coded = sum(not (c.cat or c.stripe) for c in plans) + sum(
        not ch.cat for c in plans if c.stripe for ch in c.children)
    log(f"rans kernel flag matrix: {len(cases)} streams ({coded} rANS "
        f"streams and lanes, the rest CAT) in {len(flag_groups)} launch "
        f"groups, their plain version started on the host CPU; device "
        f"decode (kernel, RLE/PACK expansions, STRIPE interleave) equals "
        f"the data ({time.perf_counter() - t0:.1f} s)")
    max_err = 0

    # a context row knocked out: the kernel's diagnostic, as the plain
    # version's, and the JAX package's error
    d, e = max(((d, e) for d, e in cases if e[0] & rx.F_ORDER1),
               key=lambda c: len(c[0]))
    p = rx.parse_nx16(e, len(d))
    used = np.flatnonzero(p.ctx_index >= 0)
    p.ctx_index = p.ctx_index.copy()
    p.ctx_index[used[len(used) // 2]] = -1
    (key, grp, t), = rans_groups([p], dev)
    kb = rd.group_stage(key, grp, t)[1]
    pb = rd.group_stage(key, grp, {n: v.cpu() for n, v in t.items()},
                        rk.rans_decode_plain)[1]
    assert int(kb[0]) == int(pb[0]) == 1, (kb, pb)
    try:
        rd.decode_parsed([p], device=dev)
    except ValueError as e:
        assert "missing order-1 context" in str(e), e
    else:
        raise AssertionError("a missing ORDER1 context did not raise")
    log("rans kernel: a missing ORDER1 context sets the kernel's "
        "diagnostic and raises 'rans-nx16: missing order-1 context'")
    t0 = time.perf_counter()
    n, err = rans_threads_check(dev)
    max_err = max(max_err, err)
    log(f"rans kernel: {n} ORDER1 launches of 2 to 256 contexts from eight "
        "threads on their own streams, at once, bitwise equal to the plain "
        f"version ({time.perf_counter() - t0:.1f} s)")
    return max_err, (flag_groups, flag_plain)


def rans_kernel_phase(dev, crams, pool) -> tuple:
    """The rANS kernel against its plain version, bitwise, on the flag
    matrix (rans_kernel_checks) and on one real 10,000-record container
    of each codec of the cohort; the device decode (kernel + expansions +
    interleave) against the data and the host decoder; times and bounds
    of each container. The containers' plain versions run in ``pool``'s
    worker processes while later phases go on → (results, finish):
    ``finish()`` waits for them, holds every group bitwise against them
    and adds the plain times and the max abs error to the results."""
    import torch

    from goleft_tpu_torch.io import rans_nx16 as rx
    from goleft_tpu_torch.io.cram import M_RANSNX16
    from goleft_tpu_torch.ops import rans_device as rd
    from goleft_tpu_torch.ops import rans_kernel as rk

    out = {}
    clock = sm_clock_hz()
    # every group of each container against the plain version, run once
    # on the host CPU (on the card each of its rounds is a few dozen small
    # launches, minutes at 375,000 rounds), the three containers and the
    # flag matrix at once in worker processes, started first (the ORDER1
    # container takes longest, about 100 s) while the card runs the
    # checks, times the kernel and goes on to the cohort phases
    pending = []
    containers = []
    for k, label in ((0, "ORDER0"), (2, "ORDER1"), (3, "STRIPE4")):
        raws = [rb for rb in first_container_blocks(crams[k])
                if rb.method == M_RANSNX16]
        cplans = [rx.parse_nx16(rb.raw, rb.rsize) for rb in raws]
        assert all(p is not None for p in cplans), label
        groups = rans_groups(cplans, dev)
        fut = pool.apply_async(rans_plain_on_host, (_host_copies(groups),))
        containers.append((label, raws, cplans, groups, fut))
    max_err, (flag_groups, flag_plain) = rans_kernel_checks(dev, pool)
    for label, raws, cplans, groups, fut in containers:
        t0 = time.perf_counter()
        dec = rd.decode_parsed(cplans, device=dev)
        for rb, g in zip(raws, dec):
            if g != rx.decode(rb.raw, rb.rsize):
                raise AssertionError(f"{label} container: block "
                                     f"{rb.content_id} differs from the "
                                     "host decoder")
        check_s = time.perf_counter() - t0

        def launch_all():
            for key, grp, t in groups:
                rd.group_stage(key, grp, t)

        ms = cuda_median_ms(launch_all, reps=5)
        flat = [c for p in cplans
                for c in (p.children if p.stripe else [p]) if not c.cat]

        def rounds_of(c):
            return rk.rounds_needed(torch.tensor([c.inner_len]),
                                    c.n_states, c.order1)

        longest = max(flat, key=rounds_of)
        rounds = rounds_of(longest)
        # the longest stream alone: its rounds without the container's
        # other launches queued before or after it on the stream
        (lkey, lgrp, lt), = rans_groups([longest], dev)
        lone_ms = cuda_median_ms(lambda: rd.group_stage(lkey, lgrp, lt),
                                 reps=5)
        nbytes = sum(c.payload_bytes + c.table_bytes + c.inner_len
                     for c in flat)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 16 * sum(c.inner_len for c in flat) / INT_OPS_PER_S * 1e3
        cyc = RANS_CYCLES_PER_ROUND[label]
        res = {"ms": ms, "launches_per_container": len(groups),
               "group_keys": [list(k) for k, _, _ in groups],
               "streams": len(flat), "longest_rounds": rounds,
               "cycles_per_round": ms * 1e-3 * clock / rounds,
               "longest_stream_ms": lone_ms,
               "longest_stream_cycles_per_round":
                   lone_ms * 1e-3 * clock / rounds,
               "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "chain_cycles_per_round": cyc,
               "chain_bound_ms": rounds * cyc / clock * 1e3,
               "sm_clock_hz": clock,
               "qs_bytes": max(rb.rsize for rb in raws)}
        out[label] = res
        pending.append((label, groups, fut, len(raws), len(flat),
                        check_s))
    out["max_abs_err"] = max_err

    def finish():
        wants, plain_s = flag_plain.get()
        held, err = rans_bitwise(flag_groups, "flag matrix", wants)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        log(f"rans kernel flag matrix: {held} launch groups bitwise equal "
            f"to the plain version on the host CPU ({plain_s:.1f} s in a "
            "worker process)")
        for label, groups, fut, n_raws, n_flat, check_s in pending:
            wants, plain_s = fut.get()
            _, err = rans_bitwise(groups, f"{label} container", wants)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            res = out[label]
            rounds, cyc = res["longest_rounds"], res["chain_cycles_per_round"]
            res["plain_ms"] = plain_s * 1e3
            res["plain_us_per_round"] = plain_s * 1e6 / rounds
            log(f"rans kernel, {label} container of {CO_RPC} records: "
                f"{n_raws} rANS blocks = {n_flat} streams in "
                f"{len(groups)} launches {res['group_keys']}, longest "
                f"{rounds} rounds; decode equals the host decoder "
                f"({check_s:.1f} s with the check); kernel median "
                f"{res['ms']:.3f} ms per container = "
                f"{res['cycles_per_round']:.1f} cycles a round at "
                f"{clock / 1e6:.0f} MHz (the longest stream alone "
                f"{res['longest_stream_ms']:.3f} ms = "
                f"{res['longest_stream_cycles_per_round']:.1f} cycles a "
                f"round), every group bitwise equal to the plain version on "
                f"the host CPU ({res['plain_ms']:.1f} ms, in a worker "
                f"process); bound {res['bound_ms']:.4f} ms "
                f"({res['bound_by']}: {res['bytes']} bytes), dependence "
                f"chain {res['chain_bound_ms']:.3f} ms ({rounds} rounds x "
                f"{cyc} cycles); library: none")

    return out, finish


def cohort_fabricate(workdir: str, rng, n_reads=CO_READS, contig_len=CO_LEN,
                     rpc=CO_RPC):
    """The cohort: per sample ``n_reads`` 150 bp reads with quality
    strings (3% MAPQ 0, 2% duplicates), written by tools/bulk_cram.py with
    the sample's codec; a .fai. → (paths, fai, names, truth)."""
    from tools.bulk_cram import write_cram_files

    files, truth = [], []
    for i, (order, stripe) in enumerate(CO_CODECS):
        pos = np.sort(rng.integers(0, contig_len - READ_LEN, n_reads))
        mapq = np.where(rng.random(n_reads) < 0.03, 0, 60)
        flag = np.where(rng.random(n_reads) < 0.02, 0x400, 0)
        drift = np.arange(READ_LEN) // 10
        quals = (np.clip(rng.normal(38, 4, (n_reads, READ_LEN)) - drift, 2, 41)
                 + 33).astype(np.uint8)
        files.append(dict(path=os.path.join(workdir, f"co{i}.cram"),
                          contig="chr1", contig_len=contig_len,
                          sample=f"co{i}", pos=pos, mapq=mapq, flag=flag,
                          quals=quals, order=order, stripe=stripe))
        truth.append((pos, mapq, flag))
    write_cram_files(files, records_per_container=rpc, read_len=READ_LEN)
    fai = os.path.join(workdir, "co.fa.fai")
    with open(fai, "w") as fh:
        fh.write(f"chr1\t{contig_len}\t6\t60\t61\n")
    return [f["path"] for f in files], fai, [f["sample"] for f in files], \
        truth


def cohort_oracle(truth, names, contig_len=CO_LEN,
                  window=CO_WINDOW) -> str:
    """The matrix from the generated reads: kept reads (MAPQ >= 1, no
    0x704 flag) → per-base depth by bincount + cumsum → window sums →
    round-half-up means."""
    cols = []
    for pos, mapq, flag in truth:
        kept = pos[(mapq >= 1) & ((flag & 0x704) == 0)]
        delta = (np.bincount(kept, minlength=contig_len + 1)
                 - np.bincount(kept + READ_LEN, minlength=contig_len + 1))
        depth = np.minimum(np.cumsum(delta[:contig_len]), 2500)
        starts = np.arange(0, contig_len, window)
        sums = np.add.reduceat(depth, starts)
        spans = np.minimum(starts + window, contig_len) - starts
        cols.append((0.5 + sums / spans).astype(np.int64))
    rows = ["#chrom\tstart\tend\t" + "\t".join(names) + "\n"]
    for k, s in enumerate(range(0, contig_len, window)):
        rows.append(f"chr1\t{s}\t{min(s + window, contig_len)}\t"
                    + "\t".join(str(c[k]) for c in cols) + "\n")
    return "".join(rows)


def cohort_launch_plan(crams, fai) -> dict:
    """The rans launches a cohortdepth run makes, counted on the host from
    the files: per shard, each container the shard's .crai lookup decodes
    (one that straddles a shard boundary is decoded once per shard); per
    container, its launch groups (rans_device.launch_groups: one per
    (ORDER1, N, shift) of its non-CAT rANS streams, stripe lanes
    flattened). → {file: {launches per container: containers
    decoded}}."""
    from collections import Counter

    from goleft_tpu_torch.commands.cohortdepth import cohort_regions
    from goleft_tpu_torch.io import rans_nx16 as rx
    from goleft_tpu_torch.io.cram import (
        M_RANSNX16, ContainerHeader, CramFile, read_block_raw,
    )
    from goleft_tpu_torch.io.fai import read_fai
    from goleft_tpu_torch.ops import rans_device as rd

    regions = cohort_regions(read_fai(fai), "", CO_WINDOW, None)
    plan = {}
    for path in crams:
        cf = CramFile.from_file(path)
        groups_at, split = {}, Counter()
        for _, s, e in regions:
            for off in cf._region_offsets(0, s, e):
                if off not in groups_at:
                    hdr, pos = ContainerHeader.parse(cf._buf, off, False)
                    end, plans = pos + hdr.length, []
                    while pos < end:
                        rb, pos = read_block_raw(cf._buf, pos)
                        if rb.method == M_RANSNX16:
                            p = rx.parse_nx16(rb.raw, rb.rsize)
                            if p is not None:
                                plans.append(p)
                    groups_at[off] = len(rd.launch_groups(plans))
                split[groups_at[off]] += 1
        plan[os.path.basename(path)] = dict(sorted(split.items()))
    return plan


def cohort_e2e_phase(root: str, workdir: str, crams, fai, want: str) -> dict:
    """``python -m goleft_tpu_torch cohortdepth --decode-device`` on the
    cohort in fresh processes: the hybrid engine (the main path), the
    device engine, and a transient fault at the decode site; every
    matrix byte-identical to the oracle; decode counters, and exactly the
    rans launches of the host's count."""
    plan = cohort_launch_plan(crams, fai)
    planned = sum(k * n for split in plan.values() for k, n in split.items())
    log(f"cohortdepth rans launch plan (file: {{launches per container: "
        f"containers decoded}}): {plan}; {planned} launches in all")
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GOLEFT_TPU_FAULTS", None)

    def run(name, extra, run_env):
        report = os.path.join(workdir, f"co_{name}.json")
        r, wall = _run_cli(root, ["--metrics-out", report, "cohortdepth",
                                  "--fai", fai, "-w", str(CO_WINDOW),
                                  "--decode-device", *extra, *crams],
                           run_env)
        if r.returncode != 0:
            raise AssertionError(f"cohortdepth ({name}) failed "
                                 f"({r.returncode}):\n{r.stderr[-4000:]}")
        _same_bytes(f"cohortdepth ({name}) matrix (against the oracle)",
                    r.stdout, want)
        rep, cmd_s, stages = read_manifest(report, "cohortdepth")
        c = rep["metrics"]["counters"]
        launches = rep["kernel_launches"]
        assert launches["rans"] == planned > 0, (launches, planned)
        assert c["decode.device_blocks_total"] > 0, c
        assert c["decode.device_fallback_total"] == 0, c
        if name == "device":
            assert launches["depth"] == CO_SAMPLES, launches
        if name == "fault":
            assert c.get("resilience.retries_total", 0) >= 1, c
        log(f"cohortdepth --decode-device ({name}): matrix byte-identical to "
            f"the oracle; process wall {wall:.3f} s, command {cmd_s:.3f} s, "
            f"import {rep['import_seconds']:.3f} s; "
            f"{CO_SAMPLES * CO_LEN / cmd_s / 1e6:.3f} Mbases/s "
            f"({CO_SAMPLES} samples x {CO_LEN} bp); launches {launches}; "
            f"device blocks {c['decode.device_blocks_total']}, fallbacks "
            f"{c['decode.device_fallback_total']}, host blocks "
            f"{c['decode.host_blocks_total']}, retries "
            f"{c.get('resilience.retries_total', 0)}; stage seconds: "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items())))
        return {"wall_s": wall, "command_s": cmd_s,
                "import_s": rep["import_seconds"],
                "stage_seconds": stages, "launches": launches,
                "counters": {k: v for k, v in c.items()
                             if k.startswith(("decode.", "prefetch.",
                                              "resilience."))},
                "bases_per_s": CO_SAMPLES * CO_LEN / cmd_s,
                "launch_plan": plan}

    # the main path alone; then the device engine and the fault together
    runs = {"hybrid": run("hybrid", [], env)}
    rest = {"device": _BG.submit(run, "device", ["--engine", "device"],
                                 env),
            "fault": _BG.submit(run, "fault", [], dict(
                env, GOLEFT_TPU_FAULTS=CO_FAULT))}
    runs.update({name: f.result() for name, f in rest.items()})
    return runs


# ---- flags phase: cache, profile, traces, kill and resume -------------

#: regions of the kill-and-resume runs: the cohort's contig cut in four
FLAG_REGIONS = 4
FLAG_KILL = "shard:after=2:kill"


def _same_bytes(what: str, got: str, want: str) -> None:
    if got != want:
        i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        lo = max(i - 80, 0)
        raise AssertionError(f"{what} differs at byte {i}: got "
                             f"{got[lo:i + 80]!r} want "
                             f"{want[lo:i + 80]!r}")


def load_trace(path: str) -> dict:
    """A ``--trace-out`` file: Chrome trace-event JSON with exactly one
    ``run.<command>`` root, every other span's parent in the file, the
    device spans fenced and of platform gpu → {"doc", "root", "spans"
    (the ph X events), "device" (the device.* events)}."""
    with open(path) as fh:
        doc = json.load(fh)
    assert isinstance(doc.get("traceEvents"), list), path
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    for e in spans:
        assert {"name", "ts", "dur", "pid", "tid", "args"} <= set(e), e
    roots = [e for e in spans if e["name"].startswith("run.")]
    assert len(roots) == 1, [e["name"] for e in roots]
    root = roots[0]
    ids = {e["args"]["span_id"] for e in spans}
    orphans = [e["name"] for e in spans if e is not root
               and e["args"].get("parent_id") not in ids]
    assert not orphans, f"spans without a parent in the trace: {orphans[:5]}"
    assert all(e["args"]["trace_id"] == root["args"]["trace_id"]
               for e in spans)
    device = [e for e in spans if e["name"].startswith("device.")]
    for e in device:
        assert e["cat"] == "device" and e["args"]["fenced"] is True, e
        assert e["args"]["platform"] == "gpu", e
    return {"doc": doc, "root": root, "spans": spans, "device": device}


def fenced_kernel_share(tr: dict) -> float:
    """The union of the fenced device.* intervals over the run span: an
    upper bound of the kernels' share of the run (a fenced span also
    holds the enqueue and the wait), not of the card's busy share: card
    work outside the launches (copies, rANS expansions) is in no span."""
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in tr["device"])
    busy, end = 0.0, -1.0
    for a, b in iv:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy / tr["root"]["dur"]


def profile_kernels(trace_dir: str) -> dict:
    """{kernel event name: count} of the CUDA kernel events in a
    ``depth --profile`` directory's Chrome trace."""
    from collections import Counter

    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    assert files, f"no Chrome trace in {trace_dir}"
    with open(os.path.join(trace_dir, files[0])) as fh:
        doc = json.load(fh)
    return dict(Counter(e["name"] for e in doc["traceEvents"]
                        if e.get("cat") == "kernel"))


def flags_phase(root: str, workdir: str, depth_fixture, pairhmm_run: dict,
                crams, fai, want: str, co_plan_launches: int,
                untraced: dict, keep_dir: str | None) -> dict:
    """The global and per-command flags through fresh processes of
    ``python -m goleft_tpu_torch`` on the fixtures of the phases before:
    ``depth --cache`` twice and ``--profile``; ``cohortdepth
    --decode-device`` and ``pairhmm`` under ``--trace-out``; a
    checkpointed cohortdepth killed by ``--inject-faults``, resumed, and
    resumed again over the complete store. The kill-and-resume chain,
    the pairhmm trace and the profile run beside the cache runs and the
    cohortdepth trace (each run's seconds are then under that load)."""
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GOLEFT_TPU_FAULTS", None)
    out: dict = {}
    bam, fa, want_d, want_c = depth_fixture
    shards = -(-E2E_LEN // SHARD)

    # started first: they go on beside the cache runs below. Kill and
    # resume: a BED that cuts the contig into FLAG_REGIONS regions
    step = CO_LEN // FLAG_REGIONS
    with open(os.path.join(workdir, "co_regions.bed"), "w") as fh:
        for lo in range(0, CO_LEN, step):
            fh.write(f"chr1\t{lo}\t{min(lo + step, CO_LEN)}\n")
    whole = _BG.submit(_flags_regions_run, root, workdir, crams, fai,
                       want, env, "uninterrupted", [])
    kill = _BG.submit(_flags_kill_resume, root, workdir, crams, fai, want,
                      env)
    ph = _BG.submit(_flags_pairhmm_trace, root, workdir, pairhmm_run,
                    untraced, keep_dir, env)
    pdir = os.path.join(workdir, "depth_profile")
    prof = _BG.submit(_run_cli, root, [
        "depth", "--profile", pdir, "--prefix",
        os.path.join(workdir, "prof"), "-r", fa, "-w", str(WINDOW), "-m",
        str(MAX_MEAN), bam], env)

    # depth --cache, twice: the second run replays every shard
    cache = os.path.join(workdir, "depth_cache")
    for run in ("cold", "warm"):
        prefix = os.path.join(workdir, f"cache_{run}")
        report = os.path.join(workdir, f"cache_{run}.json")
        r, wall = _run_cli(root, ["--metrics-out", report, "depth",
                                  "--cache", cache, "--prefix", prefix,
                                  "-r", fa, "-w", str(WINDOW), "-m",
                                  str(MAX_MEAN), bam], env)
        assert r.returncode == 0, r.stderr[-4000:]
        for path, w in ((prefix + ".depth.bed", want_d),
                        (prefix + ".callable.bed", want_c)):
            with open(path) as fh:
                _same_bytes(f"depth --cache ({run}) "
                            f"{os.path.basename(path)}", fh.read(), w)
        rep, cmd_s, _ = read_manifest(report, "depth")
        c = rep["metrics"]["counters"]
        launches = rep["kernel_launches"]["depth"]
        hits = c.get("result_cache.hits_total", 0)
        if run == "cold":
            assert launches == shards and hits == 0, (launches, c)
        else:
            assert launches == 0 and hits == shards, (launches, c)
        out[f"cache_{run}"] = {"command_s": cmd_s, "launches": launches,
                               "hits": hits}
        log(f"depth --cache ({run}): both BEDs byte-identical to the "
            f"oracle; depth launches {launches}, cache hits {hits} of "
            f"{shards} shards; command {cmd_s:.3f} s")

    # cohortdepth --decode-device --trace-out: one device.rans span a launch
    trace = os.path.join(workdir, "co_trace.json")
    report = os.path.join(workdir, "co_trace_report.json")
    r, wall = _run_cli(root, ["--trace-out", trace, "--metrics-out", report,
                              "cohortdepth", "--fai", fai, "-w",
                              str(CO_WINDOW), "--decode-device", *crams],
                       env)
    assert r.returncode == 0, r.stderr[-4000:]
    _same_bytes("cohortdepth --trace-out matrix", r.stdout, want)
    rep, cmd_s, _ = read_manifest(report, "cohortdepth")
    tr = load_trace(trace)
    assert tr["root"]["name"] == "run.cohortdepth"
    assert rep["trace_id"] == tr["root"]["args"]["trace_id"]
    n_rans = sum(e["name"] == "device.rans" for e in tr["device"])
    assert n_rans == co_plan_launches == rep["kernel_launches"]["rans"], \
        (n_rans, co_plan_launches, rep["kernel_launches"])
    share = fenced_kernel_share(tr)
    out["cohort_trace"] = {"command_s": cmd_s,
                           "untraced_command_s": untraced["cohort"],
                           "device_spans": n_rans, "fenced_kernel_share": share,
                           "spans": len(tr["spans"])}
    log(f"cohortdepth --decode-device --trace-out: matrix byte-identical; "
        f"{len(tr['spans'])} spans, {n_rans} fenced device.rans spans = "
        f"the launch plan; fenced-kernel share (union of fenced device "
        f"spans over run.cohortdepth, an upper bound of kernel time "
        f"only) {share:.4f}; "
        f"command {cmd_s:.3f} s traced against {untraced['cohort']:.3f} s "
        f"without fences (phase 9's hybrid run)")
    if keep_dir:
        shutil.copy(trace, os.path.join(keep_dir, "cohortdepth_trace.json"))

    # depth --profile: torch.profiler's trace holds the depth kernels
    r, _ = prof.result()
    assert r.returncode == 0, r.stderr[-4000:]
    kern = profile_kernels(pdir)
    for name in ("wire_starts", "depth_tiles"):
        n = sum(v for k, v in kern.items() if name in k)
        assert n == shards, (name, kern)
    out["profile_kernels"] = kern
    log(f"depth --profile: CUDA kernel events {kern}")
    out["pairhmm_trace"] = ph.result()
    runs = {"uninterrupted": whole.result(), **kill.result()}
    assert 0 < runs["killed"]["committed"] < FLAG_REGIONS * CO_SAMPLES
    assert 0 < runs["resumed"]["rans"] < runs["uninterrupted"]["rans"], runs
    assert runs["resumed"]["resumed"] == runs["killed"]["committed"], runs
    assert runs["complete"]["rans"] == 0, runs
    assert runs["complete"]["resumed"] == FLAG_REGIONS * CO_SAMPLES, runs
    out["kill_resume"] = runs
    return out


def _flags_pairhmm_trace(root, workdir, pairhmm_run, untraced, keep_dir,
                         env) -> dict:
    """pairhmm --trace-out: one device.pairhmm span per length bucket."""
    fx = pairhmm_run["fixture"]
    trace = os.path.join(workdir, "ph_trace.json")
    report = os.path.join(workdir, "ph_trace_report.json")
    table = os.path.join(workdir, "ph_trace_table.tsv")
    r, _ = _run_cli(root, ["--trace-out", trace, "--metrics-out", report,
                           "pairhmm", "--candidates", fx["candidates"],
                           "--out", table, fx["windows"]], env)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(table) as fh, open(fx["table"]) as fw:
        _same_bytes("pairhmm --trace-out table", fh.read(), fw.read())
    rep, cmd_s, _ = read_manifest(report, "pairhmm")
    tr = load_trace(trace)
    assert rep["trace_id"] == tr["root"]["args"]["trace_id"]
    n_ph = sum(e["name"] == "device.pairhmm" for e in tr["device"])
    assert n_ph == rep["kernel_launches"]["pairhmm"] \
        == pairhmm_run["launches"], (n_ph, rep["kernel_launches"])
    share = fenced_kernel_share(tr)
    log(f"pairhmm --trace-out: table byte-identical; {n_ph} fenced "
        f"device.pairhmm spans = the launches; fenced-kernel share "
        f"{share:.4f}; command {cmd_s:.3f} s traced against "
        f"{untraced['pairhmm']:.3f} s without fences (phase 6)")
    if keep_dir:
        shutil.copy(trace, os.path.join(keep_dir, "pairhmm_trace.json"))
    return {"command_s": cmd_s, "untraced_command_s": untraced["pairhmm"],
            "device_spans": n_ph, "fenced_kernel_share": share}


def _flags_regions_run(root, workdir, crams, fai, want, env, name: str,
                       extra: list) -> dict:
    """One cohortdepth run over FLAG_REGIONS regions (``co_regions.bed``)
    with ``extra`` flags → its rans launches and checkpoint counters, or
    for the killed run the columns its journal committed."""
    bed = os.path.join(workdir, "co_regions.bed")
    report = os.path.join(workdir, f"co_{name}.json")
    r, wall = _run_cli(root, ["--metrics-out", report, "cohortdepth",
                              "--fai", fai, "-w", str(CO_WINDOW), "-b", bed,
                              "--decode-device", *extra, *crams], env)
    if "--inject-faults" in extra:
        assert r.returncode == -9, (r.returncode, r.stderr[-2000:])
        ck = extra[extra.index("--checkpoint-dir") + 1]
        with open(os.path.join(ck, "journal.jsonl")) as fh:
            committed = sum(1 for _ in fh)
        log(f"cohortdepth --checkpoint-dir --inject-faults {FLAG_KILL}: "
            f"killed by SIGKILL after {committed} committed columns")
        return {"wall_s": wall, "committed": committed}
    assert r.returncode == 0, r.stderr[-4000:]
    _same_bytes(f"cohortdepth -b ({name}) matrix", r.stdout, want)
    rep, cmd_s, _ = read_manifest(report, "cohortdepth")
    c = rep["metrics"]["counters"]
    run = {"command_s": cmd_s, "rans": rep["kernel_launches"]["rans"],
           "resumed": c.get("checkpoint.shards_resumed_total", 0),
           "written": c.get("checkpoint.shards_written_total", 0)}
    log(f"cohortdepth -b {FLAG_REGIONS} regions ({name}): matrix "
        f"byte-identical to the oracle; rans launches {run['rans']}, "
        f"columns resumed {run['resumed']}, written {run['written']}; "
        f"command {cmd_s:.3f} s")
    return run


def _flags_kill_resume(root, workdir, crams, fai, want, env) -> dict:
    """The checkpointed cohortdepth over FLAG_REGIONS regions killed by
    FLAG_KILL, resumed, and resumed again over the complete store."""
    ck = os.path.join(workdir, "co_ck")
    return {name: _flags_regions_run(root, workdir, crams, fai, want, env,
                                     name, extra)
            for name, extra in (
                ("killed", ["--checkpoint-dir", ck, "--inject-faults",
                            FLAG_KILL]),
                ("resumed", ["--checkpoint-dir", ck, "--resume"]),
                ("complete", ["--checkpoint-dir", ck, "--resume"]))}


# ---- EM and cnv phases ------------------------------------------------

#: the EM at cohort width: chr20 (64,444,167 bp) in 1 kb windows x the
#: 2,504 samples of the 1000 Genomes phase-3 cohort
EM_WINDOWS = 64_445
EM_SAMPLES = 2_504
EM_CHECK = 64  # windows held against the pure-Python oracle
#: the cnv cohort: 8 BAMs of 400,000 150 bp reads (15x) on a 4 Mb contig
CNV_LEN = 4_000_000
CNV_READS = 400_000
CNV_SAMPLES = 8
CNV_WINDOW = 1000
CNV_DEL = (1_000_000, 1_200_000, 1)  # het deletion: start, end, sample
CNV_DUP = (2_500_000, 2_650_000, 5)  # duplication (CN3)


def load_em_oracle(root: str):
    """tests/oracle_emdepth.py: the pure-Python f64 transcription of the
    reference EM (no JAX)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "oracle_emdepth", os.path.join(root, "tests", "oracle_emdepth.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def em_matrix(rng, windows: int = None, samples: int = None) -> np.ndarray:
    """int16 (windows, samples) window means (EM_WINDOWS x EM_SAMPLES by
    default): per-sample coverage 20-40x times a per-window bias, Poisson
    counts (drawn on the card, from a seed taken from ``rng``); het
    deletions, homozygous deletions and duplications planted in blocks of
    samples."""
    import torch

    windows = windows or EM_WINDOWS
    samples = samples or EM_SAMPLES
    cov = rng.uniform(20, 40, samples)
    bias = rng.gamma(50, 1 / 50, windows)
    gen = torch.Generator(device="cuda").manual_seed(
        int(rng.integers(2 ** 31)))
    cov_d = torch.from_numpy(cov).cuda()
    m = np.empty((windows, samples), np.int16)
    for lo in range(0, windows, 4096):
        rate = torch.from_numpy(bias[lo:lo + 4096]).cuda()[:, None] * cov_d
        m[lo:lo + 4096] = torch.poisson(rate, generator=gen).to(
            torch.int16).cpu().numpy()
    for k in range(40):
        w = int(rng.integers(0, windows - 300))
        n = int(rng.integers(20, 300))
        s = rng.choice(samples, int(rng.integers(1, samples // 40 + 2)),
                       replace=False)
        blk = m[w:w + n, s]
        m[w:w + n, s] = (blk // 2, blk * 0, blk * 3 // 2)[k % 3]
    return m


def em_phase(root: str, dev) -> tuple:
    """The EM at cohort width on the card: the int16 matrix through
    call_cnvs's normalisation (sample_medians) and _batched_em (four
    16,384-window f64 chunks); λ of EM_CHECK windows against the oracle
    (rtol = atol = 1e-9), their CN equal to its CN clamped at 8; cn.mops
    on the first chunk against the port's CPU path on the same rows.
    → (results, (depths, med, medmed, λ, CN)) for phase 21's split."""
    import torch

    from goleft_tpu_torch.commands import emdepth_cmd as ec
    from goleft_tpu_torch.models import emdepth as em
    from goleft_tpu_torch.models import mops

    oracle = load_em_oracle(root)
    rng = np.random.default_rng(2504)
    t0 = time.perf_counter()
    depths = em_matrix(rng)
    fab_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    med, medmed = ec.sample_medians(depths)
    median_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    lam, cn = ec._batched_em(depths, med, medmed, device=dev)
    b.record()
    b.synchronize()
    em_wall = time.perf_counter() - t0
    em_ms = a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated(dev)
    n_chunks = -(-EM_WINDOWS // ec.EM_CHUNK)
    assert lam.shape == (EM_WINDOWS, 9) and cn.shape == depths.shape
    assert np.isfinite(lam).all() and cn.min() >= 0 and cn.max() <= 8

    chunk = ec._norm_chunk(depths[:ec.EM_CHUNK], med, medmed, np.float64,
                           dev)

    def em_chunk():
        em.cn_batch(em.em_depth_batch(chunk), chunk)

    chunk_ms = cuda_median_ms(em_chunk, reps=3)

    check = np.sort(rng.choice(EM_WINDOWS, EM_CHECK, replace=False))
    rows = depths[check] / med * medmed  # the host's scaling, in numpy
    worst = 0.0
    for j, w in enumerate(check):
        want = np.array(oracle.em_depth(rows[j]))
        np.testing.assert_allclose(lam[w], want, rtol=1e-9, atol=1e-9,
                                   err_msg=f"window {w}")
        worst = max(worst, float(np.max(np.abs(lam[w] - want))))
        want_cn = [min(oracle.cn_type(want, x), em.MAX_CN) for x in rows[j]]
        if cn[w].tolist() != want_cn:
            bad = np.flatnonzero(cn[w] != np.array(want_cn))
            raise AssertionError(f"window {w}: CN of samples {bad[:10]} "
                                 f"{cn[w][bad[:10]]} != oracle "
                                 f"{np.array(want_cn)[bad[:10]]}")

    torch.cuda.reset_peak_memory_stats(dev)

    def mops_chunk():
        r = mops.mops_batch(chunk)
        return mops.posterior_cn(r["aik"]), mops.information_gain(r["aik"])

    mops_ms = cuda_median_ms(mops_chunk, reps=2)
    mops_peak = torch.cuda.max_memory_allocated(dev)
    r = mops.mops_batch(chunk)
    sub = np.sort(rng.choice(ec.EM_CHUNK, EM_CHECK, replace=False))
    rc = mops.mops_batch(ec._norm_chunk(depths[sub], med, medmed,
                                        np.float64, "cpu"))
    aik = r["aik"][torch.from_numpy(sub).to(dev)].cpu()
    np.testing.assert_allclose(aik.numpy(), rc["aik"].numpy(), rtol=1e-9,
                               atol=1e-9)
    assert torch.equal(mops.posterior_cn(aik), mops.posterior_cn(rc["aik"]))
    np.testing.assert_allclose(mops.information_gain(aik).numpy(),
                               mops.information_gain(rc["aik"]).numpy(),
                               rtol=1e-9, atol=1e-9)
    mops_err = float((aik - rc["aik"]).abs().max())
    del chunk, r
    torch.cuda.empty_cache()
    cells = EM_WINDOWS * EM_SAMPLES
    log(f"EM at {EM_WINDOWS} windows x {EM_SAMPLES} samples (int16 matrix, "
        f"{depths.nbytes / 1e6:.1f} MB, fabricated in {fab_s:.1f} s): "
        f"sample medians {median_s:.3f} s; _batched_em {n_chunks} chunks of "
        f"{ec.EM_CHUNK} in {em_wall:.3f} s wall ({em_ms:.3f} ms by CUDA "
        f"events, {em_ms / n_chunks:.3f} ms a chunk with the copies and "
        f"the scaling on the card; {cells / em_wall / 1e6:.3f} M "
        f"window-samples/s), peak device memory {peak / 1e9:.3f} GB; "
        f"EM + CN of one resident chunk {chunk_ms:.3f} ms; λ of "
        f"{EM_CHECK} windows within 1e-9 of the oracle (max abs err "
        f"{worst:.3g}) and their CN equal; cn.mops of one chunk "
        f"{mops_ms:.3f} ms (peak {mops_peak / 1e9:.3f} GB), {EM_CHECK} rows "
        f"equal to the CPU path (aik max abs err {mops_err:.3g})")
    return {"windows": EM_WINDOWS, "samples": EM_SAMPLES,
            "chunks": n_chunks, "fabricate_s": fab_s, "median_s": median_s,
            "batched_em_wall_s": em_wall, "batched_em_ms": em_ms,
            "ms_a_chunk": em_ms / n_chunks, "resident_chunk_ms": chunk_ms,
            "window_samples_per_s": cells / em_wall,
            "peak_bytes": peak, "lambda_max_abs_err": worst,
            "mops_chunk_ms": mops_ms, "mops_peak_bytes": mops_peak,
            "mops_aik_max_abs_err": mops_err}, (depths, med, medmed, lam, cn)


def cnv_fabricate(workdir: str, rng):
    """8 BAMs (cnv0..cnv7) of CNV_READS 150 bp reads on a CNV_LEN contig,
    half the reads of CNV_DEL's sample dropped in its region and half as
    many again added in CNV_DUP's; the FASTA. → (bams, fasta)."""
    from goleft_tpu_torch.io.bai import write_bai
    from tools.bulk_bam import write_bam_bulk

    bams = []
    for i in range(CNV_SAMPLES):
        pos = rng.integers(0, CNV_LEN - READ_LEN, CNV_READS)
        lo, hi, who = CNV_DEL
        if i == who:
            pos = pos[~((pos >= lo) & (pos < hi)
                        & (rng.random(len(pos)) < 0.5))]
        lo, hi, who = CNV_DUP
        if i == who:
            extra = CNV_READS * (hi - lo) // CNV_LEN // 2
            pos = np.concatenate([pos, rng.integers(lo, hi, extra)])
        pos = np.sort(pos)
        n = len(pos)
        p = os.path.join(workdir, f"cnv{i}.bam")
        idx = write_bam_bulk(p, "chr1", CNV_LEN, pos, np.zeros(n, np.int64),
                             ["150M"], np.full(n, 60, np.uint8),
                             np.zeros(n, np.uint16))
        write_bai(idx, p + ".bai")
        bams.append(p)
    fa = os.path.join(workdir, "cnv.fa")
    write_fasta(fa, rng, CNV_LEN)
    return bams, fa


def _diff_rows(what: str, got: str, want: str) -> None:
    """Fail with the differing rows (windows) of two tables."""
    if got == want:
        return
    g, w = got.splitlines(), want.splitlines()
    bad = [(k, a, b) for k, (a, b) in enumerate(zip(g, w)) if a != b]
    raise AssertionError(
        f"{what}: {len(bad)} rows differ ({len(g)} against {len(w)} rows); "
        + "; ".join(f"row {k}: got {a!r} want {b!r}" for k, a, b in bad[:8]))


def cnv_e2e_phase(root: str, workdir: str) -> dict:
    """``python -m goleft_tpu_torch cnv -w 1000 --vcf --matrix-out`` on 8
    fabricated BAMs under ``--engine device`` (depth-kernel launches
    counted, from 0 in the fresh process) and the default engine: equal
    bytes, equal to the port's ``run_cnv(device="cpu")``, both planted
    events called; the ``cohortdepth`` window-mean matrix of the same
    BAMs under ``--engine device`` byte-identical to the hybrid
    engine's (the depth kernel checked exactly at cnv's shapes; the
    default engine's and the hybrid engine's runs side by side, after the
    device engine's); then ``emdepth --mops-out --gain-out`` on that
    matrix, on the card and on the CPU."""
    import io

    from goleft_tpu_torch.commands.cnv import run_cnv
    from goleft_tpu_torch.commands.emdepth_cmd import run_emdepth

    t0 = time.perf_counter()
    bams, fa = cnv_fabricate(workdir, np.random.default_rng(20))
    log(f"fabricated {CNV_SAMPLES} BAMs of {CNV_READS} reads on a {CNV_LEN} "
        f"bp contig in {time.perf_counter() - t0:.1f} s")
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GOLEFT_TPU_FAULTS", None)

    def cnv_run(name, extra):
        report = os.path.join(workdir, f"cnv_{name}.json")
        vcf = os.path.join(workdir, f"cnv_{name}.vcf")
        mat = os.path.join(workdir, f"cnv_{name}.cn.tsv")
        r, wall = _run_cli(root, ["--metrics-out", report, "cnv", "-w",
                                  str(CNV_WINDOW), "-r", fa, "--vcf", vcf,
                                  "--matrix-out", mat, *extra, *bams], env)
        if r.returncode != 0:
            raise AssertionError(f"cnv ({name}) failed ({r.returncode}):\n"
                                 f"{r.stderr[-4000:]}")
        rep, cmd_s, stages = read_manifest(report, "cnv")
        with open(vcf) as fh, open(mat) as mh:
            out = (r.stdout, fh.read(), mh.read())
        run = {"wall_s": wall, "command_s": cmd_s,
               "import_s": rep["import_seconds"], "stage_seconds": stages,
               "launches": rep["kernel_launches"],
               "native_io": rep["native_io"],
               "bases_per_s": CNV_SAMPLES * CNV_LEN / cmd_s}
        log(f"cnv ({name} engine): process wall {wall:.3f} s, command "
            f"{cmd_s:.3f} s, import {rep['import_seconds']:.3f} s; "
            f"{CNV_SAMPLES * CNV_LEN / cmd_s / 1e6:.3f} Mbases/s "
            f"({CNV_SAMPLES} samples x {CNV_LEN} bp); launches "
            f"{rep['kernel_launches']}; stage seconds: "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items())))
        return run, out

    def cohortdepth_run(name):
        report = os.path.join(workdir, f"cohortdepth_{name}.json")
        r, wall = _run_cli(root, ["--metrics-out", report, "cohortdepth",
                                  "-w", str(CNV_WINDOW), "-r", fa,
                                  "--engine", name, *bams], env)
        if r.returncode != 0:
            raise AssertionError(f"cohortdepth ({name}) failed "
                                 f"({r.returncode}):\n{r.stderr[-4000:]}")
        launches = read_manifest(
            report, "cohortdepth")[0]["kernel_launches"]["depth"]
        return r.stdout, wall, launches

    # the device engine's runs alone (phase 21 compares their walls with
    # two processes'); then the default engine's cnv and the hybrid
    # cohortdepth side by side, beside the CPU path here
    runs, outs, mats, cd_launches = {}, {}, {}, {}
    runs["device"], outs["device"] = cnv_run("device",
                                             ["--engine", "device"])
    mats["device"], cd_device_wall, cd_launches["device"] = \
        cohortdepth_run("device")
    default = _BG.submit(cnv_run, "default", [])
    hybrid = _BG.submit(cohortdepth_run, "hybrid")
    buf = io.StringIO()
    vcf = os.path.join(workdir, "cnv_cpu.vcf")
    mat = os.path.join(workdir, "cnv_cpu.cn.tsv")
    t0 = time.perf_counter()
    calls = run_cnv(bams, reference=fa, window=CNV_WINDOW, out=buf,
                    vcf_out=vcf, matrix_out=mat, device="cpu")
    cpu_s = time.perf_counter() - t0
    with open(vcf) as fh, open(mat) as mh:
        outs["cpu"] = (buf.getvalue(), fh.read(), mh.read())
    runs["default"], outs["default"] = default.result()
    mats["hybrid"], _, cd_launches["hybrid"] = hybrid.result()
    assert runs["device"]["launches"]["depth"] == CNV_SAMPLES, runs["device"]
    # with the native library, auto picks the hybrid engine (no kernel)
    assert runs["default"]["native_io"], runs["default"]
    assert runs["default"]["launches"]["depth"] == 0, runs["default"]
    for name in ("device", "default"):
        for what, got, want in zip(("calls", "VCF", "CN matrix"),
                                   outs[name], outs["cpu"]):
            _diff_rows(f"cnv {what} ({name} engine on the card against the "
                       "CPU)", got, want)
    lo, hi, who = CNV_DEL
    assert any(c[3] == f"cnv{who}" and c[1] < hi and c[2] > lo
               and c[5] < -0.5 for c in calls), calls
    lo, hi, who = CNV_DUP
    assert any(c[3] == f"cnv{who}" and c[1] < hi and c[2] > lo
               and c[5] > 0.3 for c in calls), calls
    log(f"cnv: both engines byte-identical to run_cnv(device='cpu') "
        f"({cpu_s:.3f} s on the host CPU): {len(calls)} calls, the planted "
        f"deletion and duplication among them: "
        + "; ".join(f"{c[3]} {c[1]}-{c[2]} CN {c[4]} log2FC {c[5]:.3f}"
                    for c in calls if c[3] in (f"cnv{CNV_DEL[2]}",
                                               f"cnv{CNV_DUP[2]}")))

    matrix = os.path.join(workdir, "cnv.matrix.tsv")
    assert cd_launches == {"hybrid": 0, "device": CNV_SAMPLES}, cd_launches
    _diff_rows("cohortdepth window means (depth kernel against the hybrid "
               "engine)", mats["device"], mats["hybrid"])
    log(f"cohortdepth -w {CNV_WINDOW} on the same BAMs: --engine device "
        f"({cd_launches['device']} depth launches) byte-identical to the "
        f"hybrid engine over {len(mats['device'].splitlines()) - 1} "
        f"windows x {CNV_SAMPLES} samples")
    with open(matrix, "w") as fh:
        fh.write(mats["hybrid"])
    report = os.path.join(workdir, "emdepth.json")
    files = {k: os.path.join(workdir, f"em_{k}.tsv") for k in
             ("mops", "gain", "mops_cpu", "gain_cpu")}
    r, wall = _run_cli(root, ["--metrics-out", report, "emdepth",
                              "--mops-out", files["mops"], "--gain-out",
                              files["gain"], matrix], env)
    if r.returncode != 0:
        raise AssertionError(f"emdepth failed ({r.returncode}):\n"
                             f"{r.stderr[-4000:]}")
    rep, em_s, em_stages = read_manifest(report, "emdepth")
    buf = io.StringIO()
    run_emdepth(matrix, out=buf, mops_out=files["mops_cpu"],
                gain_out=files["gain_cpu"], device="cpu")
    _diff_rows("emdepth calls (card against CPU)", r.stdout, buf.getvalue())
    for k in ("mops", "gain"):
        with open(files[k]) as g, open(files[k + "_cpu"]) as c:
            _diff_rows(f"emdepth --{k}-out (card against CPU)", g.read(),
                       c.read())
    n_win = CNV_LEN // CNV_WINDOW
    log(f"emdepth --mops-out --gain-out on the cohortdepth matrix "
        f"({n_win} windows x {CNV_SAMPLES} samples): card and CPU "
        f"byte-identical; process wall {wall:.3f} s, command {em_s:.3f} s "
        f"= {n_win * CNV_SAMPLES / em_s / 1e6:.4f} M window-samples/s; "
        f"stage seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(em_stages.items())))
    return {"runs": runs, "cpu_s": cpu_s, "calls": len(calls),
            "bams": bams, "fa": fa, "cohortdepth_launches": cd_launches,
            "single": {"cohortdepth": mats["device"], "cnv": outs["device"],
                       "cohortdepth_wall_s": cd_device_wall,
                       "cnv_wall_s": runs["device"]["wall_s"]},
            "emdepth": {"wall_s": wall, "command_s": em_s,
                        "stage_seconds": em_stages,
                        "window_samples_per_s":
                            n_win * CNV_SAMPLES / em_s}}


# ---- indexcov phases: the normalisation kernel, then the command -------

#: hg38's 24 primary chromosomes at their GRCh38 lengths (3.09 Gb)
HG38 = (("chr1", 248_956_422), ("chr2", 242_193_529), ("chr3", 198_295_559),
        ("chr4", 190_214_555), ("chr5", 181_538_259), ("chr6", 170_805_979),
        ("chr7", 159_345_973), ("chr8", 145_138_636), ("chr9", 138_394_717),
        ("chr10", 133_797_422), ("chr11", 135_086_622),
        ("chr12", 133_275_309), ("chr13", 114_364_328),
        ("chr14", 107_043_718), ("chr15", 101_991_189),
        ("chr16", 90_338_345), ("chr17", 83_257_441), ("chr18", 80_373_285),
        ("chr19", 58_617_616), ("chr20", 64_444_167), ("chr21", 46_709_983),
        ("chr22", 50_818_468), ("chrX", 156_040_895), ("chrY", 57_227_415))
IC_TILE = 16384
#: the kernel phase's main case: the 1000 Genomes phase-3 cohort x chr1 at
#: 16 KB
NORM_SAMPLES = 2_504
NORM_BINS = 15_195
#: the kernel is also timed at these widths: one block (the chain alone,
#: with its producers) and a few hundred samples
NORM_TIMED_SAMPLES = (32, 500, NORM_SAMPLES)
#: the dependent chain of one bin of csrc/indexcov_norm.cu, in SM cycles
#: (assumed, not measured): the output o_j depends on o_{j-1} through five
#: f32 adds, the multiply by float32(1/7) and the select, ~4 cycles each
NORM_CYCLES_PER_BIN = 28
#: run A (the reference's headline: 30 samples, reports), run B (cohort
#: scale, -n), the kill-and-resume runs (30 samples, -n)
IC_HEADLINE = 30
IC_SAMPLES = 30
IC_KILL = "shard:after=5:kill"
#: planted on the fabricated cohort: three latent factors a sample
#: (normal, these standard deviations of relative depth), each a sine wave
#: along every chromosome, as batch and ancestry effects give a real
#: cohort's PCA (over the autosomes) its leading components; the rest of
#: the spectrum is the bins' independent noise
IC_FACTORS = (0.06, 0.045, 0.03)
IC_STAGES = ("index_load", "qc_launch", "qc_fetch", "bed_gz", "roc",
             "plots", "pca_ped_html")
#: PCA columns and charts hold per component, up to sign, within this
#: share of the component's largest projection (float32 SVDs of two
#: libraries, %.2f of a 0..65535-scaled matrix)
PCA_RTOL = 1e-4
#: where the spectrum is known, component k's share is K * eps32 *
#: sigma_1 / gap_k (gap_k: sigma_k's distance to its nearest singular
#: value): two backward-stable float32 SVDs agree on the k-th right
#: singular vector within about eps * sigma_1 / gap_k (Davis-Kahan),
#: here with K for the growth of the solvers' backward error. A cohort
#: without structure has nearly equal singular values, so its
#: components are that ill-conditioned.
PCA_GROWTH = 64


def _norm_scalars(depths, lengths):
    """The port's pass-1 scalars (host f64 NormStats) of a cohort."""
    from goleft_tpu_torch.cohort.streaming import NormStats

    st = NormStats()
    st.accumulate(depths, lengths)
    return st.finalize(depths.shape[1])


def _zero_tails(depths, lengths):
    depths[np.arange(depths.shape[1])[None, :] >= lengths[:, None]] = 0
    return depths


def norm_main_case(rng, n: int = NORM_SAMPLES, b: int = NORM_BINS):
    """(depths, lengths, m, skip) of chr1 at 16 KB for n samples: samples
    ending 1-5 bins early (the last bins fall under the live-sample
    floor and are skipped), a length-0 sample, a run of m < 0.1 bins; m
    and skip from the port's NormStats, as on the main path."""
    lengths = np.full(n, b, np.int32)
    lengths[1:6] = b - np.arange(1, 6)
    lengths[6] = 0
    depths = rng.gamma(8.0, 1 / 8, size=(n, b)).astype(np.float32)
    depths[:, 1000:1012] *= np.float32(1e-3)
    _zero_tails(depths, lengths)
    m, skip = _norm_scalars(depths, lengths)
    assert skip[1002:1010].all() and skip[-5:].all() and not skip[500]
    return depths, lengths, m, skip


def _norm_tile() -> int:
    """The kernel's bins a shared-memory stage (ops/norm_kernel.py::
    TILE_BINS): NORM_EDGES' widths and lengths sit around a tile's edge."""
    from goleft_tpu_torch.ops import norm_kernel as nk

    return nk.TILE_BINS


def _norm_synthetic(rng, n, b, lengths, pad=0.0):
    """Any (m, skip): the kernel is a function of them, so an edge case
    may smooth bins the reference's floor would skip."""
    depths = rng.gamma(4.0, 0.25, size=(n, b)).astype(np.float32)
    if pad == 0.0:
        _zero_tails(depths, lengths)
    m = rng.uniform(0.5, 1.5, size=b).astype(np.float32)
    skip = rng.random(b) < 0.1
    return depths, lengths.astype(np.int32), m, skip


def _norm_short_lanes(rng):
    b = 300
    lengths = np.r_[np.arange(0, 9), b - np.arange(0, 6),
                    rng.integers(0, b + 1, 23)]
    return _norm_synthetic(rng, lengths.size, b, lengths)


def _norm_width(b):
    def case(rng):
        return _norm_synthetic(rng, 9, b, np.arange(9) % (b + 1))
    return case


def _norm_nonzero_padding(rng):
    lengths = rng.integers(0, 200, 40)
    return _norm_synthetic(rng, 40, 200, lengths, pad=1.0)


def _norm_tile_width(d):
    """A width d bins from the tile (T - 1, T, T + 1, T + 3): lanes of
    length 0-8 and lanes ending 0-4 bins before the matrix."""
    def case(rng):
        b = _norm_tile() + d
        return _norm_synthetic(rng, 14, b, np.r_[np.arange(9),
                                                 b - np.arange(5)])
    return case


def _norm_lanes(n):
    """n sample lanes: a block that is not full, or one lane past it."""
    def case(rng):
        b = 2 * _norm_tile() + 29
        lengths = rng.integers(0, b + 1, n)
        lengths[0] = b
        return _norm_synthetic(rng, n, b, lengths)
    return case


def _norm_extreme_values(rng):
    """Operands far from a depth's usual range: m of 3e-19 and 5e18, m = 0
    at skipped bins, depths of 1e19 and 3e-19, and -0.0 (no result is
    subnormal, and nothing sums to inf - inf)."""
    b = 3 * _norm_tile() + 7
    lengths = rng.integers(b // 2, b + 1, 40)
    depths, lengths, m, skip = _norm_synthetic(rng, 40, b, lengths)
    m[[5, 70, 140]] = np.float32(3e-19)
    m[[9, 100]] = np.float32(5e18)
    m[[20, 130]] = 0
    skip[[20, 130]] = True
    skip[[5, 9, 70, 100, 140]] = False
    rows = rng.integers(0, 40, 18)
    cols = rng.choice(np.r_[30:60, 160:180], 18, replace=False)
    depths[rows[:6], cols[:6]] = np.float32(1e19)
    depths[rows[6:12], cols[6:12]] = np.float32(3e-19)
    depths[rows[12:], cols[12:]] = np.float32(-0.0)
    return depths, lengths, m, skip


def _norm_tile_edge_lengths(rng):
    """Lengths ending 0-3 bins before, at and 1-3 bins past each of
    three tile edges, on 40 lanes (a full block and part of a second)."""
    tile = _norm_tile()
    b = 3 * tile + 5
    ends = [e * tile + d for e in (1, 2, 3) for d in range(-3, 4)]
    lengths = np.r_[ends, rng.integers(0, b + 1, 40 - len(ends))]
    return _norm_synthetic(rng, 40, b, np.minimum(lengths, b))


def _norm_skip_runs(rng):
    """NormStats scalars with every skip: low-coverage runs, and two short
    samples that put the tail under the live-sample floor."""
    n, b = 64, 2000
    lengths = np.full(n, b, np.int32)
    lengths[3], lengths[9] = 1500, 1700
    depths = rng.gamma(8.0, 1 / 8, size=(n, b)).astype(np.float32)
    depths[:, 100:130] *= np.float32(1e-3)
    depths[:, 700:703] *= np.float32(0.05)
    _zero_tails(depths, lengths)
    m, skip = _norm_scalars(depths, lengths)
    assert skip[102:128].all() and skip[1700:].all() and not skip[50]
    return depths, lengths, m, skip


def _norm_five_samples(rng):
    n, b = 5, 3000
    lengths = np.array([b, b - 2, b, 2400, b], np.int32)
    depths = rng.gamma(8.0, 1 / 8, size=(n, b)).astype(np.float32)
    _zero_tails(depths, lengths)
    return (depths, lengths) + _norm_scalars(depths, lengths)


#: edge cases of the normalisation kernel: (name → rng → depths, lengths,
#: m, skip), held bitwise against the plain version on the card here and
#: in tests/test_torch_cuda.py, and against the reference's order in
#: tests/test_torch_indexcov_norm.py on the CPU
NORM_EDGES = {
    "short_lanes": _norm_short_lanes,
    "width_1": _norm_width(1),
    "width_3": _norm_width(3),
    "width_7": _norm_width(7),
    "width_tile_minus_1": _norm_tile_width(-1),
    "width_tile": _norm_tile_width(0),
    "width_tile_plus_1": _norm_tile_width(1),
    "width_tile_plus_3": _norm_tile_width(3),
    "lanes_1": _norm_lanes(1),
    "lanes_31": _norm_lanes(31),
    "lanes_33": _norm_lanes(33),
    "tile_edge_lengths": _norm_tile_edge_lengths,
    "extreme_values": _norm_extreme_values,
    "nonzero_padding": _norm_nonzero_padding,
    "skip_runs": _norm_skip_runs,
    "five_samples": _norm_five_samples,
}


def norm_edge_case(name: str):
    return NORM_EDGES[name](np.random.default_rng(
        sum(map(ord, name))))


def _bits_equal(got, want) -> bool:
    import torch

    return got.shape == want.shape and torch.equal(
        got.view(torch.int32), want.view(torch.int32))


def norm_kernel_phase(dev) -> dict:
    """indexcov_norm against its plain version on the card, bitwise, on
    NORM_EDGES and on the first 32, 500 and 2,504 samples of the main case
    (2,504 samples x 15,195 bins, the scalars of the whole cohort: each
    width is a chunk of the main path); the kernel's time at each width
    (CUDA events, median of 20), the plain version's at 2,504 (one call),
    both bounds and ptxas's report."""
    import torch

    from goleft_tpu_torch.ops import norm_kernel as nk

    resources = kernel_resources(
        nk.BUILD_LOG,
        lambda name: "norm" if "norm_scan_kernel" in name else None)
    resources = dict(resources.get("norm", {}), dynamic_smem_bytes=(
        nk.launch_plan(1, 1)["smem_bytes"]))
    log("indexcov_norm kernel (ptxas; the ring is dynamic shared memory): "
        + json.dumps(resources))

    def on_card(case):
        d, ln, m, skip = case
        return (torch.from_numpy(np.ascontiguousarray(d)).to(dev),
                torch.from_numpy(ln.astype(np.int32)).to(dev),
                torch.from_numpy(m).to(dev), torch.from_numpy(skip).to(dev))

    for name in sorted(NORM_EDGES):
        t = on_card(norm_edge_case(name))
        got = nk.norm_scan(*t)
        want = nk.apply_normalization_plain(*t)
        torch.cuda.synchronize()
        assert _bits_equal(got, want), f"indexcov_norm edge case {name}"
    clock = sm_clock_hz()
    t0 = time.perf_counter()
    d, ln, m, skip = norm_main_case(np.random.default_rng(2504))
    fab_s = time.perf_counter() - t0
    b = d.shape[1]
    widths = {}
    for n in NORM_TIMED_SAMPLES:
        t = on_card((d[:n], ln[:n], m, skip))
        got = nk.norm_scan(*t)
        # the plain version's one call, timed by CUDA events (the widths
        # before have warmed it up)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        want = nk.apply_normalization_plain(*t)
        ev1.record()
        torch.cuda.synchronize()
        assert _bits_equal(got, want), f"indexcov_norm at {n} x {b}"
        assert torch.isfinite(got).all()
        ms = cuda_median_ms(lambda: nk.norm_scan(*t), reps=20)
        # each input read once, each output written once; per cell four
        # divisions, six adds and a multiply
        nbytes = 2 * n * b * 4 + n * 4 + b * 4 + b
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 11 * n * b / F32_OPS_PER_S * 1e3
        w = {"ms": ms, "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "chain_bound_ms": b * NORM_CYCLES_PER_BIN / clock * 1e3,
             "cycles_per_bin": ms * 1e-3 * clock / b,
             "max_abs_err": float((got - want).abs().max()),
             "plan": nk.launch_plan(n, b)}
        if n == NORM_SAMPLES:
            w["plain_ms"] = ev0.elapsed_time(ev1)
        widths[n] = w
        log(f"indexcov_norm at {n} samples x {b} bins: bitwise equal to "
            f"its plain version; kernel {ms:.4f} ms (CUDA events, median "
            f"of 20) = {w['cycles_per_bin']:.1f} cycles a bin at "
            f"{clock / 1e6:.0f} MHz, {w['plan']['blocks']} blocks; bound "
            f"{w['bound_ms']:.4f} ms ({w['bound_by']}: {nbytes / 1e6:.1f} "
            f"MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), dependence chain "
            f"{w['chain_bound_ms']:.4f} ms ({b} bins x "
            f"{NORM_CYCLES_PER_BIN} cycles); library: none"
            + (f"; plain version on the card {w['plain_ms']:.1f} ms "
               "(one call)" if "plain_ms" in w else ""))
    main = widths[NORM_SAMPLES]
    log(f"indexcov_norm: bitwise on {len(NORM_EDGES)} edge cases; main "
        f"case ({NORM_SAMPLES} x {b}, ragged) fabricated in {fab_s:.1f} s")
    return {"samples": NORM_SAMPLES, "bins": b,
            "edge_cases": sorted(NORM_EDGES), "ptxas": resources,
            "sm_clock_hz": clock,
            "widths": {str(n): w for n, w in widths.items()},
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "chain_bound_ms", "max_abs_err")}}


def indexcov_fabricate(d: str, n_ix: int, rng, contigs=HG38):
    """Whole-genome .bai files and a ref.fa.fai into ``d``: a copy of
    bench.py's ``_fabricate_bai_cohort`` with sex planted (the chrX and
    chrY deltas halved for even samples, chrY deltas near zero for odd
    ones) and a cohort structure planted on every contig (IC_FACTORS)
    → (sorted .bai paths, fai path)."""
    import struct

    fai = os.path.join(d, "ref.fa.fai")
    with open(fai, "w") as fh:
        for name, ln in contigs:
            fh.write(f"{name}\t{ln}\t6\t60\t61\n")
    scores = rng.standard_normal((n_ix, len(IC_FACTORS))) \
        * np.asarray(IC_FACTORS)
    for s in range(n_ix):
        male = s % 2 == 0
        blob = bytearray(b"BAI\x01") + struct.pack("<i", len(contigs))
        for name, ln in contigs:
            n_t = ln // IC_TILE
            blob += struct.pack("<i", 1)
            blob += struct.pack("<Ii", 0x924A, 2)
            blob += struct.pack("<QQ", 0, 0)
            blob += struct.pack("<QQ", 40_000_000, 80_000)
            base = int(rng.integers(0, 1 << 30))
            deltas = rng.integers(20_000, 60_000, size=n_t).astype(np.int64)
            # the factors on every contig alike, so that a sample's
            # median and its chrX quantile move together and sex stays
            # what was planted
            t = np.arange(n_t) / max(n_t, 1)
            waves = np.stack([np.sin(2 * np.pi * (k + 1) * t + k)
                              for k in range(len(IC_FACTORS))])
            deltas = (deltas * np.clip(1 + scores[s] @ waves, 0.2, None)
                      ).astype(np.int64)
            if name in ("chrX", "chrY") and male:
                deltas //= 2
            elif name == "chrY":
                deltas //= 1000
            ivs = ((base + np.cumsum(deltas)).astype(np.uint64)
                   * np.uint64(1 << 16))
            blob += struct.pack("<i", n_t) + ivs.astype("<u8").tobytes()
        blob += struct.pack("<Q", 0)
        with open(os.path.join(d, f"s{s:03d}.bai"), "wb") as fh:
            fh.write(bytes(blob))
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".bai")), fai


def _fab_sizes(path: str, n_ref: int) -> list:
    """The oracle's own reading of a fabricated .bai (one stats bin a
    reference): the per-tile linear-index voffset deltas."""
    data = open(path, "rb").read()
    off, out = 8, []
    for _ in range(n_ref):
        off += 4 + 8 + 32  # n_bin, the stats bin's header and 2 chunks
        n = int(np.frombuffer(data, "<i4", 1, off)[0])
        iv = np.frombuffer(data, "<u8", n, off + 4).astype(np.int64)
        out.append(np.diff(iv))
        off += 4 + 8 * n
    return out


def _oracle_cn(d) -> float:
    """GetCN (indexcov.go:957-991) in numpy."""
    nz = np.sort(d[d != 0])
    if nz.size == 0:
        return float(np.float32(-0.1))
    lows = int((nz < np.float32(0.02)).sum())
    if lows / d.size > 0.3:
        nz = nz[lows:]
    if nz.size == 0:
        return 0.0
    return float(np.float32(2) * nz[(2 * nz.size) // 5])


def indexcov_oracle(bais, contigs=HG38) -> dict:
    """From the raw indexes: per-sample median by capped cumsum, float32
    scaled depth, the bed.gz body ("%.3g"), the ped's CN of chrX and chrY,
    the autosome bin counters, and the PCA of the autosomes' quantized
    depths in float64 with each component's tolerance (pca_tolerances)
    → {"bed", "cn", "counters", "pcs", "pca_rtol"}."""
    depths = []
    for p in bais:
        sizes = _fab_sizes(p, len(contigs))
        flat = np.sort(np.concatenate(sizes))
        cum = np.cumsum(np.minimum(flat, flat[int(0.98 * len(flat))]))
        idx = int(np.searchsorted(cum, int(cum[-1]) // 2, side="right"))
        med = float(flat[min(idx, len(flat) - 1)])
        depths.append([np.minimum((s.astype(np.float64) / med).astype(
            np.float32), np.float32(50000)) for s in sizes])
    body = []
    cn = {}
    cnt = {k: np.zeros(len(bais), np.int64) for k in ("in", "out", "hi",
                                                      "lo")}
    lo85, hi115 = np.float32(0.85), np.float32(1.15)
    quantized = []
    for ci, (name, _) in enumerate(contigs):
        mat = np.stack([d[ci] for d in depths])  # equal lengths here
        cells = np.char.mod("%.3g", mat.T)
        starts = np.arange(mat.shape[1], dtype=np.int64) * IC_TILE
        body += [f"{name}\t{s}\t{s + IC_TILE}\t" + "\t".join(c) + "\n"
                 for s, c in zip(starts.tolist(), cells.tolist())]
        if name in ("chrX", "chrY"):
            cn[name] = ["%.2f" % _oracle_cn(r) for r in mat]
        else:
            cnt["in"] += ((mat >= lo85) & (mat <= hi115)).sum(axis=1)
            cnt["out"] += ((mat < lo85) | (mat > hi115)).sum(axis=1)
            cnt["hi"] += (mat > hi115).sum(axis=1)
            cnt["lo"] += (mat < np.float32(0.15)).sum(axis=1)
            # PCA input: capped at CN 8, uint16 quantized (indexcov.go:698)
            capped = np.minimum(mat, np.float32(8.0))
            quantized.append((np.float32(65535.0 / 8.0) * capped
                              + np.float32(0.5)).astype(np.uint16))
    x = np.concatenate(quantized, axis=1).astype(np.float64)
    k = min(5, len(bais))
    _, _, vt = np.linalg.svd(x - x.mean(axis=0), full_matrices=False)
    return {"bed": "".join(body), "cn": cn, "counters": cnt,
            "pcs": x @ vt[:k].T, "pca_rtol": pca_tolerances(x, k)}


def _pc_columns(header):
    import re

    return [i for i, c in enumerate(header) if re.fullmatch(r"PC\d", c)]


def pca_tolerances(mat, k: int) -> list:
    """Per-component shares (see PCA_GROWTH) from the float64 singular
    values of ``mat``'s column-centred copy, never below PCA_RTOL."""
    x = np.asarray(mat, np.float64)
    return sv_tolerances(np.linalg.svd(x - x.mean(axis=0),
                                       compute_uv=False), k)


def sv_tolerances(sv, k: int) -> list:
    """pca_tolerances from the singular values ``sv`` (descending)."""
    eps = float(np.finfo(np.float32).eps)
    out = []
    for i in range(k):
        gap = min(abs(sv[i] - sv[j]) for j in range(len(sv)) if j != i)
        out.append(max(PCA_RTOL, PCA_GROWTH * eps * sv[0] / max(gap, 1e-30)))
    return out


def _per_component(rtol, n: int) -> list:
    return [float(rtol)] * n if np.ndim(rtol) == 0 else list(rtol)


def pcs_up_to_sign(got, want, what: str, rtol=PCA_RTOL) -> list:
    """Per component up to sign, within ``rtol`` (one share, or one a
    component) of the component's largest projection (and the 0.01 of a
    %.2f) → each component's error over its scale. A component past the
    centred matrix's rank (n - 1 for n samples) projects onto a
    null-space vector each SVD picks for itself: every sample gets the
    same value, so there both columns must be constant."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tols = _per_component(rtol, want.shape[1])
    errs = []
    for j in range(want.shape[1]):
        if np.ptp(want[:, j]) <= 0.02:
            assert np.ptp(got[:, j]) <= 0.02, (what, j, got[:, j])
            errs.append(0.0)
            continue
        scale = max(float(np.abs(want[:, j]).max()), 1.0)
        err = min(np.abs(got[:, j] - want[:, j]).max(),
                  np.abs(got[:, j] + want[:, j]).max())
        assert err <= tols[j] * scale + 0.01, (what, j, err, scale, tols[j])
        errs.append(err / scale)
    return errs


def ped_pcs(path: str) -> np.ndarray:
    """The PC columns of a .ped, (samples, components)."""
    with open(path) as fh:
        rows = [line.rstrip("\n").split("\t") for line in fh]
    pcs = _pc_columns(rows[0])
    return np.array([[float(r[i]) for i in pcs] for r in rows[1:]])


def _compare_ped(want_path: str, got_path: str, rtol=PCA_RTOL) -> None:
    with open(want_path) as fh:
        want = [line.rstrip("\n").split("\t") for line in fh]
    with open(got_path) as fh:
        got = [line.rstrip("\n").split("\t") for line in fh]
    assert got[0] == want[0] and len(got) == len(want), got_path
    pcs = _pc_columns(want[0])
    for g, w in zip(got[1:], want[1:]):
        assert [v for i, v in enumerate(g) if i not in pcs] == \
            [v for i, v in enumerate(w) if i not in pcs], (g[:3], w[:3])
    if pcs:
        pcs_up_to_sign([[float(r[i]) for i in pcs] for r in got[1:]],
                       [[float(r[i]) for i in pcs] for r in want[1:]],
                       "ped PCs", rtol)


def _pca_charts(page: str):
    """index.html with the pca12/pca13 charts cut out → (the rest, {chart:
    (points (n, 2), axis labels)})."""
    import re

    charts, lines = {}, []
    for line in page.split("\n"):
        m = re.search(r'getElementById\("(pca1[23])"\)', line)
        if m:
            pts = re.findall(r'\{"x": (-?[0-9.e+-]+), "y": (-?[0-9.e+-]+)\}',
                             line)
            labels = re.findall(r'"labelString": "([^"]*)"', line)
            charts[m.group(1)] = (np.array(pts, float), labels)
            continue
        lines.append(line)
    rest = re.sub(r'<div class="chartbox"><canvas id="pca1[23]"[^<]*'
                  r"</canvas></div>", "", "\n".join(lines))
    return rest, charts


def _compare_index_html(want_path: str, got_path: str,
                        rtol=PCA_RTOL) -> None:
    import re

    with open(want_path) as fh:
        want_rest, want = _pca_charts(fh.read())
    with open(got_path) as fh:
        got_rest, got = _pca_charts(fh.read())
    _same_bytes("index.html without its PCA charts", got_rest, want_rest)
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    tols = _per_component(rtol, 3)
    for name in want:
        # pca12 plots PC1 against PC2, pca13 PC1 against PC3
        pcs_up_to_sign(got[name][0], want[name][0], name,
                       [tols[0], tols[int(name[-1]) - 1]])
        for gl, wl in zip(got[name][1], want[name][1]):
            assert gl.split(" (")[0] == wl.split(" (")[0], (gl, wl)
            gv = re.findall(r"\(([0-9.]+)% variance\)", gl)
            wv = re.findall(r"\(([0-9.]+)% variance\)", wl)
            assert len(gv) == len(wv), (gl, wl)
            for a, b in zip(gv, wv):
                assert abs(float(a) - float(b)) <= 0.1 + 1e-9, (gl, wl)


def compare_indexcov_dirs(want: str, got: str, skip=None,
                          pca_rtol=PCA_RTOL) -> dict:
    """Every output of two indexcov runs (both directories named alike:
    the page titles and file names carry the name): byte-identical (the
    .bed.gz decompressed) but the .ped's PC columns and index.html's
    pca12/pca13 charts, which hold per component up to sign within
    ``pca_rtol`` (one share, or one a component); files whose name
    ``skip`` matches are left out → {"files", "png"}."""
    import gzip

    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names, (names, os.listdir(got))
    for f in names:
        if skip is not None and skip.search(f):
            continue
        a, b = os.path.join(want, f), os.path.join(got, f)
        if f.endswith(".ped"):
            _compare_ped(a, b, pca_rtol)
        elif f == "index.html":
            _compare_index_html(a, b, pca_rtol)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                da, db = fa.read(), fb.read()
            if f.endswith(".gz"):
                da, db = gzip.decompress(da), gzip.decompress(db)
            assert da == db, f"{f} differs"
    return {"files": len(names),
            "png": sum(f.endswith(".png") for f in names)}


def _ic_summary(name, rep, cmd_s, stages, wall, n):
    # the bed.gz rows and chart points go through csrc/fastio.cpp
    assert rep["native_io"], f"indexcov {name}: no native library"
    st = {k: stages.get(k, 0.0) for k in IC_STAGES}
    log(f"indexcov {name}: {n} samples; process wall {wall:.3f} s, command "
        f"{cmd_s:.3f} s = {n / cmd_s:.2f} samples/s, import "
        f"{rep['import_seconds']:.3f} s; indexcov_norm launches "
        f"{rep['kernel_launches']['indexcov_norm']}; stage seconds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in st.items()))
    return {"wall_s": wall, "command_s": cmd_s,
            "import_s": rep["import_seconds"], "stage_seconds": st,
            "samples_per_s": n / cmd_s,
            "launches": rep["kernel_launches"]["indexcov_norm"]}


def _rows_of(path: str, chrom: str) -> str:
    """The ``chrom`` rows of a (bed.gz or text) table, in order."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    out, seen = [], False
    with opener(path, "rt") as fh:
        for line in fh:
            if line.startswith(chrom + "\t"):
                out.append(line)
                seen = True
            elif seen:
                break
    assert out, f"no {chrom} rows in {path}"
    return "".join(out)


def _ic_bytes(outdir: str) -> dict:
    return {f: open(os.path.join(outdir, f), "rb").read()
            for f in sorted(os.listdir(outdir))}


def _ic_kill_resume(root, d, fai, head, env) -> dict:
    """indexcov -n on ``head`` under --checkpoint-dir, killed by IC_KILL,
    resumed, and resumed again over the complete store → {run: (its
    summary, its output files' bytes)}."""
    ck = os.path.join(d, "ck")
    out_k = os.path.join(d, "K", "out")
    r, _ = _run_cli(root, ["--inject-faults", IC_KILL, "indexcov", "-d",
                           out_k, "--fai", fai, "-n", "--no-html",
                           "--checkpoint-dir", ck, *head], env)
    assert r.returncode == -9, (r.returncode, r.stderr[-2000:])
    out = {}
    for i, name in enumerate(("resumed", "resumed again")):
        rep_path = os.path.join(d, f"K{i}.json")
        r, wall = _run_cli(root, ["--metrics-out", rep_path, "indexcov",
                                  "-d", out_k, "--fai", fai, "-n",
                                  "--no-html", "--checkpoint-dir", ck,
                                  "--resume", *head], env)
        assert r.returncode == 0, r.stderr[-4000:]
        rep, cmd_s, stages = read_manifest(rep_path, "indexcov")
        out[name] = (_ic_summary(f"run C {name}", rep, cmd_s, stages, wall,
                                 len(head)), _ic_bytes(out_k))
    return out


def indexcov_phase(root: str, workdir: str):
    """``python -m goleft_tpu_torch indexcov`` on fabricated hg38 .bai
    files in fresh processes (launch counts from --metrics-out) →
    (results, (the .bai paths, the .fai, run B's output directory)): run A,
    30 samples with the reports, against a numpy oracle and the port's
    CPU path; run B, IC_SAMPLES with -n (22 indexcov_norm launches),
    its chr21 rows against the CPU path's -c chr21 -n; a 30-sample -n
    run killed by shard:after=5:kill, resumed (the same bytes, fewer
    launches) and resumed again (0 launches)."""
    import torch

    from goleft_tpu_torch.commands.indexcov import run_indexcov

    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    d = os.path.join(workdir, "indexcov")
    os.makedirs(d)
    t0 = time.perf_counter()
    bais, fai = indexcov_fabricate(d, IC_SAMPLES, np.random.default_rng(48))
    n_bins = sum(ln // IC_TILE - 1 for _, ln in HG38)
    fab_s = time.perf_counter() - t0
    log(f"fabricated {IC_SAMPLES} whole-genome .bai files (hg38's 24 "
        f"chromosomes, {n_bins} bins a sample, "
        f"{sum(os.path.getsize(b) for b in bais) / 1e6:.1f} MB) in "
        f"{fab_s:.1f} s")
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GOLEFT_TPU_FAULTS", None)
    try:
        import PIL  # noqa: F401

        pillow = True
    except ImportError:
        pillow = False
    runs = {}

    # run A: the headline, 30 samples with the reports
    head = bais[:IC_HEADLINE]
    out_a = os.path.join(d, "A", "card", "out")
    rep_path = os.path.join(d, "A.json")
    r, wall = _run_cli(root, ["--metrics-out", rep_path, "indexcov", "-d",
                              out_a, "--fai", fai, *head], env)
    if r.returncode != 0:
        raise AssertionError(f"indexcov run A failed ({r.returncode}):\n"
                             f"{r.stderr[-4000:]}")
    rep, cmd_s, stages = read_manifest(rep_path, "indexcov")
    runs["A"] = _ic_summary("run A (default flags, --fai)", rep, cmd_s,
                            stages, wall, len(head))
    assert runs["A"]["launches"] == 0

    # run B: cohort scale, -n
    out_b = os.path.join(d, "B", "card", "out")
    rep_path = os.path.join(d, "B.json")
    r, wall = _run_cli(root, ["--metrics-out", rep_path, "indexcov", "-d",
                              out_b, "--fai", fai, "-n", "--no-html",
                              *bais], env)
    if r.returncode != 0:
        raise AssertionError(f"indexcov run B failed ({r.returncode}):\n"
                             f"{r.stderr[-4000:]}")
    rep, cmd_s, stages = read_manifest(rep_path, "indexcov")
    runs["B"] = _ic_summary("run B (-n --no-html)", rep, cmd_s, stages,
                            wall, len(bais))
    assert runs["B"]["launches"] == 22, runs["B"]["launches"]

    # kill and resume (30 samples, -n, under --checkpoint-dir) and the
    # uninterrupted run they must equal, beside the checks of runs A and B
    out_c = os.path.join(d, "C", "out")
    rep_path = os.path.join(d, "C.json")
    run_c = _BG.submit(_run_cli, root, [
        "--metrics-out", rep_path, "indexcov", "-d", out_c, "--fai", fai,
        "-n", "--no-html", *head], env)
    killed = _BG.submit(_ic_kill_resume, root, d, fai, head, env)

    t0 = time.perf_counter()
    oracle = indexcov_oracle(head)
    import gzip

    with gzip.open(os.path.join(out_a, "out-indexcov.bed.gz"), "rt") as fh:
        fh.readline()
        _same_bytes("run A bed.gz (against the numpy oracle)", fh.read(),
                    oracle["bed"])
    with open(os.path.join(out_a, "out-indexcov.ped")) as fh:
        hdr = fh.readline().rstrip("\n").split("\t")
        prows = [line.rstrip("\n").split("\t") for line in fh]
    col = {c: i for i, c in enumerate(hdr)}
    for chrom in ("chrX", "chrY"):
        got = [r[col["CN" + chrom]] for r in prows]
        assert got == oracle["cn"][chrom], (chrom, got, oracle["cn"][chrom])
    for k, c in (("in", "bins.in"), ("out", "bins.out"), ("hi", "bins.hi"),
                 ("lo", "bins.lo")):
        assert [int(r[col[c]]) for r in prows] == \
            oracle["counters"][k].tolist(), c
    assert [int(r[col["sex"]]) for r in prows] == \
        [1 if s % 2 == 0 else 2 for s in range(len(head))]
    tols = oracle["pca_rtol"]
    pc_err = {"card": pcs_up_to_sign(
        ped_pcs(os.path.join(out_a, "out-indexcov.ped")), oracle["pcs"],
        "run A PCs (card) against the float64 oracle", tols)}
    oracle_s = time.perf_counter() - t0
    out_cpu = os.path.join(d, "A", "cpu", "out")
    t0 = time.perf_counter()
    run_indexcov(head, out_cpu, fai=fai, device="cpu")
    cpu_s = time.perf_counter() - t0
    pc_err["cpu"] = pcs_up_to_sign(
        ped_pcs(os.path.join(out_cpu, "out-indexcov.ped")), oracle["pcs"],
        "run A PCs (CPU path) against the float64 oracle", tols)
    same = compare_indexcov_dirs(out_cpu, out_a, pca_rtol=tols)
    log(f"run A: bed.gz, CNX/CNY, bin counters and sex equal to the numpy "
        f"oracle ({oracle_s:.1f} s); all {same['files']} outputs "
        f"byte-identical to the CPU path ({cpu_s:.1f} s) but the PCA "
        f"columns and charts, equal up to sign; PC errors over each "
        f"component's scale against the float64 oracle, card "
        + ", ".join(f"{e:.2e}" for e in pc_err["card"]) + "; CPU path "
        + ", ".join(f"{e:.2e}" for e in pc_err["cpu"]) + "; tolerances "
        + ", ".join(f"{t:.2e}" for t in tols)
        + f"; PNGs written: {same['png']} (Pillow "
        f"{'installed' if pillow else 'missing'})")
    runs["A"].update(cpu_s=cpu_s, files=same["files"], png=same["png"],
                     pc_err=pc_err, pca_rtol=tols)

    out_c21 = os.path.join(d, "B", "cpu", "out")
    t0 = time.perf_counter()
    run_indexcov(bais, out_c21, fai=fai, chrom="chr21",
                 extra_normalize=True, write_html=False, write_png=False,
                 device="cpu")
    c21_s = time.perf_counter() - t0
    for suffix in (".bed.gz", ".roc"):
        _same_bytes(f"run B chr21 rows of {suffix} (card against the CPU "
                    f"path's -c chr21 -n)",
                    _rows_of(os.path.join(out_b, "out-indexcov" + suffix),
                             "chr21"),
                    _rows_of(os.path.join(out_c21, "out-indexcov" + suffix),
                             "chr21"))
    bed_b = os.path.getsize(os.path.join(out_b, "out-indexcov.bed.gz"))
    log(f"run B: chr21 rows of bed.gz and ROC byte-identical to the CPU "
        f"path's -c chr21 -n ({c21_s:.1f} s); bed.gz {bed_b / 1e6:.1f} MB")
    runs["B"].update(cpu_chr21_s=c21_s, bed_gz_bytes=bed_b)

    r, wall = run_c.result()
    assert r.returncode == 0, r.stderr[-4000:]
    rep, cmd_s, stages = read_manifest(rep_path, "indexcov")
    runs["C"] = _ic_summary("run C (-n --no-html, uninterrupted)", rep,
                            cmd_s, stages, wall, len(head))
    full = runs["C"]["launches"]
    assert full == 22, full
    want = _ic_bytes(out_c)
    for name, (summary, got) in killed.result().items():
        runs[name] = summary
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        for f in want:
            assert got[f] == want[f], f"{name}: {f} differs"
    launches = [runs[name]["launches"]
                for name in ("resumed", "resumed again")]
    assert 0 < launches[0] < full and launches[1] == 0, launches
    log(f"kill and resume: killed by {IC_KILL} (rc -9), resumed with "
        f"{launches[0]} indexcov_norm launches, then {launches[1]} over "
        f"the complete store; both byte-identical to run C ({full} "
        f"launches)")
    return {"fabricate_s": fab_s, "bins_a_sample": n_bins,
            "pillow": pillow, "runs": runs, "out_c": out_c}, \
        (bais, fai, out_b)


# ---- cohortscan and multidepth phases ---------------------------------

#: cohortscan's sample chunks: phase 14's 30 samples in 4 chunks
CS_CHUNK = 8
#: the kill and append runs: the first CS_FIRST samples, then all of them
CS_FIRST = 27
#: --pca sharded's power iterations (cohort/pca.py's default)
CS_ITERS = 32
CS_STAGES = ("index_load", "spill", "norm_scalars", "normalize",
             "qc_blocks", "qc_dispatch", "bed_gz", "roc", "pca_ped")


def scan_pca_oracle(bais, dev, k: int, contigs=HG38):
    """cohortscan's PCA without -n from the raw indexes, in float64 on the
    card: the autosomes' scaled depth (the oracle's own reading of the
    .bai files and median), capped at CN 8 and uint16-quantized → (its
    projections onto the top ``k`` right singular vectors, (samples, k),
    every singular value of the centred matrix, descending)."""
    import torch

    rows = []
    for p in bais:
        sizes = _fab_sizes(p, len(contigs))
        flat = np.sort(np.concatenate(sizes))
        cum = np.cumsum(np.minimum(flat, flat[int(0.98 * len(flat))]))
        idx = int(np.searchsorted(cum, int(cum[-1]) // 2, side="right"))
        med = float(flat[min(idx, len(flat) - 1)])
        d = np.concatenate([sz for (name, _), sz in zip(contigs, sizes)
                            if name not in ("chrX", "chrY")])
        d = np.minimum((d.astype(np.float64) / med).astype(np.float32),
                       np.float32(50000))
        rows.append((np.float32(65535.0 / 8.0)
                     * np.minimum(d, np.float32(8.0))
                     + np.float32(0.5)).astype(np.uint16))
    x = torch.from_numpy(np.stack(rows)).to(dev).double()
    xc = x - x.mean(dim=0)
    evals, u = torch.linalg.eigh(xc @ xc.T)
    sv = evals.flip(0).clamp_min(0).sqrt()
    v = xc.T @ u.flip(1)[:, :k] / sv[:k]
    return (x @ v).cpu().numpy(), sv.cpu().numpy()


def sharded_tolerances(sv, k: int, n_bins: int,
                       iters: int = CS_ITERS) -> list:
    """Per component, the larger of sv_tolerances' share and the block
    power iteration's own bound after ``iters`` steps on the Gram
    operator: sqrt(n_bins) (the random start's angle) times
    (sigma_{k+1} / sigma_j)^(2 iters). Where that bound reaches 1 the
    iteration has not resolved the component (its singular value is not
    separated from the (k+1)-th), and the share is infinite: the
    component is not held."""
    out = []
    for j, t in enumerate(sv_tolerances(sv, k)):
        bound = float(np.sqrt(n_bins) * (sv[k] / sv[j]) ** (2 * iters))
        out.append(float("inf") if bound >= 1 else max(t, bound))
    return out


def _cs_run(root, d, name, what, args, env, n) -> dict:
    """One ``python -m goleft_tpu_torch cohortscan`` run in a fresh
    process → its seconds, stage totals, launches and QC counters (from
    its --metrics-out run manifest)."""
    rep_path = os.path.join(d, name + ".json")
    r, wall = _run_cli(root, ["--metrics-out", rep_path, "cohortscan",
                              *args], env)
    if r.returncode != 0:
        raise AssertionError(f"cohortscan {what} failed ({r.returncode}):"
                             f"\n{r.stderr[-4000:]}")
    rep, cmd_s, stages = read_manifest(rep_path, "cohortscan")
    assert rep["native_io"], f"cohortscan {what}: no native library"
    c = rep["metrics"]["counters"]
    out = {"wall_s": wall, "command_s": cmd_s,
           "import_s": rep["import_seconds"],
           "stage_seconds": {k: stages.get(k, 0.0) for k in CS_STAGES},
           "samples_per_s": n / cmd_s,
           "launches": rep["kernel_launches"]["indexcov_norm"],
           "computed": c.get("cohort.chrom_qc_samples_computed_total", 0),
           "resumed": c.get("cohort.chrom_qc_samples_resumed_total", 0)}
    log(f"cohortscan {what}: {n} samples; process wall {wall:.3f} s, "
        f"command {cmd_s:.3f} s = {out['samples_per_s']:.2f} samples/s, "
        f"import {out['import_s']:.3f} s; indexcov_norm launches "
        f"{out['launches']}; QC blocks computed {out['computed']}, resumed "
        f"{out['resumed']}; stage seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in out["stage_seconds"].items()))
    return out


def _scan_files(outdir: str) -> dict:
    """bed.gz (decompressed) and .roc bytes, and the .ped's path, of a
    cohortscan or indexcov output directory named ``out``."""
    import gzip

    base = os.path.join(outdir, "out-indexcov")
    with gzip.open(base + ".bed.gz", "rb") as fh:
        bed = fh.read()
    with open(base + ".roc", "rb") as fh:
        roc = fh.read()
    return {"bed": bed, "roc": roc, "ped": base + ".ped"}


def _same_scan(what: str, want: dict, got: dict, rtol=PCA_RTOL) -> bool:
    """bed.gz and .roc byte-identical, the .ped but its PC columns too,
    the PCs up to sign within ``rtol`` → whether the .ped is
    byte-identical as well."""
    assert got["bed"] == want["bed"], f"{what}: bed.gz differs"
    assert got["roc"] == want["roc"], f"{what}: .roc differs"
    _compare_ped(want["ped"], got["ped"], rtol)
    with open(want["ped"], "rb") as a, open(got["ped"], "rb") as b:
        return a.read() == b.read()


def _journal_blocks(ck: str) -> int:
    with open(os.path.join(ck, "journal.jsonl")) as fh:
        return sum(1 for line in fh if line.strip() and '"k"' in line)


def _cs_kill_append(root, d, bais, base, ck, out_a, env) -> tuple:
    """cohortscan on the first CS_FIRST samples under --checkpoint-dir
    ``ck``, killed by IC_KILL and resumed, then all of ``bais`` appended
    under --resume with --pca sharded → (the QC blocks committed at the
    kill, the resumed run's summary, the appending run's)."""
    n, chroms = len(bais), len(HG38)
    first = bais[:CS_FIRST]
    ck_args = ["-d", out_a, *base, "--checkpoint-dir", ck]
    r, _ = _run_cli(root, ["--inject-faults", IC_KILL, "cohortscan",
                           *ck_args, *first], env)
    assert r.returncode == -9, (r.returncode, r.stderr[-2000:])
    # the kill fires on the 5th Step; Steps go chromosome by chromosome,
    # chunk by chunk, and a chromosome's chunks are the same everywhere
    sizes = [min(CS_CHUNK, CS_FIRST - lo)
             for lo in range(0, CS_FIRST, CS_CHUNK)]
    steps = [sz for _ in HG38 for sz in sizes]
    kill_at = int(IC_KILL.split("after=")[1].split(":")[0])
    committed = _journal_blocks(ck)
    assert committed == sum(steps[:kill_at - 1]), committed
    run_k = _cs_run(root, d, "K", f"the first {CS_FIRST}, resumed "
                    f"after {IC_KILL}", [*ck_args, "--resume", *first],
                    env, CS_FIRST)
    assert (run_k["computed"], run_k["resumed"]) == \
        (CS_FIRST * chroms - committed, committed), run_k
    run_a = _cs_run(root, d, "A", f"all {n}, appended under --resume "
                    "with --pca sharded",
                    [*ck_args, "--resume", "--pca", "sharded", *bais],
                    env, n)
    assert (run_a["computed"], run_a["resumed"]) == \
        ((n - CS_FIRST) * chroms, CS_FIRST * chroms), run_a
    return committed, run_k, run_a


def cohortscan_phase(root: str, workdir: str, bais, fai, out_b, dev) -> dict:
    """``python -m goleft_tpu_torch cohortscan`` on phase 14's .bai files
    in fresh processes, chunks of CS_CHUNK samples: run S with -n (one
    indexcov_norm launch an autosome and chunk) against phase 14's run B;
    run P without -n, its PCs against a float64 oracle; the first
    CS_FIRST samples killed by IC_KILL and resumed, then all of them
    appended under --resume with --pca sharded (exactly the new samples'
    QC blocks computed): byte-identical to run P but the PCs, which hold
    against the oracle and run P's within the power iteration's
    tolerances."""
    d = os.path.join(workdir, "cohortscan")
    os.makedirs(d)
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GOLEFT_TPU_FAULTS", None)
    n = len(bais)
    n_chunks = -(-n // CS_CHUNK)
    autosomes = sum(1 for name, _ in HG38 if name not in ("chrX", "chrY"))
    chroms = len(HG38)
    base = ["--fai", fai, "--chunk-samples", str(CS_CHUNK)]
    runs = {}

    # run S: -n, the exact PCA: indexcov -n's bytes (phase 14's run B)
    out_s = os.path.join(d, "S", "out")
    runs["S"] = _cs_run(root, d, "S", "run S (-n)",
                        ["-d", out_s, "-n", *base, *bais], env, n)
    assert runs["S"]["launches"] == autosomes * n_chunks, runs["S"]
    assert runs["S"]["computed"] == n * chroms, runs["S"]
    ped_same = _same_scan("run S against indexcov -n (run B)",
                          _scan_files(out_b), _scan_files(out_s))
    ped = "byte-identical" if ped_same else \
        "byte-identical but its PC columns, equal up to sign"
    log(f"run S: bed.gz and .roc byte-identical to indexcov -n (phase 14's "
        f"run B), the .ped {ped}; {runs['S']['launches']} indexcov_norm "
        f"launches = {autosomes} autosomes x {n_chunks} chunks")

    # the first CS_FIRST samples killed, resumed, then all of them
    # appended with --pca sharded, beside run P
    ck = os.path.join(d, "ck")
    out_a = os.path.join(d, "A", "out")
    chain = _BG.submit(_cs_kill_append, root, d, bais, base, ck, out_a,
                       env)

    # run P: without -n, the exact PCA: the bytes the appended store must
    # give; its PCs against the float64 oracle
    out_p = os.path.join(d, "P", "out")
    runs["P"] = _cs_run(root, d, "P", "run P (without -n)",
                        ["-d", out_p, *base, *bais], env, n)
    assert runs["P"]["launches"] == 0, runs["P"]
    assert runs["P"]["computed"] == n * chroms, runs["P"]
    t0 = time.perf_counter()
    k = min(5, n)
    pcs, sv = scan_pca_oracle(bais, dev, k, HG38)
    n_bins = sum(ln // IC_TILE - 1 for name, ln in HG38
                 if name not in ("chrX", "chrY"))
    tol_exact = sv_tolerances(sv, k)
    tol_sharded = sharded_tolerances(sv, k, n_bins)
    files_p = _scan_files(out_p)
    err_p = pcs_up_to_sign(ped_pcs(files_p["ped"]), pcs,
                           "run P PCs (exact) against the float64 oracle",
                           tol_exact)
    oracle_s = time.perf_counter() - t0
    log(f"run P: PC errors over each component's scale against the float64 "
        f"oracle ({oracle_s:.1f} s) "
        + ", ".join(f"{e:.2e}" for e in err_p) + "; tolerances "
        + ", ".join(f"{t:.2e}" for t in tol_exact) + "; singular values "
        + ", ".join(f"{v:.6g}" for v in sv[:k + 1]))

    committed, runs["K"], runs["A"] = chain.result()
    from goleft_tpu_torch.cohort.manifest import CohortManifest

    man = CohortManifest.load(os.path.join(out_a,
                                           "out-indexcov.manifest.json"))
    assert (man.counters["samples_new"], man.counters["samples_unchanged"],
            man.counters["chrom_qc_samples_computed_total"]) == \
        (n - CS_FIRST, CS_FIRST, (n - CS_FIRST) * chroms), man.counters
    files_a = _scan_files(out_a)
    _same_scan("run A (appended, --pca sharded) against run P (exact)",
               files_p, files_a, tol_sharded)
    err_a = pcs_up_to_sign(ped_pcs(files_a["ped"]), pcs,
                           "run A PCs (--pca sharded) against the float64 "
                           "oracle", tol_sharded)
    log(f"kill and append: killed by {IC_KILL} (rc -9) with {committed} QC "
        f"blocks committed, resumed, then {n - CS_FIRST} samples appended: "
        f"{runs['A']['computed']} QC blocks computed = {n - CS_FIRST} x "
        f"{chroms} chromosomes, {runs['A']['resumed']} resumed; bed.gz, .roc "
        f"and the .ped but its PCs byte-identical to run P; --pca sharded "
        f"PC errors against the float64 oracle "
        + ", ".join(f"{e:.2e}" for e in err_a) + "; tolerances "
        + ", ".join(f"{t:.2e}" for t in tol_sharded))
    return {"chunks": n_chunks, "ped_byte_identical": ped_same,
            "committed_at_kill": committed, "pc_err_sharded": err_a,
            "pc_err_exact": err_p, "pca_rtol_sharded": tol_sharded,
            "pca_rtol_exact": tol_exact, "oracle_s": oracle_s,
            "singular_values": [float(v) for v in sv[:k + 1]],
            "runs": runs}


#: multidepth's per-base cap and MAPQ cutoff (the command's defaults)
MD_MAX_COV = 1000
MD_MAPQ = 10


def multidepth_kernel_check(dev, bam: str, start: int, end: int) -> dict:
    """The depth kernel at one multidepth chunk's shapes (dense, window 1,
    the chunk as the region, cap MD_MAX_COV) on both wires, against its
    plain version on the card on the same inputs: depth and window-1
    sums bitwise; the kernel's and the plain version's ms."""
    import torch

    from goleft_tpu_torch.commands.depth import _decode_shard_segments
    from goleft_tpu_torch.io.bai import read_bai
    from goleft_tpu_torch.io.bam import open_bam_file
    from goleft_tpu_torch.ops import depth_kernel as dk
    from goleft_tpu_torch.ops.coverage import pack_segments_u16

    ss, ee = _decode_shard_segments(open_bam_file(bam),
                                    read_bai(bam + ".bai"), 0, start, end,
                                    MD_MAPQ)
    length = end - start
    scal = (start, start, end, MD_MAX_COV, 0, 0)
    dd, ll, base, _ = pack_segments_u16(ss, ee, slice(None))
    wire = (torch.from_numpy(dd).to(dev), torch.from_numpy(ll).to(dev))
    seg = (torch.from_numpy(ss).to(dev), torch.from_numpy(ee).to(dev),
           torch.ones(len(ss), dtype=torch.bool, device=dev))
    out = {"segments": int(len(ss)), "length": length}
    # the bound counts the bytes multidepth needs: each segment read once
    # (4 B on the u16 wire; start, end and the mask on the int32 one) and
    # the int32 depth written once; the dense output also carries the
    # classes, the window-1 sums and the packed classes, which multidepth
    # does not read
    for name, kern, plain, args, seg_bytes in (
            ("u16", dk.fused_depth_wire, dk.fused_depth_wire_plain,
             (*wire, int(base)), 4),
            ("int32", dk.fused_depth, dk.fused_depth_plain, seg, 9)):
        got = kern(*args, *scal, length=length, window=1, dense=True)
        want = plain(*args, *scal, length, 1)
        assert torch.equal(got[3], want[3]), f"multidepth {name}: depth"
        assert torch.equal(got[0], want[0]), f"multidepth {name}: sums"
        nbytes = seg_bytes * len(ss) + 4 * length
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (8 * length + 10 * len(ss)) / INT_OPS_PER_S * 1e3
        out[name] = {
            "ms": cuda_median_ms(lambda: kern(*args, *scal, length=length,
                                              window=1, dense=True)),
            "plain_ms": cuda_median_ms(lambda: plain(*args, *scal, length,
                                                     1), reps=5),
            "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return out


def _md_run(root, workdir, name, what, bams, n_bp, env, dev) -> dict:
    """``python -m goleft_tpu_torch multidepth -c chr1`` in a fresh
    process against the port's ``run_multidepth(device="cpu")``."""
    import io

    from goleft_tpu_torch.commands.multidepth import run_multidepth

    rep_path = os.path.join(workdir, f"md_{name}.json")
    r, wall = _run_cli(root, ["--metrics-out", rep_path, "multidepth", "-c",
                              "chr1", *bams], env)
    if r.returncode != 0:
        raise AssertionError(f"multidepth {what} failed ({r.returncode}):\n"
                             f"{r.stderr[-4000:]}")
    rep, cmd_s, stages = read_manifest(rep_path, "multidepth")
    t0 = time.perf_counter()
    buf = io.StringIO()
    run_multidepth(bams, "chr1", out=buf, device="cpu")
    cpu_s = time.perf_counter() - t0
    _diff_rows(f"multidepth {what} (card against the CPU path)", r.stdout,
               buf.getvalue())
    out = {"wall_s": wall, "command_s": cmd_s,
           "import_s": rep["import_seconds"], "cpu_s": cpu_s,
           "launches": rep["kernel_launches"]["depth"],
           "rows": len(r.stdout.splitlines()) - 1,
           "sample_bp_per_s": len(bams) * n_bp / cmd_s}
    log(f"multidepth {what}: {len(bams)} samples x {n_bp} bp; process wall "
        f"{wall:.3f} s, command {cmd_s:.3f} s = "
        f"{out['sample_bp_per_s'] / 1e6:.3f} M sample-bp/s, import "
        f"{out['import_s']:.3f} s; depth launches {out['launches']}; "
        f"{out['rows']} blocks, byte-identical to the CPU path "
        f"({cpu_s:.1f} s)")
    return out


def multidepth_phase(root: str, workdir: str, dev, cnv_bams,
                     bam: str) -> dict:
    """The depth kernel at multidepth's shapes, then ``python -m
    goleft_tpu_torch multidepth`` on phase 12's BAMs (one 4 Mb chunk:
    a launch a sample) and on phase 4's 25 Mb BAM given twice (5 chunks:
    runs crossing chunk boundaries), each byte-identical to the port's
    CPU path."""
    from goleft_tpu_torch.commands.multidepth import CHUNK

    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GOLEFT_TPU_FAULTS", None)
    kern = multidepth_kernel_check(dev, bam, CHUNK, 2 * CHUNK)
    log(f"depth kernel at multidepth's shapes ({kern['segments']} segments "
        f"over {kern['length']} bases, dense, window 1): bitwise equal to "
        f"the plain version on the card; "
        + "; ".join(f"{w} wire {kern[w]['ms']:.4f} ms (plain "
                    f"{kern[w]['plain_ms']:.4f}), bound "
                    f"{kern[w]['bound_ms']:.4f} ms ({kern[w]['bound_by']}: "
                    f"{kern[w]['bytes']} bytes, the int32 depth out)"
                    for w in ("u16", "int32")))
    runs = {"cnv": _md_run(root, workdir, "cnv", "on phase 12's BAMs",
                           cnv_bams, CNV_LEN, env, dev),
            "e2e": _md_run(root, workdir, "e2e", "on phase 4's BAM twice",
                           [bam, bam], E2E_LEN, env, dev)}
    assert runs["cnv"]["launches"] == len(cnv_bams) * -(-CNV_LEN // CHUNK)
    assert runs["e2e"]["launches"] == 2 * -(-E2E_LEN // CHUNK)
    assert runs["e2e"]["rows"] > 0 and runs["cnv"]["rows"] > 0
    return {"kernel": kern, "runs": runs}


# ---- mapper phases: the swalign kernel, seeding, then the command ------

#: the map phase's genome: two contigs cut from a human-sized reference
MAP_CONTIGS = (("chr1", 6_000_000), ("chr2", 4_000_000))
#: ten full batches of the reference's DEFAULT_BATCH (4,096 reads)
MAP_READS = 20_480
MAP_BATCH = 4096
MAP_LEN = (100, 150)
MAP_FAULT = "map:after=3:transient"
MAP_CORRUPT_AT = 3000  # the corrupt record of the exit-3 run
SW_B = 4096  # pairs of the kernel phase's main bucket (a batch)
SW_BAND = 32  # the reference's DEFAULT_BAND: windows are read + 2 x band
SW_ORACLE_PAIRS = 64


def sw_pairs(rng, n: int, read_len: int):
    """``n`` (read codes, window codes) pairs as the mapper extends them:
    a window of read_len + 2 x band random bases and the read from its
    middle, with two substitutions, one base inserted or deleted in half
    of the reads and an N in a tenth of them."""
    reads, wins = [], []
    wlen = read_len + 2 * SW_BAND
    for _ in range(n):
        win = rng.integers(0, 4, wlen).astype(np.uint8)
        read = win[SW_BAND:SW_BAND + read_len].copy()
        read[rng.integers(0, read_len, 2)] = rng.integers(0, 4, 2)
        if rng.random() < 0.5:
            k = int(rng.integers(1, read_len - 1))
            read = (np.concatenate([read[:k], rng.integers(0, 4, 1).astype(
                np.uint8), read[k:-1]]) if rng.random() < 0.5
                else np.concatenate([read[:k], read[k + 1:], win[
                    SW_BAND + read_len:SW_BAND + read_len + 1]]))
        if rng.random() < 0.1:
            read[int(rng.integers(0, read_len))] = 4
        reads.append(read)
        wins.append(win)
    return reads, wins


def _sw_literal(read: bytes, win: bytes):
    from goleft_tpu_torch.ops.pairhmm import encode_seq

    return [encode_seq(read)], [encode_seq(win)]


def sw_case(name: str):
    """(reads_p, rlens, wins_p, wlens) of ``SW_CASES[name]``, packed as
    ``ops/swalign.py::_pack_bucket`` packs a bucket."""
    from goleft_tpu_torch.ops import swalign

    reads, wins = SW_CASES[name](np.random.default_rng(len(name)))
    r_pad = max(swalign.bucket_shape(len(r), 1)[0] for r in reads)
    w_pad = max(swalign.bucket_shape(1, len(w))[1] for w in wins)
    reads_p, rlens, wins_p, wlens = swalign._pack_bucket(
        list(range(len(reads))), reads, wins, r_pad, w_pad)
    if name == "wlen_past_pad":
        # a window length past the bucket's width, which _pack_bucket
        # never makes: the column is clipped to the last one, as the
        # reference clips it
        wlens = wlens + 20
    return reads_p, rlens, wins_p, wlens


#: the kernel phase's buckets; "main" is a batch of 150 bp reads at the
#: reference's DEFAULT_BAND (r1 161, w_pad 256, 417 steps)
SW_CASES = {
    "main": lambda rng: sw_pairs(rng, SW_B, 150),
    "long_1100bp": lambda rng: sw_pairs(rng, 8, 1100),  # r1 1121
    "very_long_2000bp": lambda rng: sw_pairs(rng, 2, 2000),  # device rows
    "b1": lambda rng: sw_pairs(rng, 1, 150),
    "all_n_read": lambda rng: _sw_literal(b"N" * 150, b"ACGT" * 53),
    "all_mismatch": lambda rng: _sw_literal(b"A" * 150, b"C" * 214),
    "tie": lambda rng: _sw_literal(b"ACGT", b"ACGTTTTTACGT"),
    "wlen_past_pad": lambda rng: _sw_literal(b"ACGTACGTACGT" + b"T" * 12,
                                             b"ACGT" * 16),
}


def _swalign_key(name: str):
    m = re.search(r"sw_warp_kernelILi(\d)E", name)
    return m and f"R{m[1]}"


def sw_cells(rlens, wlens, r1: int, wcap: int) -> int:
    """Cells of the reference's set {1 <= i <= min(rlen, r1 - 1),
    1 <= j <= wlen, i + j <= r1 + wcap - 1}, summed over the pairs."""
    i = np.arange(1, r1)[None, :]
    rows = np.minimum(rlens, r1 - 1)[:, None]
    per = np.clip(np.minimum(wlens[:, None], r1 + wcap - 1 - i), 0, None)
    return int((per * (i <= rows)).sum())


def sw_plane_words(rlens, wlens, r1: int, wcap: int, rpl: int) -> int:
    """32-bit words of the direction plane that the kernel writes: one a
    (band, step, lane) for each of lane L's columns 1 ..
    min(wlen, r1 + wcap - 1 - i0), i0 its band's first row of the lane,
    on the lanes that hold a row of the read, summed over the pairs."""
    rows = np.minimum(rlens, r1 - 1)[:, None]
    i0 = np.arange(0, max(r1 - 1, 1), rpl)[None, :] + 1
    per = np.clip(np.minimum(wlens[:, None], r1 + wcap - 1 - i0), 0, None)
    return int((per * (i0 <= rows)).sum())


def sw_kernel_phase(dev) -> dict:
    """The swalign kernel against its plain version on the card, on every
    ``SW_CASES`` bucket, one counted launch a bucket: best, bi, bj and
    every byte of its unpacked direction plane bitwise, and its run
    buffer, formatted, equal to the host ``traceback`` of the plain
    version's plane on every pair; 64 pairs of the main bucket against
    ``sw_oracle``. Times, at the main bucket, the kernel, the plain
    version (the plain wavefront on the card and the host walk), the
    copy of what ``align_bucket`` brings to the host, and writes the
    bound recounted on the cells these inputs need."""
    import torch

    from goleft_tpu_torch.ops import swalign
    from goleft_tpu_torch.ops import swalign_kernel as sk

    sc = torch.tensor(swalign.DEFAULT_SCORES.astuple(), dtype=torch.int32,
                      device=dev)
    out = {"cases": {}}
    err = 0
    for name in SW_CASES:
        host = sw_case(name)
        t = [torch.from_numpy(a).to(dev) for a in host] + [sc]
        b, r1 = host[0].shape
        wcap = host[2].shape[1]
        before = sk.LAUNCHES["swalign"]
        meta, runs, plane, plan = sk.launch(*t)
        torch.cuda.synchronize()
        assert sk.LAUNCHES["swalign"] == before + 1, name
        dirs = swalign.unpack_dirs(plane, plan.rows_per_lane, t[1], t[3],
                                   r1, wcap)
        want = swalign.sw_bucket_plain(*t)
        torch.cuda.synchronize()
        for what, g, w in zip(("best", "bi", "bj", "dirs"),
                              (meta[0], meta[1], meta[2], dirs), want):
            err = max(err, int((g.long() - w.long()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(
                    f"swalign {name}: {what} differs from the plain "
                    f"version at {int((g != w).sum())} entries")
        meta_h = meta.cpu().numpy()
        got = swalign.alignments(
            meta_h, runs[:max(1, int(meta_h[5].max()))].cpu().numpy())
        wb, wi, wj, wd = (x.cpu().numpy() for x in want)
        for n in range(b):
            exp = (int(wb[n]),) + swalign.traceback(wd[n], wi[n], wj[n])
            if tuple(got[n]) != exp:
                raise AssertionError(f"swalign {name}: pair {n}'s walk on "
                                     f"the card {tuple(got[n])} is not the "
                                     f"host traceback's {exp}")
        out["cases"][name] = {"pairs": b, "r1": r1, "w_pad": wcap,
                              "plan": plan._asdict(),
                              "best_max": int(meta_h[0].max())}
        if name == "main":
            main = (t, host, meta_h, got, dirs.cpu().numpy())
        if name in ("all_n_read", "all_mismatch"):
            assert int(meta_h[0].max()) == 0, name
        if name == "tie":
            assert [int(x[0]) for x in meta_h[:3]] == [8, 4, 4], name
        if name == "wlen_past_pad":
            assert int(meta_h[2][0]) > wcap, name
    main_t, (reads_p, rlens, wins_p, wlens), meta_h, got, dirs = main
    for n in range(SW_ORACLE_PAIRS):
        r, w = int(rlens[n]), int(wlens[n])
        ob, oi, oj, od = swalign.sw_oracle(reads_p[n, 1:r + 1],
                                           wins_p[n, :w])
        assert tuple(int(x) for x in meta_h[:3, n]) == (ob, oi, oj), n
        assert np.array_equal(dirs[n, :r + w + 1, :r + 1], od), n
        assert not dirs[n, r + w + 1:].any() and not dirs[n, :, r + 1:].any()
        assert tuple(got[n]) == (ob,) + swalign.traceback(od, oi, oj), n
    b, r1 = reads_p.shape
    wcap = wins_p.shape[1]
    ms = cuda_median_ms(lambda: sk.launch(*main_t))
    plain_ms = cuda_median_ms(lambda: swalign.sw_align_plain(*main_t),
                              reps=3)
    wave_ms = cuda_median_ms(lambda: swalign.sw_bucket_plain(*main_t),
                             reps=3)
    meta, runs, plane, _ = sk.launch(*main_t)
    filled = int(meta_h[5].max())
    copy_ms = cuda_median_ms(lambda: (meta.cpu(), runs[:filled].cpu()),
                             reps=5)
    cells = sw_cells(rlens, wlens, r1, wcap)
    words = sw_plane_words(rlens, wlens, r1, wcap,
                           out["cases"]["main"]["plan"]["rows_per_lane"])
    ops = cells * sk.OPS_PER_CELL
    n_runs = int(meta_h[5].sum())
    moved = (b * r1 + b * wcap + 8 * b + 16) + (24 * b + 4 * n_runs)
    t_ops = ops / INT_OPS_PER_S * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    copied = 24 * b + 4 * filled * b
    out.update(ms=ms, plain_ms=plain_ms, plain_wavefront_ms=wave_ms,
               copy_ms=copy_ms, copied_bytes=copied, cells=cells,
               plane_words=words, plane_alloc_bytes=plane.numel() * 4,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               ops_ms=t_ops, bytes_ms=t_bytes, max_abs_err=err,
               ptxas=kernel_resources(sk.BUILD_LOG, key=_swalign_key))
    log(f"swalign kernel: bitwise equal to the plain version on the card "
        f"on {len(SW_CASES)} buckets, one launch each, and its walk equal "
        f"to the host traceback on every pair (" + ", ".join(
            f"{k} {v['pairs']} x r1 {v['r1']} x w_pad {v['w_pad']} (R "
            f"{v['plan']['rows_per_lane']}, {v['plan']['bands']} band"
            f"{'s' if v['plan']['bands'] > 1 else ''})"
            for k, v in out["cases"].items()) + "), "
        f"{SW_ORACLE_PAIRS} pairs of the main bucket equal to sw_oracle; "
        f"main bucket ({b} pairs, r1 {r1}, w_pad {wcap}, {cells} cells): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms (its wavefront "
        f"{wave_ms:.2f}), align_bucket's copy {copy_ms:.4f} ms ({copied} "
        f"bytes); the plane, on the card: direction bits of {cells} "
        f"cells at 4 bits a cell, counted from the inputs, in {words} "
        f"32-bit words written ({4 * words} bytes), {plane.numel() * 4} "
        f"bytes allocated; bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}: {cells} cells x "
        f"{sk.OPS_PER_CELL} int32 ops at {INT_OPS_PER_S:.3g}/s = "
        f"{t_ops:.4f} ms; {moved} bytes at {HBM_BYTES_PER_S:.3g}/s = "
        f"{t_bytes:.4f} ms), the kernel {ms / out['bound_ms']:.2f}x it; "
        f"ptxas " + json.dumps(out["ptxas"]))
    return out


def map_fabricate(workdir: str, rng):
    """The map phase's reference (``MAP_CONTIGS`` of random bases) and
    ``MAP_READS`` reads of 100-150 bp on both strands, with two
    substitutions each, an inserted or deleted base in a third of them
    and an N in a tenth → (fasta, fastq, truth [(chrom, start, rev)],
    FASTQ records as bytes)."""
    contigs = {c: rng.integers(0, 4, n).astype(np.uint8)
               for c, n in MAP_CONTIGS}
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    fa = os.path.join(workdir, "map_ref.fa")
    with open(fa, "wb") as fh:
        for c, codes in contigs.items():
            seq = acgt[codes].tobytes()
            fh.write(f">{c}\n".encode())
            fh.write(b"\n".join(seq[i:i + 60]
                                for i in range(0, len(seq), 60)) + b"\n")
    names = [c for c, _ in MAP_CONTIGS]
    weights = np.array([n for _, n in MAP_CONTIGS], float)
    which = rng.choice(len(names), MAP_READS, p=weights / weights.sum())
    lens = rng.integers(MAP_LEN[0], MAP_LEN[1] + 1, MAP_READS)
    comp = np.array([3, 2, 1, 0, 4], np.uint8)
    truth, recs = [], []
    for i in range(MAP_READS):
        c = names[which[i]]
        ln = int(lens[i])
        s = int(rng.integers(0, len(contigs[c]) - ln - 1))
        frag = contigs[c][s:s + ln + 1].copy()
        frag[rng.integers(0, ln, 2)] = rng.integers(0, 4, 2)
        u = rng.random()
        k = int(rng.integers(10, ln - 10))
        if u < 1 / 6:
            frag = np.concatenate([frag[:k], [int(rng.integers(0, 4))],
                                   frag[k:]])
        elif u < 1 / 3:
            frag = np.concatenate([frag[:k], frag[k + 1:]])
        frag = frag[:ln]
        if rng.random() < 0.1:
            frag[int(rng.integers(0, ln))] = 4
        rev = bool(rng.random() < 0.5)
        if rev:
            frag = comp[frag[::-1]]
        seq = acgt[frag].tobytes()
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * ln))
        truth.append((c, s, rev))
    fq = os.path.join(workdir, "map_reads.fq")
    with open(fq, "wb") as fh:
        fh.write(b"".join(recs))
    return fa, fq, truth, recs


def _placed(rows: list[str], truth) -> int:
    """Tuples within ±5 bp of their read's origin, on its strand."""
    ok = 0
    for row in rows:
        chrom, s, _, name, _, strand = row.split("\t")
        tc, ts, trev = truth[int(name[1:])]
        ok += (chrom == tc and abs(int(s) - ts) <= 5
               and strand == ("-" if trev else "+"))
    return ok


def _cli_in_process(argv: list[str]) -> tuple[int, str]:
    """``goleft_tpu_torch.cli.main(argv)`` in this process (the index
    cache of mapping/index.py is shared), stdout captured."""
    import contextlib
    import io

    from goleft_tpu_torch import cli
    from goleft_tpu_torch.resilience import faults

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        faults.install(None)
    return rc, buf.getvalue()


def map_phase(root: str, workdir: str, dev, tools_bam: str) -> dict:
    """``python -m goleft_tpu_torch map --depth-out`` on ``MAP_READS``
    fabricated reads against a 10 Mb reference at the reference's
    defaults (k 13, w 8, band 32, max-occ 64, batch 4,096): ≥ 95% placed
    within ±5 bp on their strand, the first batch's tuples byte-identical
    to the port's CPU path, the ``--from-tuples`` bed byte-identical, the
    depth kernel bitwise equal to its plain version at map's inputs and
    the bed byte-identical to the CPU path's on the same tuples, a
    transient ``map`` fault retried to the same bytes, a FASTQ corrupted
    mid-stream exits 3 with the rows before it; seeding on the card held
    to ``seed_reads_host`` on 4,096 reads; then goleft's six host tools
    once each on earlier fixtures."""
    import torch

    from goleft_tpu_torch.commands.map_cmd import DEFAULT_WINDOW, run_map
    from goleft_tpu_torch.mapping import get_index, pipeline
    from goleft_tpu_torch.ops import depth_kernel as dk
    from goleft_tpu_torch.ops.pairhmm import encode_seq

    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GOLEFT_TPU_FAULTS", None)
    t0 = time.perf_counter()
    fa, fq, truth, recs = map_fabricate(workdir, np.random.default_rng(41))
    log(f"fabricated a {sum(n for _, n in MAP_CONTIGS)} bp reference and "
        f"{MAP_READS} reads in {time.perf_counter() - t0:.1f} s")
    tup = os.path.join(workdir, "map.tsv")
    bed = os.path.join(workdir, "map.depth.bed")
    rep_path = os.path.join(workdir, "map.json")
    r, wall = _run_cli(root, ["--metrics-out", rep_path, "map", fa, fq,
                              "-o", tup, "--depth-out", bed], env)
    if r.returncode != 0:
        raise AssertionError(f"map failed ({r.returncode}):\n"
                             f"{r.stderr[-4000:]}")
    rep, cmd_s, stages = read_manifest(rep_path, "map")
    launches = rep["kernel_launches"]
    assert launches["swalign"] >= MAP_READS // MAP_BATCH, launches
    assert launches["depth"] == len(MAP_CONTIGS), launches
    with open(tup) as fh:
        card = fh.read()
    rows = card.splitlines()
    placed = _placed(rows, truth)
    assert placed >= 0.95 * MAP_READS, (placed, MAP_READS)
    split = {k: stages.get(k, 0.0) for k in (
        "index-build", "seed", "extend-kernel", "extend-d2h", "traceback",
        "depth")}
    split["import"] = rep["import_seconds"]
    split["unattributed"] = cmd_s - sum(split.values())
    log(f"map CLI: {MAP_READS} reads, {len(rows)} mapped, {placed} "
        f"({100 * placed / MAP_READS:.2f}%) within ±5 bp on their strand; "
        f"process wall {wall:.3f} s, command {cmd_s:.3f} s = "
        f"{MAP_READS / cmd_s:.0f} reads/s; seconds " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items())
        + f"; launches swalign {launches['swalign']}, depth "
        f"{launches['depth']}")

    # the port's CPU path on the first batch, the fault and corrupt runs
    # and the --from-tuples rerun, in this process on one index
    t0 = time.perf_counter()
    index = get_index(fa)
    index_s = time.perf_counter() - t0
    fq1 = os.path.join(workdir, "map_batch1.fq")
    with open(fq1, "wb") as fh:
        fh.write(b"".join(recs[:MAP_BATCH]))
    first = "".join(row + "\n" for row in rows
                    if int(row.split("\t")[3][1:]) < MAP_BATCH)
    first_tsv = os.path.join(workdir, "map_first.tsv")
    with open(first_tsv, "w") as fh:
        fh.write(first)
    cpu_tup = os.path.join(workdir, "map_cpu.tsv")
    t0 = time.perf_counter()
    assert run_map(fa, fq1, out=cpu_tup, device="cpu") == 0
    cpu_s = time.perf_counter() - t0
    with open(cpu_tup) as fh:
        _same_bytes("map: the first batch's tuples (card against the CPU "
                    "path)", first, fh.read())
    bed2 = os.path.join(workdir, "map.rerun.bed")
    rc, _ = _cli_in_process(["map", fa, "--from-tuples", tup, "--depth-out",
                             bed2])
    assert rc == 0
    with open(bed) as a, open(bed2) as b:
        card_bed = a.read()
        _same_bytes("map --from-tuples (against the fused --depth-out)",
                    b.read(), card_bed)
    # the depth kernel at map's own inputs (segments in read order on the
    # int32 wire, dense, window 1, no cap, a 6 Mb and a 4 Mb contig):
    # against its plain version on the card, then the card's bed against
    # the CPU path's on the same tuples
    t0 = time.perf_counter()
    tuples = pipeline.parse_tuples(card.encode())
    lengths = dict(MAP_CONTIGS)
    depth_err, depth_segs = 0, {}
    for chrom, clen, ss, se, keep in pipeline.depth_segments(tuples,
                                                             lengths):
        seg = [torch.from_numpy(a).to(dev) for a in (ss, se, keep)]
        scal = (0, 0, clen, 0x7FFFFFFF, 0, 0)
        got = dk.fused_depth(*seg, *scal, length=clen, window=1, dense=True)
        want = dk.fused_depth_plain(*seg, *scal, clen, 1)
        for what, g, w in (("depth", got[3], want[3]),
                           ("sums", got[0], want[0])):
            depth_err = max(depth_err, float((g.double() - w.double())
                                             .abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(
                    f"map --depth-out {chrom}: the depth kernel's {what} "
                    f"differ from its plain version at "
                    f"{int((g != w).sum())} entries")
        depth_segs[chrom] = int(keep.sum())
    cpu_bed = pipeline.depth_bed_from_tuples(
        tuples, lengths, DEFAULT_WINDOW, device="cpu").decode()
    _same_bytes("map --depth-out (the card's bed against the CPU path's)",
                card_bed, cpu_bed)
    log(f"map --depth-out: the depth kernel bitwise equal to its plain "
        f"version on the card at map's inputs ({depth_segs} segments in "
        f"read order), the card's bed byte-identical to the CPU path's "
        f"({time.perf_counter() - t0:.1f} s)")
    faulty = os.path.join(workdir, "map_fault.tsv")
    rc, _ = _cli_in_process(["--inject-faults", MAP_FAULT, "map", fa, fq1,
                             "-o", faulty])
    assert rc == 0, rc
    with open(faulty) as fh:
        _same_bytes(f"map under {MAP_FAULT}", fh.read(), first)
    bad = os.path.join(workdir, "map_corrupt.fq")
    with open(bad, "wb") as fh:
        fh.write(b"".join(recs[:MAP_CORRUPT_AT]) + b"@bad\nACGT\n+\nII\n"
                 + b"".join(recs[MAP_CORRUPT_AT:MAP_BATCH]))
    bad_tup = os.path.join(workdir, "map_corrupt.tsv")
    rc, _ = _cli_in_process(["map", fa, bad, "-o", bad_tup])
    assert rc == 3, rc
    with open(bad_tup) as fh:
        _same_bytes("map on a corrupt FASTQ (the rows before it)",
                    fh.read(), "".join(
                        row + "\n" for row in first.splitlines()
                        if int(row.split("\t")[3][1:]) < MAP_CORRUPT_AT))

    # seeding on the card against the host oracle, one bucket of 4,096
    codes = [encode_seq(rec.split(b"\n")[1]) for rec in recs]
    idxs = [i for i, c in enumerate(codes) if len(c) > 128][:MAP_BATCH]
    r_pad = 160
    smax = pipeline._smax(r_pad, index.k, index.w)
    host = pipeline._pack_reads_2bit(idxs, codes, r_pad)
    pk, nm, rl = (torch.from_numpy(a).to(dev) for a in host)
    kw = dict(r_pad=r_pad, k=index.k, w=index.w, max_occ=index.max_occ,
              band=pipeline.DEFAULT_BAND, smax=smax)
    tables = index.device_tables(dev)
    s, d, rv = (x.cpu().numpy() for x in pipeline.seed_bucket(
        pk, nm, rl, tables, **kw))
    for row, i in enumerate(idxs):
        want = pipeline.seed_reads_host(index, codes[i],
                                        pipeline.DEFAULT_BAND, smax)
        assert (int(s[row]), int(d[row]), bool(rv[row])) == want, i
    seed_ms = cuda_median_ms(lambda: pipeline.seed_bucket(
        pk, nm, rl, tables, **kw), reps=5)
    log(f"map: first batch byte-identical to the CPU path ({cpu_s:.1f} s "
        f"on the host, index {index_s:.1f} s), --from-tuples bed "
        f"byte-identical, {MAP_FAULT} retried to the same bytes, a corrupt "
        f"record at {MAP_CORRUPT_AT} exits 3 with the rows before it; "
        f"seed_bucket on the card equal to seed_reads_host on "
        f"{len(idxs)} reads of 129-150 bp ({seed_ms:.3f} ms a bucket)")

    # goleft's host tools, once each (no device stage)
    t0 = time.perf_counter()
    truth_bed = os.path.join(workdir, "cnv_truth.bed")
    calls_bed = os.path.join(workdir, "cnv_calls.bed")
    with open(truth_bed, "w") as fh:
        fh.write("chr1\t1000000\t1200000\t1\ts1\nchr1\t2500000\t2650000\t3"
                 "\ts5\nchr2\t10000\t30000\t0\ts2,s3\n")
    with open(calls_bed, "w") as fh:
        fh.write("chr1\t1001000\t1199000\t1\ts1\nchr1\t2500000\t2600000\t3"
                 "\ts5\nchr1\t5000000\t5050000\t1\ts4\n")
    anon = os.path.join(workdir, "anon")
    os.makedirs(anon, exist_ok=True)
    # the fixture has no @RG: samplename reads anonymize's header
    tools = {"anonymize": ["anonymize", "smoke", tools_bam, "-d", anon],
             "samplename": ["samplename",
                            os.path.join(anon, "sample_smoke_0001.bam")],
             "covstats": ["covstats", tools_bam],
             "indexsplit": ["indexsplit", "-n", "100", tools_bam],
             "depthwed": ["depthwed", "-s", "1000", bed, bed2],
             "cnveval": ["cnveval", truth_bed, calls_bed]}
    tool_rows = {}
    for name, argv in tools.items():
        rc, text = _cli_in_process(argv)
        assert rc == 0 and text, (name, rc)
        tool_rows[name] = len(text.splitlines())
    tools_s = time.perf_counter() - t0
    log(f"goleft's host tools, each exit 0 ({tools_s:.1f} s): " + ", ".join(
        f"{k} {v} lines" for k, v in tool_rows.items()))
    return {"wall_s": wall, "command_s": cmd_s, "split_s": split,
            "reads_per_s": MAP_READS / cmd_s, "mapped": len(rows),
            "placed": placed, "launches": launches, "cpu_s": cpu_s,
            "seed_ms": seed_ms, "tools_s": tools_s, "tool_rows": tool_rows,
            "depth_max_abs_err": depth_err, "depth_segments": depth_segs,
            "fixture": {"fa": fa, "fq1": fq1, "first_tsv": first_tsv}}


SV_BURST = 8  # concurrent /v1/depth requests of the burst
SV_SCAN = 30  # .bai files of the /v1/cohortscan request
SV_TIMEOUT = 600  # the deadline of the longer requests, queue included


def _serve_start(root: str, workdir: str, env: dict, *extra: str):
    """``python -m goleft_tpu_torch serve --port 0`` in a fresh process
    (its defaults: --max-batch 16, continuous batching), with a session
    cache, --metrics-out and the flags ``extra`` → (process, base URL,
    manifest path, stderr path). Waits for its ``listening on`` line."""
    import queue
    import threading

    rep = os.path.join(workdir, "serve_report.json")
    err = os.path.join(workdir, "serve.stderr")
    errf = open(err, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "goleft_tpu_torch", "--metrics-out", rep,
         "serve", "--port", "0", "--cache", os.path.join(workdir, "sv_cache"),
         "--flight-dir", workdir, *extra],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=errf, text=True)
    errf.close()
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    t_end = time.monotonic() + 300
    while True:
        try:
            line = lines.get(timeout=max(0.1, t_end - time.monotonic()))
        except queue.Empty:
            raise AssertionError("serve printed no listening line:\n"
                                 + open(err).read()[-4000:])
        m = re.search(r"listening on (http://\S+)", line)
        if m:
            return proc, m.group(1), rep, err


def serve_phase(root: str, workdir: str, fx: dict) -> dict:
    """Phase 19: ``python -m goleft_tpu_torch serve`` in a fresh process,
    every endpoint against the earlier phases' one-shot outputs: /v1/depth
    on phase 4's BAM (the oracle's BEDs); a burst of SV_BURST concurrent
    /v1/depth requests on phase 12's BAMs (<= 2 batched launches a
    region, each response the BAM served alone, one the one-shot CLI's
    BEDs); /v1/pairhmm on phase 6's windows (its table); /v1/cohortdepth
    --decode-device on phase 7's CRAMs (phase 9's matrix); /v1/cohortscan
    -n on SV_SCAN of phase 14's .bai files (phase 14's uninterrupted
    30-sample -n run: bed.gz and .roc, the .ped but its PCs, which hold
    up to sign); /v1/map with window on phase 18's first batch (the CLI's
    tuples, the CPU path's bed); the depth request again (cached, no
    launch); /healthz, /debug/compiles, /debug/memory, Prometheus
    /metrics; SIGTERM → exit 0; the launches of its --metrics-out
    manifest against /metrics and the earlier phases' counts."""
    import signal
    import threading

    from goleft_tpu_torch.commands.map_cmd import DEFAULT_WINDOW
    from goleft_tpu_torch.mapping import pipeline
    from goleft_tpu_torch.serve.client import ServeClient

    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GOLEFT_TPU_FAULTS", None)
    t_start = time.perf_counter()
    proc, url, rep_path, err_path = _serve_start(root, workdir, env)
    up_s = time.perf_counter() - t_start
    out = {"up_s": up_s, "latency_client_s": {}}
    client = ServeClient(url, timeout_s=900)

    def timed(kind, fn):
        t0 = time.perf_counter()
        r = fn()
        out["latency_client_s"].setdefault(kind, []).append(
            time.perf_counter() - t0)
        return r

    def passes():
        return client.metrics()["counters"].get("device_passes_total", 0)

    try:
        bam, fa, want_d, want_c = fx["depth"]
        depth_req = dict(reference=fa, window=WINDOW, maxmeandepth=MAX_MEAN)
        r = timed("depth", lambda: client.depth(bam, **depth_req))
        _same_bytes("serve /v1/depth depth.bed (phase 4's oracle)",
                    r["depth_bed"], want_d)
        _same_bytes("serve /v1/depth callable.bed (phase 4's oracle)",
                    r["callable_bed"], want_c)
        assert r["shards"] == -(-E2E_LEN // SHARD) and "cached" not in r

        cnv_bams, cnv_fa = fx["cnv_bams"][:SV_BURST], fx["cnv_fa"]
        m0 = client.metrics()
        burst = [None] * len(cnv_bams)
        errs = []

        burst_lat = [None] * len(cnv_bams)

        def fire(i):
            try:
                t1 = time.perf_counter()
                burst[i] = ServeClient(url, timeout_s=900).depth(
                    cnv_bams[i], reference=cnv_fa, window=WINDOW)
                burst_lat[i] = time.perf_counter() - t1
            except Exception as e:  # noqa: BLE001 — raised below
                errs.append(e)

        ts = [threading.Thread(target=fire, args=(i,))
              for i in range(len(cnv_bams))]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=900)
        burst_s = time.perf_counter() - t0
        if errs:
            raise errs[0]
        m1 = client.metrics()
        burst_passes = m1["counters"]["device_passes_total"] \
            - m0["counters"].get("device_passes_total", 0)
        regions = burst[0]["shards"]
        hist = {int(k): v - m0["batch_size_hist"].get(k, 0)
                for k, v in m1["batch_size_hist"].items()
                if v - m0["batch_size_hist"].get(k, 0)}
        assert sum(k * v for k, v in hist.items()) == len(cnv_bams), hist
        assert burst_passes <= 2 * regions, (burst_passes, regions, hist)
        for i, b in enumerate(cnv_bams):
            alone = timed("depth", lambda b=b, i=i: client.depth(
                b, reference=cnv_fa, window=WINDOW, cache_buster=f"solo{i}"))
            for k in ("depth_bed", "callable_bed"):
                _same_bytes(f"serve burst {k} of {os.path.basename(b)} "
                            "(served alone)", burst[i][k], alone[k])
        prefix = os.path.join(workdir, "sv_oneshot")
        r1, _ = _run_cli(root, ["depth", "--prefix", prefix, "-r", cnv_fa,
                                "-w", str(WINDOW), cnv_bams[0]], env)
        assert r1.returncode == 0, r1.stderr[-4000:]
        for k, suf in (("depth_bed", ".depth.bed"),
                       ("callable_bed", ".callable.bed")):
            with open(prefix + suf) as fh:
                _same_bytes(f"serve burst {k} (the one-shot depth CLI)",
                            burst[0][k], fh.read())
        log(f"serve: a burst of {len(cnv_bams)} /v1/depth requests "
            f"({regions} region a BAM) took {burst_passes} batched launches "
            f"of the depth kernel, batch sizes {hist}, "
            f"{len(cnv_bams) / burst_s:.2f} requests/s ({burst_s:.3f} s); "
            "each response equal to the BAM served alone, the first to the "
            "one-shot CLI")

        ph = fx["pairhmm"]
        r = timed("pairhmm", lambda: client.pairhmm(
            ph["windows"], candidates=ph["candidates"]))
        with open(ph["table"]) as fh:
            _same_bytes("serve /v1/pairhmm (phase 6's table)",
                        r["likelihoods_tsv"], fh.read())

        r = timed("cohortdepth", lambda: client.cohortdepth(
            fx["crams"], fai=fx["cram_fai"], window=CO_WINDOW,
            decode_device=True, timeout_s=SV_TIMEOUT))
        _same_bytes("serve /v1/cohortdepth (phase 9's matrix)",
                    r["matrix_tsv"], fx["matrix"])

        bais = fx["bais"][:SV_SCAN]
        r = timed("cohortscan", lambda: client._request("/v1/cohortscan", {
            "bams": bais, "fai": fx["ic_fai"], "extranormalize": True,
            "timeout_s": SV_TIMEOUT}))
        want_dir = fx["ic_out"]
        name = os.path.basename(want_dir)
        with gzip.open(os.path.join(want_dir, f"{name}-indexcov.bed.gz"),
                       "rb") as fh:
            want_bed = fh.read()
        assert gzip.decompress(base64.b64decode(r["bed_gz_b64"])) \
            == want_bed, "serve /v1/cohortscan bed.gz differs"
        with open(os.path.join(want_dir, f"{name}-indexcov.roc")) as fh:
            _same_bytes("serve /v1/cohortscan .roc", r["roc"], fh.read())
        got_ped = os.path.join(workdir, "sv_scan.ped")
        with open(got_ped, "w") as fh:
            fh.write(r["ped"])
        _compare_ped(os.path.join(want_dir, f"{name}-indexcov.ped"), got_ped)

        mp = fx["map"]
        r = timed("map", lambda: client.map(mp["fq1"], mp["fa"],
                                            window=DEFAULT_WINDOW))
        with open(mp["first_tsv"]) as fh:
            first = fh.read()
        _same_bytes("serve /v1/map tuples (the CLI's first batch)",
                    r["tuples_tsv"], first)
        want_bed = pipeline.depth_bed_from_tuples(
            pipeline.parse_tuples(first.encode()), dict(MAP_CONTIGS),
            DEFAULT_WINDOW, device="cpu").decode()
        _same_bytes("serve /v1/map depth bed (the CPU path's)",
                    r["depth_bed"], want_bed)
        map_chroms = len({row.split("\t")[0] for row in first.splitlines()})

        before = passes()
        r = timed("depth_cached", lambda: client.depth(bam, **depth_req))
        assert r.get("cached") is True and passes() == before
        assert r["depth_bed"] == want_d

        health = client.healthz()
        import torch

        assert health["platform"] == "gpu" and health["devices"] \
            == torch.cuda.device_count(), health
        assert health["device_kind"] == torch.cuda.get_device_name(0)
        comp = client._request("/debug/compiles")
        built = {b["family"] for b in comp["builds"]}
        assert {"depth", "pairhmm", "rans", "indexcov_norm",
                "swalign"} <= built, comp["builds"]
        assert any(s["family"] == "depth" for s in comp["signatures"])
        mem = client._request("/debug/memory")
        assert mem["device"]["peak_bytes"] > 0 \
            and mem["device"]["reserved_bytes"] > 0, mem["device"]
        prom = client.metrics_prometheus()
        assert "serve_requests_total_depth" in prom
        final = client.metrics()
    except BaseException:
        proc.kill()
        proc.wait(timeout=60)
        log("serve stderr:\n" + open(err_path).read()[-4000:])
        raise
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=300)
    stderr = open(err_path).read()
    assert rc == 0, (rc, stderr[-4000:])
    rep, cmd_s, stages = read_manifest(rep_path, "serve")
    launches = rep["kernel_launches"]
    # warmup 1, phase 4's BAM a launch a region, the burst, the 8 alone,
    # and map's bed a launch a chromosome; the cached request none
    want_depth = 1 + -(-E2E_LEN // SHARD) + burst_passes \
        + len(cnv_bams) + map_chroms
    assert launches["depth"] == want_depth, (launches, want_depth)
    assert launches["rans"] == fx["rans_launches"], launches
    assert launches["pairhmm"] == fx["pairhmm_launches"], launches
    assert launches["indexcov_norm"] >= 1 and launches["swalign"] >= 1
    warm = re.search(r"warmup ([0-9.]+)s", stderr)
    lat = {k: {q: v.get(q) for q in ("p50", "p99", "count")}
           for k, v in final["latency_s"].items()}
    out.update(launches=launches, burst_passes=burst_passes,
               burst_batch_sizes=hist, regions=regions,
               burst_bodies=dict(zip(cnv_bams, burst)),
               burst_latency_s=dict(zip(cnv_bams, burst_lat)),
               burst_requests_per_s=len(cnv_bams) / burst_s,
               burst_s=burst_s, latency_s=lat,
               stage_seconds=final["stage_seconds"],
               warmup_s=float(warm.group(1)) if warm else None,
               import_s=rep["import_seconds"], command_s=cmd_s,
               counters={k: v for k, v in final["counters"].items()
                         if not k.startswith("tenant.")})
    log(f"serve: every endpoint byte-identical to the one-shot commands; "
        f"up in {up_s:.2f} s (warmup {out['warmup_s']} s, import "
        f"{out['import_s']:.3f} s); launches {launches}; latency (server, "
        f"p50/p99 s) " + ", ".join(
            f"{k} {v['p50']}/{v['p99']} (n={v['count']})"
            for k, v in sorted(lat.items()))
        + "; stage seconds " + json.dumps(final["stage_seconds"])
        + f"; SIGTERM drained to exit 0 ({time.perf_counter() - t_start:.1f}"
        " s in all)")
    return out


FL_WORKERS = 2  # serve workers the fleet phase's supervisor spawns
FL_TIMEOUT = 600  # the bound of every wait of the fleet phase


def _get_json(url: str, timeout: float = 60.0) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _post_json(url: str, body: dict, timeout: float = 900.0) -> dict:
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _alive(pid: int) -> bool:
    """A process that exists and is no zombie."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False


def _torch_mapped(pid: int) -> list[str]:
    """The files of torch's that a process has mapped (none in a process
    that never imported it)."""
    with open(f"/proc/{pid}/maps") as fh:
        return sorted({line.split()[-1] for line in fh
                       if "libtorch" in line or "/torch/" in line})


def _start_listening(argv: list[str], root: str, env: dict, err: str):
    """A ``python -m goleft_tpu_torch`` process whose stdout prints one
    ``listening on URL`` line once it serves → (process, URL, seconds
    to that line). Fails, with the stderr's tail, past FL_TIMEOUT."""
    import queue
    import threading

    errf = open(err, "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "goleft_tpu_torch",
                             *argv], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=errf, text=True)
    errf.close()
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    t_end = time.monotonic() + FL_TIMEOUT
    while True:
        try:
            line = lines.get(timeout=max(0.1, t_end - time.monotonic()))
        except queue.Empty:
            proc.kill()
            raise AssertionError(f"{argv[0]} printed no listening line:\n"
                                 + open(err).read()[-4000:])
        m = re.search(r"listening on (http://\S+)", line)
        if m:
            return proc, m.group(1), time.perf_counter() - t0


def _wait_for(what: str, pred, timeout: float = FL_TIMEOUT):
    t_end = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        assert time.monotonic() < t_end, f"timed out waiting for {what}"
        time.sleep(0.2)


def fleet_phase(root: str, workdir: str, fx: dict, sv: dict) -> dict:
    """Phase 20: ``python -m goleft_tpu_torch fleet --workers 2
    --shared-cache DIR --events-journal J`` in a fresh process (its
    supervisor spawns two ``serve`` workers on the card; the router
    itself never maps torch), then /v1/depth through the router on phase
    4's BAM (the oracle's BEDs; /fleet/plan names the worker that
    answered), phase 19's burst through it (each body the one phase 19
    got), a SIGKILLed home worker respawned and the same request
    answered from the shared cache with no launch, ``trace`` across the
    router and a worker (``--perfetto`` JSON), the router modes of
    ``warmup``, ``memory`` and ``profile``, a federation in front of
    the fleet (the same bytes; ``trace`` over three levels), SIGTERM to
    both → exit 0 with no worker left."""
    import signal
    import threading

    from goleft_tpu_torch.obs.compiles import validate_warmup_manifest
    from goleft_tpu_torch.obs.events import read_events
    from goleft_tpu_torch.serve.client import ServeClient

    env = dict(os.environ, PYTHONPATH=root)
    env.pop("GOLEFT_TPU_FAULTS", None)
    cache = os.path.join(workdir, "fl_cache")
    journal = os.path.join(workdir, "fl_events.jsonl")
    fl_err = os.path.join(workdir, "fleet.stderr")
    fed_err = os.path.join(workdir, "federation.stderr")
    t_wall0 = time.time()
    fleet, url, up_s = _start_listening(
        ["fleet", "--port", "0", "--workers", str(FL_WORKERS),
         "--shared-cache", cache, "--events-journal", journal,
         "--poll-interval-s", "0.5", "--supervise-interval-s", "0.5",
         "--worker-args", f"--profile-hz 100 --flight-dir {workdir}"],
        root, env, fl_err)
    fed = None
    out = {"router_up_s": up_s, "latency_s": {}}
    try:
        spawns = read_events(journal, since=t_wall0, type="spawn")
        assert len(spawns) == FL_WORKERS, spawns
        pids = {e["worker"]: e["pid"] for e in spawns}
        # spawn to announce, a worker at a time (the supervisor spawns
        # them one after another): the torch import and the warmup
        t_prev = t_wall0
        out["worker_announce_s"] = []
        for e in spawns:
            out["worker_announce_s"].append(e["t"] - t_prev)
            t_prev = e["t"]
        import torch

        for w in pids:
            h = _get_json(w + "/healthz")
            assert h["platform"] == "gpu" and h.get("cache") == "shared" \
                and h["device_kind"] == torch.cuda.get_device_name(0), h
        mapped = _torch_mapped(fleet.pid)
        assert not mapped, f"the fleet router mapped torch: {mapped[:5]}"
        assert all(_alive(p) for p in pids.values())

        def passes() -> dict:
            return {w: _get_json(w + "/metrics")["counters"].get(
                "device_passes_total", 0) for w in pids}

        bam, fa, want_d, want_c = fx["depth"]
        depth_req = dict(reference=fa, window=WINDOW,
                         maxmeandepth=MAX_MEAN)
        home = _post_json(url + "/fleet/plan",
                          {"kind": "depth", "bam": bam, **depth_req}
                          )["candidates"][0]
        p0 = passes()
        t0 = time.perf_counter()
        r = ServeClient(url, timeout_s=900).depth(bam, **depth_req)
        out["latency_s"]["depth"] = time.perf_counter() - t0
        p1 = passes()
        _same_bytes("fleet /v1/depth depth.bed (phase 4's oracle)",
                    r["depth_bed"], want_d)
        _same_bytes("fleet /v1/depth callable.bed (phase 4's oracle)",
                    r["callable_bed"], want_c)
        moved = [w for w in pids if p1[w] != p0[w]]
        assert moved == [home], (moved, home)
        launches = p1[home] - p0[home]
        assert launches == -(-E2E_LEN // SHARD), launches

        bodies = sv["burst_bodies"]
        cnv_bams, cnv_fa = list(bodies), fx["cnv_fa"]
        homes = {b: _post_json(url + "/fleet/plan", {
            "kind": "depth", "bam": b, "reference": cnv_fa,
            "window": WINDOW})["candidates"][0] for b in cnv_bams}
        m0 = {w: _get_json(w + "/metrics") for w in pids}
        burst, lat, errs = {}, {}, []
        go = threading.Event()

        def fire(b):
            try:
                go.wait(timeout=FL_TIMEOUT)
                t1 = time.perf_counter()
                burst[b] = ServeClient(url, timeout_s=900).depth(
                    b, reference=cnv_fa, window=WINDOW)
                lat[b] = time.perf_counter() - t1
            except Exception as e:  # noqa: BLE001 — raised below
                errs.append(e)

        ts = [threading.Thread(target=fire, args=(b,)) for b in cnv_bams]
        for t in ts:
            t.start()
        t0 = time.perf_counter()
        go.set()
        for t in ts:
            t.join(timeout=FL_TIMEOUT)
        burst_s = time.perf_counter() - t0
        if errs:
            raise errs[0]
        for b in cnv_bams:
            assert json.dumps(burst[b], sort_keys=True) \
                == json.dumps(bodies[b], sort_keys=True), \
                f"fleet burst body of {os.path.basename(b)} differs " \
                "from phase 19's"
        m1 = {w: _get_json(w + "/metrics") for w in pids}
        split = {w: sum(1 for h in homes.values() if h == w) for w in pids}
        per_worker = {}
        for w in pids:
            c0, c1 = m0[w]["counters"], m1[w]["counters"]
            n_req = c1.get("requests_total.depth", 0) \
                - c0.get("requests_total.depth", 0)
            assert n_req == split[w], (w, n_req, split)
            per_worker[w] = {
                "requests": n_req,
                "launches": c1.get("device_passes_total", 0)
                - c0.get("device_passes_total", 0),
                "batch_sizes": {k: v - m0[w]["batch_size_hist"].get(k, 0)
                                for k, v in m1[w]["batch_size_hist"]
                                .items()
                                if v - m0[w]["batch_size_hist"].get(k, 0)}}
        burst_launches = sum(v["launches"] for v in per_worker.values())
        launches += burst_launches
        out["latency_s"]["burst"] = lat
        log(f"fleet: a burst of {len(cnv_bams)} /v1/depth requests through "
            f"the router split {sorted(split.values())} over the ring, "
            f"{burst_launches} batched launches "
            + json.dumps({w.rsplit(':', 1)[-1]: v
                          for w, v in per_worker.items()})
            + f", {len(cnv_bams) / burst_s:.2f} requests/s "
            f"({burst_s:.3f} s); every body phase 19's")

        # kill the home worker of phase 4's BAM; the supervisor respawns
        victim = pids[home]
        t_kill = time.time()
        os.kill(victim, signal.SIGKILL)
        restart = _wait_for("the supervisor's restart", lambda: [
            e for e in read_events(journal, since=t_kill)
            if e["type"] == "restart"])[0]
        deaths = [e for e in read_events(journal, since=t_kill)
                  if e["type"] == "death"]
        assert deaths and deaths[0]["pid"] == victim, deaths
        out["restart_s"] = restart["t"] - deaths[0]["t"]
        _wait_for("two healthy workers", lambda: _get_json(
            url + "/healthz").get("healthy") == FL_WORKERS)
        new = restart["worker"]
        pids.pop(home)
        pids[new] = restart["pid"]
        assert _get_json(new + "/healthz")["platform"] == "gpu"
        ev = subprocess.run(
            [sys.executable, "-m", "goleft_tpu_torch", "fleet", "events",
             "--journal", journal, "--json"], cwd=root, env=env,
            capture_output=True, text=True, timeout=120)
        assert ev.returncode == 0, ev.stderr[-2000:]
        evdoc = json.loads(ev.stdout)
        types = [e["type"] for e in evdoc["events"]]
        assert evdoc["schema"] == "goleft-tpu.fleet-events/1"
        assert "death" in types and "restart" in types, types
        p0 = passes()
        client = ServeClient(url, timeout_s=900, trace=True)
        t0 = time.perf_counter()
        r = client.depth(bam, **depth_req)
        out["latency_s"]["depth_after_restart"] = time.perf_counter() - t0
        assert r.get("cached") is True, sorted(r)
        assert r["depth_bed"] == want_d and r["callable_bed"] == want_c
        assert passes() == p0, "the replayed request launched a kernel"
        log(f"fleet: SIGKILLed worker pid {victim} (home of phase 4's "
            f"BAM), restarted in {out['restart_s']:.2f} s at {new}; the "
            "same request answered from the shared cache, no launch on "
            "any worker")

        perf = os.path.join(workdir, "fl_trace.json")
        tr = subprocess.run(
            [sys.executable, "-m", "goleft_tpu_torch", "trace",
             client.last_trace_id, "--router", url, "--perfetto", perf],
            cwd=root, env=env, capture_output=True, text=True, timeout=120)
        assert tr.returncode == 0, tr.stderr[-2000:]
        assert re.search(r"2 process\(es\)", tr.stdout), tr.stdout
        assert "fleet.forward.depth" in tr.stdout \
            and "request.depth" in tr.stdout, tr.stdout
        with open(perf) as fh:
            assert json.load(fh)["traceEvents"]

        def cli(*argv):
            r = subprocess.run([sys.executable, "-m", "goleft_tpu_torch",
                                *argv], cwd=root, env=env,
                               capture_output=True, text=True, timeout=300)
            assert r.returncode == 0, (argv, r.stderr[-2000:])
            return r.stdout

        wpath = os.path.join(workdir, "fl_warmup.json")
        cli("warmup", "export", "--router", "--url", url, "--out", wpath)
        with open(wpath) as fh:
            wdoc = validate_warmup_manifest(json.load(fh))
        assert any(s["family"] == "depth" for s in wdoc["signatures"])
        mem = json.loads(cli("memory", "--router", url, "--json"))
        assert mem["workers"] == FL_WORKERS, mem
        reserved = mem["gauges"]["memory.device_reserved_bytes"]
        assert reserved["min"] > 0, reserved
        prof = cli("profile", "--router", url, "--seconds", "2",
                   "--collapsed", "-")
        assert prof.strip(), "profile --router printed no stacks"
        out["profile_stacks"] = len(prof.splitlines())

        fed, fed_url, fed_up = _start_listening(
            ["federation", "--port", "0", "--fleet", url,
             "--poll-interval-s", "0.5"], root, env, fed_err)
        out["federation_up_s"] = fed_up
        mapped = _torch_mapped(fed.pid)
        assert not mapped, f"the federation mapped torch: {mapped[:5]}"
        fclient = ServeClient(fed_url, timeout_s=900, trace=True)
        t0 = time.perf_counter()
        r = fclient.depth(bam, **depth_req)
        out["latency_s"]["depth_via_federation"] = \
            time.perf_counter() - t0
        assert r["depth_bed"] == want_d and r["callable_bed"] == want_c
        tr = subprocess.run(
            [sys.executable, "-m", "goleft_tpu_torch", "trace",
             fclient.last_trace_id, "--router", fed_url, "--json"],
            cwd=root, env=env, capture_output=True, text=True, timeout=120)
        assert tr.returncode == 0, tr.stderr[-2000:]
        doc = json.loads(tr.stdout)
        names = []

        def walk(node, depth=0):
            names.append((depth, node["name"]))
            for c in node.get("children", ()):
                walk(c, depth + 1)

        walk(doc["tree"])
        order = [n for _, n in names]
        assert len(doc["processes"]) >= 3, doc["processes"]
        for level in ("federation.request.depth", "fleet.request.depth",
                      "request.depth"):
            assert level in order, order
        assert order.index("federation.request.depth") \
            < order.index("fleet.request.depth") \
            < order.index("request.depth"), order
        out["federation_trace_levels"] = len(doc["processes"])
    except BaseException:
        # stop what the phase started: a drain first (the fleet stops its
        # workers), then SIGKILL to anything still alive, workers included
        for p in (fed, fleet):
            if p is not None and p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=60)
        for e in read_events(journal, since=t_wall0):
            if e.get("pid") and _alive(e["pid"]):
                try:
                    os.kill(e["pid"], signal.SIGKILL)
                except ProcessLookupError:
                    pass
        log("fleet stderr:\n" + open(fl_err).read()[-4000:])
        raise
    fed.send_signal(signal.SIGTERM)
    assert fed.wait(timeout=120) == 0, open(fed_err).read()[-4000:]
    fleet.send_signal(signal.SIGTERM)
    rc = fleet.wait(timeout=300)
    assert rc == 0, (rc, open(fl_err).read()[-4000:])
    every = {e["pid"] for e in read_events(journal, since=t_wall0)
             if e.get("pid")}
    left = [p for p in every if _alive(p)]
    assert not left, f"workers outlived the fleet: {left}"
    direct = sv["burst_latency_s"]
    out.update(launches=launches, workers=FL_WORKERS,
               burst_split=sorted(split.values()),
               burst_per_worker=per_worker,
               latency_direct_s={
                   "depth": sv["latency_client_s"]["depth"][0],
                   "burst": direct})
    log(f"fleet: router up in {up_s:.2f} s, workers announced in "
        + ", ".join(f"{s:.2f}" for s in out["worker_announce_s"])
        + f" s, restart {out['restart_s']:.2f} s, federation up in "
        f"{fed_up:.2f} s; depth through the router "
        f"{out['latency_s']['depth']:.3f} s (direct, phase 19: "
        f"{out['latency_direct_s']['depth']:.3f} s), after the restart "
        f"{out['latency_s']['depth_after_restart']:.3f} s (cached), via "
        f"the federation {out['latency_s']['depth_via_federation']:.3f} "
        "s; burst through the router / direct (s): "
        + ", ".join(f"{os.path.basename(b)} {lat[b]:.3f}/{direct[b]:.3f}"
                    for b in cnv_bams)
        + f"; {launches} depth launches; federation and fleet exited 0, "
        "no worker left")
    return out


# ---- phase 21: multi-device (processes over Gloo, the split) -----------

MD_SAMPLES = 8  # phase 12's cohort size
#: the sharded depth's and the prefetched cohort's samples (8 before
#: the bench phase was added)
MD_DEPTH_SAMPLES = 2
MD_SHARDS = 2  # the (1, 2) grid: one 10 Mb shard a rank
MD_CHUNK_SHARD = 2_500_000  # run_prefetched_cohort: 4 chunks of 2 x 2.5 Mb
MD_TIMEOUT = 600  # the bound of each process of the phase
MD_PCA = (600, 15_195, 5, 127)  # samples, bins, k, rows a chunk


def md_segments(seed: int = 2121):
    """MD_DEPTH_SAMPLES samples over MD_SHARDS x 10 Mb: for each sample and
    shard, :func:`shard_segments` moved onto that shard (endpoints
    clipped at 0: the sharded layout holds no coordinate below it),
    padded with keep=False → global (S, n) int32, int32, bool."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(MD_DEPTH_SAMPLES):
        parts = []
        for q in range(MD_SHARDS):
            w0, (s, e, k), _ = shard_segments(rng)
            off = q * SHARD - w0
            parts.append((np.maximum(s.astype(np.int64) + off, 0),
                          np.maximum(e.astype(np.int64) + off, 0), k))
        rows.append(tuple(np.concatenate(c) for c in zip(*parts)))
    n = max(len(r[0]) for r in rows)
    st = np.zeros((MD_DEPTH_SAMPLES, n), np.int32)
    en = np.zeros((MD_DEPTH_SAMPLES, n), np.int32)
    kp = np.zeros((MD_DEPTH_SAMPLES, n), bool)
    for i, (s, e, k) in enumerate(rows):
        st[i, :len(s)], en[i, :len(s)], kp[i, :len(s)] = s, e, k
    return st, en, kp


def md_chunk_decoder(st, en, kp, chunk_len: int):
    """decode_chunk for run_prefetched_cohort: chunk ci's segments (a
    start or an end in [ci * chunk_len, (ci + 1) * chunk_len)),
    chunk-relative, each sample padded with keep=False."""
    def decode(ci):
        lo, hi = ci * chunk_len, (ci + 1) * chunk_len
        sel = [kp[i] & (((st[i] >= lo) & (st[i] < hi))
                        | ((en[i] >= lo) & (en[i] < hi)))
               for i in range(len(st))]
        n = max(1, max(int(m.sum()) for m in sel))
        s = np.zeros((len(st), n), np.int32)
        e = np.zeros((len(st), n), np.int32)
        k = np.zeros((len(st), n), bool)
        for i, m in enumerate(sel):
            c = int(m.sum())
            s[i, :c], e[i, :c], k[i, :c] = st[i][m] - lo, en[i][m] - lo, True
        return s, e, k
    return decode


_MD_WORKER = r"""
import json, os, sys, time
t_start = time.perf_counter()
root, out_dir = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import numpy as np
import torch
import chip_smoke as cs
from goleft_tpu_torch.ops import depth_kernel as dk
from goleft_tpu_torch.parallel.mesh import make_mesh, world
from goleft_tpu_torch.parallel.prefetch import run_prefetched_cohort
from goleft_tpu_torch.parallel.sharded_coverage import (
    NO_CAP, partition_segments, sharded_depth_fn)
from goleft_tpu_torch.utils.profiling import StageTimer
import_s = time.perf_counter() - t_start
size, rank = world()
assert size == 2, size
mesh = make_mesh(prefer_seq=2)
assert mesh.shape == {"data": 1, "seq": 2} and mesh.device.type == "cuda"
t0 = time.perf_counter()
st, en, kp = cs.md_segments()
seg = partition_segments(st, en, kp, cs.MD_SHARDS, cs.SHARD)
prep_s = time.perf_counter() - t0
L, W = cs.MD_SHARDS * cs.SHARD, cs.WINDOW
rep = {"rank": rank, "import_s": import_s, "prep_s": prep_s,
       "segments": int(kp.sum()), "b": {}, "c": {}}
dev = mesh.device
for mode in ("all_gather", "scan"):
    fn = sharded_depth_fn(mesh, cs.SHARD, W, carry_mode=mode)
    blocks = fn.put(*seg)
    torch.cuda.synchronize()
    dk.LAUNCHES["depth"] = 0
    t0 = time.perf_counter()
    depth, wsums = fn.local(*blocks)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = dk.LAUNCHES["depth"]
    totals = depth[:, -1].cpu()
    carry_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        fn.carry(totals)
        carry_ms.append((time.perf_counter() - t0) * 1e3)
    d, w = fn.assemble(depth, wsums)
    assert d.shape == (cs.MD_DEPTH_SAMPLES, L) \
        and w.shape == (cs.MD_DEPTH_SAMPLES, L // W)
    if rank == 0:
        tp = []
        for i in range(cs.MD_DEPTH_SAMPLES):
            t = [torch.from_numpy(x[i]).to(dev) for x in (st, en, kp)]
            t0 = time.perf_counter()
            sums, _, _, pd = dk.fused_depth_plain(*t, 0, 0, L, NO_CAP, 1, 0,
                                                  L, W)
            torch.cuda.synchronize()
            tp.append(time.perf_counter() - t0)
            if not (np.array_equal(pd.cpu().numpy(), d[i])
                    and sums.cpu().numpy().tobytes() == w[i].tobytes()):
                raise AssertionError(f"sharded depth ({mode}): sample {i} "
                                     "differs from the plain version")
        assert int(d.min()) >= 0 and int(d.max()) > cs.CAP  # uncapped
        rep["b"][mode + "_plain_s"] = sum(tp)
    local_ms = cs.cuda_median_ms(lambda: dk.fused_depth_batch(
        blocks[0].reshape(-1), blocks[1].reshape(-1),
        [i * blocks[0].shape[1] for i in range(blocks[0].shape[0] + 1)],
        rank * cs.SHARD, rank * cs.SHARD, (rank + 1) * cs.SHARD, NO_CAP, 1,
        0, cs.SHARD, W, keep=blocks[2].reshape(-1), dense=True), reps=5)
    rep["b"][mode] = {"launches": launches, "call_s": call_s,
                      "local_ms": local_ms,
                      "carry_ms": float(np.median(carry_ms)),
                      "entries": int(blocks[0].numel())}
    del depth, wsums, blocks, d
    torch.cuda.empty_cache()
chunk_len = cs.MD_SHARDS * cs.MD_CHUNK_SHARD
decode = cs.md_chunk_decoder(st, en, kp, chunk_len)
outs = {}
for pd_ in (0, 2):
    tm = StageTimer()
    dk.LAUNCHES["depth"] = 0
    t0 = time.perf_counter()
    out = run_prefetched_cohort(mesh, cs.MD_CHUNK_SHARD, W,
                                list(range(L // chunk_len)), decode,
                                cs.MD_DEPTH_SAMPLES, prefetch_depth=pd_,
                                timer=tm, keep_depth=False)
    rep["c"][str(pd_)] = {"wall_s": time.perf_counter() - t0,
                          "launches": dk.LAUNCHES["depth"],
                          "stages": tm.as_dict()}
    outs[pd_] = out
for k in ("wmeans", "lambdas", "cn", "carry"):
    assert outs[0][k].tobytes() == outs[2][k].tobytes(), k
if rank == 0:
    np.savez(os.path.join(out_dir, "md_c.npz"), **outs[2])
rep["wall_s"] = time.perf_counter() - t_start
with open(os.path.join(out_dir, f"md_rank{rank}.json"), "w") as fh:
    json.dump(rep, fh)
print("MD_WORKER_OK", rank, flush=True)
"""


def _md_env(root: str, port: int, rank: int) -> dict:
    env = dict(os.environ, PYTHONPATH=root,
               GOLEFT_TPU_COORDINATOR=f"127.0.0.1:{port}",
               GOLEFT_TPU_NUM_PROCESSES="2", GOLEFT_TPU_PROCESS_ID=str(rank))
    env.pop("GOLEFT_TPU_FAULTS", None)
    return env


def _md_pair(root: str, argv_of) -> list:
    """Two processes of one Gloo world on the card, ``argv_of(rank)``
    each → [(returncode, stdout, stderr, wall seconds)] by rank; both
    are killed when one passes MD_TIMEOUT."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv_of(r), cwd=root, env=_md_env(root, port,
                                                               r),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(
                1.0, MD_TIMEOUT - (time.perf_counter() - t0)))
            outs.append((p.returncode, out, err, time.perf_counter() - t0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, _, err, _) in enumerate(outs):
        if rc != 0:
            raise AssertionError(f"process {r} of 2 failed ({rc}):\n"
                                 f"{err[-4000:]}")
    return outs


def multi_device_phase(root: str, workdir: str, dev, cnv: dict,
                       em_fx: tuple) -> dict:
    """Phase 21: (a) ``cohortdepth`` and ``cnv`` in two processes over
    Gloo on the one card (phase 12's 8 BAMs, --engine device), process
    0's output byte-identical to phase 12's single-process run, process 1
    printing nothing; (b) sharded_depth_fn on a (1, 2) grid in both carry
    modes, the assembled depth and window sums bitwise the plain
    version's over the whole 20 Mb; (c) run_prefetched_cohort on that
    grid, on all of (b)'s segments, at prefetch depth 0 and 2 and in
    a world of one, λ and CN bitwise, the window means the plain
    version's; (d) the split over devices (cuda:0 twice): _batched_em at
    phase 11's 64,445 x 2,504, bitwise, and the PCA's Gram step within
    pca_tolerances; (e) measure_resume_overhead(quick=True) and
    bisect_bench.measure()."""
    import threading

    import torch

    from goleft_tpu_torch.cohort.pca import sharded_pca
    from goleft_tpu_torch.commands import emdepth_cmd as ec
    from goleft_tpu_torch.ops import depth_kernel as dk
    from goleft_tpu_torch.parallel.mesh import make_mesh
    from goleft_tpu_torch.parallel.prefetch import run_prefetched_cohort
    from goleft_tpu_torch.resilience.overhead import measure_resume_overhead
    from goleft_tpu_torch.serve import bisect_bench

    t_phase = time.perf_counter()
    out = {}
    # the bisection bench sleeps its modelled passes: on a thread of its
    # own while the phase waits on its processes
    bisect = {}
    bt = threading.Thread(target=lambda: bisect.update(
        bisect_bench.measure()), daemon=True)
    bt.start()

    # (a) the two commands, two processes each
    bams, fa = cnv["bams"], cnv["fa"]
    single = cnv.pop("single")
    runs = {}
    for prog, extra in (
            ("cohortdepth", lambda r: []),
            ("cnv", lambda r: ["--vcf", os.path.join(workdir, f"md{r}.vcf"),
                               "--matrix-out",
                               os.path.join(workdir, f"md{r}.cn.tsv")])):
        reports = [os.path.join(workdir, f"md_{prog}{r}.json")
                   for r in range(2)]
        outs = _md_pair(root, lambda r: [
            sys.executable, "-m", "goleft_tpu_torch", "--metrics-out",
            reports[r], prog, "-w", str(CNV_WINDOW), "-r", fa, "--engine",
            "device", *extra(r), *bams])
        mans = [read_manifest(p, prog) for p in reports]
        if outs[1][1]:
            raise AssertionError(f"{prog}: process 1 printed to stdout: "
                                 f"{outs[1][1][:200]!r}")
        if prog == "cohortdepth":
            _diff_rows("cohortdepth, two processes against one",
                       outs[0][1], single["cohortdepth"])
        else:
            for what, got, want in zip(
                    ("calls", "VCF", "CN matrix"),
                    (outs[0][1], open(os.path.join(workdir, "md0.vcf")).read(),
                     open(os.path.join(workdir, "md0.cn.tsv")).read()),
                    single["cnv"]):
                _diff_rows(f"cnv {what}, two processes against one", got,
                           want)
            for p in ("md1.vcf", "md1.cn.tsv"):
                assert not os.path.exists(os.path.join(workdir, p)), p
        launches = [m[0]["kernel_launches"]["depth"] for m in mans]
        assert launches == [MD_SAMPLES // 2] * 2, (prog, launches)
        runs[prog] = {
            "walls_s": [o[3] for o in outs],
            "command_s": [m[1] for m in mans],
            "import_s": [m[0]["import_seconds"] for m in mans],
            "launches": launches,
            "single_wall_s": single[prog + "_wall_s"]}
        log(f"{prog} in two processes (Gloo, both on {dev}): process 0's "
            f"output byte-identical to the single-process run, process 1 "
            f"silent; walls {runs[prog]['walls_s'][0]:.3f} / "
            f"{runs[prog]['walls_s'][1]:.3f} s (single process "
            f"{runs[prog]['single_wall_s']:.3f} s), import "
            f"{runs[prog]['import_s'][0]:.3f} / "
            f"{runs[prog]['import_s'][1]:.3f} s; depth launches {launches}")
    out["commands"] = runs

    # (b) + (c) in two processes of one world
    outs = _md_pair(root, lambda r: [sys.executable, "-c", _MD_WORKER, root,
                                     workdir])
    reps = []
    for r in range(2):
        with open(os.path.join(workdir, f"md_rank{r}.json")) as fh:
            reps.append(json.load(fh))
    for mode in ("all_gather", "scan"):
        assert [x["b"][mode]["launches"] for x in reps] == [1, 1], reps
    for d in ("0", "2"):
        n_chunks = MD_SHARDS * SHARD // (MD_SHARDS * MD_CHUNK_SHARD)
        assert [x["c"][d]["launches"] for x in reps] == [n_chunks] * 2
    out["ranks"] = reps
    out["worker_walls_s"] = [o[3] for o in outs]
    b = {m: [x["b"][m] for x in reps] for m in ("all_gather", "scan")}
    log(f"sharded_depth_fn on a (1, 2) grid: {MD_DEPTH_SAMPLES} samples "
        f"over {MD_SHARDS} x {SHARD} bp ({reps[0]['segments']} segments), both "
        f"carry modes bitwise the plain version over the whole "
        f"{MD_SHARDS * SHARD} bp (depth, window sums); one depth launch a "
        f"rank a call; local step (both ranks on the card at once) "
        + ", ".join(f"{m} {b[m][0]['local_ms']:.3f} / {b[m][1]['local_ms']:.3f}"
                    f" ms" for m in b)
        + "; carry collective "
        + ", ".join(f"{m} {b[m][0]['carry_ms']:.3f} / "
                    f"{b[m][1]['carry_ms']:.3f} ms" for m in b)
        + f"; plain version {reps[0]['b']['all_gather_plain_s']:.3f} s; "
        f"worker import {reps[0]['import_s']:.3f} / {reps[1]['import_s']:.3f}"
        f" s, inputs {reps[0]['prep_s']:.3f} s")

    # (c) the world of one, in this process, and the plain version's
    # window means of the same segments over the whole 20 Mb
    st, en, kp = md_segments()
    chunk_len = MD_SHARDS * MD_CHUNK_SHARD
    L = MD_SHARDS * SHARD
    dk.LAUNCHES["depth"] = 0
    t0 = time.perf_counter()
    one = run_prefetched_cohort(
        make_mesh(), chunk_len, WINDOW, list(range(L // chunk_len)),
        md_chunk_decoder(st, en, kp, chunk_len), MD_DEPTH_SAMPLES,
        prefetch_depth=2, keep_depth=False)
    one_s, one_launches = time.perf_counter() - t0, dk.LAUNCHES["depth"]
    two = np.load(os.path.join(workdir, "md_c.npz"))
    for k in ("wmeans", "lambdas", "cn", "carry"):
        if one[k].tobytes() != two[k].tobytes():
            raise AssertionError(f"run_prefetched_cohort: {k} of the world "
                                 "of one differs from the world of two")
    for i in range(MD_DEPTH_SAMPLES):
        t = [torch.from_numpy(np.ascontiguousarray(x[i])).to(dev)
             for x in (st, en, kp)]
        sums = dk.fused_depth_plain(*t, 0, 0, L, 2**31 - 1, 1, 0, L,
                                    WINDOW)[0]
        if (sums.cpu().numpy() / np.float32(WINDOW)).tobytes() \
                != one["wmeans"][i].tobytes():
            raise AssertionError("run_prefetched_cohort: window means of "
                                 f"sample {i} differ from the plain version")
    lam, cn = one["lambdas"], one["cn"]
    assert np.isfinite(lam).all() and lam.shape == (L // WINDOW, 9)
    assert cn.min() >= 0 and cn.max() <= 8 and (cn == 2).mean() > 0.5
    c = {d: [x["c"][d] for x in reps] for d in ("0", "2")}
    out["prefetched"] = {"world1_s": one_s, "world1_launches": one_launches,
                         "world2": c}
    log(f"run_prefetched_cohort, {L // chunk_len} chunks of {MD_SHARDS} x "
        f"{MD_CHUNK_SHARD} bp, {int(kp.sum())} segments, no depth to the host: λ, CN, window means and "
        f"carry bitwise across prefetch depth 0 and 2 and the worlds of two "
        f"and one, the window means the plain version's; walls depth 0 "
        f"{c['0'][0]['wall_s']:.3f} s, depth 2 {c['2'][0]['wall_s']:.3f} s "
        f"(world of two), world of one {one_s:.3f} s; stage seconds "
        f"(depth 2, rank 0): " + ", ".join(
            f"{k} {v['seconds']:.3f}" for k, v in
            sorted(c["2"][0]["stages"].items())))

    # (d) the split over devices: cuda:0 twice
    depths, med, medmed, lam1, cn1 = em_fx
    t0 = time.perf_counter()
    lam2, cn2 = ec._batched_em(depths, med, medmed, devices=[dev, dev])
    em_split_s = time.perf_counter() - t0
    if lam2.tobytes() != lam1.tobytes() or cn2.tobytes() != cn1.tobytes():
        raise AssertionError("_batched_em over two devices differs from one")
    n, bins, k, rows = MD_PCA
    rng = np.random.default_rng(2122)
    basis = np.linalg.qr(rng.standard_normal((bins, k)))[0]
    x = ((rng.standard_normal((n, k)) * (200.0 / 2 ** np.arange(k)))
         @ basis.T + rng.standard_normal((n, bins))
         + 30.0).astype(np.float32)

    def chunks():
        return (x[lo:lo + rows] for lo in range(0, n, rows))

    fits, pca_s = {}, {}
    for name, devs in (("one", [dev]), ("two", [dev, dev])):
        t0 = time.perf_counter()
        fits[name] = sharded_pca(chunks, k=k, devices=devs)
        pca_s[name] = time.perf_counter() - t0
    proj = {nm: np.vstack([f.project(c) for c in chunks()])
            for nm, f in fits.items()}
    _, _, vt = np.linalg.svd(x - x.mean(axis=0), full_matrices=False)
    tols = pca_tolerances(x, k)
    errs = pcs_up_to_sign(proj["two"], proj["one"], "Gram split", tols)
    pcs_up_to_sign(proj["two"], x @ vt[:k].T, "Gram split against the SVD",
                   tols)
    out["split"] = {"em_two_devices_s": em_split_s, "pca_s": pca_s,
                    "pca_errs": errs, "pca_tolerances": tols}
    log(f"split over [{dev}, {dev}]: _batched_em at {depths.shape[0]} x "
        f"{depths.shape[1]} bitwise one device's ({em_split_s:.3f} s); the "
        f"PCA's Gram step ({n} x {bins}, chunks of {rows} rows, padded with "
        f"mean rows) within pca_tolerances of one device's and of the SVD "
        f"(worst share {max(errs):.3g}); {pca_s['one']:.3f} s one device, "
        f"{pca_s['two']:.3f} s two")

    # (e) the two measurements
    t0 = time.perf_counter()
    ov = measure_resume_overhead(quick=True)
    bt.join(MD_TIMEOUT)
    assert bisect, "bisect_bench.measure() did not finish"
    out["resume_overhead"] = ov
    out["bisect"] = bisect
    log("measure_resume_overhead(quick=True): " + json.dumps(ov))
    log("bisect_bench.measure(): " + json.dumps(bisect))
    launches = (sum(r["launches"][0] + r["launches"][1]
                    for r in runs.values())
                + sum(x["b"][m]["launches"] for x in reps
                      for m in ("all_gather", "scan"))
                + sum(x["c"][d]["launches"] for x in reps for d in ("0", "2"))
                + one_launches)
    out["depth_launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 21 (multi-device): {out['seconds']:.1f} s, "
          f"{launches} depth-kernel launches", flush=True)
    return out


#: the repository's own records, which no command of the port may write
GUARDED_FILES = ("PERF_LEDGER.jsonl", "BENCH_details.json",
                 "BENCH_lastgood.json", "BASELINE_PINNED.json",
                 ".gtlint_baseline.json")


def _sha256(path: str) -> str | None:
    import hashlib

    try:
        with open(path, "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()
    except FileNotFoundError:
        return None


#: the bench's host entries and their platform labels, the JAX
#: package's (None: it writes none); every other entry runs on the card
BENCH_HOST_LABELS = {
    "torch_decode_thread_scaling": "host (no device work)",
    "torch_cram31_codec_decode": None,
    "torch_remote_fetch": "cpu",
    "torch_profiler_overhead": None,
    "torch_memory_overhead": None,
}


def bench_phase(root: str, workdir: str) -> dict:
    """Phase 22: ``bench --quick`` in a fresh process, its records
    through ``perf``, and ``lint`` over the port; no file of the
    repository's own records may change."""
    from goleft_tpu_torch.obs.provenance import nvidia_smi_line

    t_phase = time.perf_counter()
    before = {f: _sha256(os.path.join(root, f)) for f in GUARDED_FILES}
    out_dir = os.path.join(workdir, "bench")
    report = os.path.join(out_dir, "m.json")
    env = dict(os.environ, PYTHONPATH=root)
    r, wall = _run_cli(root, ["bench", "--quick", "--out-dir", out_dir,
                              "--metrics-out", report], env)
    if r.returncode != 0:
        raise AssertionError(f"bench --quick exited {r.returncode}:\n"
                             f"{r.stderr[-6000:]}")
    headline = json.loads(r.stdout.strip().splitlines()[-1])
    with open(os.path.join(out_dir, "details.json")) as fh:
        details = json.load(fh)
    card = __import__("torch").cuda.get_device_name(0)
    want = {"torch_device_kernels", "torch_indexcov_cohort",
            "torch_kernel_vs_plain_depth", "torch_emdepth_em",
            "torch_depth_wholegenome", "torch_indexcov_e2e_wholegenome",
            "torch_cohort_scan", "torch_cohort_e2e_device",
            "torch_cohort_e2e", "torch_pairhmm_forward",
            "torch_read_mapping", "torch_serve_throughput",
            "torch_fleet_throughput", "torch_fleet_restart_recovery_s",
            "torch_fleet_failover_recovery_s",
            "torch_cohort_resume_overhead", "torch_wire_decode",
            *BENCH_HOST_LABELS}
    if set(details) != want:
        raise AssertionError(f"bench entries {sorted(details)}, want "
                             f"{sorted(want)}")
    for name, entry in details.items():
        if not name.startswith("torch_") or "error" in entry:
            raise AssertionError(f"bench entry {name}: {entry}")
        if name in BENCH_HOST_LABELS:
            if entry.get("platform") != BENCH_HOST_LABELS[name]:
                raise AssertionError(f"bench host entry {name}: {entry}")
        elif entry.get("platform") != "cuda" or entry.get("device") != card:
            raise AssertionError(f"bench entry {name}: {entry}")
    codec = details["torch_cram31_codec_decode"]
    if codec["native_lib"] is not True or set(codec["codecs"]) != {
            "rans_nx16_o0", "rans_nx16_o1", "arith_o0", "arith_o1",
            "fqzcomp", "tok3_names"} or not all(
            c["decode_mb_per_sec"] > 0 for c in codec["codecs"].values()):
        raise AssertionError(f"bench codec entry: {codec}")
    wire = details["torch_wire_decode"]
    if "device_pallas_mb_s" in wire or not all(
            v > 0 for v in (wire["device_scan_mb_s"],
                            wire["order1"]["device_scan_mb_s"],
                            wire["stripe"]["device_scan_mb_s"])):
        raise AssertionError(f"bench wire entry: {wire}")
    for name in ("torch_fleet_restart_recovery_s",
                 "torch_fleet_failover_recovery_s"):
        if not details[name]["recovery_seconds"] > 0:
            raise AssertionError(f"bench {name}: {details[name]}")
    if headline.get("metric") != "torch_cohort_depth_e2e_gbases_per_sec" \
            or not headline.get("value", 0) > 0:
        raise AssertionError(f"bench headline {headline}")
    floor = details["torch_cohort_e2e"].get("decode_floor")
    if not floor or not floor["ring_inflate_crc_ms"] > 0:
        raise AssertionError(f"bench decode floor: {floor}")
    rep, bench_s, _ = read_manifest(report, "bench")
    launches = rep["kernel_launches"]
    for k in ("depth", "pairhmm", "swalign", "rans"):
        if not launches.get(k):
            raise AssertionError(f"bench launched no {k} kernel: {launches}")
    if rep["backend"]["platform"] != "gpu":
        raise AssertionError(f"bench manifest backend {rep['backend']}")

    # lint (host work over the port's sources) beside the perf commands
    lint = _BG.submit(_run_cli, root,
                      ["lint", "--stats", "--max-seconds", "90"], env)
    added = []
    for _ in range(2):
        r, _ = _run_cli(root, ["perf", "ingest", "--root", out_dir], env)
        m = re.search(r"perf ingest: (\d+) new record", r.stdout)
        if r.returncode != 0 or not m:
            raise AssertionError(f"perf ingest: {r.returncode} "
                                 f"{r.stdout} {r.stderr[-2000:]}")
        added.append(int(m.group(1)))
    if added[0] < 1 or added[1] != 0:
        raise AssertionError(f"perf ingest added {added} records")
    r, _ = _run_cli(root, ["perf", "check", "--root", out_dir], env)
    if r.returncode != 0:
        raise AssertionError(f"perf check exited {r.returncode}: "
                             f"{r.stdout} {r.stderr[-2000:]}")
    check_line = r.stdout.strip().splitlines()[-1]
    r, _ = _run_cli(root, ["perf", "report", "--root", out_dir], env)
    if r.returncode != 0:
        raise AssertionError(f"perf report exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    r, lint_s = lint.result()
    if r.returncode != 0 or "0 finding(s)" not in r.stdout:
        raise AssertionError(f"lint exited {r.returncode}: {r.stdout} "
                             f"{r.stderr[-4000:]}")
    after = {f: _sha256(os.path.join(root, f)) for f in GUARDED_FILES}
    if after != before:
        raise AssertionError(f"the repository's records changed: "
                             f"{before} -> {after}")
    kern = details["torch_device_kernels"]
    out = {
        "seconds": time.perf_counter() - t_phase,
        "bench_wall_s": wall, "bench_command_s": bench_s,
        "headline": headline, "launches": launches,
        "ingested": added, "perf_check": check_line,
        "lint_s": lint_s, "lint_stats": r.stderr.strip().splitlines()[-1],
        "kernel_gbases_per_sec": {
            k: kern[k] for k in kern
            if k.startswith("kernel_") and k.endswith("_per_sec")},
        "entries": details, "nvidia_smi": nvidia_smi_line(),
    }
    log(f"bench --quick: headline {headline['metric']} "
        f"{headline['value']} {headline['unit']} (vs_baseline "
        f"{headline['vs_baseline']}); depth kernel "
        + ", ".join(f"{k} {v}" for k, v in
                    out["kernel_gbases_per_sec"].items())
        + f"; launches {launches}; {wall:.1f} s in its process; perf "
        f"ingest {added}, {check_line}; lint {out['lint_stats']}; "
        f"phase {out['seconds']:.1f} s on {out['nvidia_smi']}")
    for name, entry in sorted(details.items()):
        log(f"  {name}: " + json.dumps(
            {k: v for k, v in entry.items()
             if isinstance(v, (int, float)) and not isinstance(v, bool)}))
    log("  codecs MB/s (C path): " + json.dumps(
        {k: v["decode_mb_per_sec"] for k, v in codec["codecs"].items()})
        + "; wire device_scan MB/s order0 "
        f"{wire['device_scan_mb_s']}, order1 "
        f"{wire['order1']['device_scan_mb_s']}, stripe "
        f"{wire['stripe']['device_scan_mb_s']}; decode floor "
        + json.dumps(floor))
    return out


def build_kernels(mods) -> dict:
    """One nvcc per kernel source, all started together → build seconds
    per kernel."""
    def build(mod):
        t0 = time.perf_counter()
        mod.load_library()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(mods)) as pool:
        futs = {name: pool.submit(build, mod) for name, mod in mods.items()}
        return {name: f.result() for name, f in futs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--trace-dir", help="keep the flags phase's "
                    "--trace-out files in this directory")
    args = ap.parse_args(argv)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from goleft_tpu_torch.obs.provenance import (card_provenance,
                                                nvidia_smi_line)
    from goleft_tpu_torch.ops import depth_kernel as dk
    from goleft_tpu_torch.ops import norm_kernel as nk
    from goleft_tpu_torch.ops import pairhmm_kernel as pk
    from goleft_tpu_torch.ops import rans_kernel as rk
    from goleft_tpu_torch.ops import swalign_kernel as sk

    prov = card_provenance()
    log("provenance: " + json.dumps(prov))
    dev = torch.device("cuda", 0)

    # one probe of the card stands for every device command this script
    # starts (the probe's success cache outlives the run); it runs beside
    # the kernel builds and phases 3 and 3b, which start no command
    os.environ["GOLEFT_TPU_PROBE_TTL_SECONDS"] = "3600"
    os.environ.pop("GOLEFT_TPU_PROBE", None)
    probe_fx = _BG.submit(first_probe)
    t0 = time.perf_counter()
    built = build_kernels({"depth": dk, "pairhmm": pk, "rans": rk,
                           "indexcov_norm": nk, "swalign": sk})
    log(f"kernels built in parallel in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))
    for mod in (dk, pk, rk, nk, sk):
        log(mod.BUILD_LOG.strip())

    blank = {"status": "fail", "launches": 0, "max_abs_err": None,
             "ms": None, "plain_ms": None, "bound_ms": None,
             "bound_by": None, "library_ms": None}
    depth = dict(name="depth", route="cuda",
                 source="goleft_tpu_torch/csrc/depth_kernel.cu",
                 replaces="goleft_tpu/ops/pallas_coverage.py:96", **blank)
    pairhmm = dict(name="pairhmm", route="cuda",
                   source="goleft_tpu_torch/csrc/pairhmm_kernel.cu",
                   replaces="goleft_tpu/ops/pairhmm.py:576", **blank)
    rans = dict(name="rans", route="cuda",
                source="goleft_tpu_torch/csrc/rans_kernel.cu",
                replaces="goleft_tpu/ops/rans_device.py:494", **blank)
    norm = dict(name="indexcov_norm", route="cuda",
                source="goleft_tpu_torch/csrc/indexcov_norm.cu",
                replaces="goleft_tpu/cohort/streaming.py:156 (lax.scan, "
                         "no Pallas)", **blank)
    swk = dict(name="swalign", route="cuda",
               source="goleft_tpu_torch/csrc/swalign_kernel.cu",
               replaces="goleft_tpu/ops/swalign.py:82 (XLA fori_loop, "
                        "no Pallas)", **blank)
    kernels = [depth, pairhmm, rans, norm, swk]
    results = {"provenance": prov, "build_s": built}
    workdir = os.path.join(root, "build", "chip_smoke")
    # the rANS phase's plain versions on the host CPU, in worker processes
    # that run on beside the cohort and flags phases
    plain_pool = mp.get_context("spawn").Pool(4)
    try:
        results["kernel"] = kres = kernel_phase(dev)
        results["depth_batch"] = dbres = depth_batch_phase(dev)
        depth["batch"] = {k: dbres[k] for k in (
            "b", "ms", "singles_ms", "bound_ms", "bound_by", "bytes",
            "entries", "scratch_bytes", "output_bytes", "checked")}
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        # the Python processes this script starts share one bytecode
        # cache in the work directory: where the installed packages carry
        # none and writing it is turned off (PYTHONDONTWRITEBYTECODE),
        # each process would compile torch's modules again, ~2 s apiece
        os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
        os.environ["PYTHONPYCACHEPREFIX"] = os.path.join(workdir, "pycache")
        results["first_probe"] = fp = probe_fx.result()
        log(f"first probe of the card, beside the builds and phases 3-3b: "
            f"{fp['mode']} in {fp['seconds']:.3f} s")
        results["e2e"], depth_fixture = e2e_phase(root, workdir)
        e2e = results["e2e"]
        # phase 4b's guard and provenance runs go on beside phase 5
        guard_fx = _BG.submit(guard_phase, root, workdir, depth_fixture)
        main_wire = kres["u16"]  # the packed wire is the main path's
        depth.update(status="pass", launches=e2e["launches"],
                     max_abs_err=kres["max_abs_err"],
                     ms=main_wire["ms"], plain_ms=main_wire["plain_ms"],
                     bound_ms=main_wire["bound_ms"],
                     bound_by=main_wire["bound_by"],
                     device_ms=main_wire["device_ms"],
                     scratch_bytes=main_wire["scratch_bytes"])
        # the cohort phase's CRAMs are written in a worker process beside
        # the pair-HMM phases (host work that nothing there waits on)
        t0 = time.perf_counter()
        cohort_fx = plain_pool.apply_async(
            cohort_fabricate, (workdir, np.random.default_rng(31)))
        results["pairhmm_kernel"] = pres = pairhmm_kernel_phase(dev,
                                                                plain_pool)
        e2e["import_breakdown"] = e2e["import_breakdown"].result()
        results["guard"] = guard_fx.result()
        log("import breakdown (python -X importtime, a second process "
            "beside phase 5, cumulative seconds): "
            + json.dumps(e2e["import_breakdown"]))
        pe2e, pairhmm_oracle_check = pairhmm_e2e_phase(root, workdir,
                                                       plain_pool)
        results["pairhmm_e2e"] = pe2e
        f32 = pres["float32"]  # the main path's instantiation
        pairhmm.update(status="pass", launches=pe2e["launches"],
                       max_abs_err=pres["max_abs_err"], ms=f32["ms"],
                       plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
                       bound_by=f32["bound_by"])

        fab_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        crams, fai, names, truth = cohort_fx.get()
        want = cohort_oracle(truth, names)
        log(f"fabricated {CO_SAMPLES} CRAMs of {CO_READS} reads on a "
            f"{CO_LEN} bp contig ({CO_RPC} records per container, "
            f"{sum(os.path.getsize(c) for c in crams)} bytes) in a worker "
            f"process beside the pair-HMM phases ({fab_s:.1f} s), and the "
            f"oracle matrix; waited {time.perf_counter() - t0:.1f} s")
        rres, rans_plain_checks = rans_kernel_phase(dev, crams, plain_pool)
        results["rans_kernel"] = rres
        results["cohort_e2e"] = co = cohort_e2e_phase(root, workdir, crams,
                                                      fai, want)
        results["flags"] = flags_phase(
            root, workdir, depth_fixture, pe2e, crams, fai, want,
            co["hybrid"]["launches"]["rans"],
            {"cohort": co["hybrid"]["command_s"],
             "pairhmm": pe2e["command_s"]}, args.trace_dir)
        results["em"], em_fx = em_phase(root, dev)
        results["cnv_e2e"] = cnv = cnv_e2e_phase(root, workdir)
        depth["cnv_launches"] = cnv["runs"]["device"]["launches"]["depth"]
        results["norm_kernel"] = nres = norm_kernel_phase(dev)
        # the rANS phase's plain versions and the pair-HMM oracle, done on
        # the host by now
        rans_plain_checks()
        pe2e["oracle_pl_max_diff"] = pairhmm_oracle_check()
        o0 = rres["ORDER0"]  # the cohort's most common codec
        rans.update(status="pass", launches=co["hybrid"]["launches"]["rans"],
                    max_abs_err=rres["max_abs_err"], ms=o0["ms"],
                    plain_ms=o0["plain_ms"], bound_ms=o0["bound_ms"],
                    bound_by=o0["bound_by"],
                    chain_bound_ms=o0["chain_bound_ms"])
        results["indexcov"], ic_fixture = indexcov_phase(root, workdir)
        ic = results["indexcov"]
        results["cohortscan"] = cs = cohortscan_phase(root, workdir,
                                                      *ic_fixture, dev)
        results["multidepth"] = mdp = multidepth_phase(
            root, workdir, dev, cnv["bams"], depth_fixture[0])
        depth["multidepth_launches"] = {k: v["launches"]
                                        for k, v in mdp["runs"].items()}
        norm.update(status="pass", launches=ic["runs"]["B"]["launches"],
                    cohortscan_launches=cs["runs"]["S"]["launches"],
                    max_abs_err=nres["max_abs_err"], ms=nres["ms"],
                    plain_ms=nres["plain_ms"], bound_ms=nres["bound_ms"],
                    bound_by=nres["bound_by"],
                    chain_bound_ms=nres["chain_bound_ms"],
                    ms_by_samples={n: w["ms"]
                                   for n, w in nres["widths"].items()},
                    ptxas=nres["ptxas"])
        results["sw_kernel"] = sres = sw_kernel_phase(dev)
        results["map"] = mres = map_phase(root, workdir, dev,
                                          depth_fixture[0])
        depth["map_launches"] = mres["launches"]["depth"]
        depth["map_max_abs_err"] = mres["depth_max_abs_err"]
        results["serve"] = sv = serve_phase(root, workdir, {
            "depth": depth_fixture, "cnv_bams": cnv["bams"],
            "cnv_fa": cnv["fa"], "pairhmm": pe2e["fixture"],
            "pairhmm_launches": pe2e["launches"], "crams": crams,
            "cram_fai": fai, "matrix": want,
            "rans_launches": co["hybrid"]["launches"]["rans"],
            "bais": ic_fixture[0], "ic_fai": ic_fixture[1],
            "ic_out": ic["out_c"], "map": mres["fixture"]})
        depth["serve_launches"] = sv["launches"]["depth"]
        depth["serve_burst_launches"] = sv["burst_passes"]
        results["fleet"] = fl = fleet_phase(root, workdir, {
            "depth": depth_fixture, "cnv_fa": cnv["fa"]}, sv)
        sv.pop("burst_bodies")
        depth["fleet_launches"] = fl["launches"]
        results["multi_device"] = md = multi_device_phase(
            root, workdir, dev, cnv, em_fx)
        del em_fx
        depth["multi_device_launches"] = md["depth_launches"]
        results["bench"] = bres = bench_phase(root, workdir)
        depth["bench_launches"] = bres["launches"]["depth"]
        swk.update(status="pass", launches=mres["launches"]["swalign"],
                   max_abs_err=sres["max_abs_err"], ms=sres["ms"],
                   plain_ms=sres["plain_ms"], bound_ms=sres["bound_ms"],
                   bound_by=sres["bound_by"], copy_ms=sres["copy_ms"],
                   plane_alloc_bytes=sres["plane_alloc_bytes"],
                   ptxas=sres["ptxas"])
    finally:
        plain_pool.terminate()
        plain_pool.join()
        shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"kernels": kernels}), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(dict(results, kernels=kernels), fh, indent=1)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
