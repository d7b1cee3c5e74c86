"""Batch executors: one coalesced pass per request batch, on the card.

The counterpart of the JAX package's serve/executors.py. Each executor
owns one request kind: ``group_key(req)`` is the signature the batcher
groups on (same parameters, same regions, same launch geometry);
``run(reqs)`` executes the whole batch and returns one response dict per
request, in order, with the bytes the one-shot command writes.

  - depth: every request's sample joins ONE launch of the depth kernel
    per region (DepthEngine.run_segments_batch, the kernel's batch
    axis): a burst of B requests costs the card one launch a region
  - indexcov: all requests' samples stack into one ``chrom_qc`` call a
    chromosome (PyTorch ops; no hand kernel); the one cross-sample term,
    the missing-tail-bin count against the longest sample, is corrected
    back to each request's own cohort on the host, exactly
  - cohortdepth: the requests' cohorts concatenate into one
    ``cohort_matrix_blocks`` run (rANS kernel under ``decode_device`` on
    CRAMs, the depth kernel under ``engine=device``); each response
    slices its own sample columns
  - cohortscan: one whole-cohort scan a request (indexcov_norm kernel
    under ``extranormalize``), not coalesced
  - pairhmm: all requests' windows flatten into one bucketed batch of
    the pair-HMM kernel (padding-invariant, so coalescing changes no
    request's bytes)
  - map: per request ``map_reads`` (swalign kernel) and, with
    ``window``, ``depth_bed_from_tuples`` (depth kernel), sharing one
    minimizer index per reference

Executors run on the batcher's one dispatcher thread: passes are
serialised, and the kernel libraries stay loaded across requests. Every
device pass goes through ``plan/executor.py::run_device_step``. A kernel
that fails raises ``KernelFault`` out of the executor: the request fails
(500) and the endpoint's breaker counts it; nothing answers from the CPU.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import io
import os
import re
from typing import Sequence

import numpy as np

from ..io import remote as _remote

# the existence check of paths and of http(s)/s3 URLs
_exists = _remote.exists


class BadRequest(ValueError):
    """Malformed/unsupported request payload (HTTP 400)."""


def _stage(metrics, name: str):
    """metrics.timer span, or a no-op when running without metrics."""
    if metrics is None:
        return contextlib.nullcontext()
    return metrics.timer.stage(name)


def _dispatch(metrics, name: str, fn, retry: bool = True, key=None,
              count_passes: bool = False, signature=None, **attrs):
    """The executors' dispatch boundary (plan/executor.py::
    run_device_step): the ``compute`` stage, a device span, the
    ``device`` fault site per attempt, transient failures retried under
    the default policy. ``key``: the pass's content identity (every
    input's file_key, the parameters, the batch order). ``signature``:
    the launch geometry, for the compile observatory and warm starts.
    Failures past the retry budget raise; the batcher's bisection then
    narrows them to the request at fault."""
    from ..plan.executor import run_device_step

    return run_device_step(name, fn, metrics=metrics, retry=retry,
                           key=key, count_passes=count_passes,
                           signature=signature, **attrs)


def _require(req: dict, field: str):
    v = req.get(field)
    if not v:
        raise BadRequest(f"missing required field {field!r}")
    return v


def _resolve_fai(req: dict) -> str:
    """reference/fai resolution shared by depth and cohortdepth, the
    rules of run_depth (reference implies reference.fai, written on
    demand when only the fasta exists)."""
    fai = req.get("fai")
    reference = req.get("reference")
    fai_path = fai or (reference + ".fai" if reference else None)
    if fai_path is None:
        raise BadRequest("need 'reference' (with .fai) or 'fai'")
    if not _exists(fai_path):
        if reference and not _remote.is_remote(reference) \
                and os.path.exists(reference):
            from ..io.fai import write_fai

            write_fai(reference)
        else:
            raise BadRequest(f"fasta index not found: {fai_path}")
    return fai_path


class _Executor:
    def __init__(self, processes: int = 4, metrics=None, device=None,
                 checkpoint_root: str | None = None):
        self.processes = processes
        self.metrics = metrics
        self.device = device
        self.checkpoint_root = checkpoint_root


class DepthExecutor(_Executor):
    """`/v1/depth`: one BAM/CRAM per request → the depth.bed and
    callable.bed bytes of the one-shot command."""

    kind = "depth"

    def validate(self, req: dict) -> None:
        bam = _require(req, "bam")
        if not _exists(bam):
            raise BadRequest(f"no such file: {bam}")
        if not req.get("bed"):
            _resolve_fai(req)

    def group_key(self, req: dict) -> tuple:
        return (self.kind, int(req.get("window", 250)),
                int(req.get("mincov", 4)),
                int(req.get("maxmeandepth", 0)),
                int(req.get("mapq", 1)), req.get("chrom", "") or "",
                req.get("bed") or None,
                None if req.get("bed") else _resolve_fai(req))

    def cache_files(self, req: dict) -> list[str]:
        return [req["bam"]]

    def run(self, reqs: Sequence[dict]) -> list[dict]:
        from ..commands.depth import (
            DepthEngine, _decode_shard_segments, gen_regions,
            write_shard_output,
        )
        from ..io.bai import read_bai
        from ..io.bam import open_bam_file
        from ..io.fai import read_fai
        from ..ops.depth_kernel import bucket_entries
        from ..parallel.scheduler import file_key

        p0 = reqs[0]
        window = int(p0.get("window", 250))
        mapq = int(p0.get("mapq", 1))
        bed = p0.get("bed") or None
        chrom = p0.get("chrom", "") or ""
        fai_records = [] if bed else read_fai(_resolve_fai(p0))
        regions = gen_regions(fai_records, chrom, window, bed)
        max_span = max((e - (s // window) * window
                        for _, s, e in regions), default=1)
        mincov = int(p0.get("mincov", 4))
        maxmeandepth = int(p0.get("maxmeandepth", 0))
        engine = DepthEngine(window, mincov, maxmeandepth, mapq,
                             max_span=max_span, device=self.device)
        # content identity of one region pass: every parameter the
        # engine reads, the region source, each member's BAM in order
        base_key = ("serve.depth", window, mincov, maxmeandepth, mapq,
                    chrom, file_key(bed) if bed
                    else file_key(_resolve_fai(p0)),
                    tuple(file_key(r["bam"]) for r in reqs))

        def _open(req):
            handle = open_bam_file(req["bam"])
            if getattr(handle, "is_cram", False):
                bai = None
            else:
                b = req["bam"]
                bai = read_bai(b + ".bai" if _exists(b + ".bai")
                               else b[:-4] + ".bai")
            tid_of = {n: i
                      for i, n in enumerate(handle.header.ref_names)}
            return handle, bai, tid_of

        opened = [_open(r) for r in reqs]
        outs = [(io.StringIO(), io.StringIO()) for _ in reqs]
        try:
            with cf.ThreadPoolExecutor(
                    max_workers=max(1, self.processes)) as ex:
                for c, s, e in regions:
                    def _dec(o, c=c, s=s, e=e):
                        handle, bai, tid_of = o
                        return _decode_shard_segments(
                            handle, bai, tid_of.get(c, -1), s, e, mapq)

                    with _stage(self.metrics, "decode"):
                        segs = list(ex.map(_dec, opened))
                    starts, ends, sums, cls = _dispatch(
                        self.metrics, "serve.depth.dispatch",
                        lambda: engine.run_segments_batch(segs, s, e),
                        key=base_key + (c, s, e), count_passes=True,
                        # the launch's geometry: what a warm start
                        # replays (serve/warmstart.py)
                        signature={
                            "b": len(segs),
                            "bucket": bucket_entries(max(
                                max((len(ss) for ss, _ in segs),
                                    default=0), 1)),
                            "length": engine.length,
                            "window": engine.w_eff,
                        },
                        batch=len(segs), region=f"{c}:{s}-{e}")
                    with _stage(self.metrics, "format"):
                        for i, (dout, cout) in enumerate(outs):
                            write_shard_output(c, starts, ends,
                                               sums[i], cls[i], s,
                                               dout, cout, None)
        finally:
            for handle, _, _ in opened:
                close = getattr(handle, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:  # noqa: BLE001 — best-effort
                        pass
        return [{
            "depth_bed": d.getvalue(),
            "callable_bed": c.getvalue(),
            "shards": len(regions),
        } for d, c in outs]


class IndexcovExecutor(_Executor):
    """`/v1/indexcov`: index-only cohort QC, per-sample copy number and
    bin counters a chromosome, one chrom_qc call a chromosome for the
    whole batch."""

    kind = "indexcov"

    def validate(self, req: dict) -> None:
        for p in _require(req, "bams"):
            if not _exists(p):
                raise BadRequest(f"no such file: {p}")
        fai = _require(req, "fai")  # batching needs one shared ref dict
        if not _exists(fai):
            raise BadRequest(f"no such file: {fai}")

    def group_key(self, req: dict) -> tuple:
        from ..commands.indexcov import DEFAULT_EXCLUDE

        return (self.kind, req["fai"], req.get("chrom", "") or "",
                req.get("excludepatt", DEFAULT_EXCLUDE))

    def cache_files(self, req: dict) -> list[str]:
        return list(req["bams"])

    def run(self, reqs: Sequence[dict]) -> list[dict]:
        import torch

        from ..commands.indexcov import (
            DEFAULT_EXCLUDE, SampleIndex, _pad_rows, get_short_name,
            references,
        )
        from ..ops import indexcov_ops as ops
        from ..parallel.scheduler import file_key

        p0 = reqs[0]
        refs = references([], p0["fai"], p0.get("chrom", "") or "")
        patt = p0.get("excludepatt", DEFAULT_EXCLUDE)
        exclude = re.compile(patt) if patt else None

        # the index file (what normalized_depth reads) beside the path,
        # so a rebuilt .bai/.crai changes the key
        def _input_keys(p):
            keys = [file_key(p)] if _exists(p) else [p]
            for ext in (".bai", ".crai"):
                if _exists(p + ext):
                    keys.append(file_key(p + ext))
            return tuple(keys)

        base_key = ("serve.indexcov", file_key(p0["fai"]),
                    p0.get("chrom", "") or "", patt,
                    tuple(_input_keys(p)
                          for r in reqs for p in r["bams"]))
        paths = [p for r in reqs for p in r["bams"]]
        with cf.ThreadPoolExecutor(
                max_workers=max(1, self.processes)) as ex:
            idxs = list(ex.map(SampleIndex, paths))
            names = list(ex.map(get_short_name, paths))
        bounds = np.cumsum([0] + [len(r["bams"]) for r in reqs])
        S = len(idxs)
        out = [{"samples": names[lo:hi], "chroms": [], "cn": {},
                "bin_counters": {k: [0] * (hi - lo)
                                 for k in ("in", "out", "hi", "low")}}
               for lo, hi in zip(bounds, bounds[1:])]
        dev = self.device

        def qc(mat, lengths, longest):
            mat_t = torch.from_numpy(mat).to(dev)
            valid_t = (torch.arange(mat.shape[1], device=dev)[None, :]
                       < torch.from_numpy(lengths).to(dev)[:, None])
            return ops.chrom_qc(mat_t, valid_t, longest).cpu().numpy()

        for ref_id, ref_name, _len in refs:
            if exclude is not None and exclude.search(ref_name):
                continue
            rows = [idx.normalized_depth(ref_id) for idx in idxs]
            mat, _valid, lengths = _pad_rows(rows)
            longest = int(lengths.max())
            if longest == 0:
                continue
            packed = _dispatch(
                self.metrics, "serve.indexcov.dispatch",
                lambda: qc(mat, lengths, longest),
                key=base_key + (int(ref_id), ref_name),
                count_passes=True, samples=S, chrom=ref_name)
            _rocs, counters, cn = ops.unpack_chrom_qc(packed, S)
            for r, (lo, hi) in zip(out, zip(bounds, bounds[1:])):
                # tail bins count against the batch's longest sample:
                # correct out/low back to this request's own cohort
                # (exact integer arithmetic)
                own_longest = int(lengths[lo:hi].max())
                if own_longest == 0:
                    continue
                delta = longest - own_longest
                r["chroms"].append(ref_name)
                r["cn"][ref_name] = [round(float(v), 4)
                                     for v in cn[lo:hi]]
                for k in ("in", "hi"):
                    for j, v in enumerate(counters[k][lo:hi]):
                        r["bin_counters"][k][j] += int(v)
                for k in ("out", "low"):
                    for j, v in enumerate(counters[k][lo:hi]):
                        r["bin_counters"][k][j] += int(v) - delta
        return out


class PairhmmExecutor(_Executor):
    """`/v1/pairhmm`: a windows document (and optional candidates file)
    → the likelihood table bytes of the one-shot command."""

    kind = "pairhmm"

    def validate(self, req: dict) -> None:
        path = _require(req, "input")
        if not _exists(path):
            raise BadRequest(f"no such file: {path}")
        cand = req.get("candidates")
        if cand and not _exists(cand):
            raise BadRequest(f"no such file: {cand}")
        # parsed up front: a malformed document is this request's 400,
        # never a 500 for everyone who shared its batch
        from ..commands.pairhmm_cmd import read_windows
        from ..models.candidates import read_candidates

        try:
            read_windows(path)
            if cand:
                read_candidates(cand)
        except ValueError as e:
            raise BadRequest(str(e)) from None

    def group_key(self, req: dict) -> tuple:
        return (self.kind, float(req.get("gap_open", 45.0)),
                float(req.get("gap_ext", 10.0)),
                bool(req.get("f64", False)))

    def cache_files(self, req: dict) -> list[str]:
        files = [req["input"]]
        if req.get("candidates"):
            files.append(req["candidates"])
        return files

    def run(self, reqs: Sequence[dict]) -> list[dict]:
        from ..commands.pairhmm_cmd import read_windows, select_windows
        from ..models import genotype
        from ..parallel.scheduler import file_key

        p0 = reqs[0]
        with _stage(self.metrics, "decode"):
            per_req = [select_windows(read_windows(r["input"]),
                                      r.get("candidates") or None)
                       for r in reqs]
        windows = [w for ws in per_req for w in ws]
        bounds = np.cumsum([0] + [len(ws) for ws in per_req])
        n_pairs = sum(len(w["reads"]) * len(w["haps"]) for w in windows)
        step_key = ("serve.pairhmm",
                    float(p0.get("gap_open", 45.0)),
                    float(p0.get("gap_ext", 10.0)),
                    bool(p0.get("f64", False)),
                    tuple((file_key(r["input"]),
                           file_key(r["candidates"])
                           if r.get("candidates") else None)
                          for r in reqs))
        results, _n_bad = _dispatch(
            self.metrics, "serve.pairhmm.dispatch",
            lambda: genotype.score_windows(
                windows,
                gap_open=float(p0.get("gap_open", 45.0)),
                gap_ext=float(p0.get("gap_ext", 10.0)),
                dtype=np.float64 if p0.get("f64") else np.float32,
                device=self.device),
            key=step_key, count_passes=True,
            windows=len(windows), pairs=n_pairs)
        with _stage(self.metrics, "format"):
            return [{
                "likelihoods_tsv": genotype.format_table(results[lo:hi]),
                "windows": int(hi - lo),
            } for lo, hi in zip(bounds, bounds[1:])]


class CohortdepthExecutor(_Executor):
    """`/v1/cohortdepth`: the requests' cohorts concatenate into one
    cohort_matrix_blocks pass; each response carries its own
    `#chrom start end sample…` matrix.

    ``checkpoint: true`` (needs ``--checkpoint-root``) runs the pass
    against a persistent CheckpointStore, each region's columns keyed by
    content identity (independent of the batch), so a request issued
    again after a restart resumes from the committed regions."""

    kind = "cohortdepth"

    def validate(self, req: dict) -> None:
        if req.get("checkpoint") and not self.checkpoint_root:
            raise BadRequest(
                "checkpoint: true needs the daemon started with "
                "--checkpoint-root")
        for p in _require(req, "bams"):
            if not _exists(p):
                raise BadRequest(f"no such file: {p}")
        _resolve_fai(req)

    def group_key(self, req: dict) -> tuple:
        return (self.kind, _resolve_fai(req),
                int(req.get("window", 250)), int(req.get("mapq", 1)),
                req.get("chrom", "") or "", req.get("bed") or None,
                req.get("engine", "auto"),
                bool(req.get("checkpoint")),
                bool(req.get("decode_device")))

    def cache_files(self, req: dict) -> list[str]:
        return list(req["bams"])

    def _iter_blocks(self, blocks):
        """Advance the block generator under the dispatch boundary: each
        block's decode and launches happen inside ``next()``.
        ``retry=False``: a half-consumed generator cannot be attempted
        again; failures go to the batcher's bisection."""
        done = object()
        it = iter(blocks)
        i = 0
        while True:
            def _advance():
                try:
                    return next(it)
                except StopIteration:
                    return done

            blk = _dispatch(self.metrics, "serve.cohortdepth.dispatch",
                            _advance, retry=False, block=i)
            if blk is done:
                return
            i += 1
            yield blk

    def _open_store(self, reqs):
        if not (self.checkpoint_root
                and any(r.get("checkpoint") for r in reqs)):
            return None
        from ..resilience.checkpoint import CheckpointStore

        return CheckpointStore(
            os.path.join(self.checkpoint_root, "cohortdepth"), resume=True)

    def run(self, reqs: Sequence[dict]) -> list[dict]:
        from ..commands.cohortdepth import cohort_matrix_blocks, matrix_rows

        p0 = reqs[0]
        all_bams = [p for r in reqs for p in r["bams"]]
        bounds = np.cumsum([0] + [len(r["bams"]) for r in reqs])
        store = self._open_store(reqs)
        total_windows = 0
        try:
            names, blocks = cohort_matrix_blocks(
                all_bams, fai=_resolve_fai(p0),
                window=int(p0.get("window", 250)),
                mapq=int(p0.get("mapq", 1)),
                chrom=p0.get("chrom", "") or "",
                processes=max(1, self.processes),
                engine=p0.get("engine", "auto"),
                bed=p0.get("bed") or None, quarantine=None,
                checkpoint=store,
                decode_device=bool(p0.get("decode_device")),
                device=self.device)
            bufs = [io.StringIO() for _ in reqs]
            for buf, (lo, hi) in zip(bufs, zip(bounds, bounds[1:])):
                buf.write("#chrom\tstart\tend\t"
                          + "\t".join(names[lo:hi]) + "\n")
            for c, starts, ends, vals in self._iter_blocks(blocks):
                if self.metrics:
                    self.metrics.inc("device_passes_total")
                total_windows += len(starts)
                with _stage(self.metrics, "format"):
                    for buf, (lo, hi) in zip(bufs, zip(bounds,
                                                       bounds[1:])):
                        buf.write(matrix_rows(c, starts, ends,
                                              vals[lo:hi]))
        finally:
            if store is not None:
                store.close()
        return [{
            "matrix_tsv": b.getvalue(),
            "samples": names[lo:hi],
            "windows": int(total_windows),
        } for b, (lo, hi) in zip(bufs, zip(bounds, bounds[1:]))]


class CohortscanExecutor(_Executor):
    """`/v1/cohortscan`: the streaming cohort QC scan, the indexcov
    artifacts (bed.gz, .roc, .ped) of the one-shot command.

    Requests are not coalesced: a scan is one whole-cohort pipeline,
    and mixing two cohorts would change each one's normalisation
    scalars. ``checkpoint: true`` (needs ``--checkpoint-root``) keeps
    the scan's store under a directory keyed by the scan parameters
    (not the sample list), so a request issued again resumes and an
    appended cohort computes only the new samples."""

    kind = "cohortscan"

    def validate(self, req: dict) -> None:
        if req.get("checkpoint") and not self.checkpoint_root:
            raise BadRequest(
                "checkpoint: true needs the daemon started with "
                "--checkpoint-root")
        for p in _require(req, "bams"):
            if not _exists(p):
                raise BadRequest(f"no such file: {p}")
        fai = _require(req, "fai")  # URL inputs carry no local .fai
        if not _exists(fai):
            raise BadRequest(f"no such file: {fai}")
        cs = req.get("chunk_samples")
        if cs is not None and int(cs) < 1:
            raise BadRequest("chunk_samples must be >= 1")

    def group_key(self, req: dict) -> tuple:
        from ..commands.indexcov import DEFAULT_EXCLUDE

        return (self.kind, req["fai"], req.get("chrom", "") or "",
                req.get("excludepatt", DEFAULT_EXCLUDE),
                req.get("sex", "X,Y"),
                bool(req.get("extranormalize")),
                bool(req.get("checkpoint")))

    def cache_files(self, req: dict) -> list[str]:
        return list(req["bams"])

    def _scan_dir(self, req: dict) -> tuple[str, str | None, bool]:
        """(output directory, checkpoint_dir, resume) of one request."""
        import hashlib
        import json as _json
        import tempfile

        from ..commands.indexcov import DEFAULT_EXCLUDE

        if not (req.get("checkpoint") and self.checkpoint_root):
            return tempfile.mkdtemp(prefix="cohortscan-"), None, False
        from ..parallel.scheduler import file_key

        ident = _json.dumps([
            "serve.cohortscan", list(file_key(req["fai"])),
            req.get("chrom", "") or "",
            req.get("excludepatt", DEFAULT_EXCLUDE),
            req.get("sex", "X,Y"), bool(req.get("extranormalize")),
        ], sort_keys=True)
        digest = hashlib.sha256(ident.encode()).hexdigest()[:24]
        root = os.path.join(self.checkpoint_root, "cohortscan", digest)
        out_dir = os.path.join(root, "out")
        os.makedirs(out_dir, exist_ok=True)
        return out_dir, os.path.join(root, "ck"), True

    def run(self, reqs: Sequence[dict]) -> list[dict]:
        import base64
        import shutil

        from ..cohort.scan import run_cohortscan
        from ..commands.indexcov import DEFAULT_EXCLUDE

        out = []
        for req in reqs:
            out_dir, ck_dir, resume = self._scan_dir(req)
            try:
                res = _dispatch(
                    self.metrics, "serve.cohortscan.dispatch",
                    lambda: run_cohortscan(
                        list(req["bams"]), out_dir,
                        sex=req.get("sex", "X,Y"),
                        exclude_patt=req.get("excludepatt",
                                             DEFAULT_EXCLUDE),
                        chrom=req.get("chrom", "") or "",
                        fai=req["fai"],
                        extra_normalize=bool(req.get("extranormalize")),
                        include_gl=bool(req.get("includegl")),
                        chunk_samples=int(req.get("chunk_samples", 256)),
                        resume=resume, checkpoint_dir=ck_dir,
                        pca_mode=req.get("pca", "auto"),
                        device=self.device),
                    # a half-finished scan cannot be attempted again in
                    # place; a checkpointed request resumes
                    retry=False, count_passes=True,
                    samples=len(req["bams"]))
                with open(res["bed"], "rb") as f:
                    bed_b64 = base64.b64encode(f.read()).decode("ascii")
                with open(res["roc"]) as f:
                    roc = f.read()
                with open(res["ped"]) as f:
                    ped = f.read()
                out.append({
                    "bed_gz_b64": bed_b64,
                    "roc": roc,
                    "ped": ped,
                    "samples": len(req["bams"]),
                    "chroms": res["chrom_names"],
                    "qc": res["qc"],
                    "diff": {k: len(v) for k, v in res["diff"].items()},
                })
            finally:
                if ck_dir is None:  # a throwaway scan
                    shutil.rmtree(out_dir, ignore_errors=True)
        return out


class MapExecutor(_Executor):
    """`/v1/map`: FASTQ + reference → the mapped read-tuple stream of the
    one-shot ``map`` command (and with ``window`` its depth bed).
    Requests sharing a reference and parameters share one minimizer
    index; each request's reads are seeded and extended on their own,
    so a response cannot depend on what else shared the batch."""

    kind = "map"

    def validate(self, req: dict) -> None:
        fastq = _require(req, "fastq")
        if not _exists(fastq):
            raise BadRequest(f"no such file: {fastq}")
        ref = _require(req, "reference")
        if not _exists(ref):
            raise BadRequest(f"no such file: {ref}")
        for field in ("k", "w", "max_occ", "min_support", "band",
                      "window"):
            v = req.get(field)
            if v is not None and (not isinstance(v, int) or v <= 0):
                raise BadRequest(f"{field} must be a positive int")

    def _params(self, req: dict):
        from ..mapping import MapParams
        from ..mapping.index import DEFAULT_K, DEFAULT_MAX_OCC, DEFAULT_W
        from ..mapping.pipeline import DEFAULT_BAND, DEFAULT_MIN_SUPPORT

        return MapParams(
            k=int(req.get("k", DEFAULT_K)),
            w=int(req.get("w", DEFAULT_W)),
            max_occ=int(req.get("max_occ", DEFAULT_MAX_OCC)),
            band=int(req.get("band", DEFAULT_BAND)),
            min_support=int(req.get("min_support", DEFAULT_MIN_SUPPORT)))

    def group_key(self, req: dict) -> tuple:
        from ..parallel.scheduler import file_key

        try:
            ref_id = tuple(file_key(req["reference"]))
        except OSError:
            ref_id = (req["reference"],)
        return (self.kind, ref_id) + self._params(req).key()

    def cache_files(self, req: dict) -> list[str]:
        return [req["fastq"], req["reference"]]

    def run(self, reqs: Sequence[dict]) -> list[dict]:
        from ..io.fastq import FastqError, read_fastq
        from ..mapping import get_index, map_reads
        from ..mapping.pipeline import depth_bed_from_tuples, format_tuples
        from ..parallel.scheduler import file_key

        p0 = reqs[0]
        params = self._params(p0)
        index = get_index(p0["reference"], k=params.k, w=params.w,
                          max_occ=params.max_occ)
        with _stage(self.metrics, "decode"):
            per_req = []
            for r in reqs:
                try:
                    per_req.append(read_fastq(r["fastq"]))
                except FastqError as e:
                    # a corrupt FASTQ is this request's 400
                    raise BadRequest(str(e)) from None
        out = []
        for r, records in zip(reqs, per_req):
            try:
                fq_id = tuple(file_key(r["fastq"]))
            except OSError:
                fq_id = (r["fastq"],)
            res = _dispatch(
                self.metrics, "serve.map.dispatch",
                lambda idx=index, recs=records: map_reads(
                    idx, recs, params, device=self.device),
                retry=False, count_passes=True,
                key=("serve.map", fq_id) + tuple(self.group_key(r)),
                reads=len(records))
            resp = {
                "tuples_tsv": format_tuples(res.tuples).decode(),
                "reads": res.stats["reads"],
                "mapped": res.stats["mapped"],
                "unmapped": res.stats["unmapped"],
                "failed": res.stats["failed"],
            }
            if r.get("window"):
                lengths = {
                    n: int(index.chrom_starts[i + 1]
                           - index.chrom_starts[i])
                    for i, n in enumerate(index.chrom_names)}
                resp["depth_bed"] = _dispatch(
                    self.metrics, "serve.map.dispatch",
                    lambda res=res, lengths=lengths, w=int(r["window"]):
                    depth_bed_from_tuples(
                        [t for t in res.tuples if t is not None],
                        lengths, w, device=self.device).decode(),
                    retry=False, stage="depth")
            out.append(resp)
        return out
