"""The chunked, incremental cohort-scan engine behind ``cohortscan``, on
the CUDA card: the counterpart of the JAX package's cohort/scan.py.

``run_cohortscan`` writes the bed.gz/.roc/.ped bytes of one-shot
``run_indexcov`` on the same inputs, while holding at most one sample
chunk's matrix in memory and recomputing only what changed across runs.
The pipeline:

1. **Chunk pass (host)**: per sample chunk in cohort order, parse the
   .bai/.crai (local path or ranged-read URL, indexcov's
   ``SampleIndex``), spill each chromosome's raw depth rows to an .npy
   file under the checkpoint directory, and feed the
   :class:`~goleft_tpu_torch.cohort.streaming.NormStats` accumulator
   under ``-n``. Peak memory: O(chunk × bins).
2. **Scalars**: finalize the per-bin normalization scalars per
   chromosome (exact, chunk-invariant).
3. **Emit pass (card + host)**: per chromosome, per chunk, the chunk's
   raw rows go to the card once; under ``-n`` one ``indexcov_norm``
   launch normalizes them against the global scalars and the
   normalized rows come back for the ``norm`` spill; ``chrom_qc`` runs
   on the same device tensor for exactly the samples whose
   content-keyed checkpoint block is missing, and only its packed
   vector comes back (one Step a chunk, per-sample blocks in one
   journal commit). The per-sample QC passes ``longest=0`` so the
   stored block is cohort-independent; the missing-tail-bin counts (an
   additive integer) are corrected on the host against the cohort's
   longest sample. Then bed.gz blocks are streamed by gathering
   (samples × 2048-bin) column slices from the chunk spills.
4. **Finalize**: ROC/ped assembly from the per-sample blocks, PCA (the
   oracle up to ``pca_exact_max`` samples, the chunked power iteration
   above), manifest commit.

Every checkpoint key, manifest field and counter is the reference's, so
a store and manifest either package wrote resume under the other. The
reference pads each chunk's rows to a power of two (``_row_bucket``) and
its width to a bucket to bound its jit compiles; the port pads neither,
since every row of the normalization and of ``chrom_qc`` is independent
of the others and every result masks on the valid bins. The scalars'
digest in the keys is still taken at the reference's bucketed width.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import re
import shutil

import numpy as np
import torch

from ..commands import indexcov as ic
from ..device import resolve_device
from ..io.bgzf import BgzfWriter
from ..obs import get_registry
from ..obs.logging import get_logger
from ..ops import indexcov_ops as ops
from .manifest import CohortManifest
from .streaming import NormStats, apply_normalization, scalars_digest

log = get_logger("cohortscan")

#: bump to invalidate every per-sample QC block (layout change)
SCHEMA = 1
BED_BLOCK = 2048
#: above this sample count the PCA switches from the byte-parity
#: oracle (full-matrix SVD) to the chunked power iteration
PCA_EXACT_MAX = 4096
#: the power iteration's passes read each chunk's quantized rows from
#: the spills; a cohort whose rows take at most this many bytes keeps
#: them in host memory after the first pass
PCA_ROWS_CACHE_BYTES = 1 << 30


def _sample_key(path: str):
    """Content identity of the index file actually read — what every
    checkpoint block and the manifest bind."""
    from ..parallel.scheduler import file_key

    try:
        return file_key(ic._index_file(path))
    except OSError:
        return (path, -1, -1)


def _key_width(longest: int) -> int:
    """The width the reference's spills have for a chromosome whose
    longest sample has ``longest`` bins: its quarter-power-of-two bucket
    (the JAX package's commands/indexcov.py::_width_bucket). The port's
    spills are ``longest`` wide; its checkpoint keys digest the scalars
    at this width, as the reference's do."""
    w = max(longest, 1)
    if w <= 256:
        return 256
    b = 1 << (w - 1).bit_length()
    for cand in (b // 2 + b // 8, b // 2 + b // 4, b // 2 + 3 * (b // 8),
                 b):
        if cand >= w:
            return cand
    return b


class _SpillStore:
    """Run-local per-(chromosome, chunk) raw/normalized matrices on
    disk, mmap-read at emission time. Spills are host-derived and
    cheap, so they are rebuilt on every run — resume durability lives
    in the checkpoint store, not here."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, ref_id: int, ci: int, kind: str) -> str:
        return os.path.join(self.root, f"r{ref_id}_c{ci}_{kind}.npy")

    def put(self, ref_id: int, ci: int, kind: str,
            mat: np.ndarray) -> None:
        np.save(self._path(ref_id, ci, kind), mat)

    def get(self, ref_id: int, ci: int, kind: str) -> np.ndarray:
        return np.load(self._path(ref_id, ci, kind), mmap_mode="r")

    def drop(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


# spill-matrix budget for --chunk-samples 0 (auto): one chunk's raw
# matrices should fit here; the bound is advisory (auto_chunk_samples
# clamps to [8, 4096]), not an allocator limit
AUTO_CHUNK_BUDGET_BYTES = 256 * 1024 * 1024


def run_cohortscan(
    bams: list[str],
    directory: str,
    sex: str = "X,Y",
    exclude_patt: str = ic.DEFAULT_EXCLUDE,
    chrom: str = "",
    fai: str | None = None,
    extra_normalize: bool = False,
    include_gl: bool = False,
    chunk_samples: int = 256,
    manifest_path: str | None = None,
    resume: bool = False,
    checkpoint_dir: str | None = None,
    pca_mode: str = "auto",
    pca_exact_max: int = PCA_EXACT_MAX,
    device=None,
) -> dict:
    """The command's body on ``device`` (the card unless ``"cpu"``) →
    {sexes, counters, slopes, pcs, var_frac, ped, bed, roc, manifest,
    chrom_names, diff, qc, memory, stages}."""
    if chunk_samples < 0:
        raise ValueError(
            "cohortscan: --chunk-samples must be >= 1, or 0 to "
            "auto-size from measured per-sample bytes")
    if pca_mode not in ("auto", "exact", "sharded"):
        raise ValueError(f"cohortscan: unknown pca mode {pca_mode!r}")
    dev = resolve_device(device)
    os.makedirs(directory, exist_ok=True)
    sex_chroms = [s for s in sex.split(",") if s] if sex else []
    exclude = re.compile(exclude_patt) if exclude_patt else None
    reg = get_registry()

    bams = ic.expand_globs(bams)
    refs = ic.references(bams, fai, chrom)
    n_samples = len(bams)
    log.info("cohortscan: %d samples in chunks of %s", n_samples,
             chunk_samples or "auto")

    name = os.path.basename(os.path.abspath(directory))
    base = os.path.join(directory, name + "-indexcov")
    if checkpoint_dir is None:
        checkpoint_dir = os.path.join(directory, ".cohortscan-ck")
    if manifest_path is None:
        manifest_path = base + ".manifest.json"

    from ..resilience.checkpoint import CheckpointStore

    store = CheckpointStore(checkpoint_dir, resume=resume)
    spill = _SpillStore(os.path.join(checkpoint_dir, "spill"))

    params = {"sex": sex, "exclude": exclude_patt, "chrom": chrom,
              "extra_normalize": bool(extra_normalize),
              "tile": ic.TILE, "schema": SCHEMA}

    # ---- manifest diff (informational; invalidation is key-based) ----
    keys = [_sample_key(b) for b in bams]
    prev = None
    if os.path.exists(manifest_path):
        try:
            prev = CohortManifest.load(manifest_path)
        except (OSError, ValueError) as e:
            log.warning("cohortscan: ignoring unreadable manifest: %s", e)
    sample_docs = [{"path": b, "name": None, "key": list(k)}
                   for b, k in zip(bams, keys)]
    if prev is not None and prev.params != params:
        log.warning(
            "cohortscan: scan parameters changed since the committed "
            "manifest — every QC block misses (full recompute)")
        prev = None
    diff = (prev.diff(sample_docs) if prev is not None
            else {"new": list(bams), "changed": [], "unchanged": [],
                  "removed": []})

    from ..utils.profiling import StageTimer

    timer = StageTimer()

    # prior run's per-chunk high-water mark (journaled via note());
    # reported back so a --resume run knows what its predecessor
    # actually paid without re-measuring
    prior_peak = (int(store.meta.get("chunk_peak_bytes") or 0)
                  if resume else 0)
    if prior_peak:
        log.info("cohortscan: prior run peaked at %d bytes/chunk",
                 prior_peak)

    if chunk_samples == 0:
        # auto-size: journaled measurement from the prior run when
        # resuming, else probe one sample's index and extrapolate
        from ..obs.memplane import auto_chunk_samples

        per_sample = int(store.meta.get("per_sample_bytes") or 0)
        src = "journal"
        if per_sample <= 0 and bams:
            with timer.stage("chunk_probe"):
                try:
                    probe = ic.SampleIndex(bams[0])
                except ValueError as e:
                    raise SystemExit(f"cohortscan: {bams[0]}: {e}")
                per_sample = sum(
                    int(np.asarray(probe.normalized_depth(rid)).nbytes)
                    for rid, rname, _ in refs
                    if exclude is None or not exclude.search(rname))
                del probe
            src = "probe"
        chunk_samples = auto_chunk_samples(
            per_sample, AUTO_CHUNK_BUDGET_BYTES, n_samples)
        log.info(
            "cohortscan: auto chunk size %d (%s: %d bytes/sample, "
            "budget %d)", chunk_samples, src, per_sample,
            AUTO_CHUNK_BUDGET_BYTES)

    # ---- pass 1: chunked index parse + raw spills + norm stats ----
    chunks = [(lo, min(lo + chunk_samples, n_samples))
              for lo in range(0, n_samples, chunk_samples)]
    names: list[str] = [None] * n_samples
    mapped = [0] * n_samples
    unmapped = [0] * n_samples
    lengths_by_ref: dict[int, np.ndarray] = {
        rid: np.zeros(n_samples, np.int32) for rid, _, _ in refs}
    stats_by_ref: dict[int, NormStats] = {}
    if extra_normalize and n_samples >= 5:
        for rid, rname, _ in refs:
            if not ic._same_chrom(sex_chroms, rname):
                stats_by_ref[rid] = NormStats()

    def _load(p):
        try:
            return ic.SampleIndex(p)
        except ValueError as e:
            raise SystemExit(f"cohortscan: {p}: {e}")

    chunk_peak_bytes = 0
    spilled_bytes = 0
    for ci, (lo, hi) in enumerate(chunks):
        with timer.stage("index_load"):
            with cf.ThreadPoolExecutor(max_workers=8) as tex:
                idxs = list(tex.map(_load, bams[lo:hi]))
                names[lo:hi] = list(tex.map(ic.get_short_name,
                                            bams[lo:hi]))
        for off, idx in enumerate(idxs):
            mapped[lo + off] = idx.mapped
            unmapped[lo + off] = idx.unmapped
        cbytes = 0
        with timer.stage("spill"):
            for rid, rname, _rlen in refs:
                if exclude is not None and exclude.search(rname):
                    continue
                rows = [idx.normalized_depth(rid) for idx in idxs]
                mat, _valid, lens = ic._pad_rows(rows)
                lengths_by_ref[rid][lo:hi] = lens
                spill.put(rid, ci, "raw", mat)
                cbytes += int(mat.nbytes)
                st = stats_by_ref.get(rid)
                if st is not None:
                    st.accumulate(mat, lens)
        chunk_peak_bytes = max(chunk_peak_bytes, cbytes)
        spilled_bytes += cbytes
        del idxs

    # journal the measured footprint (fsync'd {"meta": ...} line): a
    # --resume run reads it back (store.meta) to report the prior
    # high-water mark and to size auto chunks from evidence instead
    # of a probe
    per_sample_bytes = (spilled_bytes // n_samples) if n_samples else 0
    store.note(chunk_peak_bytes=chunk_peak_bytes,
               per_sample_bytes=per_sample_bytes,
               chunk_samples=chunk_samples)

    # ---- pass 2 + emission ----
    bed_fh = open(base + ".bed.gz", "wb")
    bed = BgzfWriter(bed_fh, level=1)
    bed.write(("#chrom\tstart\tend\t" + "\t".join(names) + "\n")
              .encode())
    roc_fh = open(base + ".roc", "w")
    roc_fh.write("#chrom\tcov\t" + "\t".join(names) + "\n")

    sexes: dict[str, np.ndarray] = {}
    counters = {k: np.zeros(n_samples, np.int64)
                for k in ("in", "out", "hi", "low")}
    slopes = np.zeros(n_samples, np.float32)
    n_slopes = 0
    chrom_names: list[str] = []
    pca_refs: list[tuple[int, int]] = []  # (ref_id, longest) in order
    qc_computed = 0
    qc_resumed = 0

    from ..plan import Executor as PlanExecutor, Step

    pex = PlanExecutor(checkpoint=store)

    def _qc_chunk(rid, rname, rlen, ci, lo, hi, mat_t, lens, norm_sig):
        """Per-sample QC blocks for one (chromosome, chunk): resume
        committed samples from the store, run the rest as ONE
        ``chrom_qc`` on the chunk's device rows, commit the per-sample
        blocks in one journal commit."""
        nonlocal qc_computed, qc_resumed
        span = hi - lo
        ck = [("cohortscan.qc", SCHEMA, tuple(keys[lo + i]), rid,
               rname, int(rlen), norm_sig) for i in range(span)]
        missing = [i for i in range(span) if not store.has(ck[i])]
        ms = set(missing)
        resumed = [i for i in range(span) if i not in ms]
        blocks: dict[int, np.ndarray] = {
            i: np.asarray(store.get(ck[i]), np.float32)
            for i in resumed}
        qc_resumed += len(resumed)
        if resumed:
            reg.counter("cohort.chrom_qc_samples_resumed_total") \
                .inc(len(resumed))
        if missing:
            def fn():
                with timer.stage("qc_dispatch"):
                    rows = torch.tensor(missing, dtype=torch.long,
                                        device=dev)
                    sub = mat_t.index_select(0, rows)
                    sub_lens = torch.from_numpy(lens[missing]).to(dev)
                    sub_valid = (torch.arange(sub.shape[1], device=dev)
                                 [None, :] < sub_lens[:, None])
                    # longest=0: no tail term — the stored block must
                    # not depend on the cohort's composition
                    packed = ops.chrom_qc(sub, sub_valid, 0).cpu().numpy()
                rocs, cnt, cn = ops.unpack_chrom_qc(packed, len(missing))
                return [np.concatenate([
                    rocs[i],
                    np.float32([cnt["in"][i], cnt["out"][i],
                                cnt["hi"][i], cnt["low"][i]]),
                    np.float32([cn[i]]),
                ]).astype(np.float32) for i in range(len(missing))]

            vals = pex.run(Step(
                key=("cohortscan.qc", rname, ci), fn=fn, site="shard",
                retry=False,
                checkpoint_keys=[ck[i] for i in missing],
                restore=lambda vs: vs,
                commit=lambda vs: list(zip(
                    [ck[i] for i in missing], vs)),
            ))
            for i, v in zip(missing, vals):
                blocks[i] = np.asarray(v, np.float32)
            qc_computed += len(missing)
            reg.counter("cohort.chrom_qc_samples_computed_total") \
                .inc(len(missing))
        return [blocks[i] for i in range(span)]

    for rid, rname, rlen in refs:
        if exclude is not None and exclude.search(rname):
            continue
        lens = lengths_by_ref[rid]
        longest = int(lens.max()) if n_samples else 0
        is_sex = ic._same_chrom(sex_chroms, rname)

        # global scalars for this chromosome (None → no normalization)
        norm = None
        norm_sig = None
        st = stats_by_ref.get(rid)
        if st is not None and not is_sex:
            with timer.stage("norm_scalars"):
                width = max(
                    (spill.get(rid, ci, "raw").shape[1]
                     for ci in range(len(chunks))), default=0)
                m_all, skip_all = st.finalize(width)
                # NormStats.scalars_digest(_key_width(width)) without a
                # second pass: past the longest sample m is 0, skip True
                pad = _key_width(width) - width
                norm_sig = scalars_digest(
                    np.pad(m_all, (0, pad)),
                    np.pad(skip_all, (0, pad), constant_values=True))
                norm = (torch.from_numpy(m_all).to(dev),
                        torch.from_numpy(skip_all).to(dev))

        # per-chunk: normalize, QC, collect per-sample blocks
        rocs_all = np.zeros((n_samples, ops.SLOTS), np.float32)
        cnt_all = {k: np.zeros(n_samples, np.int64)
                   for k in ("in", "out", "hi", "low")}
        cn_all = np.zeros(n_samples, np.float32)
        for ci, (lo, hi) in enumerate(chunks):
            mat = np.array(spill.get(rid, ci, "raw"))  # writable
            clens = lens[lo:hi]
            if norm is not None:
                with timer.stage("normalize"):
                    w = norm[0].shape[0]
                    if mat.shape[1] < w:
                        mat = np.pad(mat, ((0, 0),
                                           (0, w - mat.shape[1])))
                    mat_t = torch.from_numpy(mat).to(dev)
                    lens_t = torch.from_numpy(clens).to(dev)
                    out = apply_normalization(mat_t, lens_t, *norm)
                    valid = (torch.arange(w, device=dev)[None, :]
                             < lens_t[:, None])
                    mat_t = torch.where(valid, out, 0.0)
                    spill.put(rid, ci, "norm", mat_t.cpu().numpy())
            elif longest > 0:
                mat_t = torch.from_numpy(mat).to(dev)
            if longest > 0:
                # the store's reads and fsync'd writes, qc_dispatch within
                with timer.stage("qc_blocks"):
                    blocks = _qc_chunk(rid, rname, rlen, ci, lo, hi,
                                       mat_t, clens, norm_sig)
                for off, blk in enumerate(blocks):
                    s = lo + off
                    rocs_all[s] = blk[: ops.SLOTS]
                    for ki, k in enumerate(("in", "out", "hi", "low")):
                        cnt_all[k][s] = int(blk[ops.SLOTS + ki])
                    cn_all[s] = blk[ops.SLOTS + 4]
            mat = mat_t = None

        # host tail correction: exactly the monolithic kernel's
        # max(longest - n_valid, 0) additive term
        if longest > 0:
            delta = (longest - lens.astype(np.int64))
            cnt_all["out"] += delta
            cnt_all["low"] += delta

        # ---- emission (byte-identical to run_indexcov._emit) ----
        with timer.stage("bed_gz"):
            for blo in range(0, longest, BED_BLOCK):
                bhi = min(blo + BED_BLOCK, longest)
                parts = []
                vparts = []
                for ci, (lo, hi) in enumerate(chunks):
                    cmat = spill.get(
                        rid, ci, "norm" if norm is not None else "raw")
                    cw = cmat.shape[1]
                    sl = np.asarray(cmat[:, blo:min(bhi, cw)],
                                    np.float32)
                    if sl.shape[1] < bhi - blo:
                        sl = np.pad(sl, ((0, 0),
                                         (0, bhi - blo - sl.shape[1])))
                    parts.append(sl)
                    vparts.append(
                        (np.arange(blo, bhi, dtype=np.int32)[None, :]
                         < lens[lo:hi, None]))
                ic.write_bed_block(bed, rname, blo, bhi,
                                   np.vstack(parts), np.vstack(vparts))

        if is_sex:
            if longest > 0:
                sexes[rname] = cn_all
        else:
            for k in counters:
                if longest > 0:
                    counters[k] += cnt_all[k]
            pca_refs.append((rid, longest))

        if longest > 0:
            with timer.stage("roc"):
                ic.write_roc_rows(roc_fh, rname, rocs_all)
            if (include_gl or not rname.startswith("GL")) and longest > 2:
                if not is_sex and longest > 100:
                    slopes += ops.update_slopes(rocs_all, rlen / 1e6)
                    n_slopes += 1
                chrom_names.append(rname)

    bed.close()
    bed_fh.close()
    roc_fh.close()

    # ---- PCA + ped ----
    with timer.stage("pca_ped"):
        if n_slopes > 0:
            slopes = slopes / np.float32(n_slopes)
        ic._check_sexes(sexes, sex_chroms)
        pcs, var_frac = _cohort_pca(
            spill, chunks, lengths_by_ref, pca_refs, n_samples,
            stats_by_ref, pca_mode, pca_exact_max, dev)
        ped_path = ic._write_ped(
            base, directory, sexes, counters, names, slopes, pcs,
            mapped, unmapped)

    store.close()
    spill.drop()

    # ---- manifest commit ----
    for doc, nm in zip(sample_docs, names):
        doc["name"] = nm
    man = CohortManifest(params, sample_docs, {
        "chrom_qc_samples_computed_total": qc_computed,
        "chrom_qc_samples_resumed_total": qc_resumed,
        "samples_total": n_samples,
        "samples_new": len(diff["new"]),
        "samples_changed": len(diff["changed"]),
        "samples_unchanged": len(diff["unchanged"]),
        "samples_removed": len(diff["removed"]),
    })
    man.save(manifest_path)
    reg.counter("cohort.scans_total").inc()

    return {
        "sexes": sexes,
        "counters": counters,
        "slopes": slopes,
        "pcs": pcs,
        "var_frac": var_frac,
        "ped": ped_path,
        "bed": base + ".bed.gz",
        "roc": base + ".roc",
        "manifest": manifest_path,
        "chrom_names": chrom_names,
        "diff": diff,
        "qc": {"computed": qc_computed, "resumed": qc_resumed},
        "memory": {"chunk_samples": chunk_samples,
                   "chunk_peak_bytes": chunk_peak_bytes,
                   "per_sample_bytes": per_sample_bytes,
                   "prior_chunk_peak_bytes": prior_peak},
        "stages": {k: round(v, 3) for k, v in timer.totals.items()},
    }


def _cohort_pca(spill, chunks, lengths_by_ref, pca_refs, n_samples,
                stats_by_ref, pca_mode, pca_exact_max, dev):
    """PCA over the quantized autosome bins — the oracle below the
    exactness threshold (byte-parity with one-shot indexcov), chunked
    power iteration above it, both on ``dev``."""
    total_bins = sum(longest for _, longest in pca_refs)
    if total_bins < 3 or n_samples < 3:
        return None, None
    use_exact = pca_mode == "exact" or (
        pca_mode == "auto" and n_samples <= pca_exact_max)
    k = min(5, n_samples)

    def chunk_rows(ci, lo, hi):
        """One chunk's quantized autosome row block (chunk, total)."""
        parts = []
        for rid, longest in pca_refs:
            if longest == 0:
                continue
            kind = "norm" if stats_by_ref.get(rid) is not None \
                else "raw"
            try:
                cmat = spill.get(rid, ci, kind)
            except FileNotFoundError:
                cmat = spill.get(rid, ci, "raw")
            lens = lengths_by_ref[rid][lo:hi]
            w = cmat.shape[1]
            sl = np.asarray(cmat[:, :min(longest, w)], np.float32)
            if sl.shape[1] < longest:
                sl = np.pad(sl, ((0, 0), (0, longest - sl.shape[1])))
            valid = (np.arange(longest, dtype=np.int32)[None, :]
                     < lens[:, None])
            capped = np.where(valid, np.minimum(sl, ops.MAX_CN), 0.0)
            q = ops.quantize_depths(capped)
            q[~valid] = 0
            parts.append(q)
        return np.concatenate(parts, axis=1).astype(np.float32)

    if use_exact:
        mat = np.vstack([chunk_rows(ci, lo, hi)
                         for ci, (lo, hi) in enumerate(chunks)])
        proj, frac = ops.pca_project(mat, k=k, device=dev)
        return proj.cpu().numpy(), frac.cpu().numpy()

    from .pca import sharded_pca

    # sharded_pca makes iters + 2 passes, the projection one more
    cache = {} if n_samples * total_bins * 4 <= PCA_ROWS_CACHE_BYTES \
        else None

    def rows(ci, lo, hi):
        if cache is None:
            return chunk_rows(ci, lo, hi)
        if ci not in cache:
            cache[ci] = chunk_rows(ci, lo, hi)
        return cache[ci]

    def chunks_fn():
        for ci, (lo, hi) in enumerate(chunks):
            yield rows(ci, lo, hi)

    fit = sharded_pca(chunks_fn, k=k, device=dev)
    proj = np.vstack([fit.project(rows(ci, lo, hi))
                      for ci, (lo, hi) in enumerate(chunks)])
    return proj, fit.frac_
