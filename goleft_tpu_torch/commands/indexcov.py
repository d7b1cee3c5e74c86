"""indexcov: whole-cohort coverage QC from .bai/.crai indexes only, on the
CUDA card.

The counterpart of the JAX package's commands/indexcov.py, with the same
flags and output bytes (the rebuild of the reference flagship,
indexcov/indexcov.go). Host work is index parsing (io.bai/io.crai) and
report writing; the per-bin numerics — histogram/ROC, bin counters, copy
number, PCA — run as PyTorch ops over a padded (samples × bins) matrix
per chromosome on the card (ops/indexcov_ops.py), and the cross-sample
normalization (``-n``) as the ``indexcov_norm`` CUDA kernel
(csrc/indexcov_norm.cu), one launch per normalized chromosome.
``run_indexcov(..., device="cpu")`` runs the same path with every kernel
as its plain PyTorch version.

Output surface matches the reference: <dir>/<name>-indexcov.bed.gz (per-
16KB-bin scaled depths), .roc, .ped (sex/CN/bin-QC/slope/PCA columns,
indexcov.go:815-953), per-chromosome -depth-<chrom>.html/png and
-roc-<chrom>.html/png, and index.html.
"""

from __future__ import annotations

import argparse
import glob as _glob
import os
import re
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..io.bgzf import BgzfWriter
from ..io.sampleindex import SampleIndex, get_short_name, references
from ..obs.logging import get_logger
from ..ops import indexcov_ops as ops
from ..utils import report

log = get_logger("indexcov")

DEFAULT_EXCLUDE = r"^chrEBV$|^NC|_random$|Un_|^HLA\-|_alt$|hap\d$"
MAX_SAMPLES = 100  # above this, interactive depth plots are skipped
TILE = 16384


def expand_globs(paths: list[str]) -> list[str]:
    out = []
    for p in paths:
        if any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    return out


def _pad_rows(rows: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """ragged float32 rows → (matrix, valid mask, lengths). The matrix is
    as wide as the longest row (at least 1): the reference pads the width
    to a bucket only to bound its jit compiles, and every result masks on
    the valid bins, not on the width."""
    n = len(rows)
    longest = max((len(r) for r in rows), default=0)
    mat = np.zeros((n, max(longest, 1)), dtype=np.float32)
    valid = np.zeros_like(mat, dtype=bool)
    lengths = np.zeros(n, dtype=np.int32)
    for i, r in enumerate(rows):
        mat[i, : len(r)] = r
        valid[i, : len(r)] = True
        lengths[i] = len(r)
    return mat, valid, lengths


def _index_file(path: str) -> str:
    """The file actually read for ``path`` — what checkpoint keys must
    bind (a .bam input's evidence is its .bai; rewriting the index
    must invalidate the sample's shards even when the BAM is
    untouched)."""
    from ..io import remote

    if path.endswith(".cram"):
        return path + ".crai"
    if path.endswith((".crai", ".bai")):
        return path
    if remote.exists(path + ".bai"):
        return path + ".bai"
    return path[:-4] + ".bai"


def write_bed_block(bed, ref_name: str, lo: int, hi: int,
                    mat_cols: np.ndarray, valid_cols: np.ndarray) -> None:
    """Format + write bed rows for bins [lo, hi) of one chromosome.

    ``mat_cols``/``valid_cols`` are the (samples, hi-lo) column slice.
    The ONE formatting path for both the monolithic ``indexcov`` loop
    and the chunked ``cohortscan`` engine — shorter samples print 0
    (indexcov.go:678-680, depthsFor :1038-1048); C++ formats the block
    when the native lib is built (byte-identical to np.char.mod
    "%.3g"). The emitted bytes depend only on the slice values, never
    on how the caller blocked its writes (BgzfWriter re-chunks to its
    fixed block size).
    """
    from ..io import native

    idx = np.arange(lo, hi, dtype=np.int64)
    if native.get_lib() is not None:
        bed.write(native.format_float_matrix_rows(
            ref_name, idx * TILE, (idx + 1) * TILE, mat_cols, valid_cols,
        ))
        return
    block = np.char.mod("%.3g", mat_cols.T)
    block[~valid_cols.T] = "0"
    starts_col = np.char.mod("%d", idx * TILE)
    ends_col = np.char.mod("%d", (idx + 1) * TILE)
    rows_txt = [
        ref_name + "\t" + starts_col[i] + "\t" + ends_col[i]
        + "\t" + "\t".join(block[i]) + "\n"
        for i in range(hi - lo)
    ]
    bed.write("".join(rows_txt).encode())


class _Fetch:
    """One device result on its way to the host. On the card the tensor
    is copied into pinned memory with ``non_blocking=True`` and a CUDA
    event is recorded after the copy; :meth:`get` waits on that event
    before the host reads the buffer. A CPU tensor is already there."""

    def __init__(self, t: torch.Tensor):
        self._src = t  # alive until the copy is known to have finished
        if t.device.type == "cuda":
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._buf, self._event = t, None

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        self._src = None
        return self._buf.numpy()


def _host(x):
    """A state field as host numpy (waiting on its copy if in flight)."""
    return x.get() if isinstance(x, _Fetch) else x


def write_roc_rows(roc_fh, ref_name: str, rocs: np.ndarray) -> None:
    """One chromosome's ROC block (SLOTS rows), one vectorized format
    pass — shared by indexcov and cohortscan for byte-parity."""
    cov_col = np.char.mod(
        "%.2f", np.arange(ops.SLOTS) / (ops.SLOTS * ops.SLOTS_MID),
    )
    cells = np.char.mod("%.2f", rocs.T)  # (SLOTS, S)
    roc_fh.write("".join(
        ref_name + "\t" + cov_col[i] + "\t" + "\t".join(cells[i]) + "\n"
        for i in range(ops.SLOTS)
    ))


def run_indexcov(
    bams: list[str],
    directory: str,
    sex: str = "X,Y",
    exclude_patt: str = DEFAULT_EXCLUDE,
    chrom: str = "",
    fai: str | None = None,
    extra_normalize: bool = False,
    include_gl: bool = False,
    write_html: bool = True,
    write_png: bool = True,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    device=None,
) -> dict:
    """The command's body on ``device`` (the card unless ``"cpu"``) →
    {sexes, counters, slopes, pcs, ped, bed, roc, chrom_names,
    stages}."""
    dev = resolve_device(device)
    os.makedirs(directory, exist_ok=True)
    sex_chroms = [s for s in sex.split(",") if s] if sex else []
    exclude = re.compile(exclude_patt) if exclude_patt else None

    bams = expand_globs(bams)
    refs = references(bams, fai, chrom)
    log.info("running on %d indexes", len(bams))
    from ..utils.profiling import StageTimer

    # wall-clock per pipeline stage, returned under "stages" (and
    # recorded by bench.py's indexcov e2e entry)
    timer = StageTimer()
    # 8-way parallel index load, mirroring indexcov.go:417-434
    import concurrent.futures as cf

    def _load(p):
        # corrupt/truncated index -> clean CLI error naming the file,
        # not a traceback (the codecs' contract is typed ValueError)
        try:
            return SampleIndex(p)
        except ValueError as e:
            raise SystemExit(f"indexcov: {p}: {e}")

    with timer.stage("index_load"):
        with cf.ThreadPoolExecutor(max_workers=8) as ex:
            idxs = list(ex.map(_load, bams))
            names = list(ex.map(get_short_name, bams))
    n_samples = len(idxs)

    # per-chromosome checkpointing: the shard unit is one chromosome's
    # launched QC state. Every sample contributes to every chromosome
    # (cross-sample normalization), so keys bind ALL resolved index
    # files' content identities — one stale index invalidates the run's
    # shards, a stale chromosome list only its own.
    checkpoint = None
    ck_sig = None
    if checkpoint_dir:
        from ..parallel.scheduler import file_key
        from ..resilience.checkpoint import CheckpointStore

        def _safe_key(p):
            try:
                return file_key(_index_file(p))
            except OSError:
                return (p, -1, -1)

        ck_sig = (tuple(_safe_key(b) for b in bams), sex,
                  exclude_patt, chrom, extra_normalize)
        checkpoint = CheckpointStore(checkpoint_dir, resume=resume)

    name = os.path.basename(os.path.abspath(directory))
    base = os.path.join(directory, name + "-indexcov")

    bed_fh = open(base + ".bed.gz", "wb")
    bed = BgzfWriter(bed_fh, level=1)
    bed.write(("#chrom\tstart\tend\t" + "\t".join(names) + "\n").encode())
    roc_fh = open(base + ".roc", "w")
    roc_fh.write("#chrom\tcov\t" + "\t".join(names) + "\n")

    sexes: dict[str, np.ndarray] = {}
    pca_blocks: list[np.ndarray] = []
    totals = {"in": 0, "out": 0, "hi": 0, "low": 0}
    counters = {
        k: np.zeros(n_samples, dtype=np.int64) for k in totals
    }
    slopes = np.zeros(n_samples, dtype=np.float32)
    n_slopes = 0
    chrom_names: list[str] = []

    def _launch(ref_id, ref_name, ref_len):
        """Host prep + async device QC for one chromosome.

        The scaled depths go to the device once; the normalization
        (``-n``: one ``indexcov_norm`` launch) and the QC run there, and
        ONE packed vector per chromosome (ROC, counters, CN together)
        comes back — plus the normalized matrix under ``-n``, which the
        bed.gz rows print. Each copy starts at once (:class:`_Fetch`) and
        rides the link while the PREVIOUS chromosome's host formatting
        runs (the 1-deep software pipeline below). Empty chromosomes
        contribute nothing.
        """
        with timer.stage("qc_launch"):
            rows = [idx.normalized_depth(ref_id) for idx in idxs]
            mat, valid, lengths = _pad_rows(rows)
            longest = int(lengths.max())
            is_sex = _same_chrom(sex_chroms, ref_name)
            normalize = extra_normalize and not is_sex and n_samples >= 5
            packed = None
            if normalize or longest > 0:
                valid_t = (torch.arange(mat.shape[1], device=dev)[None, :]
                           < torch.from_numpy(lengths).to(dev)[:, None])
                if normalize:
                    mat_t = torch.where(
                        valid_t, ops.normalize_across_samples(
                            mat, lengths, device=dev), 0.0)
                    mat = _Fetch(mat_t)
                else:
                    mat_t = torch.from_numpy(mat).to(dev)
                if longest > 0:
                    packed = _Fetch(ops.chrom_qc(mat_t, valid_t, longest))
        return (ref_name, ref_len, mat, valid, lengths, longest, is_sex,
                packed)

    def _emit(state):
        nonlocal slopes, n_slopes
        (ref_name, ref_len, mat, valid, lengths, longest, is_sex,
         packed) = state
        rocs = chrom_counters = chrom_cn = None
        if packed is not None or isinstance(mat, _Fetch):
            with timer.stage("qc_fetch"):
                mat = _host(mat)
                if packed is not None:
                    rocs, chrom_counters, chrom_cn = ops.unpack_chrom_qc(
                        _host(packed), n_samples
                    )

        # bed.gz rows: chunked so a big cohort's formatted block stays
        # bounded in RAM (write_bed_block is the shared formatter)
        with timer.stage("bed_gz"):
            for lo in range(0, longest, 2048):
                hi = min(lo + 2048, longest)
                write_bed_block(bed, ref_name, lo, hi,
                                mat[:, lo:hi], valid[:, lo:hi])

        if is_sex:
            if longest > 0:
                sexes[ref_name] = chrom_cn
        else:
            # cap at MaxCN before quantization (indexcov.go:694-698);
            # missing tail bins quantize to 0
            capped = np.where(valid, np.minimum(mat, ops.MAX_CN), 0.0)
            q = ops.quantize_depths(capped)
            q[~valid] = 0
            pca_blocks.append(q[:, :max(longest, 0)])
            if chrom_counters is not None:
                for k in counters:
                    counters[k] += chrom_counters[k]

        if longest > 0:
            with timer.stage("roc"):
                write_roc_rows(roc_fh, ref_name, rocs)
            if (include_gl or not ref_name.startswith("GL")) and longest > 2:
                if not is_sex and longest > 100:
                    slopes += ops.update_slopes(rocs, ref_len / 1e6)
                    n_slopes += 1
                chrom_names.append(ref_name)
                if write_html:
                    # render + write pages in worker threads: the page
                    # bytes ride a (possibly slow) filesystem while the
                    # next chromosome's QC/bed/roc work proceeds; the
                    # futures are joined (and errors surfaced) before
                    # index.html is written
                    with timer.stage("plots"):
                        plot_futs.append(plot_ex.submit(
                            _plot_depth_chrom,
                            base, ref_name, mat, lengths, names,
                            interactive=n_samples <= MAX_SAMPLES,
                            write_png=write_png,
                        ))
                        plot_futs.append(plot_ex.submit(
                            _plot_roc_chrom, base, ref_name, rocs,
                            names, write_png))
                        # bound the queue: each queued depth future
                        # pins its chromosome's full (samples x bins)
                        # matrix, so joining the oldest beyond a small
                        # window caps resident memory at ~4 chroms
                        # (the serial code held 1) while keeping the
                        # render/compute overlap
                        while len(plot_futs) > 8:
                            plot_futs.pop(0).result()

    from ..plan import Executor as PlanExecutor, Step

    pex = PlanExecutor(checkpoint=checkpoint)

    def _launch_or_resume(ref_id, ref_name, ref_len):
        """One chromosome's QC as a plan Step: unless the state is
        already committed — then the stored state (device result
        fetched to host numpy) re-enters the emit pipeline with zero
        QC/device work and byte-identical downstream artifacts. The
        'shard' fault site fires per computed chromosome, uniform with
        the cohortdepth region boundary."""

        def fn():
            state = _launch(ref_id, ref_name, ref_len)
            if checkpoint is not None:
                # host numpy for pickling, in the reference's layout, so
                # a store either package wrote resumes under the other
                # (unchanged bytes downstream)
                state = (*state[:2], _host(state[2]), *state[3:7],
                         _host(state[7]))
            return state

        return pex.run(Step(
            key=("indexcov", ref_name), fn=fn, site="shard",
            retry=False,
            checkpoint_key=(("indexcov", ck_sig, ref_id, ref_name,
                             ref_len) if checkpoint is not None
                            else None)))

    plot_ex = cf.ThreadPoolExecutor(max_workers=4)
    plot_futs: list = []
    try:
        pending = None
        for ref_id, ref_name, ref_len in refs:
            if exclude is not None and exclude.search(ref_name):
                continue
            cur = _launch_or_resume(ref_id, ref_name, ref_len)
            if pending is not None:
                _emit(pending)
            pending = cur
        if pending is not None:
            _emit(pending)
        with timer.stage("plots"):
            for f in plot_futs:
                f.result()  # surface the first page-render failure
    finally:
        plot_ex.shutdown(wait=True, cancel_futures=True)
        if checkpoint is not None:
            checkpoint.close()

    bed.close()
    bed_fh.close()
    roc_fh.close()
    with timer.stage("pca_ped_html"):
        if n_slopes > 0:
            slopes = slopes / np.float32(n_slopes)
        _check_sexes(sexes, sex_chroms)

        # PCA over autosome bins (indexcov.go:773-807)
        pcs = None
        var_frac = None
        if pca_blocks:
            pca_mat = np.concatenate(pca_blocks, axis=1).astype(
                np.float32)
            if pca_mat.shape[1] >= 3 and n_samples >= 3:
                # k clamps to the sample count: same projection values
                # (the SVD only has min(n, bins) right vectors anyway),
                # but inside pca_project's guarded domain
                proj, frac = ops.pca_project(
                    pca_mat, k=min(5, n_samples), device=dev)
                pcs, var_frac = proj.cpu().numpy(), frac.cpu().numpy()

        ped_path = _write_ped(
            base, directory, sexes, counters, names, slopes, pcs,
            [i.mapped for i in idxs], [i.unmapped for i in idxs],
        )
        if write_html:
            _write_index_html(
                directory, base, name, sexes, counters, names, pcs,
                var_frac,
                [i.mapped for i in idxs], [i.unmapped for i in idxs],
                chrom_names, write_png=write_png,
            )
            log.info("indexcov finished: see %s/index.html", directory)
    return {
        "sexes": sexes,
        "counters": counters,
        "slopes": slopes,
        "pcs": pcs,
        "ped": ped_path,
        "bed": base + ".bed.gz",
        "roc": base + ".roc",
        "chrom_names": chrom_names,
        "stages": {k: round(v, 3) for k, v in timer.totals.items()},
    }


def _same_chrom(sex_chroms: list[str], chrom: str) -> bool:
    # tolerate chr-prefix mismatches (indexcov.go:526-547)
    for a in sex_chroms:
        if a == chrom:
            return True
        na = "chr" + a if not a.startswith("chr") else a[3:]
        if na == chrom:
            return True
    return False


def _check_sexes(obs: dict, exp: list[str]) -> None:
    if len(obs) != len(exp):
        msg = (
            f"indexcov: expected {len(exp)} sex chromosomes, found: "
            f"{len(obs)}. you can set the expected with --sex "
            f"'{','.join(obs)}'"
        )
        if len(obs) == 0 and exp != ["X", "Y"]:
            raise SystemExit("(FATAL) " + msg)
        print("(WARNING) " + msg, file=sys.stderr)


def _write_ped(base, directory, sexes, counters, samples, slopes, pcs,
               mapped, unmapped) -> str:
    """.ped columns per indexcov.go:815-894."""
    keys = sorted(sexes)
    hdr = ["CN" + k for k in keys]
    hdr += ["bins.out", "bins.lo", "bins.hi", "bins.in", "slope", "p.out"]
    n_pc = 0
    if pcs is not None:
        n_pc = min(5, pcs.shape[1])
        hdr += [f"PC{i + 1}" for i in range(n_pc)]
    has_map = any(m > 0 for m in mapped) or any(u > 0 for u in unmapped)
    if has_map:
        hdr += ["mapped", "unmapped"]
    path = base + ".ped"
    with open(path, "w") as f:
        f.write(
            "#family_id\tsample_id\tpaternal_id\tmaternal_id\tsex\t"
            "phenotype\t" + "\t".join(hdr) + "\n"
        )
        for i, s in enumerate(samples):
            inferred = (
                int(0.5 + sexes[keys[0]][i]) if keys else -9
            )
            row = ["unknown", s, "-9", "-9", str(inferred), "-9"]
            row += ["%.2f" % sexes[k][i] for k in keys]
            out, lo = counters["out"][i], counters["low"][i]
            hi, inn = counters["hi"][i], counters["in"][i]
            row += [str(out), str(lo), str(hi), str(inn),
                    "%.3f" % slopes[i],
                    "%.2f" % (out / inn if inn else float("inf"))]
            if pcs is not None:
                row += ["%.2f" % pcs[i, j] for j in range(n_pc)]
            if has_map:
                row += [str(mapped[i]), str(unmapped[i])]
            f.write("\t".join(row) + "\n")
    return path


def _plot_depth_chrom(base, chrom, mat, lengths, names, interactive,
                      write_png):
    # numpy end-to-end: these series carry whole-genome tile vectors and
    # Python-list round trips were ~20% of e2e wall
    x = np.arange(mat.shape[1], dtype=np.float64) * TILE
    width = 0.4 if len(names) <= 30 else (0.3 if len(names) <= 50 else 0.2)
    series = [
        {"label": names[k], "x": x[: lengths[k]],
         "y": mat[k, : lengths[k]], "width": width}
        for k in range(len(names))
    ]
    if interactive:
        div, js = report.line_chart(
            "depth", series, f"position on {chrom}", "scaled coverage",
            y_max=2.5,
        )
        report.write_page(
            f"{base}-depth-{chrom}.html", f"depth {chrom}", [(div, js)],
            nav_html='<nav><a href="index.html">back to index</a></nav>',
        )
    if write_png:
        sub = 1 + len(x) // 2000
        report.save_png(f"{base}-depth-{chrom}.png", series,
                        f"position on {chrom}", "scaled coverage",
                        y_max=2.5, subsample=sub)


def _plot_roc_chrom(base, chrom, rocs, names, write_png):
    x = np.arange(ops.SLOTS, dtype=np.float64) / (ops.SLOTS * ops.SLOTS_MID)
    n_bg = report._n_backgrounds()  # plot.go:338-341 relabels them
    series = [
        {"label": "background" if k < n_bg else names[k],
         "x": x, "y": rocs[k]}
        for k in range(len(names))
    ]
    div, js = report.line_chart(
        "roc", series, "scaled coverage", "proportion of regions covered",
        legend=False, stepped=False,
    )
    report.write_page(
        f"{base}-roc-{chrom}.html", f"ROC {chrom}", [(div, js)],
        nav_html='<nav><a href="index.html">back to index</a></nav>',
    )
    if write_png:
        report.save_png(f"{base}-roc-{chrom}.png", series,
                        "scaled coverage", "proportion of regions covered")


def _write_index_html(directory, base, name, sexes, counters, samples, pcs,
                      var_frac, mapped, unmapped, chrom_names, write_png):
    charts = []
    keys = sorted(sexes)
    if len(keys) >= 2:
        # background samples are excluded from the sex scatter entirely
        # (plot.go:443-445)
        bg = report._n_backgrounds()
        pts = [{
            "label": "samples",
            "x": sexes[keys[0]][bg:].tolist(),
            "y": sexes[keys[1]][bg:].tolist(),
            "names": samples[bg:],
        }]
        charts.append(report.scatter_chart(
            "sex", pts, f"inferred copy number for {keys[0]}",
            f"inferred copy number for {keys[1]}"))
        if write_png:
            report.save_png(f"{base}-sex.png", pts,
                            f"CN {keys[0]}", f"CN {keys[1]}", kind="scatter")
    inn = np.maximum(counters["in"], 1)
    pts_bins = [{
        "label": "samples",
        "x": counters["in"].tolist(),
        "y": counters["out"].tolist(),
        "names": samples,
    }]
    charts.append(report.scatter_chart(
        "bins", pts_bins, "bins with depth in (0.85, 1.15)",
        "bins with depth outside (0.85, 1.15)"))
    if pcs is not None and var_frac is not None:
        charts.append(report.scatter_chart(
            "pca12",
            [{"label": "samples", "x": pcs[:, 0].tolist(),
              "y": pcs[:, 1].tolist(), "names": samples}],
            f"PC1 ({100 * var_frac[0]:.1f}% variance)",
            f"PC2 ({100 * var_frac[1]:.1f}% variance)"))
        if pcs.shape[1] > 2:
            charts.append(report.scatter_chart(
                "pca13",
                [{"label": "samples", "x": pcs[:, 0].tolist(),
                  "y": pcs[:, 2].tolist(), "names": samples}],
                "PC1", f"PC3 ({100 * var_frac[2]:.1f}% variance)"))
    if any(mapped) or any(unmapped):
        charts.append(report.scatter_chart(
            "mapped",
            [{"label": "samples", "x": [float(m) for m in mapped],
              "y": [float(u) for u in unmapped], "names": samples}],
            "mapped reads", "unmapped reads"))
    links = "".join(
        f'<li><a href="{os.path.basename(base)}-depth-{c}.html">depth {c}'
        f'</a> / <a href="{os.path.basename(base)}-roc-{c}.html">ROC {c}'
        f"</a></li>"
        for c in chrom_names
    )
    extra = f"<h2>chromosomes</h2><ul>{links}</ul>"
    report.write_page(
        os.path.join(directory, "index.html"),
        f"indexcov: {name}", charts, extra_html=extra,
    )


def main(argv=None):
    p = argparse.ArgumentParser(
        "goleft-tpu-torch indexcov",
        description="cohort coverage QC from BAM/CRAM indexes only",
    )
    p.add_argument("-d", "--directory", required=True,
                   help="directory for output files")
    p.add_argument("-e", "--includegl", action="store_true",
                   help="plot GL chromosomes")
    p.add_argument("-p", "--excludepatt", default=DEFAULT_EXCLUDE,
                   help="regex of chromosomes to exclude")
    p.add_argument("-X", "--sex", default="X,Y",
                   help="comma-delimited sex chromosomes ('' for none)")
    p.add_argument("-c", "--chrom", default="",
                   help="optional chromosome to restrict")
    p.add_argument("-f", "--fai", default=None,
                   help="fasta index; required for crais")
    p.add_argument("-n", "--extranormalize", action="store_true",
                   help="normalize across samples (recommended for CRAI)")
    p.add_argument("--no-html", action="store_true",
                   help="skip html/png reports")
    p.add_argument("--checkpoint-dir", default=None,
                   help="per-chromosome QC checkpoint store "
                        "(docs/resilience.md); with --resume, "
                        "committed chromosomes skip index/QC work "
                        "with byte-identical artifacts")
    p.add_argument("--resume", action="store_true",
                   help="replay the checkpoint journal and skip "
                        "committed chromosomes (requires "
                        "--checkpoint-dir)")
    p.add_argument("bam", nargs="+", help="bam(s)/bai(s)/crai(s)")
    a = p.parse_args(argv)
    if a.resume and not a.checkpoint_dir:
        p.error("--resume requires --checkpoint-dir")
    run_indexcov(
        a.bam, a.directory, sex=a.sex, exclude_patt=a.excludepatt,
        chrom=a.chrom, fai=a.fai, extra_normalize=a.extranormalize,
        include_gl=a.includegl, write_html=not a.no_html,
        write_png=not a.no_html, checkpoint_dir=a.checkpoint_dir,
        resume=a.resume,
    )


if __name__ == "__main__":
    main()
