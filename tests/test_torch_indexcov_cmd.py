"""``indexcov`` of the port (goleft_tpu_torch/commands/indexcov.py,
``run_indexcov(device="cpu")``) against the JAX package's, on the fixtures
of tests/test_indexcov_cmd.py, tests/test_golden_indexcov.py and
tests/test_indexcov_oracle.py, and on a CRAI cohort.

Every output is byte-identical — the decompressed ``.bed.gz``, ``.roc``,
the per-chromosome depth and ROC pages and PNGs, the sex PNG — except the
PCA, compared by chip_smoke.py's ``compare_indexcov_dirs``: the
``.ped``'s PC columns (every other column byte-identical) and the
``pca12``/``pca13`` charts of ``index.html`` (the rest of the page
byte-identical) hold per component, up to sign, within 1e-4
(``PCA_RTOL``) of the component's largest projection (float32 SVDs of
LAPACK builds and of XLA differ in the last digits of a %.2f of a
0..65535-scaled matrix), and the charts' variance percentages within
0.1. A component past the rank of the centred matrix (the fifth of five
samples, the fourth of four) is a constant column in both, at a value
of each library's choosing.
"""

import gzip
import json
import os
import shutil

import numpy as np
import pytest

from chip_smoke import compare_indexcov_dirs as _compare_dirs
from chip_smoke import ped_pcs
from goleft_tpu.commands import indexcov as jic
from goleft_tpu_torch.commands import indexcov as tic
from goleft_tpu_torch.resilience import faults as tfaults
from helpers import random_reads, write_bam_and_bai
from test_golden_indexcov import _build_bai
from test_indexcov_cmd import make_cohort


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cohort")
    return make_cohort(tmp)


def _run_both(tmp_path, inputs, **kw):
    """The same run through both packages, each into a directory named
    ``out`` (the page titles and file names carry it) → (ref dir, port
    dir, port result)."""
    ref = str(tmp_path / "ref" / "out")
    port = str(tmp_path / "port" / "out")
    jic.run_indexcov(list(inputs), ref, **kw)
    res = tic.run_indexcov(list(inputs), port, device="cpu", **kw)
    return ref, port, res


def _check_against_jax(tmp_path, inputs, **kw):
    """Both packages on ``inputs`` → the port's result, every output
    compared against the plain JAX package's, under ``extra_normalize``
    the normalised depth pages and PNGs included (the port's scan
    multiplies by float32(1/7), as XLA does)."""
    ref, port, res = _run_both(tmp_path, inputs, **kw)
    _compare_dirs(ref, port)
    return res


CASES = {
    "default": {},
    "normalize": {"extra_normalize": True},
    "no_sex": {"sex": ""},
    "exclude_x": {"exclude_patt": "^X$", "write_png": False},
    "chrom": {"chrom": "chr1"},
    "chrom_unprefixed": {"chrom": "1", "write_html": False,
                         "write_png": False},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bam_cohort_outputs_match_jax(cohort, tmp_path, case):
    kw = CASES[case]
    res = _check_against_jax(tmp_path, cohort, **kw)
    port = os.path.dirname(res["ped"])
    assert os.path.exists(res["bed"]) and os.path.exists(res["roc"])
    if kw.get("write_html", True):
        assert os.path.exists(os.path.join(port, "index.html"))
        n_png = sum(f.endswith(".png") for f in os.listdir(port))
        assert (n_png > 0) == kw.get("write_png", True)
    assert set(res["stages"]) >= {"index_load", "qc_launch", "bed_gz",
                                  "pca_ped_html"}
    if "chrom" not in kw:
        # six samples: five principal components
        assert ped_pcs(res["ped"]).shape == (6, 5)


def test_hand_derived_golden_matches_jax(tmp_path):
    """tests/test_golden_indexcov.py's .bai of chosen linear-index
    offsets: the hand-derived rows and counters, and the reference's
    bytes."""
    sizes = [100, 200, 300, 400, 500, 1000]
    bai = str(tmp_path / "s1.bai")
    _build_bai(bai, sizes, len(sizes))
    fai = str(tmp_path / "ref.fa.fai")
    with open(fai, "w") as fh:
        fh.write(f"chr1\t{16384 * len(sizes)}\t6\t60\t61\n")
    ref, port, _ = _run_both(tmp_path, [bai], fai=fai, exclude_patt="",
                             sex="", write_html=False, write_png=False)
    _compare_dirs(ref, port)
    rows = gzip.open(os.path.join(port, "out-indexcov.bed.gz"),
                     "rt").read().splitlines()
    assert rows[1:] == [
        f"chr1\t{i * 16384}\t{(i + 1) * 16384}\t{w}"
        for i, w in enumerate(["0.2", "0.4", "0.6", "0.8", "1", "2"])]
    ped = open(os.path.join(port, "out-indexcov.ped")).read().splitlines()
    vals = dict(zip(ped[0].lstrip("#").split("\t"), ped[1].split("\t")))
    assert (vals["bins.in"], vals["bins.out"], vals["bins.hi"],
            vals["bins.lo"], vals["p.out"], vals["mapped"],
            vals["unmapped"]) == ("1", "5", "1", "0", "5.00", "600", "7")


def test_sequential_oracle_fixture_matches_jax(tmp_path):
    """tests/test_indexcov_oracle.py's cohort (4 samples, chr1 + X, sex
    'X'): byte-identical outputs, and the bed.gz against the oracle's
    "%.3g" of float32 size / median."""
    from goleft_tpu_torch.io.bai import read_bai

    refs, lens = ("chr1", "X"), (800_000, 300_000)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        sq = "".join(f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in zip(refs, lens))
        hdr = f"@HD\tVN:1.6\tSO:coordinate\n{sq}@RG\tID:r\tSM:s{i}\n"
        reads = random_reads(rng, 4000, 0, lens[0])
        n_x = 4000 * lens[1] // lens[0]
        reads += random_reads(rng, n_x // 2 if i % 2 == 0 else n_x, 1,
                              lens[1])
        p = str(tmp_path / f"s{i}.bam")
        write_bam_and_bai(p, reads, ref_names=refs, ref_lens=lens,
                          header_text=hdr)
        paths.append(p)
    ref, port, res = _run_both(tmp_path, paths, sex="X", write_html=False,
                               write_png=False)
    _compare_dirs(ref, port)
    with gzip.open(res["bed"], "rt") as fh:
        fh.readline()
        rows = [line.rstrip("\n").split("\t") for line in fh]
    for k, p in enumerate(paths):
        sizes = read_bai(p + ".bai").sizes()
        flat = np.sort(np.concatenate(sizes))
        cum = np.cumsum(np.minimum(flat, flat[int(0.98 * len(flat))]))
        med = float(flat[min(int(np.searchsorted(cum, int(cum[-1]) // 2,
                                                  side="right")),
                             len(flat) - 1)])
        for ci, chrom in enumerate(refs):
            d = np.minimum((sizes[ci].astype(np.float64) / med).astype(
                np.float32), 50000)
            crows = [r for r in rows if r[0] == chrom]
            for b, r in enumerate(crows):
                assert r[3 + k] == ("%.3g" % d[b] if b < len(d) else "0")


def _crai_cohort(tmp_path, n: int = 6):
    """n .crai files over chr1 (48 tiles), chrX (24), chrY (12), a GL
    contig (6) and a chrUn contig (4), with an .fai: females carry no
    chrY slices, one sample stops 5 tiles short on chr1, slices of 1-3
    tiles, a gap, and a sub-tile slice."""
    contigs = [("chr1", 48), ("chrX", 24), ("chrY", 12), ("GL000192.1", 6),
               ("chrUn_KI270302v1", 4)]
    fai = str(tmp_path / "g.fa.fai")
    with open(fai, "w") as fh:
        for name, t in contigs:
            fh.write(f"{name}\t{t * 16384}\t6\t60\t61\n")
    rng = np.random.default_rng(17)
    paths = []
    for s in range(n):
        male = s % 2 == 0
        lines = []
        for si, (name, tiles) in enumerate(contigs):
            if name == "chrY" and not male:
                continue
            scale = 0.5 if name in ("chrX", "chrY") and male else 1.0
            end = tiles - 5 if (name == "chr1" and s == 3) else tiles
            t = 0
            while t < end:
                span = int(rng.integers(1, 4))
                if t == 10 and name == "chr1":
                    t += 2  # a gap of two tiles
                    continue
                nbytes = int(800 * span * scale
                             * (1 + 0.2 * rng.standard_normal()))
                lines.append(f"{si}\t{t * 16384}\t{span * 16384}\t"
                             f"{t * 1000}\t0\t{max(nbytes, 1)}")
                t += span
            if name == "chr1":
                lines.append(f"{si}\t{end * 16384}\t5000\t0\t0\t90")
        lines.append("-1\t0\t0\t0\t0\t50")  # unmapped: skipped
        p = tmp_path / f"c{s}.crai"
        p.write_bytes(gzip.compress(("\n".join(lines) + "\n").encode()))
        paths.append(str(p))
    return paths, fai


@pytest.mark.parametrize("kw", [
    {"extra_normalize": True, "include_gl": True},
    {"extra_normalize": True, "sex": "", "write_png": False},
    {"exclude_patt": "", "include_gl": True, "write_html": False},
    {"chrom": "chr1", "extra_normalize": True, "write_png": False},
], ids=["n_includegl", "n_no_sex", "no_exclude", "n_chrom"])
def test_crai_cohort_matches_jax(tmp_path, kw):
    paths, fai = _crai_cohort(tmp_path)
    res = _check_against_jax(tmp_path, paths, fai=fai, **kw)
    with gzip.open(res["bed"], "rt") as fh:
        header = fh.readline().rstrip("\n").split("\t")
        chroms = {line.split("\t")[0] for line in fh}
    assert header[3:] == [f"c{s}" for s in range(6)]
    if "chrom" in kw:
        assert chroms == {kw["chrom"]}
    else:
        assert ("chrUn_KI270302v1" in chroms) == (kw.get("exclude_patt")
                                                  == "")
    if kw.get("include_gl"):
        assert "GL000192.1" in res["chrom_names"]


def test_crai_sizes_match_jax(tmp_path):
    from goleft_tpu.io.crai import read_crai as jread
    from goleft_tpu_torch.io.crai import read_crai as tread

    paths, _ = _crai_cohort(tmp_path, n=2)
    for p in paths:
        for a, b in zip(tread(p).sizes(), jread(p).sizes()):
            assert np.array_equal(a, b)


def test_jax_checkpoint_store_resumes_under_the_port(cohort, tmp_path):
    """A store written by goleft_tpu's run_indexcov resumes under the
    port with every chromosome restored (a shard fault on every compute
    would fail the run) and the reference's bytes."""
    ck = str(tmp_path / "ck")
    ref = str(tmp_path / "ref" / "out")
    port = str(tmp_path / "port" / "out")
    kw = {"extra_normalize": True, "write_png": False}
    jic.run_indexcov(list(cohort), ref, checkpoint_dir=ck, **kw)
    tfaults.install("shard:every=1:permanent")
    try:
        tic.run_indexcov(list(cohort), port, checkpoint_dir=ck, resume=True,
                         device="cpu", **kw)
    finally:
        tfaults.install(None)
    _compare_dirs(ref, port)


def test_shard_fault_then_resume_gives_the_same_bytes(cohort, tmp_path):
    """A permanent 'shard' fault at the second chromosome fails the run
    after the first committed; the resumed run restores it, computes the
    rest and writes the bytes of an uninterrupted run."""
    ck = str(tmp_path / "ck")
    full = str(tmp_path / "full" / "out")
    port = str(tmp_path / "port" / "out")
    kw = {"extra_normalize": True, "write_png": False}
    tic.run_indexcov(list(cohort), full, device="cpu", **kw)
    tfaults.install("shard:after=2:permanent")
    try:
        with pytest.raises(tfaults.InjectedPermanentFault):
            tic.run_indexcov(list(cohort), port, checkpoint_dir=ck,
                             device="cpu", **kw)
    finally:
        tfaults.install(None)
    journal = os.path.join(ck, "journal.jsonl")
    assert os.path.exists(journal)
    shutil.rmtree(port)
    tic.run_indexcov(list(cohort), port, checkpoint_dir=ck, resume=True,
                     device="cpu", **kw)
    for f in os.listdir(full):
        with open(os.path.join(full, f), "rb") as a, \
                open(os.path.join(port, f), "rb") as b:
            assert a.read() == b.read(), f


def test_names_references_and_globs_match_jax(cohort, tmp_path):
    for p in ["/a/b/sample1.bam.bai", "/a/b/s.crai", "x.y.z.bai", "solo",
              cohort[0]]:
        assert tic.get_short_name(p) == jic.get_short_name(p)
    assert tic.references(cohort, None) == jic.references(cohort, None)
    assert tic.references(cohort, None, "chrX") == \
        jic.references(cohort, None, "chrX")
    with pytest.raises(SystemExit, match="not found"):
        tic.references(cohort, None, "chr9")
    with pytest.raises(SystemExit, match="--fai is required"):
        tic.references(["a.bai"], None)
    pattern = os.path.join(os.path.dirname(cohort[0]), "s*.bam")
    assert tic.expand_globs([pattern, "lit.bai"]) == \
        jic.expand_globs([pattern, "lit.bai"])


def test_cli_runs_indexcov(cohort, tmp_path, monkeypatch):
    """``python -m goleft_tpu_torch indexcov`` (the default device
    pointed at the CPU) writes the reference CLI's bytes, and the
    manifest counts no kernel launch on the CPU."""
    from goleft_tpu_torch import cli, device as tdev

    monkeypatch.setattr(tic, "resolve_device",
                        lambda d=None: tdev.resolve_device("cpu"))
    ref = str(tmp_path / "ref" / "out")
    port = str(tmp_path / "port" / "out")
    man = str(tmp_path / "m.json")
    jic.main(["-d", ref, "-n", "--no-html", *cohort])
    rc = cli.main(["--metrics-out", man, "indexcov", "-d", port, "-n",
                   "--no-html", *cohort])
    assert rc == 0
    _compare_dirs(ref, port)
    with open(man) as fh:
        rep = json.load(fh)
    assert rep["command"] == "indexcov" and rep["exit_code"] == 0
    assert "indexcov_norm" in rep["kernel_launches"]
    assert "qc_launch" in rep["spans"]
    with pytest.raises(SystemExit):
        tic.main(["-d", port, "--resume", *cohort])


def test_trace_out_has_one_device_span_a_normalized_chromosome(
        cohort, tmp_path, monkeypatch):
    """``--trace-out`` on an ``-n`` run: one ``device.indexcov_norm``
    span per normalized chromosome (the cohort's one autosome), under the
    run's root, beside the seven stage spans."""
    from goleft_tpu_torch import cli, obs
    from goleft_tpu_torch import device as tdev

    monkeypatch.setattr(tic, "resolve_device",
                        lambda d=None: tdev.resolve_device("cpu"))
    obs.get_tracer().clear()
    trace = str(tmp_path / "t.json")
    try:
        rc = cli.main(["--trace-out", trace, "indexcov", "-d",
                       str(tmp_path / "out"), "-n", *cohort])
    finally:
        obs.set_device_events(False)
        obs.configure_logging("warning")
        obs.get_tracer().clear()
    assert rc == 0
    with open(trace) as fh:
        spans = [e for e in json.load(fh)["traceEvents"] if e["ph"] == "X"]
    names = [e["name"] for e in spans]
    assert names.count("run.indexcov") == 1
    assert names.count("device.indexcov_norm") == 1
    assert {"index_load", "qc_launch", "qc_fetch", "bed_gz", "roc", "plots",
            "pca_ped_html"} <= set(names)
