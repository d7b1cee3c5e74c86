"""``cohortscan`` of the port (goleft_tpu_torch/cohort/scan.py, the CLI;
``run_cohortscan(device="cpu")``) against the JAX package's
``run_cohortscan`` and ``run_indexcov``, on tests/test_cohortscan.py's
fixtures.

The bed.gz (decompressed) and .roc are byte-identical; the .ped is
byte-identical but for its PC columns, which hold per component, up to
sign, within chip_smoke.py's ``PCA_RTOL`` (1e-4) of the component's
largest projection (``_compare_ped``: float32 SVDs of two libraries).
Checkpoint keys, manifest fields and counters are the reference's, so a
store and manifest either package wrote resume under the other.
"""

import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import PCA_RTOL, _compare_ped, ped_pcs, pcs_up_to_sign
from goleft_tpu.cohort import scan as jscan
from goleft_tpu.commands import cohortscan as jcmd
from goleft_tpu.commands.indexcov import run_indexcov as jindexcov
from goleft_tpu.ops import indexcov_ops as jops
from goleft_tpu_torch.cohort import scan as tscan
from goleft_tpu_torch.cohort import streaming as tstream
from goleft_tpu_torch.cohort.manifest import FORMAT, CohortManifest
from goleft_tpu_torch.commands import cohortscan as tcmd
from goleft_tpu_torch.ops import indexcov_ops as tops
from helpers import random_reads, write_bam_and_bai
from test_cohortscan import LENS, REFS, _header, _make_cohort
from test_torch_checkpoint import _CPU_CLI

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def trun(paths, out, **kw):
    return tscan.run_cohortscan(paths, out, device="cpu", **kw)


def _artifacts(outdir):
    name = os.path.basename(os.path.abspath(outdir))
    return {s: os.path.join(outdir, f"{name}-indexcov{s}")
            for s in (".bed.gz", ".roc", ".ped")}


def _same_artifacts(want_dir, got_dir):
    """bed.gz and .roc byte for byte, the .ped but its PC columns, which
    hold up to sign."""
    want, got = _artifacts(want_dir), _artifacts(got_dir)
    for s in (".bed.gz", ".roc"):
        with open(want[s], "rb") as a, open(got[s], "rb") as b:
            da, db = a.read(), b.read()
        if s == ".bed.gz":
            da, db = gzip.decompress(da), gzip.decompress(db)
        assert da == db, s
    _compare_ped(want[".ped"], got[".ped"])


def _same_bytes(want_dir, got_dir):
    want, got = _artifacts(want_dir), _artifacts(got_dir)
    for s in want:
        with open(want[s], "rb") as a, open(got[s], "rb") as b:
            assert a.read() == b.read(), s


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return _make_cohort(tmp_path_factory.mktemp("cohort"))


@pytest.fixture(scope="module")
def one_shot(cohort, tmp_path_factory):
    """The JAX package's run_indexcov of the cohort, with and without
    -n, each in a directory named ``out``."""
    root = tmp_path_factory.mktemp("oneshot")
    dirs = {}
    for norm in (False, True):
        d = str(root / str(norm) / "out")
        jindexcov(list(cohort), d, sex="X,Y", extra_normalize=norm,
                  write_png=False)
        dirs[norm] = d
    return dirs


# --------------------------------------------- one-shot byte parity

@pytest.mark.parametrize("extra_normalize", [False, True])
@pytest.mark.parametrize("chunk", [1, 3, 6, 7])
def test_chunked_scan_matches_both_references(cohort, one_shot, tmp_path,
                                              chunk, extra_normalize):
    """Chunks of 1, 3, n-1 and n samples: the port's artifacts equal the
    JAX package's cohortscan and its one-shot indexcov."""
    ref = str(tmp_path / "ref" / "out")
    got = str(tmp_path / "port" / "out")
    jres = jscan.run_cohortscan(list(cohort), ref, sex="X,Y",
                                extra_normalize=extra_normalize,
                                chunk_samples=chunk)
    res = trun(list(cohort), got, sex="X,Y",
               extra_normalize=extra_normalize, chunk_samples=chunk)
    _same_artifacts(ref, got)
    _same_artifacts(one_shot[extra_normalize], got)
    assert res["qc"] == jres["qc"] == {"computed": 7 * 3, "resumed": 0}
    # the spill bytes differ: the reference pads a chunk's width to a
    # bucket (indexcov's _width_bucket), the port does not
    assert res["memory"]["chunk_samples"] == \
        jres["memory"]["chunk_samples"] == chunk
    assert res["diff"] == jres["diff"]
    man = CohortManifest.load(res["manifest"])
    jman = CohortManifest.load(jres["manifest"])
    assert man.params == jman.params
    assert man.counters == jman.counters
    assert [s["path"] for s in man.samples] == list(cohort)
    assert [s["name"] for s in man.samples] == \
        [s["name"] for s in jman.samples]
    stages = {"index_load", "spill", "qc_blocks", "qc_dispatch", "bed_gz",
              "roc", "pca_ped"}
    if extra_normalize:
        stages |= {"norm_scalars", "normalize"}
    assert set(res["stages"]) == stages


def test_sharded_pca_matches_the_references(cohort, tmp_path):
    """``--pca sharded``: every byte but the PCs is the exact path's, and
    the PCs hold up to sign against the reference's sharded path. Against
    the exact PCA only the first three components are held: on this
    cohort the fourth and fifth singular values lie within 3% of each
    other, which 32 power iterations do not separate."""
    ref = str(tmp_path / "ref" / "out")
    got = str(tmp_path / "port" / "out")
    exact = str(tmp_path / "exact" / "out")
    jscan.run_cohortscan(list(cohort), ref, chunk_samples=3,
                         pca_mode="sharded")
    res = trun(list(cohort), got, chunk_samples=3, pca_mode="sharded")
    trun(list(cohort), exact, chunk_samples=3, pca_mode="exact")
    _same_artifacts(ref, got)
    _compare_ped(_artifacts(exact)[".ped"], _artifacts(got)[".ped"],
                 [PCA_RTOL] * 3 + [np.inf] * 2)
    pcs_up_to_sign(ped_pcs(_artifacts(got)[".ped"])[:, :3],
                   ped_pcs(_artifacts(exact)[".ped"])[:, :3],
                   "sharded against exact")
    assert res["var_frac"].dtype == np.float32
    assert res["pcs"].shape == (7, 5)


def test_sharded_pca_rows_cache_changes_no_byte(cohort, tmp_path,
                                                monkeypatch):
    """The quantized rows kept in memory between the power iteration's
    passes (``PCA_ROWS_CACHE_BYTES``) and the rows read back from the
    spills every pass give the same bytes, PCs included."""
    want = str(tmp_path / "reread" / "out")
    got = str(tmp_path / "cached" / "out")
    monkeypatch.setattr(tscan, "PCA_ROWS_CACHE_BYTES", 0)
    trun(list(cohort), want, chunk_samples=3, pca_mode="sharded")
    monkeypatch.setattr(tscan, "PCA_ROWS_CACHE_BYTES", 1 << 30)
    trun(list(cohort), got, chunk_samples=3, pca_mode="sharded")
    _same_bytes(want, got)


# ------------------------------------------------- incrementality

def test_append_k_computes_exactly_k_columns(tmp_path):
    paths = _make_cohort(tmp_path, n=9, seed=11)
    out = str(tmp_path / "inc" / "out")
    first = trun(paths[:7], out, chunk_samples=3)
    n_chroms = len(first["chrom_names"])
    assert first["qc"] == {"computed": 7 * n_chroms, "resumed": 0}

    second = trun(paths, out, chunk_samples=3, resume=True)
    assert second["qc"] == {"computed": 2 * n_chroms,
                            "resumed": 7 * n_chroms}
    assert second["diff"]["new"] == paths[7:]
    assert second["diff"]["unchanged"] == paths[:7]
    man = CohortManifest.load(second["manifest"])
    assert man.counters["chrom_qc_samples_computed_total"] \
        == 2 * n_chroms
    assert man.counters["samples_new"] == 2

    fresh = str(tmp_path / "fresh" / "out")
    trun(paths, fresh, chunk_samples=9)
    _same_bytes(fresh, out)
    ref = str(tmp_path / "ref" / "out")
    jscan.run_cohortscan(paths, ref, chunk_samples=9)
    _same_artifacts(ref, out)


def test_changed_input_invalidates_only_itself(tmp_path):
    paths = _make_cohort(tmp_path, n=5, seed=23)
    out = str(tmp_path / "chg" / "out")
    first = trun(paths, out, chunk_samples=2)
    n_chroms = len(first["chrom_names"])
    rng = np.random.default_rng(99)
    reads = random_reads(rng, 2500, 0, LENS[0])
    reads += random_reads(rng, 900, 1, LENS[1])
    write_bam_and_bai(paths[2], reads, ref_names=REFS, ref_lens=LENS,
                      header_text=_header("sM2"))
    second = trun(paths, out, chunk_samples=2, resume=True)
    assert second["diff"]["changed"] == [paths[2]]
    assert second["qc"] == {"computed": 1 * n_chroms,
                            "resumed": 4 * n_chroms}
    ref = str(tmp_path / "ref" / "out")
    jscan.run_cohortscan(paths, ref, chunk_samples=2)
    _same_artifacts(ref, out)


def test_foreign_manifest_is_rejected_loudly(tmp_path):
    p = str(tmp_path / "m.json")
    with open(p, "w") as f:
        json.dump({"format": "something-else/9", "params": {},
                   "samples": []}, f)
    with pytest.raises(ValueError, match=FORMAT):
        CohortManifest.load(p)
    assert FORMAT == "goleft-tpu.cohort-manifest/1"


def test_param_drift_invalidation_is_exactly_scoped(tmp_path):
    paths = _make_cohort(tmp_path, n=5, seed=31)
    out = str(tmp_path / "drift" / "out")
    trun(paths, out, chunk_samples=5)
    # -n changes the scalars' digest in each autosome block's key only
    second = trun(paths, out, chunk_samples=5, resume=True,
                  extra_normalize=True)
    assert second["qc"] == {"computed": 5, "resumed": 10}


# ------------------------------------- stores of the other package

def test_reference_store_resumes_under_the_port(tmp_path):
    """A checkpoint store and manifest written by the JAX package's
    cohortscan, to which the port appends two samples under --resume:
    computed 2 x chromosomes, resumed 7 x chromosomes, and the bytes of
    a fresh reference run."""
    paths = _make_cohort(tmp_path, n=9, seed=11)
    out = str(tmp_path / "inc" / "out")
    first = jscan.run_cohortscan(paths[:7], out, chunk_samples=3)
    n_chroms = len(first["chrom_names"])
    res = trun(paths, out, chunk_samples=3, resume=True)
    assert res["qc"] == {"computed": 2 * n_chroms,
                         "resumed": 7 * n_chroms}
    assert res["diff"]["new"] == paths[7:]
    assert res["diff"]["unchanged"] == paths[:7]
    ref = str(tmp_path / "ref" / "out")
    jscan.run_cohortscan(paths, ref, chunk_samples=9)
    _same_artifacts(ref, out)


def test_reference_normalized_store_resumes_under_the_port(cohort,
                                                           tmp_path):
    """Under -n the autosome blocks' keys carry the normalisation
    scalars' digest: a reference -n store resumes every block under the
    port (the digests agree), with the reference's bytes."""
    out = str(tmp_path / "n" / "out")
    ref = jscan.run_cohortscan(list(cohort), out, chunk_samples=3,
                               extra_normalize=True)
    want = str(tmp_path / "want" / "out")
    os.makedirs(want)
    for s, p in _artifacts(out).items():
        with open(p, "rb") as a, open(_artifacts(want)[s], "wb") as b:
            b.write(a.read())
    res = trun(list(cohort), out, chunk_samples=3, extra_normalize=True,
               resume=True)
    assert res["qc"] == {"computed": 0, "resumed": ref["qc"]["computed"]}
    _same_artifacts(want, out)


def test_port_store_resumes_under_the_reference(tmp_path):
    paths = _make_cohort(tmp_path, n=6, seed=5)
    out = str(tmp_path / "inc" / "out")
    first = trun(paths[:5], out, chunk_samples=2)
    n_chroms = len(first["chrom_names"])
    res = jscan.run_cohortscan(paths, out, chunk_samples=2, resume=True)
    assert res["qc"] == {"computed": n_chroms, "resumed": 5 * n_chroms}
    assert res["diff"]["new"] == paths[5:]


def test_key_width_and_digest_are_the_references():
    """The port's spills are as wide as the longest sample; its keys
    digest the scalars at the reference's bucketed width, equal to
    ``NormStats.scalars_digest`` there."""
    from goleft_tpu.commands.indexcov import _width_bucket

    for w in list(range(0, 1100)) + [15_195, 15_196, 2**14, 2**14 + 1,
                                     188_457]:
        assert tscan._key_width(w) == _width_bucket(max(w, 1)), w
    rng = np.random.default_rng(4)
    for n_bins in (7, 300, 1000):
        mat = rng.gamma(4.0, 0.25, (6, n_bins)).astype(np.float32)
        lens = rng.integers(max(n_bins - 5, 1), n_bins + 1, 6)
        lens[0] = n_bins
        for i, ln in enumerate(lens):
            mat[i, ln:] = 0
        st = tstream.NormStats()
        st.accumulate(mat, lens)
        m, skip = st.finalize(n_bins)
        pad = tscan._key_width(n_bins) - n_bins
        assert tstream.scalars_digest(
            np.pad(m, (0, pad)), np.pad(skip, (0, pad),
                                        constant_values=True)) == \
            st.scalars_digest(n_bins + pad)


# -------------------------------------------- the dropped row buckets

def test_dropped_row_buckets_change_no_byte(tmp_path):
    """The reference pads a chunk's rows to a power of two before the
    normalisation and chrom_qc (``_row_bucket``/``_pad_rows_to``); the
    port does not. Its rows equal the reference's padded ones bitwise,
    for a chunk of 3 rows padded to 4 and of 5 padded to 8."""
    rng = np.random.default_rng(12)
    for rows in (3, 5):
        n_bins = 40
        mat = rng.gamma(8.0, 1 / 8.0, (rows, n_bins)).astype(np.float32)
        lens = np.array([n_bins - i for i in range(rows)], np.int32)
        for i, ln in enumerate(lens):
            mat[i, ln:] = 0
        stats = tstream.NormStats()
        stats.accumulate(mat, lens)
        m, skip = stats.finalize(n_bins)
        rb = jscan._row_bucket(rows)
        assert rb > rows
        want = np.asarray(jscan.apply_normalization(
            jscan._pad_rows_to(mat, rb),
            jscan._pad_rows_to(lens.reshape(-1, 1), rb).ravel(),
            m, skip))[:rows]
        got = tstream.apply_normalization(
            torch.from_numpy(mat), torch.from_numpy(lens),
            torch.from_numpy(m), torch.from_numpy(skip)).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        valid = np.arange(n_bins)[None, :] < lens[:, None]
        norm = np.where(valid, got, 0.0).astype(np.float32)
        pad_valid = np.arange(n_bins)[None, :] < jscan._pad_rows_to(
            lens.reshape(-1, 1), rb).ravel()[:, None]
        jp = np.asarray(jops.chrom_qc(jscan._pad_rows_to(norm, rb),
                                      pad_valid, np.int32(0)))
        tp = tops.chrom_qc(torch.from_numpy(norm),
                           torch.from_numpy(valid), 0).numpy()
        jr, jc, jcn = jops.unpack_chrom_qc(jp, rb)
        tr, tc, tcn = tops.unpack_chrom_qc(tp, rows)
        assert np.array_equal(tr, jr[:rows])
        assert np.array_equal(tcn, jcn[:rows])
        for k in tc:
            assert np.array_equal(tc[k], jc[k][:rows]), k


# -------------------------------------- memory plane: chunk sizing

def test_auto_chunk_sizing_measures_and_journals_bytes(cohort, tmp_path):
    ref = str(tmp_path / "explicit" / "out")
    trun(list(cohort), ref, chunk_samples=3)
    out = str(tmp_path / "auto" / "out")
    res = trun(list(cohort), out, chunk_samples=0)
    jres = jscan.run_cohortscan(list(cohort), str(tmp_path / "j" / "out"),
                                chunk_samples=0)
    mem = res["memory"]
    assert mem["chunk_samples"] == jres["memory"]["chunk_samples"]
    assert mem["chunk_samples"] >= len(cohort)
    assert mem["chunk_peak_bytes"] > 0
    assert mem["per_sample_bytes"] > 0
    assert mem["prior_chunk_peak_bytes"] == 0
    assert "chunk_probe" in res["stages"]
    _same_bytes(ref, out)
    ck = os.path.join(out, ".cohortscan-ck")
    metas = [json.loads(line)["meta"]
             for line in open(os.path.join(ck, "journal.jsonl"))
             if line.strip() and "\"meta\"" in line]
    merged = {}
    for m in metas:
        merged.update(m)
    assert merged["chunk_peak_bytes"] == mem["chunk_peak_bytes"]
    assert merged["per_sample_bytes"] == mem["per_sample_bytes"]


def test_auto_chunk_samples_is_the_references():
    from goleft_tpu.obs.memplane import auto_chunk_samples as jauto
    from goleft_tpu_torch.obs.memplane import auto_chunk_samples as tauto

    for args in [(0, 1 << 28, 7), (1000, 0, 50), (1 << 20, 1 << 28, 100),
                 (1 << 20, 1 << 28, 5000), (1 << 30, 1 << 28, 100),
                 (3, 1 << 28, 10_000)]:
        assert tauto(*args) == jauto(*args), args


def test_resume_reports_prior_runs_peak_bytes(cohort, tmp_path):
    out = str(tmp_path / "scan")
    first = trun(list(cohort), out, chunk_samples=3)
    peak = first["memory"]["chunk_peak_bytes"]
    assert peak > 0
    second = trun(list(cohort), out, chunk_samples=3, resume=True)
    assert second["memory"]["prior_chunk_peak_bytes"] == peak


def test_negative_chunk_samples_rejected(tmp_path):
    with pytest.raises(ValueError, match="--chunk-samples"):
        trun(["x.bam"], str(tmp_path / "o"), chunk_samples=-1)
    with pytest.raises(ValueError, match="pca mode"):
        trun(["x.bam"], str(tmp_path / "o"), pca_mode="svd")


def test_default_run_needs_a_card(monkeypatch, tmp_path):
    from goleft_tpu_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device.NoCudaDevice):
        tscan.run_cohortscan(["x.bai"], str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


# ------------------------------------------------------ the CLI

def test_cli_help_is_the_references(capsys):
    """The reference's flags, defaults and help (argparse wraps the
    usage by the program's name, so whitespace is compared collapsed)."""
    helps = []
    for main in (jcmd.main, tcmd.main):
        with pytest.raises(SystemExit):
            main(["--help"])
        text = capsys.readouterr().out.replace("goleft-tpu-torch",
                                               "goleft-tpu")
        helps.append(" ".join(text.split()))
    assert helps[0] == helps[1]


def test_cli_runs_cohortscan(cohort, tmp_path, monkeypatch):
    """``python -m goleft_tpu_torch cohortscan -n`` (the default device
    pointed at the CPU) writes the reference CLI's artifacts and manifest
    counters; its run manifest has the stages."""
    from goleft_tpu_torch import cli, device as tdev

    monkeypatch.setattr(tscan, "resolve_device",
                        lambda d=None: tdev.resolve_device("cpu"))
    ref = str(tmp_path / "ref" / "out")
    got = str(tmp_path / "port" / "out")
    man = str(tmp_path / "m.json")
    jcmd.main(["-d", ref, "-n", "--chunk-samples", "2", *cohort])
    rc = cli.main(["--metrics-out", man, "cohortscan", "-d", got, "-n",
                   "--chunk-samples", "2", *cohort])
    assert rc == 0
    _same_artifacts(ref, got)
    a = CohortManifest.load(os.path.join(ref, "out-indexcov.manifest.json"))
    b = CohortManifest.load(os.path.join(got, "out-indexcov.manifest.json"))
    assert a.counters == b.counters and a.params == b.params
    with open(man) as fh:
        rep = json.load(fh)
    assert rep["command"] == "cohortscan" and rep["exit_code"] == 0
    assert "indexcov_norm" in rep["kernel_launches"]
    assert {"normalize", "qc_dispatch", "bed_gz"} <= set(rep["spans"])
    assert rep["metrics"]["counters"][
        "cohort.chrom_qc_samples_computed_total"] >= 7 * 3


def test_sigkill_mid_scan_then_resume_byte_identical(tmp_path):
    """``python -m goleft_tpu_torch cohortscan`` killed by
    ``--inject-faults shard:after=4:kill`` (the first X chunk), then
    --resume: the artifacts of an uninterrupted run, and the manifest
    counters show only the tail recomputed."""
    paths = _make_cohort(tmp_path, n=7, seed=17)
    runner = tmp_path / "cpu_cli.py"
    runner.write_text(_CPU_CLI.format(root=ROOT))
    env = dict(os.environ)
    env.pop("GOLEFT_TPU_FAULTS", None)
    ref = str(tmp_path / "cold" / "out")
    trun(paths, ref, chunk_samples=3)

    out = str(tmp_path / "kill" / "out")
    ck = str(tmp_path / "kill" / "ck")
    base = [sys.executable, str(runner), "cohortscan", "-d", out,
            "--chunk-samples", "3", "--checkpoint-dir", ck]
    kill = subprocess.run(
        base + ["--inject-faults", "shard:after=4:kill"] + paths,
        env=env, capture_output=True, timeout=300)
    assert kill.returncode in (-9, 137), kill.stderr.decode()
    # the kill fires on the 4th Step (the first X chunk): chr1's three
    # chunks (3, 3, 1 samples) committed, a journal line a block (the
    # journal also carries pass 1's {"meta": ...} line)
    committed = sum(
        1 for line in open(os.path.join(ck, "journal.jsonl"))
        if line.strip() and "\"k\"" in line)
    assert committed == 7

    res = subprocess.run(base + ["--resume"] + paths, env=env,
                         capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr.decode()
    _same_bytes(ref, out)
    man = CohortManifest.load(os.path.join(out,
                                           "out-indexcov.manifest.json"))
    assert man.counters["chrom_qc_samples_resumed_total"] == committed
    assert man.counters["chrom_qc_samples_computed_total"] \
        == 7 * 3 - committed
