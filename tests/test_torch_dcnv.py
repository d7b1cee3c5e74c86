"""``dcnv`` of the port (goleft_tpu_torch/commands/dcnv_cmd.py,
models/dcnv.py) against the JAX package's, on tests/test_cnv_clis.py's
``test_dcnv_cmd`` and ``test_dcnv_plot_pages`` fixtures: the table,
``--candidates-out`` (TSV and JSON) and the chart pages byte for byte.
The scalers and debiasers are host numpy copies and must agree exactly;
``SVDDebiaser`` (a float32 SVD of two libraries) within 2e-5 of the
matrix's largest magnitude.
"""

import io

import numpy as np
import pytest

from goleft_tpu.commands import dcnv_cmd as jcmd
from goleft_tpu.models import dcnv as jdcnv
from goleft_tpu_torch.commands import dcnv_cmd as tcmd
from goleft_tpu_torch.models import dcnv as tdcnv
from helpers import write_fasta
from test_cnv_clis import _write_matrix


def _gc_fixture(tmp_path):
    """test_dcnv_cmd's matrix: 200 windows of 1 kb whose GC share drives
    the depth of 3 samples."""
    rng = np.random.default_rng(1)
    n, w = 200, 1000
    gcs = rng.random(n)
    seqs = ["G" * int(g * w) + "A" * (w - int(g * w)) for g in gcs]
    fasta = write_fasta(str(tmp_path / "r.fa"), {"chr1": "".join(seqs)})
    starts = np.arange(n) * w
    depths = np.outer(50 + 100 * gcs, np.ones(3)) + rng.normal(0, 2, (n, 3))
    depths[40:55, 1] *= 0.4  # a loss in one sample: candidates to write
    depths[120:130, 2] *= 1.8
    p = str(tmp_path / "m.tsv")
    _write_matrix(p, ["chr1"] * n, starts, starts + w, depths.round(1),
                  ["a", "b", "c"])
    return p, fasta


def _pages_fixture(tmp_path):
    """test_dcnv_plot_pages' matrix: 40 windows on chr9, 2 samples."""
    rng = np.random.default_rng(5)
    n = 40
    seqs = "".join("GCAT"[int(x) % 4] * 250
                   for x in rng.integers(0, 4, 4 * n))
    fasta = write_fasta(str(tmp_path / "r.fa"), {"chr9": seqs[: n * 1000]})
    starts = np.arange(n) * 1000
    depths = rng.gamma(30, 1.0, size=(n, 2)).round(1)
    p = str(tmp_path / "m.tsv")
    _write_matrix(p, ["chr9"] * n, starts, starts + 1000, depths,
                  ["a", "b"])
    return p, fasta


@pytest.mark.parametrize("cand", ["c.tsv", "c.json"])
def test_dcnv_cmd_matches_jax(tmp_path, cand):
    p, fasta = _gc_fixture(tmp_path)
    outs, cands = [], []
    for i, run in enumerate((jcmd.run_dcnv, tcmd.run_dcnv)):
        buf = io.StringIO()
        c = str(tmp_path / f"{i}{cand}")
        norm = run(p, fasta, out=buf, candidates_out=c)
        outs.append(buf.getvalue())
        cands.append(open(c).read())
        assert norm.shape == (200, 3)
    assert outs[1] == outs[0]
    assert cands[1] == cands[0]
    assert len(outs[1].splitlines()) == 201
    assert "\tb\t" in cands[1] or '"b"' in cands[1]


def test_dcnv_plot_pages_match_jax(tmp_path, monkeypatch):
    p, fasta = _pages_fixture(tmp_path)
    monkeypatch.chdir(tmp_path)
    jcmd.run_dcnv(p, fasta, out=io.StringIO(), plot_prefix="jx")
    tcmd.run_dcnv(p, fasta, out=io.StringIO(), plot_prefix="pt")
    want = (tmp_path / "jx-depth-chr9.html").read_text()
    got = (tmp_path / "pt-depth-chr9.html").read_text()
    assert got == want
    assert "scaled coverage" in got and "dcnv_chr9" in got


def test_dcnv_gc_pages_and_window_match_jax(tmp_path, monkeypatch):
    p, fasta = _gc_fixture(tmp_path)
    monkeypatch.chdir(tmp_path)
    a, b = io.StringIO(), io.StringIO()
    jcmd.run_dcnv(p, fasta, out=a, window=5, plot_prefix="jx")
    tcmd.run_dcnv(p, fasta, out=b, window=5, plot_prefix="pt")
    assert b.getvalue() == a.getvalue()
    assert (tmp_path / "pt-depth-chr1.html").read_text() == \
        (tmp_path / "jx-depth-chr1.html").read_text()


def test_cli_runs_dcnv(tmp_path, capsys):
    """``python -m goleft_tpu_torch dcnv`` needs no card: the reference
    CLI's bytes, with the reference's help."""
    from goleft_tpu_torch import cli

    p, fasta = _gc_fixture(tmp_path)
    jcmd.main(["-f", fasta, "-w", "7", p])
    want = capsys.readouterr().out
    assert cli.main(["dcnv", "-f", fasta, "-w", "7", p]) == 0
    assert capsys.readouterr().out == want
    helps = []
    for main in (jcmd.main, tcmd.main):
        with pytest.raises(SystemExit):
            main(["--help"])
        text = capsys.readouterr().out.replace("goleft-tpu-torch",
                                               "goleft-tpu")
        helps.append(" ".join(text.split()))
    assert helps[0] == helps[1]


# ---- the models

def _matrix(seed, n=60, s=5):
    rng = np.random.default_rng(seed)
    a = rng.gamma(20, 2.0, (n, s))
    a[rng.random((n, s)) < 0.05] = 0
    return a


@pytest.mark.parametrize("scaler", ["ZScore", "RowCentered", "ColCentered",
                                    "Log2"])
def test_scalers_match_jax(scaler):
    a = _matrix(3)
    j, t = getattr(jdcnv, scaler)(), getattr(tdcnv, scaler)()
    sj, st = j.scale(a.copy()), t.scale(a.copy())
    assert np.array_equal(st, sj)
    assert np.array_equal(t.unscale(st), j.unscale(sj))


@pytest.mark.parametrize("window", [1, 4, 9, 65, 200])
def test_general_debiaser_matches_jax(window):
    a = _matrix(4, n=80)
    gcs = np.random.default_rng(9).random(80)
    outs = []
    for mod in (jdcnv, tdcnv):
        db = mod.GeneralDebiaser(gcs, window=window)
        outs.append(db.unsort(db.debias(db.sort(a))))
    assert np.array_equal(outs[1], outs[0])
    assert np.array_equal(tdcnv.gc_debias_pipeline(a, gcs, window),
                          jdcnv.gc_debias_pipeline(a, gcs, window))
    with pytest.raises(RuntimeError, match="sort first"):
        tdcnv.GeneralDebiaser(gcs).unsort(a)


def test_chunk_debiaser_and_medians_match_jax():
    a = _matrix(6, n=90)
    gcs = np.random.default_rng(2).random(90)
    outs = []
    for mod in (jdcnv, tdcnv):
        db = mod.ChunkDebiaser(gcs, score_window=0.1)
        outs.append(db.unsort(db.debias(db.sort(a))))
    assert np.array_equal(outs[1], outs[0])
    assert np.array_equal(tdcnv.sample_medians(a), jdcnv.sample_medians(a))
    assert np.array_equal(tdcnv.normalize_by_sample_median(a),
                          jdcnv.normalize_by_sample_median(a))
    with pytest.raises(ValueError, match="score_window"):
        tdcnv.ChunkDebiaser(gcs, 0)


@pytest.mark.parametrize("shape,pct", [((60, 5), 5.0), ((40, 12), 2.0),
                                       ((8, 30), 10.0)])
def test_svd_debiaser_matches_jax(shape, pct):
    """The float32 SVD on the CPU against the reference's jnp.linalg.svd:
    the same components zeroed, the rebuilt matrix within 2e-5 of the
    input's largest magnitude."""
    rng = np.random.default_rng(shape[0])
    a = (rng.gamma(20, 2.0, shape)
         + np.outer(rng.random(shape[0]) * 30, np.ones(shape[1])))
    a = a.astype(np.float32)
    want = jdcnv.SVDDebiaser(min_variance_pct=pct).debias(a)
    got = tdcnv.SVDDebiaser(min_variance_pct=pct).debias(a, device="cpu")
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * float(np.abs(a).max()))
    assert np.abs(got).max() < np.abs(a).max()  # the leading one zeroed
