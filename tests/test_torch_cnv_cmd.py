"""The port's ``emdepth`` and ``cnv`` commands (goleft_tpu_torch/commands/
emdepth_cmd.py, commands/cnv.py, on the CPU) against the JAX package's:
every output byte for byte.

- ``emdepth``: stdout, ``--matrix-out``, ``--vcf`` (plain and ``.gz``),
  ``--mops-out``, ``--gain-out``, ``--candidates-out`` (TSV and JSON)
  and ``--no-normalize``, on tests/test_cnv_clis.py's matrix and on a
  3,000-window x 12-sample matrix with planted CNVs, under ``EM_CHUNK``
  16 and the default; through the CLI too.
- A sample at 2% of the cohort's depth (k = 1 against λ near 40) drives
  cn.mops' E-step denominator to its 1e-30 floor and the information
  gain past 1e28: there, and only there, the printed gain differs from
  JAX's in digits beyond f64's 16 significant ones (XLA's exp and
  lgamma are not libm's; ROADMAP Queue C). Every other byte is equal.
- ``cnv`` on tests/test_cnv_cmd.py's planted-deletion cohort under
  ``--engine`` hybrid, device and auto, with ``-b``, with ``--vcf -r``
  (the padding base), on a CRAM cohort, and under a permanent ``shard``
  fault, which fails the command in both packages.
"""

import gzip
import io

import numpy as np
import pytest
import torch

from goleft_tpu.commands import cnv as jcnv
from goleft_tpu.commands import emdepth_cmd as jcmd
from goleft_tpu.io.fai import write_fai
from goleft_tpu.ops.decode_smoke import make_cram_cohort
from goleft_tpu.resilience import faults as jfaults
from goleft_tpu_torch import cli, device as tdev
from goleft_tpu_torch.commands import cnv as tcnv
from goleft_tpu_torch.commands import emdepth_cmd as tcmd
from goleft_tpu_torch.device import NoCudaDevice
from goleft_tpu_torch.resilience import faults as tfaults
from helpers import write_bam_and_bai, write_fasta

CPU = "cpu"


def _write_matrix(path, chroms, starts, ends, depths, samples):
    with open(path, "w") as fh:
        fh.write("#chrom\tstart\tend\t" + "\t".join(samples) + "\n")
        for i in range(len(chroms)):
            vals = "\t".join(str(v) for v in depths[i])
            fh.write(f"{chroms[i]}\t{starts[i]}\t{ends[i]}\t{vals}\n")


def _clis_matrix(path):
    """tests/test_cnv_clis.py's matrix: a het-deletion-like run in s4."""
    rng = np.random.default_rng(0)
    n_win, n_s = 40, 12
    depths = rng.gamma(40, 1.0, size=(n_win, n_s)).round(1)
    depths[10:16, 4] *= 0.25
    starts = np.arange(n_win) * 1000
    _write_matrix(path, ["chr1"] * n_win, starts, starts + 1000, depths,
                  [f"s{i}" for i in range(n_s)])


def _planted_matrix(path, deep: bool = False):
    """3,000 windows x 12 samples on two chromosomes: a homozygous
    deletion (depth 0), a het deletion, two duplications, a CN1-CN3 run
    merged across the 30 kb gap; ``deep`` adds a sample at 2% depth."""
    rng = np.random.default_rng(9)
    n_win, n_s = 3000, 12
    d = rng.gamma(40, 1.0, size=(n_win, n_s)).round(1)
    d[100:160, 4] *= 0.5
    d[400:430, 1] = 0
    d[1000:1100, 7] *= 1.5
    d[1800:1850, 9] *= 2.0
    d[2500:2520, 3] *= 0.5
    d[2540:2560, 3] *= 1.5
    if deep:
        d[2000:2030, 1] *= 0.02
    chroms = ["chr1"] * 2000 + ["chr2"] * (n_win - 2000)
    starts = np.r_[np.arange(2000), np.arange(n_win - 2000)] * 1000
    _write_matrix(path, chroms, starts, starts + 1000, d,
                  [f"s{i}" for i in range(n_s)])


MATRICES = {"clis": _clis_matrix, "planted": _planted_matrix}


@pytest.fixture(scope="module")
def matrices(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_emdepth")
    out = {}
    for name, make in MATRICES.items():
        out[name] = str(d / f"{name}.tsv")
        make(out[name])
    out["deep"] = str(d / "deep.tsv")
    _planted_matrix(out["deep"], deep=True)
    return out


def _outputs(d, tag, vcf_ext, cand_ext):
    return dict(matrix_out=f"{d}/{tag}.cn.tsv",
                vcf_out=f"{d}/{tag}{vcf_ext}",
                mops_out=f"{d}/{tag}.mops.tsv",
                gain_out=f"{d}/{tag}.gain.tsv",
                candidates_out=f"{d}/{tag}.cand{cand_ext}")


def _both_emdepth(monkeypatch, tmp_path, matrix, chunk, normalize,
                  vcf_ext=".vcf", cand_ext=".tsv"):
    """Run both packages' emdepth with every output → (JAX's, the
    port's) {name: bytes}, stdout under "out"."""
    if chunk is not None:
        monkeypatch.setattr(jcmd, "EM_CHUNK", chunk)
        monkeypatch.setattr(tcmd, "EM_CHUNK", chunk)
    got = {}
    for tag, run, kw in (("jax", jcmd.run_emdepth, {}),
                         ("port", tcmd.run_emdepth, {"device": CPU})):
        outs = _outputs(tmp_path, tag, vcf_ext, cand_ext)
        buf = io.StringIO()
        run(matrix, out=buf, normalize=normalize, **outs, **kw)
        got[tag] = {"out": buf.getvalue().encode()}
        for k, p in outs.items():
            with open(p, "rb") as fh:
                got[tag][k] = fh.read()
    return got["jax"], got["port"]


@pytest.mark.parametrize("name,chunk,normalize,vcf_ext,cand_ext", [
    ("clis", 16, True, ".vcf", ".tsv"),
    ("clis", None, True, ".vcf.gz", ".json"),
    ("clis", None, False, ".vcf", ".json"),
    ("planted", 16, True, ".vcf.gz", ".tsv"),
    ("planted", None, True, ".vcf", ".json"),
    ("planted", 16, False, ".vcf", ".tsv"),
])
def test_emdepth_outputs_match_jax(matrices, monkeypatch, tmp_path, name,
                                   chunk, normalize, vcf_ext, cand_ext):
    want, got = _both_emdepth(monkeypatch, tmp_path, matrices[name], chunk,
                              normalize, vcf_ext, cand_ext)
    for k in want:
        assert got[k] == want[k], k
    assert len(want["out"].splitlines()) > 1
    if vcf_ext.endswith(".gz"):
        assert gzip.decompress(got["vcf_out"]).startswith(
            b"##fileformat=VCFv4.2")


def test_emdepth_finds_the_planted_events(matrices):
    calls = tcmd.run_emdepth(matrices["planted"], out=io.StringIO(),
                             device=CPU)
    hit = {(c, s): (st, en, cn, fc) for c, st, en, s, cn, fc in calls}
    assert any(s == "s1" and v[2] == 0 for (c, s), v in hit.items())
    assert any(s == "s7" and v[3] > 0.3 for (c, s), v in hit.items())
    assert any(c == "chr2" for c, _ in hit)


def test_deep_deletion_gain_differs_only_past_f64_digits(
        matrices, monkeypatch, tmp_path):
    want, got = _both_emdepth(monkeypatch, tmp_path, matrices["deep"], None,
                              True)
    for k in want:
        if k != "gain_out":
            assert got[k] == want[k], k
    wl = want["gain_out"].decode().splitlines()
    gl = got["gain_out"].decode().splitlines()
    assert len(wl) == len(gl) == 3001
    differ = 0
    for a, b in zip(wl, gl):
        if a == b:
            continue
        differ += 1
        fa, fb = a.split("\t"), b.split("\t")
        assert fa[:3] == fb[:3]
        wa, wb = float(fa[3]), float(fb[3])
        # 4 decimals of a value past 1e12 print digits f64 does not hold
        assert wa > 1e12 and wb > 1e12, (a, b)
        assert wb == pytest.approx(wa, rel=1e-12), (a, b)
    assert differ <= 30  # the deep sample's windows only


@pytest.fixture
def cpu_cli(monkeypatch):
    """The port's CLI with the commands' default device on the CPU."""
    cpu = lambda d=None: tdev.resolve_device("cpu" if d is None else d)  # noqa: E731
    cpus = lambda ds=None, d=None: tdev.resolve_devices(  # noqa: E731
        ds, "cpu" if d is None else d)
    from goleft_tpu_torch.commands import cohortdepth as tcd

    for mod in (tcmd, tcnv, tcd):
        monkeypatch.setattr(mod, "resolve_device", cpu)
    for mod in (tcmd, tcd):
        monkeypatch.setattr(mod, "resolve_devices", cpus)
    # the card's subprocess probe is skipped: the commands run on the
    # CPU here (utils/device_guard.py)
    monkeypatch.setenv("GOLEFT_TPU_PROBE", "0")
    return cli.main


def test_emdepth_cli_matches_jax(matrices, cpu_cli, tmp_path, capsys):
    outs = _outputs(tmp_path, "jax", ".vcf", ".json")
    buf = io.StringIO()
    jcmd.run_emdepth(matrices["clis"], out=buf, **outs)
    p = _outputs(tmp_path, "port", ".vcf", ".json")
    capsys.readouterr()
    assert cpu_cli(["emdepth", "--matrix-out", p["matrix_out"],
                    "--vcf", p["vcf_out"], "--mops-out", p["mops_out"],
                    "--gain-out", p["gain_out"], "--candidates-out",
                    p["candidates_out"], matrices["clis"]]) == 0
    assert capsys.readouterr().out == buf.getvalue()
    for k in outs:
        assert open(p[k], "rb").read() == open(outs[k], "rb").read(), k


def test_emdepth_cli_manifest_and_trace(matrices, cpu_cli, tmp_path,
                                        capsys):
    """``--metrics-out`` and ``--trace-out`` cover emdepth: the
    reference's manifest with the ``run.emdepth`` root and the command's
    stages, and one trace root with every stage under it."""
    import json

    from goleft_tpu.obs.manifest import load_manifest
    from goleft_tpu_torch import obs

    man, trace = str(tmp_path / "m.json"), str(tmp_path / "t.json")
    obs.get_tracer().clear()
    try:
        assert cpu_cli(["--metrics-out", man, "--trace-out", trace,
                        "emdepth", "--mops-out", str(tmp_path / "mops.tsv"),
                        matrices["clis"]]) == 0
    finally:
        obs.set_device_events(False)
        obs.get_tracer().clear()
    capsys.readouterr()
    doc = load_manifest(man)
    assert doc["command"] == "emdepth" and doc["exit_code"] == 0
    assert doc["backend"]["platform"] == "cpu"
    for stage in ("run.emdepth", "matrix-read", "normalize", "mops",
                  "em-chunk", "merge", "output"):
        assert doc["spans"][stage]["calls"] >= 1, stage
    events = [e for e in json.load(open(trace))["traceEvents"]
              if e.get("ph") == "X"]
    roots = [e for e in events if e["name"] == "run.emdepth"]
    assert len(roots) == 1
    assert {"em-chunk", "merge", "output"} <= {e["name"] for e in events}


def test_emdepth_without_a_card_raises(matrices, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        tcmd.run_emdepth(matrices["clis"], out=io.StringIO())


# ---- cnv ----------------------------------------------------------------

REF_LEN = 120_000
DEL_LO, DEL_HI = 40_000, 60_000


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """tests/test_cnv_cmd.py's cohort: 8 BAMs, p3 with a het deletion,
    over a random ACGT reference (so the VCF's padding base varies)."""
    d = tmp_path_factory.mktemp("torch_cnv")
    rng = np.random.default_rng(0)
    seq = "".join(rng.choice(list("ACGT"), REF_LEN))
    fa = write_fasta(str(d / "r.fa"), {"chr1": seq})
    write_fai(fa)
    bams = []
    for i in range(8):
        starts = np.sort(rng.integers(0, REF_LEN - 100, size=4000))
        if i == 3:
            in_del = (starts >= DEL_LO) & (starts < DEL_HI)
            starts = starts[~(in_del & (rng.random(len(starts)) < 0.5))]
        reads = [(0, int(s), "100M", 60, 0) for s in starts]
        hdr = ("@HD\tVN:1.6\tSO:coordinate\n"
               f"@SQ\tSN:chr1\tLN:{REF_LEN}\n@RG\tID:r\tSM:p{i}\n")
        p = str(d / f"p{i}.bam")
        write_bam_and_bai(p, reads, ref_names=("chr1",),
                          ref_lens=(REF_LEN,), header_text=hdr)
        bams.append(p)
    bed = str(d / "regions.bed")
    with open(bed, "w") as fh:
        fh.write("chr1\t10000\t70000\nchr1\t90000\t115000\n")
    return fa, bams, bed


def _both_cnv(tmp_path, bams, **kw):
    """Both packages' cnv → (JAX's, the port's) (calls, {name: bytes})."""
    res = {}
    for tag, run, extra in (("jax", jcnv.run_cnv, {}),
                            ("port", tcnv.run_cnv, {"device": CPU})):
        outs = {k: f"{tmp_path}/{tag}.{k}" for k in
                ("matrix_out", "mops_out", "gain_out")}
        outs["vcf_out"] = f"{tmp_path}/{tag}.vcf.gz"
        buf = io.StringIO()
        calls = run(bams, out=buf, **outs, **kw, **extra)
        files = {"out": buf.getvalue().encode()}
        for k, p in outs.items():
            with open(p, "rb") as fh:
                files[k] = fh.read()
        res[tag] = (calls, files)
    return res["jax"], res["port"]


def _same(want, got):
    for k in want[1]:
        assert got[1][k] == want[1][k], k
    assert [r[:5] for r in got[0]] == [r[:5] for r in want[0]]


@pytest.mark.parametrize("engine", ["hybrid", "device", "auto"])
def test_cnv_matches_jax(cohort, tmp_path, engine):
    fa, bams, _ = cohort
    want, got = _both_cnv(tmp_path, bams, reference=fa, window=2000,
                          engine=engine)
    _same(want, got)
    hits = [r for r in got[0] if r[3] == "p3" and r[5] < -0.5]
    assert hits and hits[0][1] < DEL_HI and hits[0][2] > DEL_LO
    rows = got[1]["matrix_out"].decode().splitlines()
    assert len(rows) == REF_LEN // 2000 + 1
    # the padding base of every record is the reference's base before it
    seq = open(fa).read().split("\n", 1)[1].replace("\n", "")
    recs = [ln.split("\t") for ln in
            gzip.decompress(got[1]["vcf_out"]).decode().splitlines()
            if not ln.startswith("#")]
    assert recs
    for r in recs:
        assert r[3] == seq[int(r[1]) - 1]


def test_cnv_with_a_bed_matches_jax(cohort, tmp_path):
    fa, bams, bed = cohort
    want, got = _both_cnv(tmp_path, bams, reference=fa, window=1000,
                          bed=bed, processes=3)
    _same(want, got)
    rows = got[1]["matrix_out"].decode().splitlines()
    assert len(rows) == 1 + 60 + 25


def test_cnv_cli_matches_jax(cohort, cpu_cli, tmp_path, capsys):
    fa, bams, _ = cohort
    want, _ = _both_cnv(tmp_path, bams, reference=fa, window=2000)
    capsys.readouterr()
    vcf = str(tmp_path / "cli.vcf.gz")
    assert cpu_cli(["cnv", "-w", "2000", "-r", fa, "--vcf", vcf,
                    "--engine", "device", "-p", "2"] + bams) == 0
    assert capsys.readouterr().out.encode() == want[1]["out"]
    assert open(vcf, "rb").read() == want[1]["vcf_out"]


def test_cnv_on_a_cram_cohort_matches_jax(tmp_path):
    crams, fai = make_cram_cohort(str(tmp_path))
    want, got = _both_cnv(tmp_path, crams, fai=fai, window=500)
    _same(want, got)
    assert len(got[1]["matrix_out"].decode().splitlines()) == 101


def test_permanent_shard_fault_fails_cnv_in_both(cohort, tmp_path):
    fa, bams, _ = cohort
    spec = "shard:after=1:permanent"
    for inst, run, kw in ((jfaults.install, jcnv.run_cnv, {}),
                          (tfaults.install, tcnv.run_cnv,
                           {"device": CPU})):
        try:
            inst(spec)
            with pytest.raises(Exception, match="injected"):
                run(bams, reference=fa, window=2000, out=io.StringIO(),
                    **kw)
        finally:
            inst(None)


def test_cnv_fails_on_a_sample_that_does_not_open(cohort, tmp_path):
    """No quarantine in cnv: a missing input fails the run, in both."""
    fa, bams, _ = cohort
    bad = bams[:2] + [str(tmp_path / "missing.bam")]
    for run, kw in ((jcnv.run_cnv, {}), (tcnv.run_cnv, {"device": CPU})):
        with pytest.raises(FileNotFoundError):
            run(bad, reference=fa, window=2000, out=io.StringIO(), **kw)


def test_cnv_refuses_multi_process_and_needs_a_card(cohort, monkeypatch):
    fa, bams, _ = cohort
    # a world of processes asked for and not up: no quiet world of one
    monkeypatch.delenv("GOLEFT_TPU_COORDINATOR", raising=False)
    monkeypatch.setenv("GOLEFT_TPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="asks for a world"):
        tcnv.run_cnv(bams, reference=fa, device=CPU)
    monkeypatch.delenv("GOLEFT_TPU_NUM_PROCESSES")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        tcnv.run_cnv(bams, reference=fa, out=io.StringIO())


def test_collect_matrix_holds_int16():
    def blocks():
        for lo in range(0, 30, 10):
            st = np.arange(lo, lo + 10, dtype=np.int64) * 100
            yield "chr1", st, st + 100, np.full((3, 10), lo + 1, np.int64)

    chroms, starts, ends, depths = tcnv.collect_matrix(blocks(), 30, 3)
    want = jcnv.collect_matrix(blocks(), 30, 3)
    assert depths.dtype == np.int16
    for a, b in zip((chroms, starts, ends, depths), want):
        np.testing.assert_array_equal(a, b)


def test_native_library_loads_once_for_concurrent_openers(monkeypatch):
    """The sample threads open a cohort's inputs at once. A thread that
    asks for the native library while another is still loading it must
    wait for it, not take the pure-Python handle: one such BAM turned a
    BAM cohort's ``auto`` engine from hybrid into device."""
    import ctypes
    import threading
    import time

    from goleft_tpu_torch.io import native

    assert native.get_lib() is not None, "the native library must build"
    cdll = ctypes.CDLL

    def slow_cdll(path, *a, **k):
        time.sleep(0.2)
        return cdll(path, *a, **k)

    monkeypatch.setattr(native.ctypes, "CDLL", slow_cdll)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    gate = threading.Barrier(8)
    got = [None] * 8

    def opener(i):
        gate.wait(timeout=10)
        got[i] = native.get_lib()

    threads = [threading.Thread(target=opener, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert all(g is not None and g is got[0] for g in got), got


def test_cnv_fails_on_a_sample_that_fails_mid_run(cohort, monkeypatch):
    """No quarantine in cnv: a sample whose window reduction fails
    permanently fails the run, in both packages (cohortdepth would
    zero-fill it and exit 3)."""
    from goleft_tpu.io import bam as jbam
    from goleft_tpu_torch.io import bam as tbam

    fa, bams, _ = cohort

    def broken(self, *a, **k):
        raise ValueError("broken sample")

    for mod, run, kw in ((jbam, jcnv.run_cnv, {}),
                         (tbam, tcnv.run_cnv, {"device": CPU})):
        monkeypatch.setattr(mod.BamFile, "window_reduce", broken)
        with pytest.raises(ValueError, match="broken sample"):
            run(bams, reference=fa, window=2000, out=io.StringIO(),
                engine="hybrid", **kw)
