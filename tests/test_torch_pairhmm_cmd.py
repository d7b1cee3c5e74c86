"""``goleft_tpu_torch pairhmm`` against ``goleft_tpu pairhmm`` on the CPU:
the same windows documents through the reference's ``run_pairhmm`` and
the port's ``run_pairhmm(..., device="cpu")`` give byte-identical tables
(f32 and f64, with and without ``--candidates``), the same validation
errors, and the same degraded-run contract under injected faults."""

import io
import json

import numpy as np
import pytest
import torch

from goleft_tpu.commands import pairhmm_cmd as jcmd
from goleft_tpu.models import genotype as jgt
from goleft_tpu.models.candidates import write_candidates as jwrite
from goleft_tpu.obs.manifest import load_manifest
from goleft_tpu.resilience import faults as jfaults
from goleft_tpu_torch import cli
from goleft_tpu_torch.commands import pairhmm_cmd as tcmd
from goleft_tpu_torch.models import candidates as tcand
from goleft_tpu_torch.models import genotype as tgt
from goleft_tpu_torch.obs import get_registry
from goleft_tpu_torch.ops import pairhmm as tph
from goleft_tpu_torch.resilience import faults as tfaults
from test_pairhmm import _windows_doc

_BASES = np.array(list("ACGT"))


def _mixed_doc(path, n_windows=30, seed=21):
    """Seeded windows of mixed lengths: 2-4 haplotypes (ref, SNP,
    insertion, deletion) of 50-120 bp, 3-9 reads of 30-60 bp with
    errors and an N now and then, quals as phred+33 strings, int lists
    or one int."""
    rng = np.random.default_rng(seed)
    wins = []
    for w in range(n_windows):
        hl = int(rng.integers(50, 121))
        ref = "".join(rng.choice(_BASES, hl))
        v = hl // 2
        alts = [ref[:v] + ("A" if ref[v] != "A" else "C") + ref[v + 1:],
                ref[:v] + "GT" + ref[v:], ref[:v] + ref[v + 3:]]
        haps = [ref] + alts[:int(rng.integers(1, 4))]
        reads = []
        for r in range(int(rng.integers(3, 10))):
            src = haps[int(rng.integers(len(haps)))]
            rl = int(rng.integers(30, 61))
            st = int(rng.integers(0, max(1, len(src) - rl)))
            seq = list(src[st:st + rl])
            for k in np.flatnonzero(rng.random(len(seq)) < 0.03):
                seq[k] = str(rng.choice(_BASES))
            if rng.random() < 0.2:
                seq[int(rng.integers(len(seq)))] = "N"
            q = rng.integers(2, 42, len(seq))
            kind = r % 3
            quals = ("".join(chr(33 + int(x)) for x in q) if kind == 0
                     else [int(x) for x in q] if kind == 1 else 30)
            reads.append({"seq": "".join(seq), "quals": quals})
        start = 1000 * w
        wins.append({"chrom": "chr1" if w < 20 else "chr2", "start": start,
                     "end": start + hl, "haplotypes": haps,
                     "reads": reads})
    with open(path, "w") as fh:
        json.dump({"schema": "goleft-tpu.pairhmm-windows/1",
                   "windows": wins}, fh)


def _cands(path):
    jwrite(path, [{"chrom": "chr1", "start": 4500, "end": 12_200,
                   "sample": "s", "cn": 1, "log2fc": -1.0},
                  {"chrom": "chr2", "start": 25_000, "end": 27_010,
                   "sample": "s", "cn": 3, "log2fc": 0.6}], "test")


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pairhmm")
    small, mixed, cand = (str(d / n) for n in ("w.json", "m.json",
                                                "c.bed"))
    _windows_doc(small)
    _mixed_doc(mixed)
    _cands(cand)
    return {"small": small, "mixed": mixed, "cand": cand}


def _run_both(path, **kw):
    want, got = io.StringIO(), io.StringIO()
    rc_want = jcmd.run_pairhmm(path, out=want, **kw)
    rc_got = tcmd.run_pairhmm(path, out=got, device="cpu", **kw)
    return rc_want, want.getvalue(), rc_got, got.getvalue()


@pytest.mark.parametrize("use_f64", [False, True])
@pytest.mark.parametrize("with_cands", [False, True])
@pytest.mark.parametrize("doc", ["small", "mixed"])
def test_table_byte_identical(docs, doc, with_cands, use_f64):
    kw = {"use_f64": use_f64}
    if with_cands:
        kw["candidates"] = docs["cand"]
    rc_want, want, rc_got, got = _run_both(docs[doc], **kw)
    assert rc_want == rc_got == 0
    assert got == want
    rows = got.splitlines()
    assert rows[0] == tgt.HEADER.rstrip("\n")
    if doc == "mixed":
        assert len(rows) - 1 == (11 if with_cands else 30)


def test_gap_penalties_pass_through(docs):
    rc_want, want, rc_got, got = _run_both(docs["mixed"], gap_open=30.0,
                                           gap_ext=5.0)
    assert rc_want == rc_got == 0 and got == want


def test_candidates_files_read_the_same(docs, tmp_path):
    cj = str(tmp_path / "c.json")
    jwrite(cj, [{"chrom": "chr1", "start": 4500, "end": 12_200,
                 "sample": "s", "cn": 1, "log2fc": -1.0}], "test")
    tb = str(tmp_path / "t.bed")
    tcand.write_candidates(tb, tcand.read_candidates(docs["cand"]), "test")
    assert open(tb).read() == open(docs["cand"]).read()
    from goleft_tpu.models.candidates import read_candidates as jread

    for path in (docs["cand"], cj):
        assert tcand.read_candidates(path) == jread(path)
    bad = tmp_path / "x.bed"
    bad.write_text("chr1\t0\t10\n")
    with pytest.raises(ValueError, match="not a goleft-tpu"):
        tcand.read_candidates(str(bad))


_OK = {"schema": "goleft-tpu.pairhmm-windows/1",
       "windows": [{"chrom": "c", "start": 0, "end": 9,
                    "haplotypes": ["ACGT"],
                    "reads": [{"seq": "AC", "quals": [30, 31]}]}]}


def _bad(edit):
    doc = json.loads(json.dumps(_OK))
    edit(doc)
    return doc


BAD_DOCS = {
    "not-object": [],
    "schema": {"schema": "nope", "windows": []},
    "windows-not-list": {"schema": _OK["schema"], "windows": {}},
    "window-not-object": {"schema": _OK["schema"], "windows": [3]},
    "no-chrom": _bad(lambda d: d["windows"][0].pop("chrom")),
    "no-haps": _bad(lambda d: d["windows"][0].update(haplotypes=[])),
    "empty-hap": _bad(lambda d: d["windows"][0].update(haplotypes=[""])),
    "no-seq": _bad(lambda d: d["windows"][0]["reads"][0].pop("seq")),
    "quals-type": _bad(
        lambda d: d["windows"][0]["reads"][0].update(quals={})),
    "quals-length": _bad(
        lambda d: d["windows"][0]["reads"][0].update(quals=[30])),
    "negative-qual": _bad(
        lambda d: d["windows"][0]["reads"][0].update(quals=[30, -1])),
}


@pytest.mark.parametrize("name", sorted(BAD_DOCS))
def test_load_windows_raises_the_same_errors(name):
    doc = BAD_DOCS[name]
    with pytest.raises(ValueError) as want:
        jgt.load_windows(doc)
    with pytest.raises(ValueError) as got:
        tgt.load_windows(doc)
    assert str(got.value) == str(want.value)


def test_load_windows_encodes_the_same():
    s = json.loads(json.dumps(_OK))
    s["windows"][0]["reads"].append({"seq": "ACGTN", "quals": "I5!~~"})
    s["windows"][0]["reads"].append({"seq": "GG"})
    got, want = tgt.load_windows(s, "x"), jgt.load_windows(s, "x")
    assert len(got) == len(want) == 1
    for g, w in zip(got[0]["haps"], want[0]["haps"]):
        np.testing.assert_array_equal(g, w)
    for (gc, gq), (wc, wq) in zip(got[0]["reads"], want[0]["reads"]):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gq, wq)


def test_genotype_likelihoods_match(docs):
    rng = np.random.default_rng(4)
    for shape in ((5, 2), (0, 3), (7, 4), (3, 1)):
        ll = -rng.random(shape) * 20
        if ll.size:
            ll[0, 0] = -np.inf
        g, w = tgt.genotype_likelihoods(ll), jgt.genotype_likelihoods(ll)
        np.testing.assert_array_equal(g["gl"], w["gl"])
        np.testing.assert_array_equal(g["pl"], w["pl"])
        assert (g["best"], g["gq"]) == (w["best"], w["gq"])


def test_injected_transient_fault_is_retried(docs):
    path = docs["small"]
    clean = io.StringIO()
    assert tcmd.run_pairhmm(path, out=clean, device="cpu") == 0
    reg = get_registry()
    before = reg.counter("resilience.retries_total").value
    tfaults.install("pairhmm:after=1:times=1:transient")
    try:
        injected = io.StringIO()
        assert tcmd.run_pairhmm(path, out=injected, device="cpu") == 0
    finally:
        tfaults.install(None)
    assert injected.getvalue() == clean.getvalue()
    assert reg.counter("resilience.retries_total").value == before + 1
    assert reg.counter(
        "resilience.faults_injected.pairhmm_total").value >= 1


def test_injected_permanent_fault_quarantines_window(docs, tmp_path):
    qpath = str(tmp_path / "q.json")
    tfaults.install("pairhmm:every=1:permanent:times=99")
    try:
        buf = io.StringIO()
        rc = tcmd.run_pairhmm(docs["small"], out=buf, quarantine_out=qpath,
                              device="cpu")
    finally:
        tfaults.install(None)
    assert rc == 3
    assert buf.getvalue() == tgt.HEADER
    doc = json.load(open(qpath))
    assert len(doc["quarantined"]) == 2
    assert all(e["phase"] == "pairhmm" for e in doc["quarantined"])


def test_kernel_fault_fails_the_run_unretried(docs, tmp_path, monkeypatch):
    """A kernel that does not build or launch is a fault of the card or
    its toolchain, not of the data: the run fails with it, with no retry
    and no quarantine manifest (tensors on the meta device take the
    wrapper's kernel route, whose library load fails here)."""
    from goleft_tpu_torch.device import KernelFault
    from goleft_tpu_torch.ops import pairhmm_kernel as pk

    calls = []

    def no_nvcc():
        calls.append(1)
        raise KernelFault("pairhmm kernel: nvcc not found (set CUDA_HOME)")

    monkeypatch.setattr(pk, "load_library", no_nvcc)
    monkeypatch.setattr(tph, "resolve_device",
                        lambda d=None: torch.device("meta"))
    reg = get_registry()
    before = reg.counter("resilience.retries_total").value
    qpath = tmp_path / "q.json"
    with pytest.raises(KernelFault, match="nvcc not found"):
        tcmd.run_pairhmm(docs["small"], out=io.StringIO(),
                         quarantine_out=str(qpath))
    assert calls == [1]
    assert reg.counter("resilience.retries_total").value == before
    assert not qpath.exists()


def test_one_failed_bucket_quarantines_like_the_reference(docs, tmp_path):
    """The second bucket fails permanently in both: the same windows are
    quarantined, the tables and manifests are identical."""
    spec = "pairhmm:after=2:permanent"
    out = {}
    for name, mod, fl in (("want", jcmd, jfaults), ("got", tcmd, tfaults)):
        q = str(tmp_path / f"{name}.json")
        fl.install(spec)
        try:
            buf = io.StringIO()
            kw = {"device": "cpu"} if mod is tcmd else {}
            rc = mod.run_pairhmm(docs["mixed"], out=buf, quarantine_out=q,
                                 **kw)
        finally:
            fl.install(None)
        out[name] = (rc, buf.getvalue(), open(q).read())
    assert out["got"] == out["want"]
    rc, table, manifest = out["got"]
    assert rc == 3 and 0 < len(json.loads(manifest)["quarantined"]) < 30
    assert 1 < len(table.splitlines()) < 31


def test_fault_spec_grammar():
    with pytest.raises(ValueError, match="needs one of"):
        tfaults.parse_faults("pairhmm:transient")
    with pytest.raises(ValueError, match="unknown part"):
        tfaults.parse_faults("pairhmm:after=1:kaboom")
    with pytest.raises(ValueError, match="exclusive"):
        tfaults.parse_faults("pairhmm:after=1:every=2")
    c, = tfaults.parse_faults("pairhmm:every=3:times=2:permanent")
    assert (c.every, c.times, c.kind) == (3, 2, "permanent")
    assert [c.should_fire(i) for i in (1, 3, 6)] == [False, True, True]


def test_main_flags_and_out_match_reference(docs, tmp_path, monkeypatch):
    """The port's argparse front end takes the reference's flags and
    writes the same --out and --quarantine-out files (run on the CPU by
    pointing the default device there)."""
    from goleft_tpu_torch import device as tdev

    monkeypatch.setattr(tph, "resolve_device",
                        lambda d=None: tdev.resolve_device("cpu"))
    args = ["--candidates", docs["cand"], "--gap-open", "40",
            "--gap-ext", "9", "--f64"]
    want, got = str(tmp_path / "want.tsv"), str(tmp_path / "got.tsv")
    assert jcmd.main(args + ["--out", want, docs["mixed"]]) == 0
    assert tcmd.main(args + ["--out", got, docs["mixed"]]) == 0
    assert open(got).read() == open(want).read()


def test_cli_bad_input_and_missing_card_exit_1(docs, tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.delenv("GOLEFT_TPU_DEBUG", raising=False)
    assert cli.main(["pairhmm", str(tmp_path / "nope.json")]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "cannot read windows file" in err[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    report = tmp_path / "rep.json"
    assert cli.main(["pairhmm", "--metrics-out", str(report),
                     docs["small"]]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    rep = load_manifest(str(report))
    assert rep["kernel_launches"]["pairhmm"] == 0
    assert rep["command"] == "pairhmm" and rep["exit_code"] == 1
    assert rep["backend"]["platform"] == "cpu"
    assert rep["spans"]["run.pairhmm"]["calls"] == 1


def test_chip_smoke_windows_document(tmp_path):
    """chip_smoke.py's fabricated windows (4 haplotypes, 150 bp reads,
    phred+33 quals) load in both packages and score to the same table;
    its genotype oracle agrees with the reference's genotype fold."""
    import chip_smoke

    doc = chip_smoke.fabricate_windows(np.random.default_rng(3), 3, 6)
    path = str(tmp_path / "w.json")
    with open(path, "w") as fh:
        json.dump(doc, fh)
    rc_want, want, rc_got, got = _run_both(path)
    assert rc_want == rc_got == 0 and got == want
    assert len(want.splitlines()) == 4
    assert all(len(w["haplotypes"]) == 4 for w in doc["windows"])
    ll = -np.random.default_rng(5).random((6, 4)) * 30
    g = jgt.genotype_likelihoods(ll)
    assert chip_smoke.oracle_genotype(ll) == (
        f"{g['best'][0]}/{g['best'][1]}", g["gq"], [int(x) for x in g["pl"]])
