"""goleft's own host tools in the port (depthwed, covstats, indexsplit,
samplename, cnveval, anonymize) against the JAX package's, byte for
byte, on the fixtures and cases of tests/test_matrix_tools.py,
test_covstats_oracle.py, test_golden_covstats.py,
test_covstats_stream.py, test_cnv_clis.py::test_cnveval_cmd and the
covstats / indexsplit cases of test_reference_conformance.py. None of
them has a device stage: they run with no card."""

import gzip
import io
import os

import numpy as np
import pytest

from goleft_tpu.commands import anonymize as ref_anon
from goleft_tpu.commands import cnveval_cmd as ref_cnveval
from goleft_tpu.commands import covstats as ref_cov
from goleft_tpu.commands import depthwed as ref_dw
from goleft_tpu.commands import indexsplit as ref_split
from goleft_tpu.commands import samplename as ref_sn
from goleft_tpu.utils import regions as ref_regions
from goleft_tpu_torch.commands import anonymize, cnveval_cmd, covstats
from goleft_tpu_torch.commands import depthwed, indexsplit, samplename
from goleft_tpu_torch.io.bam import BamFile, BamWriter, ReadColumns
from goleft_tpu_torch.io.bam import parse_cigar
from goleft_tpu_torch.utils import regions

from helpers import random_reads, write_bam, write_bam_and_bai
from test_covstats_oracle import make_cols, oracle_bam_stats
from test_golden_covstats import _build_bai_with_stats
from test_covstats_stream import _slice_cols

REF = "/root/reference"


def _same_stats(got: dict, want: dict):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert np.array_equal(g, w), key
        else:
            assert g == w and type(g) is type(w), key


# ---------- depthwed ----------

_ROWS_A = [("chr1", 0, 250, "1.5"), ("chr1", 250, 500, "2.4"),
           ("chr1", 500, 750, "3.0"), ("chr1", 750, 1000, "0"),
           ("chr2", 0, 250, "5.0"), ("chr2", 250, 500, "1.0")]
_ROWS_B = [("chr1", 0, 250, "2.5"), ("chr1", 250, 500, "0.4"),
           ("chr1", 500, 750, "1.0"), ("chr1", 750, 1000, "1.0"),
           ("chr2", 0, 250, "0.2"), ("chr2", 250, 500, "2.6")]
_ROWS_C = [("chr1", 0, 100, "1"), ("chr1", 100, 200, "1"),
           ("chr1", 200, 300, "1"),
           ("chr2", 0, 100, "2"), ("chr2", 100, 200, "2"),
           ("chr2", 200, 300, "2"), ("chr2", 300, 400, "2")]


def _write_bed(path, rows, gz=False):
    text = "".join("\t".join(str(x) for x in r) + "\n" for r in rows)
    if gz:
        with gzip.open(path, "wt") as fh:
            fh.write(text)
    else:
        path.write_text(text)
    return str(path)


@pytest.mark.parametrize("case", ["aggregates", "chrom_boundary",
                                  "gzipped", "one_window"])
def test_depthwed_equals_reference(tmp_path, case):
    if case == "chrom_boundary":
        beds, size = [_write_bed(tmp_path / "s.depth.bed", _ROWS_C)], 200
    elif case == "one_window":
        beds, size = [_write_bed(tmp_path / "s.depth.bed", _ROWS_C)], 1
    else:
        gz = case == "gzipped"
        sfx = ".depth.bed.gz" if gz else ".depth.bed"
        beds = [_write_bed(tmp_path / f"sampleA{sfx}", _ROWS_A, gz),
                _write_bed(tmp_path / f"sampleB{sfx}", _ROWS_B, gz)]
        size = 500
    got, want = io.StringIO(), io.StringIO()
    depthwed.run_depthwed(beds, size=size, out=got)
    ref_dw.run_depthwed(beds, size=size, out=want)
    assert got.getvalue() == want.getvalue()
    lines = got.getvalue().splitlines()
    if case == "aggregates":
        assert lines == ["#chrom\tstart\tend\tsampleA\tsampleB",
                         "chr1\t0\t500\t4\t3", "chr1\t500\t1000\t3\t2",
                         "chr2\t0\t500\t6\t3"]
    if case == "chrom_boundary":
        assert lines[1:] == ["chr1\t0\t200\t2", "chr1\t200\t300\t1",
                             "chr2\t0\t200\t4", "chr2\t200\t400\t4"]


def test_depthwed_lockstep_error_and_names(tmp_path):
    a = _write_bed(tmp_path / "a.bed", _ROWS_A)
    b = _write_bed(tmp_path / "b.bed", _ROWS_B[:3])
    for run in (depthwed.run_depthwed, ref_dw.run_depthwed):
        with pytest.raises(SystemExit, match="same number"):
            run([a, b], size=500, out=io.StringIO())
    for p in ("/x/y/NA12878.depth.bed.gz", "s1.bed", "x.depth"):
        assert depthwed.name_from_file(p) == ref_dw.name_from_file(p)


# ---------- samplename and regions ----------

@pytest.mark.parametrize("header", [
    "@HD\tVN:1.6\n@RG\tID:a\tSM:sampleA\n",
    "@HD\tVN:1.6\n@RG\tID:a\tSM:s1\n@RG\tID:b\tSM:s2\n@RG\tID:c\tSM:s1\n",
    "@HD\tVN:1.6\n",
])
@pytest.mark.native_io
def test_samplename_equals_reference(tmp_path, capsys, header):
    p = str(tmp_path / "t.bam")
    write_bam(p, [(0, 10, "50M", 60, 0)], header_text=header)
    rc = samplename.main([p])
    got = capsys.readouterr().out
    assert (rc, got) == (ref_sn.main([p]), capsys.readouterr().out)
    assert rc == (0 if "SM:" in header else 1)


def test_interval_sets_equal_reference(tmp_path):
    bed = tmp_path / "p.bed"
    bed.write_text("#c\ntrack x\nchr1\t10\t20\nchr2\t0\t5\n"
                   "chr1\t50\t300\nchr1\t100\t200\n")
    got, want = regions.read_tree(str(bed)), ref_regions.read_tree(str(bed))
    rng = np.random.default_rng(4)
    for _ in range(300):
        c = ["chr1", "chr2", "chr3"][int(rng.integers(3))]
        s = int(rng.integers(0, 320))
        e = s + int(rng.integers(1, 40))
        assert regions.overlaps(got, c, s, e) == \
            ref_regions.overlaps(want, c, s, e)
    assert not regions.overlaps(None, "chr1", 0, 100)


# ---------- indexsplit ----------

@pytest.fixture(scope="module")
def split_bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("split")
    rng = np.random.default_rng(11)
    paths = []
    for s in range(3):
        reads = random_reads(rng, 3000, 0, 1_000_000) + random_reads(
            rng, 600, 1, 200_000)
        p = str(d / f"s{s}.bam")
        write_bam_and_bai(p, reads, ref_names=("chr1", "chr2"),
                          ref_lens=(1_000_000, 200_000))
        paths.append(p)
    bed = d / "probs.bed"
    bed.write_text("chr1\t100000\t120000\n")
    return paths, str(bed)


@pytest.mark.parametrize("n,probs", [(20, False), (5, True), (1, False),
                                     (200, True)])
def test_indexsplit_equals_reference(split_bams, n, probs):
    paths, bed = split_bams
    refs = [(0, "chr1", 1_000_000), (1, "chr2", 200_000)]
    got = [str(c) for c in indexsplit.split(
        paths, refs, n, regions.read_tree(bed) if probs else None)]
    want = [str(c) for c in ref_split.split(
        paths, refs, n, ref_regions.read_tree(bed) if probs else None)]
    assert got == want
    assert got[0].startswith("chr1\t0\t")


def test_indexsplit_cli_equals_reference(split_bams, capsys):
    paths, bed = split_bams
    indexsplit.main(["-n", "12", "-p", bed, *paths])
    got = capsys.readouterr().out
    ref_split.main(["-n", "12", "-p", bed, *paths])
    assert got == capsys.readouterr().out and got.count("\n") >= 10
    assert [str(c) for c in indexsplit.split(
        [], [(0, "chrEmpty", 5000)], 4)] == ["chrEmpty\t0\t5000\t0.00\t0"]


# ---------- covstats ----------

def test_mad_filter_and_mean_std_equal_reference():
    rng = np.random.default_rng(1)
    for arr in (np.arange(100), np.concatenate([np.arange(100), [10_000]]),
                rng.integers(0, 500, 777), np.array([5])):
        assert np.array_equal(covstats.mad_filter(arr, 10),
                              ref_cov.mad_filter(arr, 10))
        assert covstats.mean_std(arr) == ref_cov.mean_std(arr)


@pytest.mark.parametrize("n,skip,chunk", [(300, 100, 10_000), (300, 100, 7),
                                          (50, 0, 501), (10_000, 4990, 64)])
def test_bam_stats_equal_reference_and_oracle(n, skip, chunk):
    cols = make_cols(np.random.default_rng(n + skip), 5000)
    want = ref_cov.bam_stats(cols, n=n, skip=skip)
    acc = covstats.BamStatsAccumulator(n, skip)
    for lo in range(0, cols.n_reads, chunk):
        acc.update(_slice_cols(cols, lo, min(lo + chunk, cols.n_reads)))
        if acc.done:
            break
    _same_stats(acc.finalize(), want)
    oracle = oracle_bam_stats(cols, n, skip)
    for key, w in oracle.items():
        assert np.isclose(want[key], w, rtol=1e-12), key


def _paired_bam(tmp_path, n_pairs=300, insert=150, read_len=100, seed=13):
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n_pairs):
        s = int(rng.integers(0, 500_000))
        isz = insert + int(rng.integers(-20, 21))
        mate_start = s + read_len + isz
        recs.append((s, mate_start, mate_start + read_len - s))
    recs.sort()
    p = str(tmp_path / "pairs.bam")
    with open(p, "wb") as fh:
        with BamWriter(fh, "@HD\tVN:1.6\n@RG\tID:x\tSM:pp\n", ["chr1"],
                       [1_000_000], level=0, block_size=4096) as w:
            rows = []
            for i, (s, ms, tl) in enumerate(recs):
                rows.append((s, ms, tl, 0x2 | 0x1 | 0x20, f"p{i}"))
                rows.append((ms, s, -tl, 0x2 | 0x1 | 0x10, f"p{i}"))
            rows.sort()
            for s, ms, tl, flag, nm in rows:
                w.write_record(0, s, parse_cigar(f"{read_len}M"),
                               mapq=60, flag=flag, name=nm,
                               mate_tid=0, mate_pos=ms, tlen=tl)
    return p


@pytest.mark.parametrize("n,skip,regions_bed", [(100, 0, False),
                                                (200, 37, True),
                                                (1_000_000, 100_000, False)])
@pytest.mark.native_io
def test_run_covstats_equals_reference(tmp_path, capsys, n, skip,
                                       regions_bed):
    from goleft_tpu_torch.io.bai import build_bai, write_bai

    p = _paired_bam(tmp_path, n_pairs=200)
    write_bai(build_bai(p), p + ".bai")
    bed = None
    if regions_bed:
        bed = str(tmp_path / "t.bed")
        open(bed, "w").write("chr1\t0\t1000\nchr1\t5000\t250000\n")
    got, want = io.StringIO(), io.StringIO()
    res = covstats.run_covstats([p, p], n=n, skip=skip, regions=bed,
                                out=got)
    err = capsys.readouterr().err
    wres = ref_cov.run_covstats([p, p], n=n, skip=skip, regions=bed,
                                out=want)
    assert got.getvalue() == want.getvalue()
    assert err == capsys.readouterr().err
    for a, b in zip(res, wres):
        _same_stats(a, b)
    assert got.getvalue().splitlines()[1].split("\t")[-1] == "pp"


@pytest.mark.native_io
def test_covstats_golden_line(tmp_path):
    p = str(tmp_path / "g.bam")
    hdr = "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:100000\n" \
          "@RG\tID:r\tSM:gold\n"
    with open(p, "wb") as fh:
        with BamWriter(fh, hdr, ["chr1"], [100_000]) as w:
            for i, (pos, mp, tl) in enumerate([(0, 150, 250),
                                               (10, 210, 300),
                                               (20, 320, 400)]):
                w.write_record(0, pos, parse_cigar("100M"), mapq=60,
                               flag=0x1 | 0x2, name=f"g{i}",
                               mate_tid=0, mate_pos=mp, tlen=tl)
    _build_bai_with_stats(p + ".bai", mapped=300, unmapped=0)
    out = io.StringIO()
    res = covstats.run_covstats([p], n=3, skip=0, out=out)
    assert out.getvalue().splitlines()[1] == (
        "0.30\t75.00\t25.00\t50\t200\t275.00\t25.00\t0.00\t0.0\t0.0"
        f"\t100.0\t100\t{p}\tgold")
    h = res[0]["histogram"]
    assert len(h) == 276 and h[150] == 0.5 and h[200] == 0.5


@pytest.mark.native_io
@pytest.mark.parametrize("window", [1 << 12, 1 << 14, 1 << 24])
def test_stream_columns_equals_the_reference_decode(tmp_path, window):
    from goleft_tpu.io.bam import BamFile as RefBamFile

    rng = np.random.default_rng(5)
    p = str(tmp_path / "t.bam")
    write_bam(p, random_reads(rng, 3000, 0, 90_000)
              + random_reads(rng, 500, 1, 40_000))
    want = RefBamFile(open(p, "rb").read()).read_columns()
    parts = list(BamFile.from_file(p).stream_columns(window_bytes=window))
    if window == 1 << 12:
        assert len(parts) > 1
    for f in ReadColumns.__dataclass_fields__:
        got = np.concatenate([getattr(c, f) for c in parts]) \
            if f != "seg_read" else None
        if got is not None:
            assert np.array_equal(got, getattr(want, f)), f


@pytest.mark.native_io
def test_covstats_parallel_and_failure(tmp_path):
    rng = np.random.default_rng(9)
    bams = []
    for i in range(3):
        reads, pos = [], 0
        for j in range(400):
            pos += int(rng.integers(1, 50))
            reads.append((0, pos, "100M", 60, 0x63 if j % 2 == 0 else 0x93))
        p = str(tmp_path / f"v{i}.bam")
        write_bam_and_bai(p, reads, ref_names=("chr1",),
                          ref_lens=(100_000,))
        bams.append(p)
    a, b, w = io.StringIO(), io.StringIO(), io.StringIO()
    covstats.run_covstats(bams, n=200, skip=0, out=a, processes=1)
    covstats.run_covstats(bams, n=200, skip=0, out=b, processes=4)
    ref_cov.run_covstats(bams, n=200, skip=0, out=w, processes=1)
    assert a.getvalue() == b.getvalue() == w.getvalue()
    corrupt = str(tmp_path / "bad.bam")
    with open(corrupt, "wb") as fh:
        fh.write(b"\x1f\x8b\x08\x04BROKEN")
    with pytest.raises(BaseException) as ei:
        covstats.run_covstats([bams[0], corrupt], n=1_000_000, skip=0,
                              out=io.StringIO(), processes=2)
    assert not isinstance(ei.value, covstats._SamplingAborted)


# ---------- cnveval ----------

@pytest.mark.parametrize("min_overlap,limit", [(0.4, False), (0.9, True),
                                               (0.1, False)])
def test_cnveval_equals_reference(tmp_path, min_overlap, limit):
    truth = tmp_path / "truth.bed"
    truth.write_text("1\t1000\t15000\t1\ta,b\n1\t50000\t140000\t3\ta\n"
                     "2\t0\t300000\t1\tc\n1\t200000\t260000\t4\td\n")
    test = tmp_path / "test.bed"
    test.write_text("1\t1000\t15000\t1\ta\n1\t50000\t140000\t3\ta\n"
                    "1\t500000\t540000\t1\ta\n2\t600000\t620000\t1\tb\n"
                    "1\t210000\t250000\t5\td\n1\t2000\t9000\t1\tb\n")
    got, want = io.StringIO(), io.StringIO()
    tabs = cnveval_cmd.run_cnveval(str(truth), str(test), min_overlap,
                                   limit, out=got)
    wtabs = ref_cnveval.run_cnveval(str(truth), str(test), min_overlap,
                                    limit, out=want)
    assert got.getvalue() == want.getvalue()
    assert {k: str(v) for k, v in tabs.items()} == \
        {k: str(v) for k, v in wtabs.items()}
    if (min_overlap, limit) == (0.4, False):
        assert tabs["all"].tp >= 2 and "precision" in got.getvalue()


# ---------- anonymize ----------

def test_anonymize_writes_the_reference_files(tmp_path, capsys):
    rng = np.random.default_rng(3)
    bams = []
    for i in range(2):
        p = str(tmp_path / f"in{i}.bam")
        write_bam_and_bai(p, random_reads(rng, 500, 0, 90_000))
        bams.append(p)
    (tmp_path / "g").mkdir()
    (tmp_path / "w").mkdir()
    got = anonymize.anonymize("coh", bams, str(tmp_path / "g"))
    out = capsys.readouterr().out
    want = ref_anon.anonymize("coh", bams, str(tmp_path / "w"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == \
        ["sample_coh_0001.bam", "sample_coh_0002.bam"]
    assert out.replace("/g/", "/w/") == capsys.readouterr().out
    for g, w in zip(got, want):
        for sfx in ("", ".bai"):
            assert open(g + sfx, "rb").read() == open(w + sfx, "rb").read()
    with pytest.raises(SystemExit):
        anonymize.main([bams[0], bams[1]])


# ---------- the reference's foreign BAMs ----------

needs_ref = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF, "depth", "test")),
    reason="reference checkout not present")


@needs_ref
def test_covstats_on_foreign_bam(capsys):
    p = os.path.join(REF, "depth", "test", "t.bam")
    got, want = io.StringIO(), io.StringIO()
    covstats.run_covstats([p], out=got)
    ref_cov.run_covstats([p], out=want)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().splitlines()[1].split("\t")[-1] == "Test1"


@needs_ref
def test_indexsplit_on_foreign_bam(capsys):
    p = os.path.join(REF, "indexcov", "test-data",
                     "sample_issue_27_0001.bam")
    indexsplit.main(["-n", "20", p])
    got = capsys.readouterr().out
    ref_split.main(["-n", "20", p])
    assert got == capsys.readouterr().out
    assert got.splitlines()[0] == "KU215903\t0\t5462\t627.74\t3"
