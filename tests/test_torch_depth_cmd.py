"""The port's ``depth`` command (goleft_tpu_torch/commands/depth.py, on the
CPU) against the JAX package's: byte-identical BED files on the
fixtures of tests/test_depth_cmd.py, the ``-b``, ``-c``, ``-s`` and
``-Q`` flags, and the hand-derived goldens of tests/golden through the
port alone. Also the vectorised BAM + BAI writer that chip_smoke.py uses
for its large fixture, held against ``build_bai`` and ``BamReader``.
"""

import os

import numpy as np
import pytest

from goleft_tpu.commands.depth import run_depth as jax_run_depth
from goleft_tpu.io.bai import build_bai as jax_build_bai
from goleft_tpu.io.fai import write_fai as jax_write_fai
from goleft_tpu_torch.commands.depth import run_depth
from helpers import random_reads, write_bam_and_bai, write_fasta

REF_LEN = 61_234  # awkward length: partial tail windows
REF2_LEN = 8_000
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """tests/test_depth_cmd.py's make_bam: two contigs, reads with random
    MAPQ and DUP / SECONDARY flags."""
    tmp = tmp_path_factory.mktemp("torch_depth")
    rng = np.random.default_rng(0)
    reads = []
    for tid, rl in ((0, REF_LEN), (1, REF2_LEN)):
        rr = random_reads(rng, 800 if tid == 0 else 80, tid, rl)
        reads += [(t, p, c, int(rng.integers(0, 61)),
                   int(rng.choice([0, 0x400, 0x100], p=[0.8, 0.1, 0.1])))
                  for (t, p, c, _, _) in rr]
    bam = str(tmp / "t.bam")
    write_bam_and_bai(bam, reads, ref_names=("chr1", "chr2"),
                      ref_lens=(REF_LEN, REF2_LEN))
    fa = write_fasta(str(tmp / "ref.fa"), {
        "chr1": ("ACGT" * (REF_LEN // 4 + 1))[:REF_LEN],
        "chr2": ("AC" * (REF2_LEN // 2))[:REF2_LEN]})
    jax_write_fai(fa)
    return tmp, bam, fa


def _same_beds(a, b):
    for x, y in zip(a, b):
        with open(x) as fx, open(y) as fy:
            got, want = fy.read(), fx.read()
        assert got == want, os.path.basename(y)
        assert want


@pytest.mark.parametrize("window", [13, 55, 100, 250, 2001, 10**9])
def test_window_sweep_matches_jax(fixture, window):
    tmp, bam, fa = fixture
    for mm in (0, 7):
        _same_beds(
            jax_run_depth(bam, str(tmp / f"j{window}_{mm}"), reference=fa,
                          window=window, max_mean_depth=mm),
            run_depth(bam, str(tmp / f"t{window}_{mm}"), reference=fa,
                      window=window, max_mean_depth=mm, device="cpu"))


@pytest.mark.parametrize("flags", [
    dict(bed="chr1\t130\t1020\nchr1\t5000\t6000\nchr2\t0\t500\n"),
    dict(chrom="chr2", window=100),
    dict(stats=True, window=1000),
    dict(mapq=20, window=100, min_cov=2),
    dict(processes=1, window=500),
], ids=["bed", "chrom", "stats", "mapq", "one_thread"])
def test_flags_match_jax(fixture, flags):
    tmp, bam, fa = fixture
    kw = dict(flags)
    name = "_".join(sorted(kw))
    if "bed" in kw:
        path = str(tmp / "regions.bed")
        with open(path, "w") as fh:
            fh.write(kw["bed"])
        kw["bed"] = path
    else:
        kw["reference"] = fa
    _same_beds(jax_run_depth(bam, str(tmp / f"jf_{name}"), **kw),
               run_depth(bam, str(tmp / f"tf_{name}"), device="cpu", **kw))


def _golden_fixture(tmp_path):
    """The read list of tests/golden/README.md, written with the port's
    own BamWriter, build_bai and write_fai."""
    from goleft_tpu_torch.io.bai import build_bai, write_bai
    from goleft_tpu_torch.io.bam import BamWriter, parse_cigar
    from goleft_tpu_torch.io.fai import write_fai

    reads = [
        ("r0", 0, "100M", 60, 0), ("r1", 50, "100M", 60, 0),
        ("r2", 50, "100M", 0, 0), ("r3", 120, "30M10D30M", 60, 0),
        ("r4", 200, "20M60N20M", 60, 0), ("r5", 300, "10S50M", 60, 0),
        ("r6", 400, "50M", 60, 0x400), ("r7", 400, "50M", 60, 0x100),
        ("r8", 450, "50M", 60, 0x3), ("r9", 470, "50M", 60, 0x3),
    ]
    reads += [(f"p{i:04d}", 600, "10M", 60, 0) for i in range(2510)]
    reads += [("r10", 800, "40M5I40M", 60, 0), ("r11", 900, "30M20S", 60, 0),
              ("r12", 1000, "50M", 60, 0x200), ("r13", 1100, "50M", 60, 0x4)]
    fa = str(tmp_path / "r.fa")
    with open(fa, "w") as fh:
        fh.write(">chr1\n" + "".join("A" * 60 + "\n" for _ in range(33))
                 + "A" * 20 + "\n")
    write_fai(fa)
    bam = str(tmp_path / "g.bam")
    hdr = "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:2000\n"
    with open(bam, "wb") as fh:
        with BamWriter(fh, hdr, ["chr1"], [2000]) as w:
            for name, pos, cig, mq, fl in reads:
                w.write_record(0, pos, parse_cigar(cig), mapq=mq, flag=fl,
                               name=name)
    write_bai(build_bai(bam), bam + ".bai")
    return fa, bam


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as fh:
        return fh.read()


def test_hand_derived_golden_through_port_alone(tmp_path):
    fa, bam = _golden_fixture(tmp_path)
    dp, cp = run_depth(bam, str(tmp_path / "out"), reference=fa,
                       window=100, min_cov=4, mapq=1, device="cpu")
    assert open(dp).read() == _golden("depth_w100.depth.bed")
    assert open(cp).read() == _golden("depth_w100.callable.bed")


def test_excessive_coverage_golden_through_port_alone(tmp_path):
    """maxmeandepth 100 → cap 2600: the 2510-read pile is uncapped,
    classifies EXCESSIVE and its window mean becomes 251."""
    fa, bam = _golden_fixture(tmp_path)
    dp, cp = run_depth(bam, str(tmp_path / "out"), reference=fa,
                       window=100, min_cov=4, mapq=1, max_mean_depth=100,
                       device="cpu")
    got = open(dp).read().splitlines()
    want = _golden("depth_w100.depth.bed").splitlines()
    assert got[6] == "chr1\t600\t700\t251"
    assert got[:6] == want[:6] and got[7:] == want[7:]
    calls = open(cp).read().splitlines()
    assert "chr1\t600\t610\tEXCESSIVE_COVERAGE" in calls
    want_c = _golden("depth_w100.callable.bed").splitlines()
    assert [x for x in calls if "600\t610" not in x] == \
        [x for x in want_c if "600\t610" not in x]


@pytest.mark.parametrize("method", ["gzip", "rans-nx16"])
def test_cram_twin_of_the_golden_matches_jax(tmp_path, method):
    """tests/test_golden_depth.py's CRAM twin of the golden read list:
    the port's depth on it equals goleft_tpu depth's, and the golden."""
    from goleft_tpu.io import cram as jcram
    from goleft_tpu_torch.io.bam import BamReader

    fa, bam = _golden_fixture(tmp_path)
    reads = [(r.name, r.pos, r.cigar, r.mapq, r.flag)
             for r in BamReader.from_file(bam)]
    p = str(tmp_path / "g.cram")
    kw = dict(block_method=jcram.M_RANSNX16, minor=1, rans_order=1) \
        if method == "rans-nx16" else {}
    with open(p, "wb") as fh:
        with jcram.CramWriter(fh, "@HD\tVN:1.6\tSO:coordinate\n", ["chr1"],
                              [2000], records_per_container=800, **kw) as w:
            for name, pos, cig, mq, fl in reads:
                w.write_record(0, pos, cig, mapq=mq, flag=fl, name=name)
        w.write_crai(p + ".crai")
    want = jax_run_depth(p, str(tmp_path / "j"), reference=fa, window=100,
                         min_cov=4, mapq=1)
    got = run_depth(p, str(tmp_path / "t"), reference=fa, window=100,
                    min_cov=4, mapq=1, device="cpu")
    _same_beds(want, got)
    assert open(got[0]).read() == _golden("depth_w100.depth.bed")
    assert open(got[1]).read() == _golden("depth_w100.callable.bed")


@pytest.mark.parametrize("level", [0, 1])
def test_bulk_writer_matches_build_bai_and_reader(tmp_path, level):
    from goleft_tpu_torch.io.bai import build_bai
    from goleft_tpu_torch.io.bam import BamReader, parse_cigar
    from tools.bulk_bam import write_bam_bulk

    rng = np.random.default_rng(1)
    n = 6000
    pos = np.sort(rng.integers(0, 300_000, n))
    cigars = ["150M", "70M10D80M", "60M300N90M", "20S130M", "75M5I70M",
              "16384M"]
    ci = rng.choice(len(cigars), n, p=[.5, .1, .1, .1, .19, .01])
    mapq = np.where(rng.random(n) < .05, 0, 60)
    flag = rng.choice([0, 0x400, 0x100, 0x4], n, p=[.85, .05, .05, .05])
    bam = str(tmp_path / "b.bam")
    idx = write_bam_bulk(bam, "chr1", 400_000, pos, ci, cigars, mapq, flag,
                         level=level)
    for ref in (build_bai(bam).refs[0], jax_build_bai(bam).refs[0]):
        got = idx.refs[0]
        np.testing.assert_array_equal(got.intervals, ref.intervals)
        assert got.bins == ref.bins
        assert (got.mapped, got.unmapped) == (ref.mapped, ref.unmapped)
    recs = list(BamReader.from_file(bam))
    assert [r.pos for r in recs] == pos.tolist()
    assert [r.cigar for r in recs] == [parse_cigar(cigars[c]) for c in ci]
    assert [r.flag for r in recs] == flag.tolist()
    assert [r.mapq for r in recs] == mapq.tolist()
