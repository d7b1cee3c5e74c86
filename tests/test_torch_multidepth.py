"""``multidepth`` of the port (goleft_tpu_torch/commands/multidepth.py,
``run_multidepth(device="cpu")``) against the JAX package's, byte for
byte: tests/test_cnv_clis.py::test_multidepth's fixture, and fixtures
that cross 10,000-base chunk boundaries (``CHUNK`` monkeypatched in both
packages), with runs, gaps and windows that end on both sides of them.

The depth stage is the depth kernel's dense output (window 1, the cap,
the chunk as the region), whose plain version runs on the CPU; it is held
here to the reference's ``depth_from_segments`` per base, exactly.
"""

import io

import numpy as np
import pytest
import torch

from goleft_tpu.commands import multidepth as jmd
from goleft_tpu.ops.coverage import depth_from_segments
from goleft_tpu_torch.commands import multidepth as tmd
from goleft_tpu_torch.ops import depth_kernel
from goleft_tpu_torch.ops.coverage import pack_segments_u16
from helpers import random_reads, write_bam_and_bai


def _both(paths, chrom="chr1", **kw):
    a, b = io.StringIO(), io.StringIO()
    jmd.run_multidepth(paths, chrom, out=a, **kw)
    tmd.run_multidepth(paths, chrom, out=b, device="cpu", **kw)
    return a.getvalue(), b.getvalue()


@pytest.fixture(scope="module")
def dense_cohort(tmp_path_factory):
    """test_cnv_clis.py::test_multidepth's four BAMs: sparse reads over
    [0, 10k), 2,000 100 bp reads in [10k, 20k), a 50 kb contig."""
    tmp = tmp_path_factory.mktemp("md")
    rng = np.random.default_rng(3)
    paths = []
    for s in range(4):
        reads = sorted(
            random_reads(rng, 100, 0, 10_000)
            + [(0, int(p), "100M", 60, 0)
               for p in rng.integers(10_000, 19_900, size=2000)])
        reads = sorted(reads, key=lambda r: r[1])
        p = str(tmp / f"md{s}.bam")
        write_bam_and_bai(p, reads, ref_names=("chr1",),
                          ref_lens=(50_000,))
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def boundary_cohort(tmp_path_factory):
    """Five BAMs on a 60 kb contig (and a second contig): a dense stretch
    over the 10k, 20k and 30k boundaries, a patchy stretch of short runs
    and gaps of 5-30 bases around 40k, one sample covered only past 45k,
    a read past the cap's pileup at 25k, MAPQ 0 reads and D/N/S/I
    CIGARs."""
    tmp = tmp_path_factory.mktemp("mdb")
    rng = np.random.default_rng(17)
    lens = (60_000, 20_000)
    paths = []
    for s in range(5):
        reads = []
        if s != 4:
            for p in rng.integers(8_000, 33_000, size=2500):
                reads.append((0, int(p), "100M", 60, 0))
            for p in range(36_000, 44_000, 180):
                ln = int(rng.integers(30, 160))
                reads += [(0, p + int(rng.integers(0, 20)), f"{ln}M", 60, 0)
                          for _ in range(10)]
        for p in rng.integers(45_000, 59_000, size=900):
            reads.append((0, int(p), "50M2D30M5S", 60, 0))
        reads += [(0, 25_000, "60M", 60, 0)] * 40
        reads += [(0, int(p), "30M200N40M", 0, 0)
                  for p in rng.integers(20_000, 30_000, size=200)]
        reads += [(0, int(p), "20M3I60M", 30, 0)
                  for p in rng.integers(0, 60_000, size=300)]
        reads += random_reads(rng, 200, 1, lens[1])
        reads = sorted(reads, key=lambda r: (r[0], r[1]))
        p = str(tmp / f"b{s}.bam")
        hdr = ("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:60000\n"
               f"@SQ\tSN:chr2\tLN:20000\n@RG\tID:rg\tSM:b{s}\n")
        write_bam_and_bai(p, reads, ref_names=("chr1", "chr2"),
                          ref_lens=lens, header_text=hdr)
        paths.append(p)
    return paths


def test_multidepth_matches_jax(dense_cohort):
    want, got = _both(dense_cohort, mapq=1, min_cov=7, min_samples=0.5)
    assert got == want
    lines = got.splitlines()
    assert lines[0] == "#chrom\tstart\tend" + "\tsampleA" * 4
    assert len(lines) > 1


BOUNDARY_CASES = {
    "defaults": {},
    "window_3000": {"window": 3000},
    "window_37_minsize_40": {"window": 37, "min_size": 40},
    "maxskip_0_minsize_2": {"min_cov": 1, "max_skip": 0, "min_size": 2},
    "maxskip_25_cap_20": {"max_skip": 25, "max_cov": 20, "mapq": 0},
    "minsamples_0": {"min_samples": 0.0, "min_cov": 3},
    "minsamples_0.6": {"min_samples": 0.6, "window": 10_000},
}


@pytest.mark.parametrize("case", sorted(BOUNDARY_CASES))
def test_chunk_boundaries_match_jax(boundary_cohort, monkeypatch, case):
    """Chunks of 10,000 bases in both packages: runs and blocks that
    cross chunk boundaries, byte for byte."""
    monkeypatch.setattr(jmd, "CHUNK", 10_000)
    monkeypatch.setattr(tmd, "CHUNK", 10_000)
    want, got = _both(boundary_cohort, **BOUNDARY_CASES[case])
    assert got == want
    assert len(got.splitlines()) > 1
    # runs cross the chunk edges
    blocks = [tuple(map(int, ln.split("\t")[1:3]))
              for ln in got.splitlines()[1:]]
    if case == "defaults":
        assert any(s < 10_000 < e for s, e in blocks)


def test_second_contig_and_unknown_contig(boundary_cohort, monkeypatch):
    monkeypatch.setattr(jmd, "CHUNK", 7_000)
    monkeypatch.setattr(tmd, "CHUNK", 7_000)
    want, got = _both(boundary_cohort, chrom="chr2", min_cov=1)
    assert got == want
    with pytest.raises(SystemExit, match="chr9 not found"):
        tmd.run_multidepth(boundary_cohort, "chr9", out=io.StringIO(),
                           device="cpu")


# ---- the depth stage: the kernel's dense output is depth_from_segments

def _segments(rng, n, lo, hi, max_len):
    s = np.sort(rng.integers(lo, hi, n)).astype(np.int32)
    e = (s + rng.integers(1, max_len, n)).astype(np.int32)
    return s, e


@pytest.mark.parametrize("wire", ["int32", "u16"])
@pytest.mark.parametrize("case", ["inside", "crossing", "outside", "cap",
                                  "empty", "long"])
def test_dense_depth_is_depth_from_segments(wire, case):
    """``fused_depth(dense=True, window=1)`` (and ``fused_depth_wire``)
    with w0 = rs = start, re = end, length = end - start and cap =
    max_cov, as multidepth calls it: per base, exactly the reference's
    ``depth_from_segments(..., region_start=start, depth_cap=max_cov)``
    (clip to the region, cap)."""
    rng = np.random.default_rng(["inside", "crossing", "outside", "cap",
                                 "empty", "long"].index(case))
    start, end, cap = 10_000, 14_097, 1000
    if case == "inside":
        s, e = _segments(rng, 3000, start, end - 200, 200)
    elif case == "crossing":
        s, e = _segments(rng, 3000, start - 500, end + 300, 700)
    elif case == "outside":
        s, e = _segments(rng, 500, 0, start - 800, 300)
        s2, e2 = _segments(rng, 500, end, end + 5000, 300)
        s, e = np.concatenate([s, s2]), np.concatenate([e, e2])
    elif case == "cap":
        s, e = _segments(rng, 4000, start + 100, start + 140, 60)
        cap = 37
    elif case == "empty":
        s, e = np.zeros(0, np.int32), np.zeros(0, np.int32)
    else:
        s, e = _segments(rng, 50, start - 70_000, end, 90_000)
    if wire == "u16" and case == "long":
        assert pack_segments_u16(s, e, slice(None)) is None
        return
    length = end - start
    keep = np.ones(len(s), bool)
    want = np.asarray(depth_from_segments(
        s, e, keep, length, region_start=start, depth_cap=cap))
    scalars = (start, start, end, cap, 0, 0)
    if wire == "int32":
        out = depth_kernel.fused_depth(
            torch.from_numpy(s), torch.from_numpy(e), torch.from_numpy(keep),
            *scalars, length=length, window=1, dense=True)
    else:
        d, ln, base, _ = pack_segments_u16(s, e, slice(None))
        out = depth_kernel.fused_depth_wire(
            torch.from_numpy(d), torch.from_numpy(ln), int(base), *scalars,
            length=length, window=1, dense=True)
    got = out[3].numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    # the window-1 sums are the same depth, as float32
    assert np.array_equal(out[0].numpy(), want.astype(np.float32))
    # and multidepth's own entry, with its padding
    got = tmd._sample_depth(s, e, start, end, cap, torch.device("cpu"))
    assert np.array_equal(got.numpy(), want)


def test_cli_runs_multidepth(dense_cohort, monkeypatch, capsys):
    """``python -m goleft_tpu_torch multidepth`` (the default device
    pointed at the CPU) prints the reference CLI's bytes, and its usage
    line (every flag, its metavar, the positionals) is the reference's;
    the help texts differ only where the port's ``--no-crc`` help drops
    the reference's throughput figure."""
    from goleft_tpu_torch import cli, device as tdev

    monkeypatch.setattr(tmd, "resolve_device",
                        lambda d=None: tdev.resolve_device("cpu"))
    # the card's subprocess probe is skipped: the commands run on the
    # CPU here (utils/device_guard.py)
    monkeypatch.setenv("GOLEFT_TPU_PROBE", "0")
    args = ["-c", "chr1", "-Q", "1", "--mincov", "5", *dense_cohort]
    jmd.main(args)
    want = capsys.readouterr().out
    assert cli.main(["multidepth", *args]) == 0
    assert capsys.readouterr().out == want
    usages = []
    for main in (jmd.main, tmd.main):
        with pytest.raises(SystemExit):
            main(["--help"])
        text = capsys.readouterr().out.replace("goleft-tpu-torch",
                                               "goleft-tpu")
        usages.append(" ".join(text.split("\n\n")[0].split()))
    assert usages[0] == usages[1]
    assert "--no-crc" in usages[1] and "--minsamples" in usages[1]
