"""The port's ``cohortdepth`` (goleft_tpu_torch/commands/cohortdepth.py, on
the CPU) against the JAX package's, and the CRAM reader it stands on.

- ``run_cohortdepth(device="cpu")``: matrices byte-identical to the JAX
  package's ``run_cohortdepth`` on ops/decode_smoke.py's CRAM cohort
  (ORDER0, ORDER1 and STRIPE rANS-Nx16 samples), with and without
  ``decode_device``, under ``prefetch_depth`` 0 and 2 and both engines;
  on the mixed BAM/CRAM cohort of tests/test_cohortdepth.py; with a
  ``-b`` bed; under a transient and a permanent ``decode`` fault.
- ``CramFile.read_columns`` equal to the JAX package's on the writer
  settings of tests/test_cram.py (gzip, rANS 4x8, rANS-Nx16, arith,
  fqzcomp, tok3, CORE-bit HUFFMAN, tags, CRAM 2.x).
- The fixture writer tools/bulk_cram.py equal to ``CramWriter`` and
  ``rans_nx16.encode``.
"""

import gzip
import io
import os

import numpy as np
import pytest
import torch

from goleft_tpu.commands.cohortdepth import run_cohortdepth as jax_run
from goleft_tpu.io import cram as jcram
from goleft_tpu.io.bam import parse_cigar
from goleft_tpu.ops.decode_smoke import make_cram_cohort
from goleft_tpu.resilience import faults as jfaults
from goleft_tpu_torch import cli
from goleft_tpu_torch.commands.cohortdepth import run_cohortdepth
from goleft_tpu_torch.io import cram as tcram
from goleft_tpu_torch.io import rans_nx16 as rx
from goleft_tpu_torch.obs import get_registry
from goleft_tpu_torch.ops import rans_device as rd
from goleft_tpu_torch.resilience import faults
from helpers import write_bam_and_bai, write_fasta
from tools import bulk_cram

CPU = "cpu"


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """make_cram_cohort's four CRAMs and the JAX package's matrix."""
    d = str(tmp_path_factory.mktemp("torch_cohort"))
    crams, fai = make_cram_cohort(d)
    want = io.StringIO()
    assert jax_run(crams, fai=fai, window=500, out=want) == 0
    return crams, fai, want.getvalue()


def _port(crams, fai, **kw):
    out = io.StringIO()
    rc = run_cohortdepth(crams, fai=fai, window=500, out=out, device=CPU,
                         **kw)
    return rc, out.getvalue()


@pytest.mark.parametrize("engine", ["auto", "device"])
@pytest.mark.parametrize("prefetch_depth", [0, 2])
@pytest.mark.parametrize("decode_device", [False, True])
def test_matrix_matches_jax(cohort, engine, prefetch_depth, decode_device):
    crams, fai, want = cohort
    reg = get_registry()
    before = reg.snapshot()["counters"]
    rc, got = _port(crams, fai, engine=engine, prefetch_depth=prefetch_depth,
                    decode_device=decode_device)
    assert rc == 0 and got == want
    after = reg.snapshot()["counters"]
    moved = after.get("decode.device_blocks_total", 0) \
        - before.get("decode.device_blocks_total", 0)
    assert (moved > 0) == decode_device
    assert after.get("decode.device_fallback_total", 0) \
        == before.get("decode.device_fallback_total", 0)


def test_transient_decode_fault_retried_to_the_same_bytes(cohort):
    crams, fai, want = cohort
    reg = get_registry()
    retries = reg.counter("resilience.retries_total").value
    try:
        faults.install("decode:after=1:transient")
        rc, got = _port(crams, fai, decode_device=True)
    finally:
        faults.install(None)
    assert rc == 0 and got == want
    assert reg.counter("resilience.retries_total").value == retries + 1


def test_permanent_decode_fault_degrades_as_jax_does(cohort, capsys):
    """A permanent fault at the first decode quarantines that sample and
    zero-fills it; exit 3 and the JAX package's matrix."""
    crams, fai, _ = cohort
    spec = "decode:after=1:permanent"
    try:
        jfaults.install(spec)
        want = io.StringIO()
        assert jax_run(crams, fai=fai, window=500, out=want, processes=1,
                       decode_device=True) == 3
    finally:
        jfaults.install(None)
    try:
        faults.install(spec)
        rc, got = _port(crams, fai, processes=1, decode_device=True)
    finally:
        faults.install(None)
    assert rc == 3 and got == want.getvalue()
    assert "1 sample(s) quarantined" in capsys.readouterr().err
    col = [int(r.split("\t")[3]) for r in got.splitlines()[1:]]
    assert not any(col), "the quarantined sample zero-fills"


@pytest.mark.parametrize("processes", [1, 4])
def test_kernel_fault_on_the_card_fails_the_run(cohort, monkeypatch,
                                                processes):
    """An error a kernel leaves on the card is raised by the wait on the
    calling thread's stream as KernelFault: the run fails with it,
    unretried and with nothing quarantined, instead of exiting 3 with
    zero-filled samples. The stream's synchronize is driven here against
    a stand-in that raises as a sticky CUDA error does."""
    from goleft_tpu_torch.device import KernelFault

    crams, fai, _ = cohort

    class StickyStream:
        def synchronize(self):
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

    real_sync = rd._sync
    monkeypatch.setattr(rd, "_sync",
                        lambda stream: real_sync(StickyStream()))
    reg = get_registry()
    retries = reg.counter("resilience.retries_total").value
    quarantined = reg.counter("resilience.quarantined_total").value
    with pytest.raises(KernelFault, match="illegal memory access"):
        _port(crams, fai, processes=processes, decode_device=True)
    assert reg.counter("resilience.retries_total").value == retries
    assert reg.counter("resilience.quarantined_total").value == quarantined


def test_bed_regions_match_jax(cohort, tmp_path):
    crams, fai, _ = cohort
    bed = tmp_path / "r.bed"
    bed.write_text("# regions\nchr1\t120\t7040\nchr1\t9999\t10001\n"
                   "chr2\t0\t500\nchr1\t30000\t49990\n")
    want = io.StringIO()
    assert jax_run(crams, fai=fai, window=500, out=want, bed=str(bed)) == 0
    for kw in ({}, dict(engine="device", decode_device=True)):
        rc, got = _port(crams, fai, bed=str(bed), **kw)
        assert rc == 0 and got == want.getvalue()
    want = io.StringIO()
    assert jax_run(crams, fai=fai, window=500, out=want, bed=str(bed),
                   chrom="chr1") == 0
    rc, got = _port(crams, fai, bed=str(bed), chrom="chr1")
    assert got == want.getvalue() and "chr2" not in got


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """tests/test_cohortdepth.py's mixed cohort: three BAMs and the CRAM
    twin of the second, in place of its BAM."""
    from goleft_tpu.io.fai import write_fai

    tmp = tmp_path_factory.mktemp("torch_mixed")
    rng = np.random.default_rng(21)
    ref_len = 25_000
    fa = write_fasta(str(tmp / "r.fa"), {"chr1": "A" * ref_len})
    write_fai(fa)
    paths, reads1 = [], None
    for i in range(3):
        starts = np.sort(rng.integers(0, ref_len - 100, size=700))
        reads = [(0, int(s), "100M", 60, 0) for s in starts]
        hdr = ("@HD\tVN:1.6\tSO:coordinate\n"
               f"@SQ\tSN:chr1\tLN:{ref_len}\n@RG\tID:r\tSM:mx{i}\n")
        p = str(tmp / f"mx{i}.bam")
        write_bam_and_bai(p, reads, ref_names=("chr1",),
                          ref_lens=(ref_len,), header_text=hdr)
        paths.append(p)
        if i == 1:
            reads1 = reads
    cram_p = str(tmp / "mx1.cram")
    with open(cram_p, "wb") as fh:
        with jcram.CramWriter(fh, "@HD\tVN:1.6\tSO:coordinate\n@RG\tID:r\t"
                              "SM:mx1\n", ["chr1"], [ref_len],
                              records_per_container=300,
                              block_method=jcram.M_RANSNX16, minor=1) as w:
            for k, (tid, pos, cig, mq, fl) in enumerate(reads1):
                w.write_record(tid, pos, parse_cigar(cig), mapq=mq,
                               flag=fl, name=f"r{k:05d}")
        w.write_crai(cram_p + ".crai")
    return [paths[0], cram_p, paths[2]], fa, paths


def test_mixed_bam_cram_cohort_matches_jax(mixed):
    cohort_paths, fa, bams = mixed
    want = io.StringIO()
    assert jax_run(cohort_paths, reference=fa, window=500, out=want) == 0
    all_bam = io.StringIO()
    assert jax_run(bams, reference=fa, window=500, out=all_bam) == 0
    assert want.getvalue() == all_bam.getvalue()
    for kw in ({}, dict(decode_device=True), dict(prefetch_depth=2)):
        out = io.StringIO()
        assert run_cohortdepth(cohort_paths, reference=fa, window=500,
                               out=out, device=CPU, **kw) == 0
        assert out.getvalue() == want.getvalue(), kw


@pytest.mark.parametrize("engine", ["auto", "hybrid"])
@pytest.mark.parametrize("kind", ["bam", "mixed"])
def test_bam_cohorts_hybrid_and_auto_match_jax(mixed, kind, engine):
    """BAM and mixed BAM/CRAM cohorts on the hybrid engine (``auto``
    picks it, as the reference does, when the native io is loaded):
    byte-identical to the JAX package under the same engine, with the
    lean window accumulation and under ``prefetch_depth``."""
    cohort_paths, fa, bams = mixed
    paths = bams if kind == "bam" else cohort_paths
    want = io.StringIO()
    assert jax_run(paths, reference=fa, window=500, out=want,
                   engine=engine) == 0
    for kw in ({}, dict(prefetch_depth=2), dict(processes=1)):
        out = io.StringIO()
        assert run_cohortdepth(paths, reference=fa, window=500, out=out,
                               engine=engine, device=CPU, **kw) == 0
        assert out.getvalue() == want.getvalue(), kw


@pytest.fixture(scope="module")
def c1_bam(tmp_path_factory):
    """One BAM on a 1,000,000 bp contig whose one 1 Mb window sums to
    20,499,999 bases (204,999 reads of 100M and one of 99M): the exact
    mean 20.499999 rounds half up to 20, but the sum in f32 is
    20,500,000, whose mean rounds to 21. Every window's pileup count
    passes the cap, so the hybrid engine takes its capped dense pass."""
    from goleft_tpu_torch.io.bai import write_bai
    from tools.bulk_bam import write_bam_bulk

    tmp = tmp_path_factory.mktemp("torch_c1")
    ref_len, n = 1_000_000, 205_000
    pos = np.sort(np.random.default_rng(5).integers(0, ref_len - 100, n))
    cig = np.zeros(n, np.int64)
    cig[n // 2] = 1
    bam = str(tmp / "c1.bam")
    write_bai(write_bam_bulk(bam, "chr1", ref_len, pos, cig,
                             ["100M", "99M"], np.full(n, 60),
                             np.zeros(n, np.int64)), bam + ".bai")
    fai = tmp / "r.fa.fai"
    fai.write_text(f"chr1\t{ref_len}\t6\t60\t61\n")
    return bam, str(fai)


def test_bam_window_sum_past_f32_matches_jax(c1_bam):
    """``auto`` on a BAM cohort sums windows exactly as the reference
    does: 20, not the device engine's f32 21."""
    bam, fai = c1_bam
    want = io.StringIO()
    assert jax_run([bam], fai=fai, window=1_000_000, out=want) == 0
    assert want.getvalue().splitlines()[1:] == ["chr1\t0\t1000000\t20"]
    for engine in ("auto", "hybrid"):
        out = io.StringIO()
        assert run_cohortdepth([bam], fai=fai, window=1_000_000, out=out,
                               engine=engine, device=CPU) == 0
        assert out.getvalue() == want.getvalue(), engine
    out = io.StringIO()
    assert run_cohortdepth([bam], fai=fai, window=1_000_000, out=out,
                           engine="device", device=CPU) == 0
    assert out.getvalue().splitlines()[1] == "chr1\t0\t1000000\t21"


def test_native_window_reductions_agree(c1_bam, mixed):
    """The three host reductions of csrc/fastio.cpp on one region: the
    lean accumulation (uncapped), the capped dense pass over the
    compressed stream and over the inflated body; equal where the cap
    cannot bind, and the cap lowers the dense sums where it can."""
    from goleft_tpu_torch.io import native
    from goleft_tpu_torch.io.bam import DEPTH_SKIP_FLAGS, BamFile

    for bam, end, window in ((c1_bam[0], 1_000_000, 1_000),
                             (mixed[2][0], 25_000, 500)):
        h = BamFile.from_file(bam)
        args = (0, 0, end, 0, end, window)
        acc = native.bam_window_acc_stream(h._comp, 0, h._body_start,
                                           *args, 1, DEPTH_SKIP_FLAGS)
        body = native.bgzf_inflate_range(h._comp, 0, len(h._comp),
                                         h._total)
        for cap in (2500, 3):
            dense = native.bam_window_reduce_stream(
                h._comp, 0, h._body_start, *args, cap, 1,
                DEPTH_SKIP_FLAGS)["wsums"]
            eager = native.bam_window_reduce(
                body, h._body_start, *args, cap, 1, DEPTH_SKIP_FLAGS)
            assert eager["done"] and eager["n_kept"] == acc["n_kept"]
            assert np.array_equal(eager["wsums"], dense)
            if cap >= acc["max_overlap"]:
                assert np.array_equal(acc["wsums"], dense)
            else:
                assert (dense <= acc["wsums"]).all()
                assert (dense < acc["wsums"]).any()
        assert acc["wsums"].sum() == (20_499_999 if bam == c1_bam[0]
                                      else 700 * 100)
        np.testing.assert_array_equal(
            h.window_reduce(*args, 2500, 1, DEPTH_SKIP_FLAGS),
            acc["wsums"])


def test_refusals(mixed, cohort, monkeypatch, tmp_path):
    """What is not ported says so in one line (the multi-process path);
    the flags this used to refuse now run: ``--checkpoint-dir`` and an
    ``s3://`` cohort give the JAX package's matrix. The hybrid engine on
    BAM input runs, and needs the native io as in the reference."""
    from goleft_tpu.io.remote_stub import StubServer

    cohort_paths, fa, bams = mixed
    crams, fai, want_crams = cohort
    want = io.StringIO()
    assert jax_run(bams, reference=fa, engine="hybrid", window=250,
                   out=want) == 0
    got = io.StringIO()
    assert run_cohortdepth(bams, reference=fa, engine="hybrid", out=got,
                           device=CPU) == 0
    assert got.getvalue() == want.getvalue()
    from goleft_tpu_torch.io import native

    with monkeypatch.context() as m:
        m.setattr(native, "get_lib", lambda: None)
        with pytest.raises(SystemExit, match="needs the native io"):
            run_cohortdepth(bams, reference=fa, engine="hybrid",
                            out=io.StringIO(), device=CPU)
        # auto takes the device engine where a BAM has no native io
        out = io.StringIO()
        assert run_cohortdepth(bams, reference=fa, out=out,
                               device=CPU) == 0
        assert out.getvalue() == want.getvalue()
    rc, got = _port(crams, fai, checkpoint_dir=str(tmp_path / "ck"))
    assert rc == 0 and got == want_crams
    with StubServer() as srv:
        urls = []
        for p in crams:
            name = os.path.basename(p)
            srv.put(f"bucket/{name}", open(p, "rb").read())
            srv.put(f"bucket/{name}.crai", open(p + ".crai", "rb").read())
            urls.append(f"s3://bucket/{name}")
        monkeypatch.setenv("GOLEFT_TPU_S3_ENDPOINT", srv.url)
        rc, got = _port(urls, fai)
        assert rc == 0 and got == want_crams
    monkeypatch.setenv("GOLEFT_TPU_NUM_PROCESSES", "2")
    with pytest.raises(SystemExit, match="multi-process"):
        run_cohortdepth(crams, fai=fai, out=io.StringIO(), device=CPU)


def test_cli_without_cuda_exits_1(cohort, monkeypatch, capsys, tmp_path):
    crams, fai, _ = cohort
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("GOLEFT_TPU_DEBUG", raising=False)
    report = tmp_path / "rep.json"
    rc = cli.main(["--metrics-out", str(report), "cohortdepth", "--fai", fai,
                   "-w", "500", "--decode-device", *crams])
    assert rc == 1
    assert "no CUDA device" in capsys.readouterr().err
    from goleft_tpu.obs.manifest import load_manifest

    rep = load_manifest(str(report))
    assert rep["kernel_launches"]["rans"] == 0
    assert rep["command"] == "cohortdepth" and rep["exit_code"] == 1
    assert rep["backend"]["platform"] == "cpu"


# ---- the CRAM reader ---------------------------------------------------

def _twin_reads(rng, n, ref_len=120_000):
    """tests/test_cram.py's read mix: CIGAR ops, flags, MAPQs and
    placed-unmapped records."""
    reads = []
    for s in np.sort(rng.integers(0, ref_len - 400, size=n)):
        cig = str(rng.choice(["100M", "50M10D50M", "30M1000N70M", "10S90M",
                              "40M5I55M", "5H95M", "20M3D30M2I48M",
                              "80M20S"]))
        mq = int(rng.integers(0, 61))
        fl = int(rng.choice([0, 0x10, 0x400, 0x100, 0x200, 0x3, 0x4, 0x5]))
        if fl & 0x4:
            cig, mq = "", 0
        reads.append((0, int(s), cig, mq, fl))
    return reads


WRITERS = {
    "raw": dict(block_method=jcram.M_RAW),
    "gzip": dict(block_method=jcram.M_GZIP),
    "rans4x8-o0": dict(block_method=jcram.M_RANS),
    "rans4x8-o1": dict(block_method=jcram.M_RANS, rans_order=1),
    "nx16-o0": dict(block_method=jcram.M_RANSNX16, minor=1),
    "nx16-o1-stripe": dict(block_method=jcram.M_RANSNX16, rans_order=1,
                           minor=1, rans_stripe=4),
    "arith-o1": dict(block_method=jcram.M_ARITH, rans_order=1, minor=1),
    "tok3-fqzcomp": dict(block_method=jcram.M_RANSNX16, rans_order=1,
                         minor=1, series_methods={"RN": jcram.M_TOK3,
                                                  "QS": jcram.M_FQZCOMP}),
    "core-huffman-tags": dict(block_method=jcram.M_GZIP, with_tags=True,
                              core_series=("BF", "RL", "MQ")),
    "v2": dict(block_method=jcram.M_GZIP, major=2),
}


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_cram_reader_matches_jax(tmp_path, name):
    rng = np.random.default_rng(9)
    reads = _twin_reads(rng, 900)
    p = str(tmp_path / f"{name}.cram")
    with open(p, "wb") as fh:
        with jcram.CramWriter(fh, "@HD\tVN:1.6\tSO:coordinate\n@RG\tID:rg1\t"
                              "SM:sampleA\n", ["chr1", "chr2"],
                              [120_000, 50_000], records_per_container=250,
                              **WRITERS[name]) as w:
            for i, (tid, pos, cig, mq, fl) in enumerate(reads):
                ops = parse_cigar(cig)
                q_len = sum(ln for ln, op in ops if op in (0, 1, 4, 7, 8))
                quals = bytes(rng.integers(2, 42, q_len).astype(np.uint8)) \
                    if q_len and name == "tok3-fqzcomp" else None
                w.write_record(tid, pos, ops, mapq=mq, flag=fl,
                               name=f"A00:1:{1100 + i % 4}:{i}", quals=quals)
        w.write_crai(p + ".crai")
    want = jcram.CramFile.from_file(p)
    got = tcram.CramFile.from_file(p)
    assert got.header.ref_names == want.header.ref_names
    for region in ((None, 0, None), (0, 30_000, 80_000)):
        a = want.read_columns(*region)
        b = got.read_columns(*region)
        for f in ("tid", "pos", "end", "mapq", "flag", "read_len",
                  "seg_start", "seg_end", "seg_read", "single_m"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                          err_msg=f"{name} {region} {f}")


def test_device_block_decoder_on_cram_container(tmp_path):
    """The decoder installed on a CramFile: the columns equal the host
    path's, and the decode and staging counters move."""
    rng = np.random.default_rng(9)
    p = str(tmp_path / "t.cram")
    with open(p, "wb") as fh:
        with tcram.CramWriter(fh, "@HD\tVN:1.6\n@RG\tID:r\tSM:t\n", ["chr1"],
                              [30_000], records_per_container=120,
                              block_method=tcram.M_RANSNX16, minor=1) as w:
            for j, s in enumerate(np.sort(rng.integers(0, 29_800, 300))):
                w.write_record(0, int(s), parse_cigar("100M"),
                               name=f"r{j:04d}")
        w.write_crai(p + ".crai")
    cols_host = tcram.CramFile.from_file(p).read_columns(0, 0, 30_000)
    reg = get_registry()
    before = reg.snapshot()["counters"]
    h = tcram.CramFile.from_file(p)
    h.set_block_decoder(rd.DeviceBlockDecoder(device=CPU))
    cols_dev = h.read_columns(0, 0, 30_000)
    after = reg.snapshot()["counters"]
    for f in ("pos", "end", "mapq", "flag", "seg_start", "seg_end",
              "seg_read"):
        np.testing.assert_array_equal(getattr(cols_host, f),
                                      getattr(cols_dev, f))
    for name in ("decode.device_blocks_total",
                 "decode.wire_bytes_compressed_total",
                 "decode.wire_bytes_uncompressed_total",
                 "prefetch.bytes_staged_total",
                 "prefetch.bytes_transferred_total"):
        assert after[name] > before.get(name, 0), name


# ---- the fixture writer ------------------------------------------------

def test_bulk_encode_many_equals_encode():
    rng = np.random.default_rng(1)
    items = [(bytes(rng.integers(0, int(rng.integers(1, 60)), sz,
                                 dtype=np.uint8)), order, stripe)
             for sz in (0, 1, 15, 16, 17, 100, 4097, 20000)
             for order in (0, 1) for stripe in (0, 3, 4)]
    items += [(b"a" * 100, 1, 0), (bytes(range(200)), 1, 0)]
    assert bulk_cram.encode_many(items) == [
        rx.encode(d, order=o, stripe=k) for d, o, k in items]
    v = np.array([0, 1, 127, 128, 16383, 16384, 2**21, 2**28, -1, -5])
    assert bulk_cram.itf8_concat(v) == b"".join(
        tcram.write_itf8(int(x)) for x in v)


@pytest.mark.parametrize("order,stripe", [(0, 0), (1, 0), (0, 4)])
def test_bulk_cram_equals_cram_writer(tmp_path, order, stripe):
    rng = np.random.default_rng(2)
    n, ref_len = 1200, 40_000
    pos = np.sort(rng.integers(0, ref_len - 150, n))
    mapq = np.where(rng.random(n) < 0.05, 0, 60)
    flag = np.where(rng.random(n) < 0.03, 0x400, 0)
    quals = rng.integers(35, 75, (n, 150), dtype=np.uint8)
    bulk = str(tmp_path / "bulk.cram")
    bulk_cram.write_cram_files([dict(
        path=bulk, contig="chr1", contig_len=ref_len, sample="s", pos=pos,
        mapq=mapq, flag=flag, quals=quals, order=order, stripe=stripe)],
        records_per_container=500)
    ref = str(tmp_path / "ref.cram")
    with open(ref, "wb") as fh:
        with tcram.CramWriter(fh, "@HD\tVN:1.6\tSO:coordinate\n@RG\tID:r\t"
                              "SM:s\n", ["chr1"], [ref_len],
                              records_per_container=500,
                              block_method=tcram.M_RANSNX16,
                              rans_order=order, minor=1,
                              rans_stripe=stripe) as w:
            for j in range(n):
                w.write_record(0, int(pos[j]), parse_cigar("150M"),
                               mapq=int(mapq[j]), flag=int(flag[j]),
                               name=f"r{j:07d}", quals=quals[j].tobytes())
        w.write_crai(ref + ".crai")
    with open(bulk, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert gzip.open(bulk + ".crai").read() == gzip.open(
        ref + ".crai").read()
    cols = tcram.CramFile.from_file(bulk).read_columns(0, 0, ref_len)
    np.testing.assert_array_equal(cols.pos, pos)
    assert os.path.getsize(bulk) < n * 150
