"""The port's remote data plane (goleft_tpu_torch/io/remote.py) and the
readers' URL branches, on the CPU, against the JAX package's local stub
object store (``goleft_tpu.io.remote_stub``, on loopback).

- The module: scheme handling, ranged reads, the block cache and
  read-ahead, ``read_range``/``fetch_bytes``, ``exists``, ``file_key``
  parity with the JAX package, an ETag change, a stale mid-read, 404,
  403, a transient 503, an injected ``fetch`` fault.
- The readers over URLs: fai and Faidx, bai, crai, ``open_bam_file``
  of a BAM (a CRAM's through cohortdepth below).
- ``depth`` and ``cohortdepth`` over URLs (BAM and CRAM), byte-identical
  to ``goleft_tpu`` on the local paths; ``auto`` picks the engine the
  JAX package picks for a remote BAM cohort, with and without the
  native library.
"""

import gzip
import io
import os

import numpy as np
import pytest

from goleft_tpu.commands import cohortdepth as jcd
from goleft_tpu.commands.depth import run_depth as jax_run_depth
from goleft_tpu.io import remote as jremote
from goleft_tpu.io.fai import write_fai
from goleft_tpu.io.remote_stub import StubServer
from goleft_tpu.ops.decode_smoke import make_cram_cohort
from goleft_tpu_torch.commands import cohortdepth as pcd
from goleft_tpu_torch.commands.depth import run_depth
from goleft_tpu_torch.io import remote
from goleft_tpu_torch.io.remote import StaleRemoteInput
from goleft_tpu_torch.resilience.policy import RetryPolicy
from helpers import random_reads, write_bam_and_bai, write_fasta


@pytest.fixture()
def srv():
    with StubServer() as s:
        yield s


@pytest.fixture(autouse=True)
def _fresh_identity_cache():
    remote.invalidate_identity()
    jremote.invalidate_identity()
    yield
    remote.invalidate_identity()
    jremote.invalidate_identity()


DATA = bytes(range(256)) * 2048  # 512 KiB


# ---- the module ---------------------------------------------------------

@pytest.mark.parametrize("path", [
    "http://x/y", "https://x/y", "s3://bucket/key", "HTTPS://x/y",
    "/plain/path", "relative/path.bam", "ftp://x/y", "gs://b/k", None])
def test_is_remote_matches_reference(path):
    assert remote.is_remote(path) == jremote.is_remote(path)


def test_s3_maps_through_endpoint(monkeypatch, srv):
    monkeypatch.setenv("GOLEFT_TPU_S3_ENDPOINT", "http://127.0.0.1:1/")
    assert remote.resolve_url("s3://bucket/a/b.bam") \
        == "http://127.0.0.1:1/bucket/a/b.bam"
    monkeypatch.delenv("GOLEFT_TPU_S3_ENDPOINT")
    with pytest.raises(ValueError):
        remote.resolve_url("s3://bucket/a/b.bam")
    srv.put("bucket/obj.bin", DATA)
    monkeypatch.setenv("GOLEFT_TPU_S3_ENDPOINT", srv.url)
    assert remote.fetch_bytes("s3://bucket/obj.bin") == DATA


def test_ranged_reads_byte_identical(srv, tmp_path):
    url = srv.put("obj.bin", DATA)
    with remote.open_source(url) as src:
        assert src.length == len(DATA)
        for off, n in ((0, 1), (17, 100), (1000, 65536),
                       (len(DATA) - 5, 50), (len(DATA), 10)):
            assert src.read(off, n) == DATA[off:off + n]
        assert src.read_all() == DATA
    p = tmp_path / "f.bin"
    p.write_bytes(DATA)
    with remote.open_source(str(p)) as src:
        assert src.length == len(DATA) and src.read(10, 20) == DATA[10:30]
        assert src.key()[1] == len(DATA)


def test_block_cache_and_readahead(srv, monkeypatch):
    monkeypatch.setenv("GOLEFT_TPU_FETCH_BLOCK", "4096")
    monkeypatch.setenv("GOLEFT_TPU_FETCH_READAHEAD", "2")
    url = srv.put("obj.bin", DATA)
    with remote.open_source(url) as src:
        src.read(0, 4096)       # a miss: blocks 0..2 in one request
        n = srv.store.request_counts["obj.bin"]
        src.read(4096, 8192)    # blocks 1, 2: read-ahead hits
        assert srv.store.request_counts["obj.bin"] == n
        assert src.read(0, len(DATA)) == DATA


def test_range_ignoring_server_still_correct(srv):
    srv.store.ignore_range("obj.bin")
    url = srv.put("obj.bin", DATA)
    with remote.open_source(url) as src:
        assert src.read(100, 200) == DATA[100:300]


def test_read_range_fetch_bytes_and_exists(tmp_path, srv):
    p = tmp_path / "f.bin"
    p.write_bytes(DATA)
    url = srv.put("f.bin", DATA)
    assert remote.read_range(str(p), 7, 9) == remote.read_range(url, 7, 9) \
        == DATA[7:16]
    assert remote.fetch_bytes(str(p)) == remote.fetch_bytes(url)
    assert remote.exists(str(p)) and remote.exists(url)
    assert not remote.exists(str(tmp_path / "missing"))
    assert not remote.exists(srv.url + "/missing.bin")


def test_file_key_parity_with_reference(tmp_path, srv):
    from goleft_tpu.parallel.scheduler import file_key as jkey
    from goleft_tpu_torch.parallel.scheduler import file_key

    p = tmp_path / "f.bin"
    p.write_bytes(DATA)
    url = srv.put("f.bin", DATA)
    assert file_key(str(p)) == jkey(str(p))
    assert file_key(url) == jkey(url)
    assert file_key(url)[2].startswith("etag:")
    k1 = file_key(url)
    srv.store.put("f.bin", DATA[:-1] + b"\x00")  # same length
    remote.invalidate_identity(url)
    jremote.invalidate_identity(url)
    k2 = file_key(url)
    assert k1 != k2 and k1[1] == k2[1] and k2 == jkey(url)


def test_identity_ttl_caches_probes(srv):
    url = srv.put("f.bin", DATA)
    remote.remote_file_key(url)
    n = srv.store.request_counts["f.bin"]
    remote.remote_file_key(url)
    assert srv.store.request_counts["f.bin"] == n


def test_stale_mid_read_raises_not_mixes(srv, monkeypatch):
    monkeypatch.setenv("GOLEFT_TPU_FETCH_BLOCK", "4096")
    monkeypatch.setenv("GOLEFT_TPU_FETCH_READAHEAD", "0")
    url = srv.put("f.bin", DATA)
    src = remote.open_source(url)
    src.read(0, 10)
    srv.store.put("f.bin", b"v2" * (len(DATA) // 2))
    with pytest.raises(StaleRemoteInput):
        src.read(len(DATA) - 10, 10)
    exc = StaleRemoteInput("http://x/f", "etag:a", "etag:b")
    assert RetryPolicy().classify(exc) == "permanent"


@pytest.mark.parametrize("status,exc", [(404, FileNotFoundError),
                                        (403, PermissionError)])
def test_permanent_statuses(srv, status, exc):
    srv.put("f.bin", DATA)
    if status == 404:
        url = srv.url + "/missing.bin"
    else:
        srv.store.fail("f.bin", times=3, status=403)
        url = srv.url + "/f.bin"
    with pytest.raises(exc):
        remote.fetch_bytes(url)


def test_transient_503_retried_to_identical_bytes(srv):
    url = srv.put("f.bin", DATA)
    srv.store.fail("f.bin", times=1, status=503)
    assert remote.fetch_bytes(url) == DATA


def test_injected_fetch_fault_retried(srv):
    from goleft_tpu_torch.obs import get_registry
    from goleft_tpu_torch.resilience import faults

    url = srv.put("f.bin", DATA)
    retries = get_registry().counter("resilience.retries_total")
    before = retries.value
    faults.install("fetch:after=1:transient")
    try:
        assert remote.fetch_bytes(url) == DATA
    finally:
        faults.install(None)
    assert retries.value == before + 1


# ---- the readers over URLs ---------------------------------------------

def test_fai_and_faidx_over_urls(tmp_path, srv):
    from goleft_tpu_torch.io.fai import Faidx, read_fai

    fa = tmp_path / "ref.fa"
    fa.write_text(">chr1\n" + "ACGT" * 25 + "\n" + "ACGT" * 25 + "\n")
    write_fai(str(fa))
    fa_url = srv.put("ref.fa", fa.read_bytes())
    srv.put("ref.fa.fai", (tmp_path / "ref.fa.fai").read_bytes())
    assert read_fai(str(fa) + ".fai") == read_fai(fa_url + ".fai")
    with Faidx(str(fa)) as fl, Faidx(fa_url) as fr:
        assert fl.fetch("chr1", 10, 90) == fr.fetch("chr1", 10, 90)
        assert fl.names() == fr.names()


def test_bai_and_crai_over_urls(tmp_path, srv):
    from goleft_tpu_torch.io.bai import query_voffset, read_bai
    from goleft_tpu_torch.io.crai import load_crai_entries

    bam = tmp_path / "s.bam"
    write_bam_and_bai(str(bam), [(0, pos, "50M", 60, 0)
                                 for pos in (10, 500, 900)],
                      ref_names=["chr1"], ref_lens=[10_000])
    bai_url = srv.put("s.bam.bai", (tmp_path / "s.bam.bai").read_bytes())
    il, ir = read_bai(str(bam) + ".bai"), read_bai(bai_url)
    assert query_voffset(il, 0, 400) == query_voffset(ir, 0, 400)
    crai = gzip.compress(b"0\t1\t999\t100\t0\t500\n1\t5\t10\t700\t0\t9\n")
    local = tmp_path / "s.cram.crai"
    local.write_bytes(crai)
    crai_url = srv.put("s.cram.crai", crai)
    assert load_crai_entries(str(local)) == load_crai_entries(crai_url) \
        == [(0, 1, 999, 100), (1, 5, 10, 700)]


@pytest.mark.native_io
def test_open_bam_file_over_url_decodes_identically(tmp_path, srv):
    from goleft_tpu_torch.io.bam import open_bam_file

    bam = tmp_path / "s.bam"
    write_bam_and_bai(str(bam), [(0, pos, "50M", 60, 0)
                                 for pos in (10, 500, 900)],
                      ref_names=["chr1"], ref_lens=[10_000])
    url = srv.put("s.bam", bam.read_bytes())
    cl = open_bam_file(str(bam)).read_columns(tid=0, start=0, end=10_000)
    cr = open_bam_file(url).read_columns(tid=0, start=0, end=10_000)
    assert cl.n_reads == cr.n_reads == 3
    assert np.array_equal(cl.pos, cr.pos)


# ---- the commands over URLs ---------------------------------------------

@pytest.fixture(scope="module")
def bam_cohort(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_remote")
    rng = np.random.default_rng(11)
    ref_len = 30_000
    fa = write_fasta(str(tmp / "ref.fa"),
                     {"chr1": ("ACGT" * ref_len)[:ref_len]})
    write_fai(fa)
    bams = []
    for i in range(3):
        hdr = ("@HD\tVN:1.6\tSO:coordinate\n"
               f"@SQ\tSN:chr1\tLN:{ref_len}\n@RG\tID:r\tSM:s{i}\n")
        p = str(tmp / f"s{i}.bam")
        write_bam_and_bai(p, random_reads(rng, 600, 0, ref_len),
                          ref_names=("chr1",), ref_lens=(ref_len,),
                          header_text=hdr)
        bams.append(p)
    return tmp, fa, bams


def _serve(srv, paths, suffixes, prefix="bucket"):
    """Put each path (and its existing sibling ``suffixes``) under
    ``prefix/`` in the store → the URLs of the paths."""
    urls = []
    for p in paths:
        name = f"{prefix}/{os.path.basename(p)}"
        for suf in suffixes:
            if os.path.exists(p + suf):
                srv.put(name + suf, open(p + suf, "rb").read())
        urls.append(f"{srv.url}/{name}")
    return urls


@pytest.mark.parametrize("stats", [False, True])
def test_depth_over_urls_matches_reference_on_local_paths(bam_cohort, srv,
                                                          tmp_path, stats):
    _, fa, bams = bam_cohort
    url, = _serve(srv, bams[:1], ("", ".bai"))
    fa_url, = _serve(srv, [fa], ("", ".fai"))
    want = jax_run_depth(bams[0], str(tmp_path / "j"), reference=fa,
                         window=250, stats=stats)
    got = run_depth(url, str(tmp_path / "p"), reference=fa_url, window=250,
                    stats=stats, device="cpu")
    for a, b in zip(want, got):
        assert open(a).read() == open(b).read()


def test_depth_over_a_cram_url_matches_reference(srv, tmp_path):
    crams, fai = make_cram_cohort(str(tmp_path))
    url, = _serve(srv, crams[:1], ("", ".crai"), "crams")
    fai_url, = _serve(srv, [fai], ("",), "crams")
    want = jax_run_depth(crams[0], str(tmp_path / "j"), fai=fai,
                         window=500)
    got = run_depth(url, str(tmp_path / "p"), fai=fai_url, window=500,
                    device="cpu")
    for a, b in zip(want, got):
        assert open(a).read() == open(b).read()


def test_cohortdepth_over_urls_bam_and_cram(bam_cohort, srv, tmp_path):
    _, fa, bams = bam_cohort
    want = io.StringIO()
    assert jcd.run_cohortdepth(bams, reference=fa, window=250,
                               out=want) == 0
    urls = _serve(srv, bams, ("", ".bai"))
    fa_url, = _serve(srv, [fa], ("", ".fai"))
    got = io.StringIO()
    assert pcd.run_cohortdepth(urls, reference=fa_url, window=250, out=got,
                               device="cpu") == 0
    assert got.getvalue() == want.getvalue()

    crams, fai = make_cram_cohort(str(tmp_path))
    want = io.StringIO()
    assert jcd.run_cohortdepth(crams, fai=fai, window=500, out=want) == 0
    curls = _serve(srv, crams, ("", ".crai"), "crams")
    fai_url, = _serve(srv, [fai], ("",), "crams")
    got = io.StringIO()
    assert pcd.run_cohortdepth(curls, fai=fai_url, window=500, out=got,
                               decode_device=True, device="cpu") == 0
    assert got.getvalue() == want.getvalue()


@pytest.mark.parametrize("native_lib", [True, False])
def test_auto_picks_the_reference_engine_for_a_remote_bam_cohort(
        bam_cohort, srv, monkeypatch, native_lib):
    """Which engine ``auto`` takes for a cohort of BAM URLs, observed by
    what each package's run calls: the port's DepthEngine, the JAX
    package's vmapped device pipeline."""
    from goleft_tpu.io import native as jnative
    from goleft_tpu_torch.io import native as pnative

    if not native_lib:
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
        monkeypatch.setattr(pnative, "get_lib", lambda: None)
    _, fa, bams = bam_cohort
    urls = _serve(srv, bams, ("", ".bai"))
    fa_url, = _serve(srv, [fa], ("", ".fai"))
    used = {"port": 0, "jax": 0}
    real_engine, real_pipe = pcd.DepthEngine, jcd._batched_pipeline

    def engine(*a, **kw):
        used["port"] += 1
        return real_engine(*a, **kw)

    def pipe(*a, **kw):
        used["jax"] += 1
        return real_pipe(*a, **kw)

    monkeypatch.setattr(pcd, "DepthEngine", engine)
    monkeypatch.setattr(jcd, "_batched_pipeline", pipe)
    want, got = io.StringIO(), io.StringIO()
    assert jcd.run_cohortdepth(urls, reference=fa_url, window=250,
                               out=want) == 0
    assert pcd.run_cohortdepth(urls, reference=fa_url, window=250, out=got,
                               device="cpu") == 0
    assert got.getvalue() == want.getvalue()
    assert bool(used["port"]) == bool(used["jax"]) == (not native_lib)
