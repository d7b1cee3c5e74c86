"""Every BAM, BAI, BGZF and formatter function of the port's C library
(goleft_tpu_torch/csrc/fastio.cpp through io/native.py) against the JAX
package's on the same inputs, on the CPU: the scan and inflate, the
record decode, the depth path's segment walk, the three window
reductions, the index scan, the row formatters and the block deflate,
each on good input, at region edges and on truncated or corrupt input
(the reference's exception and message), and the walks from eight
threads at once on one buffer.

Every case runs neither XLA nor torch and carries the ``native_io``
marker: ``tools/native_sanitize.py`` runs them with the port's library
built under ASan and under TSan, so these are what give the sanitizers
the library's BAM and formatter paths to watch.
"""

import threading

import numpy as np
import pytest

from goleft_tpu.io import native as jnative
from goleft_tpu_torch.io import native
from helpers import random_reads, write_bam_and_bai

pytestmark = pytest.mark.native_io

FLAG_MASK = 0x704  # unmapped, secondary, QC fail, duplicate
LEN1 = 100_000


@pytest.fixture(autouse=True)
def _libs():
    assert native.get_lib() is not None, "the port's library must build"
    assert jnative.get_lib() is not None


def _reads(seed: int):
    """chr1 and chr2 reads with D / N / S / I CIGARs, MAPQ 0, filtered
    flags, a pileup of 400 reads at one position and a 20 kb N."""
    rng = np.random.default_rng(seed)
    cigars = ["100M", "40M10D60M", "30M2000N70M", "10S90M", "50M5I45M",
              "20M20000N80M"]
    out = []
    for tid, n, length in ((0, 3000, LEN1), (1, 800, 50_000)):
        base = random_reads(rng, n, tid, length - 25_000)
        for k, (t, pos, _, mapq, _) in enumerate(base):
            flag = int(rng.choice([0, 0, 0, 0x400, 0x100, 0x4, 0x10]))
            out.append((t, pos, cigars[k % len(cigars)], mapq, flag))
        if tid == 0:
            out += [(0, 60_000, "100M", 60, 0)] * 400
    return sorted(out, key=lambda r: (r[0], r[1]))


@pytest.fixture(scope="module", params=[0, 1], ids=["stored", "deflated"])
def bam(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("nio") / "t.bam")
    write_bam_and_bai(path, _reads(5), level=request.param,
                      block_size=4096)
    with open(path, "rb") as fh:
        data = fh.read()
    co, uo, total = native.bgzf_scan(data)
    body = native.bgzf_inflate_range(data, 0, len(data), total)
    with open(path + ".bai", "rb") as fh:
        bai = fh.read()
    from goleft_tpu_torch.io.bam import BamFile

    return {"path": path, "data": data, "co": co, "uo": uo, "total": total,
            "body": body, "bai": bai,
            "body_start": BamFile(data)._body_start}


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want


def _raises_alike(port_call, ref_call):
    with pytest.raises(Exception) as want:
        ref_call()
    with pytest.raises(type(want.value)) as got:
        port_call()
    assert str(got.value) == str(want.value)


def _alike(port_call, ref_call):
    """The reference's exception and message where it raises, else its
    answer."""
    try:
        want = ref_call()
    except Exception:  # noqa: BLE001
        _raises_alike(port_call, ref_call)
        return
    _same(port_call(), want)


def test_bgzf_scan_and_inflate_range(bam):
    data = bam["data"]
    _same(native.bgzf_scan(data), jnative.bgzf_scan(data))
    co, uo = bam["co"], bam["uo"]
    assert len(co) > 4
    for b0, b1 in ((0, 1), (1, 3), (2, len(co))):
        c_end = int(co[b1]) if b1 < len(co) else len(data)
        cap = (int(uo[b1]) if b1 < len(co) else bam["total"]) - int(uo[b0])
        _same(native.bgzf_inflate_range(data, int(co[b0]), c_end, cap),
              jnative.bgzf_inflate_range(data, int(co[b0]), c_end, cap))
    _raises_alike(lambda: native.bgzf_inflate_range(data, 0, len(data), 10),
                  lambda: jnative.bgzf_inflate_range(data, 0, len(data), 10))


@pytest.mark.parametrize("tid,start,end", [(-1, 0, -1), (0, 0, LEN1),
                                           (0, 59_950, 60_050),
                                           (1, 10_000, 20_000), (0, 0, 1)])
def test_bam_decode(bam, tid, start, end):
    body, off = bam["body"], bam["body_start"]
    _same(native.bam_decode(body, off, tid, start, end),
          jnative.bam_decode(body, off, tid, start, end))
    # a capacity too small for the records: both grow and retry
    _same(native.bam_decode(body, off, tid, start, end, cap_reads=7),
          jnative.bam_decode(body, off, tid, start, end, cap_reads=7))


REGIONS = [(0, 0, LEN1), (0, 59_000, 61_000), (0, 74_990, LEN1),
           (1, 0, 50_000), (1, 12_345, 12_346), (0, 99_999, LEN1)]


@pytest.mark.parametrize("tid,start,end", REGIONS)
@pytest.mark.parametrize("mapq", [0, 1, 30])
def test_bam_segments_stream(bam, tid, start, end, mapq):
    args = (bam["data"], 0, bam["body_start"], tid, start, end, mapq,
            FLAG_MASK)
    got = native.bam_segments_stream(*args)
    _same(got, jnative.bam_segments_stream(*args))
    # an undersized capacity: one exact-size re-walk, the same segments
    _same(native.bam_segments_stream(*args, cap_hint=3), got)
    _same(native.bam_segments_stream(*args, check_crc=False), got)


@pytest.mark.parametrize("tid,start,end", REGIONS)
@pytest.mark.parametrize("window,cap", [(250, 2600), (1, 100), (50, 7)])
def test_window_reductions(bam, tid, start, end, window, cap):
    w0 = start // window * window
    length = -(-(end - w0) // window) * window
    data, off = bam["data"], bam["body_start"]
    common = (tid, start, end, w0, length, window)
    _same(native.bam_window_reduce_stream(data, 0, off, *common, cap, 1,
                                          FLAG_MASK),
          jnative.bam_window_reduce_stream(data, 0, off, *common, cap, 1,
                                           FLAG_MASK))
    _same(native.bam_window_acc_stream(data, 0, off, *common, 1,
                                       FLAG_MASK),
          jnative.bam_window_acc_stream(data, 0, off, *common, 1,
                                        FLAG_MASK))
    body = bam["body"]
    _same(native.bam_window_reduce(body, off, *common, cap, 1, FLAG_MASK),
          jnative.bam_window_reduce(body, off, *common, cap, 1, FLAG_MASK))


def test_window_reductions_refuse_a_ragged_grid(bam):
    data, off = bam["data"], bam["body_start"]
    _raises_alike(
        lambda: native.bam_window_acc_stream(data, 0, off, 0, 0, 1000, 0,
                                             999, 250, 1, FLAG_MASK),
        lambda: jnative.bam_window_acc_stream(data, 0, off, 0, 0, 1000, 0,
                                              999, 250, 1, FLAG_MASK))


@pytest.mark.parametrize("cut", [0.3, 0.77, 0.999])
def test_truncated_bgzf_raises_the_references_error(bam, cut):
    data = bam["data"][:int(len(bam["data"]) * cut)]
    off = bam["body_start"]
    # a cut past chr1's records may end no walk of chr1: then both answer
    _alike(
        lambda: native.bam_segments_stream(data, 0, off, 0, 0, LEN1, 1,
                                           FLAG_MASK),
        lambda: jnative.bam_segments_stream(data, 0, off, 0, 0, LEN1, 1,
                                            FLAG_MASK))
    _alike(
        lambda: native.bam_window_reduce_stream(data, 0, off, 0, 0, LEN1, 0,
                                                LEN1, 250, 2600, 1,
                                                FLAG_MASK),
        lambda: jnative.bam_window_reduce_stream(data, 0, off, 0, 0, LEN1,
                                                 0, LEN1, 250, 2600, 1,
                                                 FLAG_MASK))


def test_corrupt_block_raises_the_references_error(bam):
    if bam["co"][1] - bam["co"][0] < 40:
        pytest.skip("first block too small to corrupt")
    data = bytearray(bam["data"])
    mid = int(bam["co"][1]) - 12  # inside the first block's payload
    data[mid] ^= 0xFF
    data = bytes(data)
    off = bam["body_start"]
    _raises_alike(
        lambda: native.bam_segments_stream(data, 0, off, 0, 0, LEN1, 1,
                                           FLAG_MASK),
        lambda: jnative.bam_segments_stream(data, 0, off, 0, 0, LEN1, 1,
                                            FLAG_MASK))


def test_walks_from_eight_threads_at_once(bam):
    """One buffer, eight threads, each walking its own regions with the
    segment walk and both window reductions: every answer is the
    single-threaded one (the walks share the library's thread-local
    rings; this is what TSan watches)."""
    data, off = bam["data"], bam["body_start"]
    jobs = [(tid, s, e) for tid, s, e in REGIONS] * 4
    want = [(native.bam_segments_stream(data, 0, off, t, s, e, 1,
                                        FLAG_MASK),
             native.bam_window_acc_stream(
                 data, 0, off, t, s, e, s // 50 * 50,
                 -(-(e - s // 50 * 50) // 50) * 50, 50, 1, FLAG_MASK))
            for t, s, e in jobs]
    got = [None] * len(jobs)
    gate = threading.Barrier(8)

    def worker(k):
        gate.wait(timeout=30)
        for i in range(k, len(jobs), 8):
            t, s, e = jobs[i]
            w0 = s // 50 * 50
            got[i] = (native.bam_segments_stream(data, 0, off, t, s, e, 1,
                                                 FLAG_MASK),
                      native.bam_window_acc_stream(
                          data, 0, off, t, s, e, w0,
                          -(-(e - w0) // 50) * 50, 50, 1, FLAG_MASK))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for g, w in zip(got, want):
        _same(g, w)


def test_bai_scan(bam):
    bai = bam["bai"]
    _same(native.bai_scan(bai), jnative.bai_scan(bai))
    for bad in (bai[:6], bai[:len(bai) // 2], b"XXXX" + bai[4:],
                bai[:4] + b"\xff\xff\xff\x7f" + bai[8:]):
        _raises_alike(lambda: native.bai_scan(bad),
                      lambda: jnative.bai_scan(bad))


def _rows(n: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.integers(0, 1 << 40, n)).astype(np.int64)
    return starts, starts + rng.integers(1, 10_000, n)


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_row_formatters(n):
    rng = np.random.default_rng(n)
    starts, ends = _rows(n)
    means = np.concatenate([rng.random(n // 2) * 1e3,
                            rng.choice([0.0, 1e-5, 123456.0, 2.5e9,
                                        0.30000000000000004], n - n // 2)])
    for chrom in ("chr1", "HLA-A*01:01:01:01"):
        _same(native.format_depth_rows(chrom, starts, ends, means),
              jnative.format_depth_rows(chrom, starts, ends, means))
        cls = rng.integers(0, 4, n).astype(np.uint8)
        _same(native.format_class_rows(chrom, starts, ends, cls),
              jnative.format_class_rows(chrom, starts, ends, cls))
        vals = rng.standard_normal((5, n)) * 10.0 ** rng.integers(
            -6, 9, (5, n))
        valid = (rng.random((5, n)) < 0.9).astype(np.uint8)
        for prec in (3, 6):
            _same(native.format_float_matrix_rows(chrom, starts, ends, vals,
                                                  valid, prec),
                  jnative.format_float_matrix_rows(chrom, starts, ends,
                                                   vals, valid, prec))
    xs, ys = rng.random(n) * 1e6, rng.standard_normal(n)
    for xp, yp in ((10, 5), (3, 2)):
        _same(native.format_xy_json(xs, ys, xp, yp),
              jnative.format_xy_json(xs, ys, xp, yp))


def test_formatters_refuse_bad_input():
    starts, ends = _rows(4)
    cls = np.array([0, 1, 4, 2], np.uint8)
    _raises_alike(lambda: native.format_class_rows("c", starts, ends, cls),
                  lambda: jnative.format_class_rows("c", starts, ends, cls))
    _raises_alike(
        lambda: native.format_xy_json(np.zeros(3), np.zeros(2)),
        lambda: jnative.format_xy_json(np.zeros(3), np.zeros(2)))


@pytest.mark.parametrize("size", [0, 1, 4096, 65280])
@pytest.mark.parametrize("level", [0, 1, 6])
def test_bgzf_deflate_block(size, level):
    import gzip

    rng = np.random.default_rng(size + level)
    chunk = rng.choice(np.frombuffer(b"ACGTN\t\n", np.uint8),
                       size).tobytes()
    got = native.bgzf_deflate_block(chunk, level)
    assert got == jnative.bgzf_deflate_block(chunk, level)
    assert gzip.decompress(got) == chunk
    co, uo, total = native.bgzf_scan(got)
    assert total == size and len(co) == 1
