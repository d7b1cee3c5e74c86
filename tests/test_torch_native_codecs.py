"""The port's host CRAM codecs, matrix formatter and decode floor in its C
library (goleft_tpu_torch/csrc/fastio.cpp through io/native.py), on the
CPU, against the JAX package's.

- Every codec byte for byte: streams from the JAX package's encoders
  (rANS 4x8 from its CRAM writer's encoders), decoded by the port with
  its library loaded (the C path is asserted to have answered) and
  without it, and by the reference with its library loaded and with
  ``goleft_tpu.io.native.get_lib`` patched to None. The rANS-Nx16
  matrix is x32 × rle × pack over ORDER0 and ORDER1, plus STRIPE and
  NOSZ; rANS 4x8 ORDER0/1; arith ORDER0/1 with and without RLE;
  fqzcomp at default and non-default parameters; tok3 on
  instrument-style names.
- A truncated or corrupt input to each of the eight C functions: the
  port raises the reference's exception type (and message), or its
  wrapper answers None where the reference's does.
- ``format_matrix_rows`` against the reference's and the port's
  ``format_block`` at 0, near 2^62 and across chromosome names; its
  capacity overflow. ``bgzf_stream_inflate_only`` as
  tests/test_native.py holds the reference's.
- ``cohortdepth`` and ``/v1/cohortdepth`` give the reference's bytes
  with the port's library loaded and without it.

Every case but those two runs neither XLA nor torch and carries the
``native_io`` marker: ``tools/native_sanitize.py`` runs them with the
port's library built under ASan and under TSan.
"""

import io
import json

import numpy as np
import pytest

from goleft_tpu.commands.cohortdepth import run_cohortdepth as jax_run
from goleft_tpu.io import arith as jarith
from goleft_tpu.io import cram as jcram
from goleft_tpu.io import fqzcomp as jfq
from goleft_tpu.io import native as jnative
from goleft_tpu.io import rans_nx16 as jrx
from goleft_tpu.io import tok3 as jtok3
from goleft_tpu.ops.decode_smoke import make_cram_cohort
from goleft_tpu.serve.server import ServeApp as RefApp
from goleft_tpu_torch.commands.cohortdepth import format_block
from goleft_tpu_torch.commands.cohortdepth import run_cohortdepth
from goleft_tpu_torch.io import arith, cram, native, tok3
from goleft_tpu_torch.io import fqzcomp as fq
from goleft_tpu_torch.io import rans_nx16 as rx
from goleft_tpu_torch.serve.server import ServeApp
from helpers import random_reads, write_bam

CPU = "cpu"


@pytest.fixture(autouse=True)
def _libs():
    assert native.get_lib() is not None, "the port's library must build"
    assert jnative.get_lib() is not None


def _spy(monkeypatch, name):
    """Record whether each call of ``native.<name>`` answered (not
    None): the port's modules reach the wrapper as an attribute of the
    module, so the patch sees every call."""
    real = getattr(native, name)
    answered = []

    def spy(*a, **k):
        r = real(*a, **k)
        answered.append(r is not None)
        return r

    monkeypatch.setattr(native, name, spy)
    return answered


def _decode_four(monkeypatch, port_decode, ref_decode, enc, want,
                 c_names):
    """The port's decode with its C path (asserted taken) and without,
    the reference's with its library and without: all ``want``."""
    spies = [_spy(monkeypatch, n) for n in c_names]
    assert port_decode(enc) == want
    for n, s in zip(c_names, spies):
        assert s and all(s), f"the C path {n} did not answer: {s}"
    assert ref_decode(enc) == want
    with monkeypatch.context() as m:
        m.setattr(native, "get_lib", lambda: None)
        m.setattr(jnative, "get_lib", lambda: None)
        assert port_decode(enc) == want
        assert ref_decode(enc) == want


def _runs(rng, n, alphabet=8, run=6):
    """Low-alphabet run-heavy bytes (PACK and RLE both engage)."""
    return bytes(np.repeat(rng.integers(0, alphabet, n // run + 1),
                           run).astype(np.uint8)[:n])


def _quals(rng, n_rec, lo=60, hi=151):
    lens, out = [], bytearray()
    for _ in range(n_rec):
        ln = int(rng.integers(lo, hi))
        lens.append(ln)
        out += bytes(np.clip(np.cumsum(rng.integers(-2, 3, ln)) + 30,
                             0, 45).astype(np.uint8))
    return lens, bytes(out)


def _names(rng, n):
    return [(f"A00111:123:HXXYZ:1:{1101 + int(rng.integers(0, 4))}:"
             f"{int(rng.integers(1000, 30000))}:"
             f"{int(rng.integers(1000, 30000))}").encode()
            for _ in range(n)]


# ---------------- the codecs, byte for byte ----------------


@pytest.mark.native_io
@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("x32", [False, True])
@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("pack", [False, True])
def test_rans_nx16_flag_matrix(monkeypatch, order, x32, rle, pack):
    rng = np.random.default_rng(100 + 8 * order + 4 * x32 + 2 * rle + pack)
    data = _runs(rng, 6000)
    enc = jrx.encode(data, order=order, use_rle=rle, use_pack=pack,
                     x32=x32)
    _decode_four(monkeypatch, lambda e: rx.decode(e, len(data)),
                 lambda e: jrx.decode(e, len(data)), enc, data,
                 [f"ransnx16_decode{order}"])


@pytest.mark.native_io
@pytest.mark.parametrize("order", [0, 1])
def test_rans_nx16_stripe(monkeypatch, order):
    rng = np.random.default_rng(7 + order)
    data = bytes(rng.choice([65, 67, 71, 84], p=[.4, .3, .2, .1],
                            size=5001).astype(np.uint8))
    enc = jrx.encode(data, order=order, stripe=4)
    _decode_four(monkeypatch, lambda e: rx.decode(e, len(data)),
                 lambda e: jrx.decode(e, len(data)), enc, data,
                 [f"ransnx16_decode{order}"])


@pytest.mark.native_io
@pytest.mark.parametrize("order", [0, 1])
def test_rans_nx16_nosz(monkeypatch, order):
    rng = np.random.default_rng(11 + order)
    data = bytes(np.clip(np.cumsum(rng.integers(-2, 3, 4000)) + 30, 0,
                         45).astype(np.uint8))
    enc = jrx.encode(data, order=order)
    szlen = len(jrx.write_uint7(len(data)))
    nosz = bytes([enc[0] | jrx.F_NOSZ]) + enc[1 + szlen:]
    _decode_four(monkeypatch, lambda e: rx.decode(e, len(data)),
                 lambda e: jrx.decode(e, len(data)), nosz, data,
                 [f"ransnx16_decode{order}"])


@pytest.mark.native_io
@pytest.mark.parametrize("order", [0, 1])
def test_rans4x8(monkeypatch, order):
    rng = np.random.default_rng(21 + order)
    data = bytes(np.clip(np.cumsum(rng.integers(-2, 3, 7001)) + 30, 0,
                         45).astype(np.uint8))
    enc = (jcram.rans_encode_0 if order == 0 else jcram.rans_encode_1)(
        data)
    _decode_four(monkeypatch, cram.rans_decode, jcram.rans_decode, enc,
                 data, ["rans4x8_decode"])


@pytest.mark.native_io
@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("rle", [False, True])
def test_arith(monkeypatch, order, rle):
    rng = np.random.default_rng(31 + 2 * order + rle)
    data = _runs(rng, 5000, alphabet=5, run=4) if rle else bytes(
        rng.choice([65, 67, 71, 84], p=[.4, .3, .2, .1],
                   size=5000).astype(np.uint8))
    enc = jarith.encode(data, order=order, use_rle=rle)
    _decode_four(monkeypatch, lambda e: arith.decode(e, len(data)),
                 lambda e: jarith.decode(e, len(data)), enc, data,
                 ["arith_decode_body"])


def _fqz_params(kind):
    if kind == "default":
        return {}
    p = jfq.default_params(45)
    if kind == "fixed_length_dedup":
        p.pflags &= ~jfq.P_DO_LEN
        p.pflags |= jfq.P_DO_DEDUP
    elif kind == "delta_context":
        p.dbits, p.dshift, p.dloc = 3, 2, 13
        p.pflags |= jfq.P_HAVE_DTAB
        p.dtab = jfq._default_table(256, 3, 2)
    return {"params": p}


@pytest.mark.parametrize("kind", ["default", "fixed_length_dedup",
                                  "delta_context", "reversal"])
@pytest.mark.native_io
def test_fqzcomp(monkeypatch, kind):
    rng = np.random.default_rng(41)
    if kind == "fixed_length_dedup":
        lens, quals = _quals(rng, 30, 100, 101)
        lens, quals = lens + [100] * 3, quals + quals[-100:] * 3
    else:
        lens, quals = _quals(rng, 60)
    kw = _fqz_params(kind)
    if kind == "reversal":
        kw = {"do_rev": True,
              "rev": [bool(rng.integers(0, 2)) for _ in lens]}
    enc = jfq.encode(lens, quals, **kw)
    _decode_four(monkeypatch, lambda e: fq.decode(e, len(quals)),
                 lambda e: jfq.decode(e, len(quals)), enc, quals,
                 ["fqzcomp_decode"])


@pytest.mark.native_io
@pytest.mark.parametrize("use_arith", [False, True])
def test_tok3(monkeypatch, use_arith):
    names = _names(np.random.default_rng(51), 400)
    want = b"\x00".join(names) + b"\x00"
    enc = jtok3.encode(names, use_arith=use_arith)
    _decode_four(monkeypatch, lambda e: tok3.decode(e, len(want)),
                 lambda e: jtok3.decode(e, len(want)), enc, want,
                 ["tok3_assemble"])


# ---------------- truncated and corrupt inputs ----------------


def _same_error(port_call, ref_call):
    """Both raise; the same exception type and message."""
    with pytest.raises(Exception) as got:
        port_call()
    with pytest.raises(Exception) as want:
        ref_call()
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


@pytest.mark.native_io
@pytest.mark.parametrize("order", [0, 1])
def test_rans4x8_truncated_raises_the_references_error(order):
    data = bytes(np.random.default_rng(61).integers(0, 40, 3000)
                 .astype(np.uint8))
    enc = (jcram.rans_encode_0 if order == 0 else jcram.rans_encode_1)(
        data)
    cut = enc[:9 + 20]  # the table and no states
    with pytest.raises(ValueError, match="malformed rans stream"):
        native.rans4x8_decode(cut, 9, order, len(data))
    _same_error(lambda: cram.rans_decode(cut),
                lambda: jcram.rans_decode(cut))


@pytest.mark.native_io
@pytest.mark.parametrize("order", [0, 1])
def test_ransnx16_truncated_falls_back_to_the_references_error(order):
    data = _runs(np.random.default_rng(62), 4000)
    enc = jrx.encode(data, order=order)
    pos = 1 + len(jrx.write_uint7(len(data)))
    cut = enc[:pos + 5]  # inside the frequency table
    if order == 0:
        assert native.ransnx16_decode0(cut, pos, len(data), 4) is None
        assert jnative.ransnx16_decode0(cut, pos, len(data), 4) is None
    else:
        args = (cut, pos + 1, None, 0, True, cut[pos] >> 4, len(data), 4)
        assert native.ransnx16_decode1(*args) is None
        assert jnative.ransnx16_decode1(*args) is None
    _same_error(lambda: rx.decode(cut, len(data)),
                lambda: jrx.decode(cut, len(data)))


@pytest.mark.native_io
def test_arith_truncated_falls_back_to_the_references_error():
    data = bytes(np.random.default_rng(63).integers(0, 4, 4000)
                 .astype(np.uint8) + 65)
    enc = jarith.encode(data, order=1)
    pos = 1 + len(jrx.write_uint7(len(data)))
    cut = enc[:pos]  # the header, and no body
    assert native.arith_decode_body(cut, pos, len(data), 1, False) is None
    assert jnative.arith_decode_body(cut, pos, len(data), 1,
                                     False) is None
    _same_error(lambda: arith.decode(cut, len(data)),
                lambda: jarith.decode(cut, len(data)))


@pytest.mark.native_io
def test_fqzcomp_truncated_falls_back_to_the_references_error():
    lens, quals = _quals(np.random.default_rng(64), 20)
    enc = jfq.encode(lens, quals)
    cut = enc[:len(enc) // 4]
    assert native.fqzcomp_decode(cut, len(quals)) is None
    assert jnative.fqzcomp_decode(cut, len(quals)) is None
    _same_error(lambda: fq.decode(cut, len(quals)),
                lambda: jfq.decode(cut, len(quals)))


@pytest.mark.native_io
def test_tok3_corrupt_streams_fall_back_to_the_references_error():
    names = _names(np.random.default_rng(65), 50)
    want = b"\x00".join(names) + b"\x00"
    # an assembly over missing token streams: no type stream at all
    assert native.tok3_assemble({}, len(names), 0, len(want)) is None
    assert jnative.tok3_assemble({}, len(names), 0, len(want)) is None
    enc = jtok3.encode(names)
    cut = enc[:len(enc) - 7]
    _same_error(lambda: tok3.decode(cut, len(want)),
                lambda: jtok3.decode(cut, len(want)))


@pytest.mark.native_io
def test_bgzf_stream_inflate_only_corrupt_raises_the_references_error(
        tmp_path):
    p = str(tmp_path / "t.bam")
    write_bam(p, random_reads(np.random.default_rng(66), 400, 0, 60_000))
    comp = np.fromfile(p, dtype=np.uint8)
    bad = comp.copy()
    bad[len(bad) // 2] ^= 0xFF
    _same_error(lambda: native.bgzf_stream_inflate_only(bad),
                lambda: jnative.bgzf_stream_inflate_only(bad))
    _same_error(lambda: native.bgzf_stream_inflate_only(comp[:-40]),
                lambda: jnative.bgzf_stream_inflate_only(comp[:-40]))


@pytest.mark.native_io
def test_format_matrix_rows_capacity_overflow():
    """The C formatter refuses a buffer one byte under a row's worst
    case (-1, as the reference's); the wrapper sizes its buffer for the
    worst case, so it never meets one."""
    import ctypes

    starts = np.array([0], np.int64)
    ends = np.array([100], np.int64)
    vals = np.array([[1], [3]], np.int64)  # (samples, windows)
    for lib in (native.get_lib(), jnative.get_lib()):
        cb = b"chr1"
        need = len(cb) + 2 * 21 + 2 * 21 + 2
        for cap, want in ((need - 1, -1), (need, None)):
            out = np.zeros(4 * need, np.uint8)
            w = lib.format_matrix_rows(
                ctypes.c_char_p(cb), ctypes.c_long(len(cb)),
                native._ptr(starts, ctypes.c_int64),
                native._ptr(ends, ctypes.c_int64),
                native._ptr(vals, ctypes.c_int64), ctypes.c_long(1),
                ctypes.c_long(2), native._ptr(out, ctypes.c_char),
                ctypes.c_long(cap))
            if want is None:
                assert out[:w].tobytes() == b"chr1\t0\t100\t1\t3\n"
            else:
                assert w == want


# ---------------- the matrix formatter and the decode floor ----------


@pytest.mark.native_io
@pytest.mark.parametrize("case", ["zeros", "near_2_62", "chrom_names"])
def test_format_matrix_rows_matches_the_reference(case):
    rng = np.random.default_rng(71)
    n_rows, n_cols = 50, 7
    starts = np.arange(n_rows, dtype=np.int64) * 500
    ends = starts + 500
    if case == "zeros":
        vals = np.zeros((n_cols, n_rows), np.int64)
        chroms = ["chr1"]
    elif case == "near_2_62":
        vals = (1 << 62) - rng.integers(0, 1000, (n_cols, n_rows))
        starts = starts + (1 << 62) - 10_000_000
        ends = starts + 500
        chroms = ["chrX"]
    else:
        vals = rng.integers(0, 10_000, (n_cols, n_rows))
        chroms = ["chr1", "HLA-A*01:01:01:01", "chrUn_KI270302v1", "1",
                  "chrM"]
    for c in chroms:
        got = native.format_matrix_rows(c, starts, ends, vals)
        assert got == jnative.format_matrix_rows(c, starts, ends, vals)
        assert got.decode("ascii") == format_block(c, starts, ends, vals)
        # the (samples, windows) view of a (windows, samples) matrix
        t = np.ascontiguousarray(vals.T).T
        assert native.format_matrix_rows(c, starts, ends, t) == got


@pytest.mark.native_io
def test_bgzf_stream_inflate_only(tmp_path):
    """The decode-floor probe streams the product's ring driver with a
    no-op walk: the total is the block scan's, with and without CRC;
    a corrupt payload fails its CRC."""
    p = str(tmp_path / "t.bam")
    write_bam(p, random_reads(np.random.default_rng(1), 500, 0, 80_000))
    comp = np.fromfile(p, dtype=np.uint8)
    _, _, total = native.bgzf_scan(comp)
    assert native.bgzf_stream_inflate_only(comp) == total
    assert native.bgzf_stream_inflate_only(comp, check_crc=False) == total
    assert jnative.bgzf_stream_inflate_only(comp) == total
    bad = comp.copy()
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(ValueError):
        native.bgzf_stream_inflate_only(bad)
    try:  # no-CRC mode inflates garbage or reports a typed error
        native.bgzf_stream_inflate_only(bad, check_crc=False)
    except ValueError:
        pass
    assert native.bgzf_stream_inflate_only(
        np.zeros(0, np.uint8)) == 0


# ---------------- cohortdepth and /v1/cohortdepth ----------------


@pytest.fixture(scope="module")
def crams(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("native_cohort"))
    crams, fai = make_cram_cohort(d)
    want = io.StringIO()
    assert jax_run(crams, fai=fai, window=500, out=want) == 0
    return crams, fai, want.getvalue()


@pytest.mark.parametrize("lib", ["loaded", "none"])
def test_cohortdepth_gives_the_references_bytes(crams, monkeypatch, lib):
    paths, fai, want = crams
    if lib == "none":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        answered = []
    else:
        answered = _spy(monkeypatch, "format_matrix_rows")
    out = io.StringIO()
    assert run_cohortdepth(paths, fai=fai, window=500, out=out,
                           device=CPU) == 0
    assert out.getvalue() == want
    assert answered == ([] if lib == "none" else [True] * len(answered))
    assert lib == "none" or answered


@pytest.mark.parametrize("lib", ["loaded", "none"])
def test_serve_cohortdepth_gives_the_references_body(crams, monkeypatch,
                                                     lib):
    paths, fai, _ = crams
    if lib == "none":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    payload = {"bams": paths[:3], "fai": fai, "window": 500,
               "cache_buster": f"native-{lib}"}
    port = ServeApp(batch_window_s=0.01, device=CPU)
    ref = RefApp(batch_window_s=0.01)
    try:
        code, body = port.handle("cohortdepth", dict(payload))
        want_code, want = ref.handle("cohortdepth", dict(payload))
    finally:
        port.close()
        ref.close()
    assert code == want_code == 200
    assert json.dumps(body) == json.dumps(want)

