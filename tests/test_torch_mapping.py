"""The port's read mapper (goleft_tpu_torch/mapping/) against the JAX
package's, on the CPU: index tables array for array, seeding on the same
tables against the reference's XLA program and host oracle, the tuples
of ``map_reads``, the map fault site, and the fused depth bed. The cases
mirror tests/test_mapping.py. Every comparison is exact."""

import numpy as np
import pytest
import torch

from goleft_tpu.io.fastq import FastqRecord
from goleft_tpu.mapping import build_index as ref_build_index
from goleft_tpu.mapping import depth_bed_from_tuples as ref_depth_bed
from goleft_tpu.mapping import map_reads as ref_map_reads
from goleft_tpu.mapping import pipeline as ref_pipeline
from goleft_tpu_torch.mapping import (
    build_index, depth_bed_from_tuples, format_tuples, from_arrays,
    map_reads, parse_tuples, seed_bucket,
)
from goleft_tpu_torch.mapping import pipeline
from goleft_tpu_torch.mapping.index import ARRAY_FIELDS, fmix32
from goleft_tpu_torch.ops import depth_kernel
from goleft_tpu_torch.ops.pairhmm import encode_seq

_BASES = b"ACGT"


def _rand_seq(rng, n):
    return bytes(rng.choice(list(_BASES), size=n).tolist())


def _write_fasta(path, chroms):
    out = []
    for cname, seq in chroms:
        out.append(f">{cname}\n".encode())
        for i in range(0, len(seq), 60):
            out.append(seq[i:i + 60] + b"\n")
    path.write_bytes(b"".join(out))
    return str(path)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    rng = np.random.default_rng(42)
    chroms = [("chr1", _rand_seq(rng, 1600)),
              ("chr2", _rand_seq(rng, 900))]
    path = _write_fasta(tmp_path_factory.mktemp("ref") / "ref.fa", chroms)
    return path, dict(chroms)


@pytest.fixture(scope="module")
def indexes(ref):
    """(the reference's index, the port's own build, the port's index
    carried across from the reference's arrays)."""
    want = ref_build_index(ref[0])
    return (want, build_index(ref[0]),
            from_arrays({f: getattr(want, f) for f in ARRAY_FIELDS}))


def _sim_reads(rng, chroms, n, rlen, subs=2, rc_rate=0.3, n_rate=0.0):
    """(records, truth) — truth[i] = (chrom, start, rev)."""
    names = sorted(chroms)
    recs, truth = [], []
    for i in range(n):
        cname = names[int(rng.integers(0, len(names)))]
        seq = chroms[cname]
        s = int(rng.integers(0, len(seq) - rlen))
        frag = bytearray(seq[s:s + rlen])
        for _ in range(subs):
            j = int(rng.integers(0, rlen))
            frag[j] = _BASES[int(rng.integers(0, 4))]
        for j in range(rlen):
            if rng.random() < n_rate:
                frag[j] = ord("N")
        rev = rng.random() < rc_rate
        if rev:
            frag = bytearray(bytes(frag).translate(
                bytes.maketrans(b"ACGT", b"TGCA"))[::-1])
        recs.append(FastqRecord(f"r{i}", bytes(frag), b"I" * rlen))
        truth.append((cname, s, rev))
    return recs, truth


# ---------------- index ----------------


@pytest.mark.parametrize("k,w,max_occ", [(13, 8, 64), (11, 5, 2),
                                         (15, 12, 64)])
def test_index_tables_equal_the_reference(ref, k, w, max_occ):
    want = ref_build_index(ref[0], k=k, w=w, max_occ=max_occ)
    got = build_index(ref[0], k=k, w=w, max_occ=max_occ)
    for f in ARRAY_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f


def test_from_arrays_and_device_tables(indexes):
    want, own, carried = indexes
    for f in ARRAY_FIELDS:
        a = getattr(carried, f)
        assert np.array_equal(np.asarray(a), np.asarray(getattr(own, f))), f
    t = carried.device_tables("cpu")
    assert t is carried.device_tables(torch.device("cpu"))
    assert all(x.dtype == torch.int32 for x in t)
    assert torch.equal(t[0], torch.from_numpy(want.ht_code))
    assert own.chrom_of(0) == ("chr1", 0)
    g2 = int(own.chrom_starts[1])
    assert own.chrom_of(g2) == ("chr2", 0)
    assert own.chrom_bounds(g2 + 5) == (g2, int(own.chrom_starts[2]))


def test_fmix32_torch_equals_numpy():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64),
                        [0, 1, 2**32 - 1, 2**31, 2**30 - 1]]
                       ).astype(np.uint32)
    got = pipeline.fmix32_torch(torch.from_numpy(x.astype(np.int64)))
    assert np.array_equal(got.numpy(), fmix32(x).astype(np.int64))
    assert int(got.max()) < 2**32


# ---------------- seeding == the reference, same tables ----------------


@pytest.mark.parametrize("rlen,rc_rate,n_rate", [
    (60, 0.0, 0.0),    # forward strand only
    (60, 1.0, 0.0),    # reverse strand only
    (100, 0.5, 0.02),  # both, N bases
    (150, 0.5, 0.0),   # the main path's read length
    (45, 0.5, 0.0),    # a read shorter than its bucket
])
def test_seed_bucket_matches_reference_and_host(ref, indexes, rlen,
                                                rc_rate, n_rate):
    want_idx, _, idx = indexes
    rng = np.random.default_rng(rlen + int(10 * rc_rate))
    recs, truth = _sim_reads(rng, ref[1], 24, rlen, subs=3,
                             rc_rate=rc_rate, n_rate=n_rate)
    codes = [encode_seq(r.seq) for r in recs]
    r_pad = pipeline._pad_up(rlen, pipeline.BUCKET)
    smax = pipeline._smax(r_pad, idx.k, idx.w)
    pk, nm, rl = pipeline._pack_reads_2bit(list(range(len(recs))), codes,
                                           r_pad)
    s, d, rv = seed_bucket(torch.from_numpy(pk), torch.from_numpy(nm),
                           torch.from_numpy(rl), idx.device_tables("cpu"),
                           r_pad=r_pad, k=idx.k, w=idx.w,
                           max_occ=idx.max_occ, band=pipeline.DEFAULT_BAND,
                           smax=smax)
    assert (s.dtype, d.dtype, rv.dtype) == (torch.int32, torch.int32,
                                            torch.bool)
    fn = ref_pipeline._seed_jit(r_pad, idx.k, idx.w, idx.max_occ,
                                pipeline.DEFAULT_BAND, smax)
    ws, wd, wrv = (np.asarray(a) for a in
                   fn(pk, nm, rl, *want_idx.device_tables()))
    assert np.array_equal(s.numpy(), ws)
    assert np.array_equal(d.numpy(), wd)
    assert np.array_equal(rv.numpy(), wrv)
    for i, c in enumerate(codes):
        assert (int(s[i]), int(d[i]), bool(rv[i])) == \
            pipeline.seed_reads_host(idx, c, pipeline.DEFAULT_BAND, smax)
    # the strands are both covered: most seeded reads of 60 bp and more
    # take their true strand
    seeded = [(bool(r), t[2]) for r, t, n in zip(rv.numpy(), truth, s)
              if n >= pipeline.DEFAULT_MIN_SUPPORT]
    if rlen >= 60:
        assert len(seeded) >= len(recs) // 2
        assert sum(a == b for a, b in seeded) >= 0.9 * len(seeded)


# ---------------- end to end ----------------


def test_map_reads_gives_the_reference_tuples(ref, indexes):
    want_idx, idx, _ = indexes
    rng = np.random.default_rng(9)
    recs, truth = _sim_reads(rng, ref[1], 120, 100)
    res = map_reads(idx, recs, device="cpu")
    want = ref_map_reads(want_idx, recs)
    assert res.tuples == want.tuples and not res.failed
    assert res.stats == want.stats
    ok = sum(1 for t, (tc, ts, trev) in zip(res.tuples, truth)
             if t is not None and t[0] == tc and abs(t[1] - ts) <= 5
             and t[5] == ("-" if trev else "+"))
    assert ok >= 0.95 * len(recs)


def test_short_and_empty_reads_are_unmapped_not_errors(indexes):
    idx = indexes[1]
    res = map_reads(idx, [FastqRecord("tiny", b"ACGT", b"IIII")],
                    device="cpu")
    assert res.tuples == [None] and not res.failed
    assert res.stats["unmapped"] == 1
    assert map_reads(idx, [], device="cpu").stats["reads"] == 0


def test_map_fault_site_retries_then_quarantines(ref, indexes):
    from goleft_tpu_torch.resilience import faults

    idx = indexes[1]
    rng = np.random.default_rng(13)
    recs, _ = _sim_reads(rng, ref[1], 8, 100)
    want = map_reads(idx, recs, device="cpu").tuples
    try:
        faults.install("map:after=1:transient")
        got = map_reads(idx, recs, device="cpu")
        assert got.tuples == want and not got.failed
        faults.install("map:every=1:permanent")
        dead = map_reads(idx, recs, device="cpu")
        assert dead.tuples == [None] * len(recs)
        assert set(dead.failed) == set(range(len(recs)))
        assert dead.stats["failed"] == len(recs)
    finally:
        faults.install(None)


def test_tuple_stream_round_trip(ref, indexes):
    rng = np.random.default_rng(21)
    recs, _ = _sim_reads(rng, ref[1], 20, 80)
    tuples = map_reads(indexes[1], recs, device="cpu").tuples
    back = parse_tuples(format_tuples(tuples))
    assert back == [t for t in tuples if t is not None]
    with pytest.raises(ValueError, match="6 fields"):
        parse_tuples(b"chr1\t0\t5\n")


@pytest.mark.parametrize("window", [250, 7, 1000])
def test_fused_depth_equals_rerun_and_reference(ref, indexes, window):
    rng = np.random.default_rng(22)
    recs, _ = _sim_reads(rng, ref[1], 40, 100)
    tuples = map_reads(indexes[1], recs, device="cpu").tuples
    lengths = {c: len(s) for c, s in ref[1].items()}
    before = depth_kernel.LAUNCHES["depth"]
    fused = depth_bed_from_tuples(tuples, lengths, window, device="cpu")
    assert depth_kernel.LAUNCHES["depth"] == before  # plain on the CPU
    rerun = depth_bed_from_tuples(parse_tuples(format_tuples(tuples)),
                                  lengths, window, device="cpu")
    assert fused == rerun and fused
    assert fused == ref_depth_bed(tuples, lengths, window)
    rows = [ln.split(b"\t") for ln in fused.splitlines()]
    for chrom in {r[0] for r in rows}:
        spans = [(int(r[1]), int(r[2])) for r in rows if r[0] == chrom]
        assert spans[0][0] == 0 and spans[-1][1] == lengths[chrom.decode()]


def test_depth_bed_of_an_unknown_chromosome_matches_reference():
    tuples = [("chrX", 10, 60, "a", 5, "+"), ("chr1", 0, 40, "b", 5, "-"),
              ("chrX", 30, 90, "c", 5, "+"), None]
    lengths = {"chr1": 100}
    assert depth_bed_from_tuples(tuples, lengths, 25, device="cpu") == \
        ref_depth_bed(tuples, lengths, 25)


def test_depth_segments_keep_read_order_and_pad_to_a_bucket():
    """The depth kernel's inputs on the --depth-out path: known
    chromosomes first by name, then the rest ending at their last
    segment; segments in read order (empty ones dropped), padded with
    masked zeros to ``bucket_size``."""
    from goleft_tpu_torch.ops.coverage import bucket_size

    tuples = [("chrX", 10, 60, "a", 5, "+"), ("chr2", 70, 90, "b", 5, "-"),
              None, ("chr2", 5, 40, "c", 5, "+"), ("chr1", 8, 8, "d", 5, "+"),
              ("chr1", 3, 9, "e", 5, "+")]
    got = list(pipeline.depth_segments(tuples, {"chr1": 50, "chr2": 100}))
    assert [(c, n) for c, n, *_ in got] == [("chr1", 50), ("chr2", 100),
                                            ("chrX", 60)]
    for (_, _, ss, se, keep), want in zip(
            got, ([(3, 9)], [(70, 90), (5, 40)], [(10, 60)])):
        n = len(want)
        assert len(ss) == len(se) == len(keep) == bucket_size(n)
        assert ss.dtype == se.dtype == np.int32
        assert list(zip(ss[:n].tolist(), se[:n].tolist())) == want
        assert keep[:n].all() and not keep[n:].any()
        assert not ss[n:].any() and not se[n:].any()


def test_more_than_128_bucket_shapes_give_the_reference_bytes(
        ref, indexes):
    """The reference caps distinct bucket shapes (stage, r_pad, [w_pad],
    batch) at 128 and sends the rest to its host oracles; the port has
    no cap (ROADMAP Queue C, noted divergences): every bucket of
    batches of 1..70 reads takes the device path, the tuples equal the
    reference's, and ``mapping.host_fallback_total`` stays 0."""
    from goleft_tpu_torch.obs import get_registry

    want_idx, idx, _ = indexes
    rng = np.random.default_rng(77)
    recs, _ = _sim_reads(rng, ref[1], 70 * 71 // 2, 64, subs=1)
    want = ref_map_reads(want_idx, recs).tuples
    got, shapes, at = [], 0, 0
    for b in range(1, 71):
        res = map_reads(idx, recs[at:at + b], device="cpu")
        got.extend(res.tuples)
        shapes += res.stats["seed_buckets"] + res.stats["extend_buckets"]
        at += b
    assert shapes > ref_pipeline.MAX_BUCKET_SIGNATURES
    assert got == want
    assert sum(t is not None for t in got) > 0.5 * len(recs)
    assert get_registry().counter("mapping.host_fallback_total").value == 0
