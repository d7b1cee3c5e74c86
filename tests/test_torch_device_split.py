"""The split over a host's devices, on the CPU with ``["cpu", "cpu"]``
(and three, where a chunk's rows need mean-row padding): ``_batched_em``
with its EM_CHUNK chunks over the devices, bitwise one device's;
cohortdepth's device engine with the samples over the devices, the same
matrix bytes as one device; ``sharded_pca`` with the Gram step's rows
over the devices, within tests/test_torch_cohort_pca.py's tolerances of
the JAX package's (whose tests split over 8 virtual devices) and of the
exact SVD. Then the two measurements of the slice: the resume overhead
and the poison-bisection bench."""

import numpy as np
import pytest

from goleft_tpu_torch.commands import emdepth_cmd as tcmd
from goleft_tpu_torch.device import resolve_devices


def test_resolve_devices():
    assert [d.type for d in resolve_devices(["cpu", "cpu"])] == ["cpu"] * 2
    assert [d.type for d in resolve_devices(device="cpu")] == ["cpu"]
    with pytest.raises(ValueError):
        resolve_devices([])


@pytest.mark.parametrize("n_dev", [2, 3])
def test_batched_em_split_is_bitwise(monkeypatch, n_dev):
    """Five chunks of 16 windows over 2 or 3 devices: λ and CN bitwise
    those of one device, on the int16 matrix cnv hands it."""
    monkeypatch.setattr(tcmd, "EM_CHUNK", 16)
    rng = np.random.default_rng(3)
    depths = rng.poisson(30, (70, 9)).astype(np.int16)
    depths[20:40, 4] //= 2
    med, medmed = tcmd.sample_medians(depths)
    one = tcmd._batched_em(depths, med, medmed, device="cpu")
    split = tcmd._batched_em(depths, med, medmed,
                             devices=["cpu"] * n_dev)
    for a, b in zip(one, split):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (one[1][20:40, 4] < 2).any()  # the halved sample is called


def _bam_cohort(d, n=5):
    from goleft_tpu.io.fai import write_fai
    from helpers import write_bam_and_bai, write_fasta

    rng = np.random.default_rng(8)
    ref_len = 60_000
    fa = write_fasta(str(d / "ref.fa"), {"chr1": "A" * ref_len})
    write_fai(fa)
    bams = []
    for i in range(n):
        starts = np.sort(rng.integers(0, ref_len - 100, size=1200))
        reads = [(0, int(s), "100M", 60, 0) for s in starts]
        hdr = ("@HD\tVN:1.6\tSO:coordinate\n"
               f"@SQ\tSN:chr1\tLN:{ref_len}\n@RG\tID:r\tSM:s{i}\n")
        p = str(d / f"s{i}.bam")
        write_bam_and_bai(p, reads, ref_names=("chr1",),
                          ref_lens=(ref_len,), header_text=hdr)
        bams.append(p)
    return fa, bams


def test_cohortdepth_device_engine_split_byte_identical(tmp_path,
                                                        monkeypatch):
    """The device engine with the samples over two devices: each device
    runs its block of samples, the matrix is one device's, byte for
    byte."""
    from goleft_tpu_torch.commands import cohortdepth as cd
    from goleft_tpu_torch.commands import depth as depth_mod
    from goleft_tpu_torch.resilience.policy import Quarantine

    monkeypatch.setattr(depth_mod, "STEP", 20_000)  # 3 shards
    fa, bams = _bam_cohort(tmp_path)
    used = []
    orig = depth_mod.DepthEngine.run_segments

    def run_segments(self, *a, **kw):
        used.append(id(self))
        return orig(self, *a, **kw)

    monkeypatch.setattr(depth_mod.DepthEngine, "run_segments",
                        run_segments)
    mats = {}
    for name, devs in (("one", ["cpu"]), ("two", ["cpu", "cpu"])):
        used.clear()
        names, blocks = cd.cohort_matrix_blocks(
            bams, fai=fa + ".fai", window=500, processes=2,
            engine="device", quarantine=Quarantine(), device="cpu",
            devices=devs)
        mats[name] = "".join(cd.format_block(*b) for b in blocks)
        assert len(set(used)) == len(devs)
        assert len(used) == 3 * len(bams)
    assert mats["one"] == mats["two"]
    from goleft_tpu.commands.cohortdepth import run_cohortdepth

    import io

    ref = io.StringIO()
    monkeypatch.setattr("goleft_tpu.commands.depth.STEP", 20_000)
    run_cohortdepth(bams, fai=fa + ".fai", window=500, out=ref,
                    engine="device")
    assert ref.getvalue().split("\n", 1)[1] == mats["two"]


@pytest.mark.parametrize("n_dev", [2, 3])
def test_sharded_pca_split_within_tolerances(n_dev):
    from goleft_tpu.cohort.pca import sharded_pca as jsharded
    from goleft_tpu_torch.cohort.pca import sharded_pca
    from goleft_tpu_torch.ops.indexcov_ops import pca_project
    from test_cohort_pca import _chunks, _rank_separated

    rng = np.random.default_rng(42)
    x = _rank_separated(rng, n=60, bins=48, k=4)
    kw = {"iters": 48, "seed": 3}
    got = sharded_pca(_chunks(x, 13), k=4, devices=["cpu"] * n_dev, **kw)
    want = jsharded(_chunks(x, 13), k=4, **kw)
    np.testing.assert_allclose(got.components_, want.components_,
                               rtol=1e-6, atol=1e-6 * np.abs(
                                   want.components_).max())
    np.testing.assert_allclose(got.frac_, want.frac_, rtol=1e-6)
    _, want_frac = pca_project(x, k=4, device="cpu")
    np.testing.assert_allclose(got.frac_, want_frac.numpy(), rtol=1e-4,
                               atol=1e-5)
    one = sharded_pca(_chunks(x, 13), k=4, device="cpu", **kw)
    np.testing.assert_allclose(got.components_, one.components_,
                               rtol=1e-6, atol=1e-6 * np.abs(
                                   one.components_).max())


def test_measure_resume_overhead_keys():
    from goleft_tpu_torch.resilience.overhead import measure_resume_overhead

    r = measure_resume_overhead(quick=True, device="cpu", repeats=1)
    assert set(r) == {"samples", "regions", "window", "ref_len",
                      "committed_shards", "seconds_plain",
                      "seconds_checkpointed", "seconds_resumed",
                      "overhead_frac", "resume_speedup", "platform", "note"}
    assert r["platform"] == "cpu"
    assert r["committed_shards"] == r["samples"] * r["regions"]
    assert r["seconds_plain"] > 0 and r["seconds_resumed"] > 0


def test_bisect_bench_same_passes_and_decision():
    from goleft_tpu.serve import bisect_bench as jbb
    from goleft_tpu_torch.serve import bisect_bench as tbb

    # passes of 24-40 ms, each time the best of the reference's default
    # 3 repeats: one repeat of ~10 ms passes let a scheduler stall under
    # loaded xdist workers push a serial run past the 1.15 threshold
    # (on either package's side)
    kw = dict(batch_sizes=(4, 5), overhead_s=0.02, per_item_s=0.004,
              repeats=3)
    got, want = tbb.measure(**kw), jbb.measure(**kw)
    assert set(got) == set(want)
    for g, w in zip(got["entries"], want["entries"]):
        assert g["batch"] == w["batch"]
        for regime in ("device_locked", "free_device"):
            for mode in ("serial", "parallel"):
                assert g[regime][mode]["passes"] == \
                    w[regime][mode]["passes"]
    # passes serialise on the device lock: parallel halves cannot pay
    assert got["decision"] == want["decision"] == "serial"


def test_bisect_bench_cli(capsys, monkeypatch):
    import json

    from goleft_tpu_torch.serve import bisect_bench as tbb

    orig = tbb.measure
    monkeypatch.setattr(tbb, "measure", lambda: orig(
        batch_sizes=(4,), overhead_s=0.001, per_item_s=0.0001, repeats=1))
    assert tbb.main(["--json"]) == 0
    assert json.loads(capsys.readouterr().out)["entries"][0]["batch"] == 4
    assert tbb.main([]) == 0
    assert "decision:" in capsys.readouterr().out
