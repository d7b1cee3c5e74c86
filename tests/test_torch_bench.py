"""The port's benchmark suite (goleft_tpu_torch/bench.py), on the CPU.

The last-good and pinned-baseline cases of the JAX package's
tests/test_bench_lastgood.py on the bench's output directory; the
workload and the numpy baseline equal the reference bench's for a seed;
the cohort, whole-genome-depth, pair-HMM and mapping entries at toy
sizes with ``device="cpu"``, each on the same fixture as the reference
(the oracle): the same output bytes, or likelihoods within the
reference's stated tolerance (5e-5 log10, XLA's inexact CPU ``exp2``),
or the same tuples. Then the command: ``--suite-host --quick`` at toy
sizes labels every device entry cpu (the host entries keep the JAX
package's labels; the recovery entries are skipped without a card) and
writes only under ``--out-dir``; no
card and no ``--suite-host`` exits nonzero before any entry; an entry
that raises makes the command exit nonzero.
"""

import functools
import importlib.util
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from goleft_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _reference_bench():
    spec = importlib.util.spec_from_file_location(
        "goleft_bench_reference", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _out(tmp_path, details):
    out = bench.OutDir(str(tmp_path / "out"))
    with open(out.details, "w") as fh:
        json.dump(details, fh)
    return out


# ---------------- lastgood and the pinned baseline ----------------


def test_save_load_roundtrip_excludes_errored_entries(tmp_path):
    out = _out(tmp_path, {
        "torch_device_kernels": {
            "platform": "cuda", "device": "NVIDIA H100 80GB HBM3",
            "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W",
            "kernel_device_resident_gbases_per_sec": 2.8},
        "torch_indexcov_cohort": {"samples": 100, "seconds": 0.003,
                                  "platform": "cuda"},
        "torch_emdepth_em": {"error": "RuntimeError('launch')"},
        "torch_cohort_e2e": {"gbases_per_sec": 0.3, "platform": "cuda"},
    })
    assert bench.save_lastgood(out)
    doc = bench.load_lastgood(out)
    assert doc["provenance"]["ts"]
    assert doc["provenance"]["device"] == "NVIDIA H100 80GB HBM3"
    assert doc["provenance"]["nvidia_smi"].endswith("700.00 W")
    assert set(doc["entries"]) == {"torch_device_kernels",
                                   "torch_indexcov_cohort"}
    assert os.path.dirname(out.lastgood) == out.path


def test_save_refuses_host_only_run(tmp_path):
    out = _out(tmp_path, {"torch_device_kernels": {"platform": "cpu"}})
    assert not bench.save_lastgood(out)
    assert not os.path.exists(out.lastgood)
    assert bench.load_lastgood(out) is None


def test_save_pins_only_entries_with_own_device_platform(tmp_path):
    out = _out(tmp_path, {
        "torch_device_kernels": {"platform": "cuda", "device": "H100",
                                 "kernel_device_resident_gbases_per_sec":
                                     2.8},
        "torch_depth_wholegenome": {"platform": "cpu",
                                    "seconds_warm": 9.9},
        "torch_cohort_e2e_device": {"platform": "host (x)",
                                    "hybrid_gbases_per_sec": 0.1},
        "torch_kernel_vs_plain_depth": {"kernel_ms": 1.0},
        "torch_emdepth_em": {"platform": "cuda", "seconds": 0.01},
    })
    assert bench.save_lastgood(out)
    assert set(bench.load_lastgood(out)["entries"]) == {
        "torch_device_kernels", "torch_emdepth_em"}


def test_save_skipped_entirely_in_kernels_only_mode(tmp_path):
    out = _out(tmp_path, {
        "torch_device_kernels": {"platform": "cuda",
                                 "kernel_device_resident_gbases_per_sec":
                                     2.8}})
    assert not bench.save_lastgood(out, kernels_only=True)
    assert not os.path.exists(out.lastgood)


def test_drop_details_removes_stale_carryover(tmp_path):
    out = _out(tmp_path, {"device_lastgood": {"stale": True},
                          "torch_cohort_e2e": {"gbases_per_sec": 0.5}})
    bench.drop_details(out, ["device_lastgood"])
    with open(out.details) as fh:
        det = json.load(fh)
    assert "device_lastgood" not in det
    assert det["torch_cohort_e2e"]["gbases_per_sec"] == 0.5


def test_pinned_baseline_written_and_preferred(tmp_path, monkeypatch):
    out = bench.OutDir(str(tmp_path / "out"))
    cohort = {"numpy_kernel_gbases_per_sec": 0.999}
    v, info = bench._baseline_block(cohort, out)
    assert v == 0.999 and info["pinned"] is False
    # --pin-baseline's numbers, without its nine 10 Mb timings
    calls = []
    monkeypatch.setattr(bench, "numpy_pipeline",
                        lambda *a, **k: calls.append(1))
    assert bench.main(["--pin-baseline", "--out-dir", out.path]) == 0
    assert len(calls) == 10  # a first touch and nine timed runs
    pin = json.load(open(out.pinned))
    assert pin["numpy_kernel_gbases_per_sec"] > 0
    prov = pin["provenance"]
    assert prov["ts"] and len(prov["runs_seconds"]) == 9
    assert prov["workload"]["ref_bp"] == 10_000_000
    v, info = bench._baseline_block(cohort, out)
    assert v == pin["numpy_kernel_gbases_per_sec"] and info["pinned"]
    assert info["measured_this_run_gbases_per_sec"] == 0.999
    assert sorted(os.listdir(out.path)) == ["baseline_pinned.json"]


# ---------------- the workload and the numpy baseline ----------------


@pytest.mark.parametrize("seed", [0, 7])
def test_workload_and_numpy_pipeline_equal_the_references(seed):
    ref = _reference_bench()
    mine = bench.make_workload(50_000, 30, 150, seed)
    want = ref.make_workload(50_000, 30, 150, seed)
    for a, b in zip(mine, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for x, y in zip(bench.numpy_pipeline(*mine, 50_000, 250),
                    ref.numpy_pipeline(*want, 50_000, 250)):
        assert np.array_equal(x, y)


def test_roofline_uses_the_h100_peaks():
    r = bench.roofline(3.35e9, 0.002, flops=67e9, model="m")
    assert r["hbm_peak_gb_per_sec"] == 3350.0
    assert r["pct_of_hbm_peak"] == 50.0
    assert r["pct_of_fp32_peak"] == 50.0
    assert r["bound_seconds"] == pytest.approx(0.001)


# ---------------- the entries against the reference ----------------


def test_cohort_entries_write_the_references_matrix(tmp_path):
    """The headline's and the engine side-by-side's fixture is the
    reference's byte for byte, and the port's cohortdepth (both engines,
    on the CPU) writes the reference's matrix over it; then both entries
    run at toy size."""
    from goleft_tpu.commands.cohortdepth import (
        run_cohortdepth as ref_cohortdepth,
    )
    from goleft_tpu_torch.commands.cohortdepth import run_cohortdepth

    ref = _reference_bench()
    d, bams, fai, starts = bench._build_cohort_fixture(3, 200_000, 2)
    rd, rbams, _, rstarts = ref._build_cohort_fixture(3, 200_000, 2)
    try:
        assert np.array_equal(starts, rstarts)
        for a, b in zip(bams, rbams):
            assert open(a, "rb").read() == open(b, "rb").read()
        want = io.StringIO()
        ref_cohortdepth(rbams, fai=fai, window=500, out=want)
        for engine in ("hybrid", "device"):
            got = io.StringIO()
            run_cohortdepth(bams, fai=fai, window=500, out=got,
                            engine=engine, device="cpu")
            assert got.getvalue() == want.getvalue(), engine
    finally:
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(rd, ignore_errors=True)
    e = bench.bench_cohort(3, 200_000, 2, dev=CPU)
    assert e["platform"] == "cpu" and e["gbases_per_sec"] > 0
    assert set(e["stage_seconds"]) == {"open_and_index",
                                       "decode_window_reduce",
                                       "format_matrix"}
    e = bench.bench_cohort_device(3, 200_000, 2, dev=CPU)
    assert e["identical_output"] is True and e["platform"] == "cpu"
    assert e["crossover"]["chips_needed_to_beat_hybrid"] >= 1
    assert set(e["stage_seconds"]) == {"host_segment_extract",
                                       "pack_transfer_compute"}
    assert e["prefetch"]["stage_spans"]


def test_wholegenome_entry_writes_the_references_beds(tmp_path):
    from goleft_tpu.commands.depth import run_depth as ref_depth
    from goleft_tpu_torch.commands.depth import run_depth

    bam, fai, lens = bench.wholegenome_fixture(str(tmp_path), 3, 60_000)
    assert len(lens) == 3 and lens[0] > lens[2]
    ref_depth(bam, str(tmp_path / "ref"), fai=fai, window=250, mapq=20)
    run_depth(bam, str(tmp_path / "port"), fai=fai, window=250, mapq=20,
              device="cpu")
    for suffix in (".depth.bed", ".callable.bed"):
        got = open(str(tmp_path / "port") + suffix, "rb").read()
        assert got and got == open(str(tmp_path / "ref") + suffix,
                                   "rb").read()
    e = bench.bench_depth_wholegenome(True, CPU, n_chrom=3,
                                      base_len=60_000)
    assert e["platform"] == "cpu" and e["chromosomes"] == 3
    # on the CPU nothing launches and nothing builds, warm or cold
    assert e["kernel_launches_cold"] == e["kernel_launches_warm_repeat"] \
        == 0
    assert e["nvcc_builds_warm_repeat"] == 0
    assert e["no_rebuild_across_chroms"] is True
    assert set(e["stage_seconds"]) >= {"host-decode", "device-compute",
                                       "write-output"}


def test_pairhmm_entry_likelihoods_within_the_references_tolerance():
    from goleft_tpu.ops import pairhmm as ref_ph

    e = bench.bench_pairhmm_forward(True, CPU, n_pairs=6)
    reads, quals, haps = bench.pairhmm_batch(6)
    want = ref_ph.forward_pairs(reads, quals, haps)
    np.testing.assert_allclose(e["likelihoods"], want, rtol=0, atol=5e-5)
    assert e["cells"] == ref_ph.total_cells(reads, haps)
    assert e["platform"] == "cpu" and e["gcups"] > 0


def test_pairhmm_entry_gates_on_the_plain_version_before_the_clock(
        monkeypatch):
    """Likelihoods off the plain version's by more than the tolerance
    fail the entry before its timed call."""
    from goleft_tpu_torch.ops import pairhmm as ph

    real = ph.forward_pairs
    calls = []

    def off(reads, quals, haps, device=None):
        calls.append(device)
        ll = real(reads, quals, haps, device="cpu")
        return ll if device == "cpu" else ll + 10 * bench.PAIRHMM_ATOL

    monkeypatch.setattr(ph, "forward_pairs", off)
    with pytest.raises(AssertionError, match="differs from the CPU path"):
        bench.bench_pairhmm_forward(True, "gpu-stand-in", n_pairs=4)
    assert calls == ["gpu-stand-in", "cpu"]  # warm-up and oracle only


def test_mapping_entry_gives_the_references_tuples(tmp_path):
    from goleft_tpu.io.fastq import FastqRecord
    from goleft_tpu.mapping import build_index, map_reads

    e = bench.bench_read_mapping(True, CPU, ref_bp=20_000, n_reads=40)
    fa, reads = bench.mapping_inputs(str(tmp_path), 20_000, 40)
    want = map_reads(build_index(fa), [FastqRecord(*r) for r in reads])
    assert e["tuples"] == want.tuples
    assert e["mapped_frac"] == round(want.stats["mapped"] / 40, 4)
    assert e["platform"] == "cpu" and e["seed_extend_reads_s"] > 0


def test_host_scale_validation_entries():
    out = bench.host_scale_validation(CPU, ix_shape=(50, 4096),
                                      em_samples=64, em_windows=256)
    assert set(out) == {"torch_indexcov_cohort_hostcheck",
                        "torch_emdepth_em_hostcheck"}
    for e in out.values():
        assert "error" not in e, e
        assert e["platform"] == "cpu" and "validation" in e["note"]
    assert out["torch_emdepth_em_hostcheck"]["windows"] == 256


# ---------------- the command ----------------


#: the host-service and codec entries' toy sizes
TOY_HOST_ENTRIES = {
    "bench_decode_thread_scaling": dict(n_files=2, ref_len=50_000),
    "bench_cram31_codec_decode": dict(n=8192),
    "bench_serve_throughput": dict(n_clients=2, n_requests=4,
                                   ref_len=20_000),
    "bench_fleet_throughput": dict(n_clients=2, n_requests=4,
                                   ref_len=20_000),
    "bench_cohort_resume_overhead": dict(n_samples=2, ref_len=100_000,
                                         repeats=1),
    "bench_wire_decode": dict(bs=2048, nb=3),
    "bench_remote_fetch": dict(size_mb=1),
    "bench_profiler_overhead": dict(length=100_000, reps=2),
    "bench_memory_overhead": dict(length=100_000, reps=2),
}

#: each host entry's platform label, the JAX package's (None: it has
#: none); the recovery entries are skipped on a host with no card
HOST_LABELS = {
    "torch_decode_thread_scaling": "host (no device work)",
    "torch_cram31_codec_decode": None,
    "torch_fleet_restart_recovery_s": "cpu",
    "torch_fleet_failover_recovery_s": "cpu",
    "torch_remote_fetch": "cpu",
    "torch_profiler_overhead": None,
    "torch_memory_overhead": None,
}


def _toy(monkeypatch):
    """Every entry of a --suite-host --quick run at toy size."""
    monkeypatch.setattr(bench, "COHORT_SIZES",
                        {True: (3, 200_000, 2), False: (3, 200_000, 2)})
    monkeypatch.setattr(bench, "COHORT_DEVICE_SIZES",
                        {True: (2, 100_000, 2), False: (2, 100_000, 2)})
    for name, kw in (("bench_depth_wholegenome",
                      dict(n_chrom=2, base_len=40_000)),
                     ("bench_indexcov_e2e",
                      dict(n_ix=2, chrom_lens=[1_000_000, 600_000])),
                     ("bench_pairhmm_forward", dict(n_pairs=4)),
                     ("bench_read_mapping",
                      dict(ref_bp=10_000, n_reads=20)),
                     *TOY_HOST_ENTRIES.items()):
        monkeypatch.setattr(bench, name,
                            functools.partial(getattr(bench, name), **kw))


def test_suite_host_labels_cpu_and_writes_only_the_out_dir(
        tmp_path, monkeypatch, capsys):
    _toy(monkeypatch)
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    decoys = {"PERF_LEDGER.jsonl": '{"decoy": 1}\n',
              "BENCH_details.json": "{}\n", "BENCH_lastgood.json": "{}\n",
              "BASELINE_PINNED.json": "{}\n",
              ".gtlint_baseline.json": "{}\n"}
    for n, text in decoys.items():
        (cwd / n).write_text(text)
    monkeypatch.chdir(cwd)
    assert bench.main(["--suite-host", "--quick", "--no-probe",
                       "--out-dir", "o"]) == 0
    head = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert head["metric"] == "torch_cohort_depth_e2e_gbases_per_sec"
    assert head["value"] > 0 and head["config"]["platform"] == "cpu"
    assert sorted(os.listdir(cwd)) == sorted(list(decoys) + ["o"])
    for n, text in decoys.items():
        assert (cwd / n).read_text() == text
    assert sorted(os.listdir(cwd / "o")) == ["details.json",
                                             "ledger.jsonl"]
    det = json.load(open(cwd / "o" / "details.json"))
    assert set(det) == {"torch_depth_wholegenome",
                        "torch_indexcov_e2e_wholegenome",
                        "torch_cohort_e2e_device", "torch_cohort_e2e",
                        "torch_pairhmm_forward", "torch_read_mapping",
                        "torch_serve_throughput", "torch_fleet_throughput",
                        "torch_cohort_resume_overhead",
                        "torch_wire_decode", *HOST_LABELS}
    for name, entry in det.items():
        assert name.startswith("torch_") and "error" not in entry, entry
        if name in HOST_LABELS:
            assert entry.get("platform") == HOST_LABELS[name], entry
        else:
            assert entry["platform"] == "cpu" and entry["device"] == "cpu"
    from goleft_tpu_torch.obs import ledger

    recs = ledger.read_ledger(str(cwd / "o" / "ledger.jsonl"))
    assert {r["entry"] for r in recs} == set(det) | {head["metric"]}
    # the host entries the JAX package labels with no platform are of
    # unknown provenance in the ledger; every other record is host
    assert {r["entry"] for r in recs if r["provenance"] != "host"} == {
        n for n, lab in HOST_LABELS.items() if lab is None}


def test_no_card_and_no_suite_host_runs_no_entry(tmp_path, monkeypatch):
    """Without a card the command raises NoCudaDevice before any entry
    (the dispatcher turns it into exit 1 and one line); nothing falls
    back to the CPU."""
    from goleft_tpu_torch import cli, device
    from goleft_tpu_torch.errors import NoCudaDevice

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(bench, "run_suite",
                        lambda *a, **k: ran.append(1))
    out = str(tmp_path / "o")
    with pytest.raises(NoCudaDevice):
        bench.main(["--quick", "--out-dir", out])
    assert ran == [] and os.listdir(out) == []
    assert device.resolve_device("cpu").type == "cpu"
    assert cli.main(["bench", "--quick", "--out-dir", out]) == 1
    assert ran == [] and os.listdir(out) == []


@pytest.mark.parametrize("argv,want", [
    (["--quick"], "cuda"),
    (["--quick", "--suite-host"], "cpu"),
    (["--suite-h", "--out-dir", "o"], "cpu"),
    (["--pin-baseline"], None),
    (["--out-dir"], None),
])
def test_run_device_is_the_manifests_backend(argv, want):
    """The device ``bench`` runs on with its argv, as the dispatcher
    writes it into the run manifest: the card, the CPU under
    --suite-host (as argparse abbreviates it), none for the numpy-only
    --pin-baseline or an argv that does not parse."""
    from goleft_tpu_torch import cli

    assert bench.run_device(argv) == want
    assert cli._device_of("bench", argv) == want
    assert cli._device_of("depth", argv) == "cuda"
    assert cli._device_of("perf", argv) is None


def test_an_entry_that_raises_makes_the_command_fail(
        tmp_path, monkeypatch, capsys):
    _toy(monkeypatch)

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(bench, "bench_pairhmm_forward", boom)
    out = str(tmp_path / "o")
    assert bench.main(["--suite-host", "--quick", "--out-dir", out]) == 1
    cap = capsys.readouterr()
    head = json.loads(cap.out.strip().splitlines()[-1])
    assert head["value"] > 0  # the headline is still printed
    assert "torch_pairhmm_forward" in cap.err
    det = json.load(open(os.path.join(out, "details.json")))
    assert "injected" in det["torch_pairhmm_forward"]["error"]
    assert "error" not in det["torch_read_mapping"]  # the suite went on
