"""The host-service, codec and wire entries of the port's bench
(goleft_tpu_torch/bench.py), on the CPU, against the JAX package's
bench.py.

- Each new ``torch_`` entry's keys are the reference entry's, apart
  from the card's provenance (``device``, ``nvidia_smi``) on the entries
  that do device work and the two noted divergences: ``torch_wire_decode``
  has no ``device_pallas_mb_s`` (the port's one device lane is the rANS
  kernel, reported under ``device_scan_*``), and the recovery entries
  are recorded as skipped under ``--suite-host`` on a host with no card.
  The cheap entries are run on both sides at toy sizes; the others are
  held against the reference's keys as its bench.py writes them.
- ``torch_cram31_codec_decode`` decodes every codec to its input, or
  raises.
- The serve and fleet throughput entries run with ``device="cpu"``; the
  two recovery entries run once each with the CPU worker shim of
  tests/test_torch_fleet_e2e.py in place of the card's ``serve``.
- Without a card, a ``--suite-host`` run starts no worker process.
"""

import functools
import importlib.util
import os
import subprocess
import sys

import pytest
import torch

from goleft_tpu_torch import bench
from test_torch_fleet_e2e import CPU_SERVE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
#: what ``provenance(dev)`` adds to the reference's ``platform``
PROVENANCE = {"device", "nvidia_smi"}
SHIM = (sys.executable, "-c", CPU_SERVE)


@pytest.fixture(scope="module")
def ref_bench():
    spec = importlib.util.spec_from_file_location(
        "goleft_bench_reference_host", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(d: dict, depth: int = 2) -> set:
    """Dotted key paths of a nested entry, ``depth`` levels down (the
    per-codec and per-phase blocks included)."""
    out = set()
    for k, v in d.items():
        out.add(k)
        if depth > 1 and isinstance(v, dict) and k not in (
                "curve_seconds", "batch_size_hist", "routed_per_worker",
                "cache", "latency_s"):
            out |= {f"{k}.{s}" for s in _keys(v, depth - 1)}
    return out


# ---------------- the cheap entries, both sides at toy sizes ----------


def test_decode_thread_scaling_keys(ref_bench, monkeypatch):
    from goleft_tpu.utils import decode_scaling as jds

    monkeypatch.setattr(jds, "build_cohort", functools.partial(
        jds.build_cohort, n_files=2, ref_len=50_000))
    want = ref_bench._thread_scaling_entry()
    got = bench.bench_decode_thread_scaling(n_files=2, ref_len=50_000)
    assert "error" not in want, want
    assert _keys(got) == _keys(want)
    assert got["platform"] == want["platform"] == "host (no device work)"
    assert set(got["curve_seconds"]) == set(want["curve_seconds"])


def test_cram31_codec_decode_keys_and_equality(ref_bench):
    want = ref_bench._cram31_codec_entry_inner(True)
    got = bench.bench_cram31_codec_decode(True, n=16_384)
    assert _keys(got) == _keys(want)
    assert got["native_lib"] is True
    assert set(got["codecs"]) == {"rans_nx16_o0", "rans_nx16_o1",
                                  "arith_o0", "arith_o1", "fqzcomp",
                                  "tok3_names"}
    assert all(c["decode_mb_per_sec"] > 0 for c in got["codecs"].values())


def test_codec_entry_raises_on_a_wrong_decode(monkeypatch):
    from goleft_tpu_torch.io import tok3

    real = tok3.decode
    monkeypatch.setattr(tok3, "decode",
                        lambda e, n: real(e, n)[:-1] + b"\x01")
    with pytest.raises(AssertionError, match="tok3_names"):
        bench.bench_cram31_codec_decode(True, n=8192)


@pytest.mark.parametrize("name", ["remote_fetch", "profiler_overhead",
                                  "memory_overhead"])
def test_host_entry_keys(ref_bench, name):
    want = getattr(ref_bench, f"_{name}_entry")(True)
    small = {"remote_fetch": dict(size_mb=1),
             "profiler_overhead": dict(length=100_000, reps=2),
             "memory_overhead": dict(length=100_000, reps=2)}[name]
    got = getattr(bench, f"bench_{name}")(True, **small)
    assert _keys(got) == _keys(want)
    assert got.get("platform") == want.get("platform")


def test_cohort_resume_overhead_keys(monkeypatch):
    from goleft_tpu.resilience.overhead import measure_resume_overhead

    small = dict(n_samples=2, ref_len=100_000, repeats=1)
    want = measure_resume_overhead(quick=True, **small)
    got = bench.bench_cohort_resume_overhead(True, CPU, **small)
    assert _keys(got) == _keys(want) | PROVENANCE
    assert got["platform"] == "cpu" and got["committed_shards"] > 0


# ---------------- the rest, against the reference's written keys ------

#: the reference's entries as bench.py writes them (its serve, fleet and
#: wire entries need its daemon, router and Pallas interpreter at their
#: own sizes, so their keys are held here)
REF_KEYS = {
    "serve_throughput": {
        "platform", "clients", "requests_per_phase", "ref_bp",
        "batch_size_hist", "cache", "note", "cold", "warm",
        "cold.req_per_sec", "cold.latency_s", "warm.req_per_sec",
        "warm.latency_s"},
    "fleet_throughput": {
        "platform", "clients", "requests_per_phase", "workers", "ref_bp",
        "note", "single", "fleet", "router_overhead_frac",
        "single.req_per_sec", "single.latency_s", "fleet.req_per_sec",
        "fleet.latency_s", "fleet.routed_per_worker",
        "fleet.affinity_hits", "fleet.retries"},
    "fleet_restart_recovery_s": {
        "workers", "trials", "recovery_seconds", "recovery_s_each",
        "platform", "note"},
    "fleet_failover_recovery_s": {
        "fleets", "workers_per_fleet", "trials", "failover_seconds",
        "recovery_seconds", "failover_s_each", "recovery_s_each",
        "platform", "note"},
    "wire_decode": {
        "blocks", "block_bytes", "payload", "host", "order1", "stripe",
        "device_scan_mb_s", "device_scan_gbases_s", "device_pallas_mb_s",
        "wire_bytes_compressed", "wire_bytes_uncompressed", "wire_ratio",
        "platform", "device", "device_kind", "note",
        "host.scalar_n4_mb_s", "host.scalar_x32_mb_s",
        "host.vectorized_x32_mb_s", "host.vectorized_over_scalar_x32",
        "order1.scalar_n4_mb_s", "order1.scalar_x32_mb_s",
        "order1.vectorized_x32_mb_s",
        "order1.vectorized_over_scalar_x32", "order1.device_scan_mb_s",
        "stripe.host_mb_s", "stripe.device_scan_mb_s"},
}


def test_reference_keys_are_the_reference_sources():
    """Each key held above is written by the reference's entry."""
    src = open(os.path.join(REPO, "bench.py")).read()
    for keys in REF_KEYS.values():
        for k in keys:
            assert f'"{k.rsplit(".", 1)[-1]}"' in src, k


@pytest.mark.parametrize("name", ["serve_throughput", "fleet_throughput"])
def test_serve_and_fleet_throughput_on_the_cpu(name):
    got = getattr(bench, f"bench_{name}")(True, CPU, n_clients=2,
                                          n_requests=4, ref_len=20_000)
    assert _keys(got) == REF_KEYS[name] | PROVENANCE
    assert got["platform"] == "cpu" and got["device"] == "cpu"
    for phase in (("cold", "warm") if name == "serve_throughput"
                  else ("single", "fleet")):
        assert got[phase]["req_per_sec"] > 0
        assert got[phase]["latency_s"]["count"] == 4
    if name == "fleet_throughput":
        assert sum(got["fleet"]["routed_per_worker"].values()) >= 4


def test_wire_decode_drops_only_the_pallas_lane():
    got = bench.bench_wire_decode(True, CPU, bs=2048, nb=3)
    assert "device_pallas_mb_s" not in got
    assert _keys(got) == (REF_KEYS["wire_decode"]
                          - {"device_pallas_mb_s"}) | {"nvidia_smi"}
    assert got["platform"] == "cpu" and got["device_kind"] == "cpu"
    assert got["device_scan_mb_s"] > 0 and got["order1"][
        "device_scan_mb_s"] > 0 and got["stripe"]["device_scan_mb_s"] > 0
    assert 0 < got["wire_ratio"] < 1


def test_wire_decode_raises_when_the_device_lane_diverges(monkeypatch):
    from goleft_tpu_torch.ops import rans_device as rd

    real = rd.decode_streams
    monkeypatch.setattr(
        rd, "decode_streams",
        lambda encs, lens, device=None: [None] + real(encs, lens,
                                                      device=device)[1:])
    with pytest.raises(AssertionError, match="device lane"):
        bench.bench_wire_decode(True, CPU, bs=2048, nb=3)


@pytest.mark.parametrize("name", ["fleet_restart_recovery_s",
                                  "fleet_failover_recovery_s"])
def test_recovery_entries_with_the_cpu_worker_shim(name):
    fn = {"fleet_restart_recovery_s": bench.bench_fleet_restart_recovery,
          "fleet_failover_recovery_s":
              bench.bench_fleet_failover_recovery}[name]
    got = fn(True, CPU, worker_cmd=SHIM)
    assert _keys(got) == REF_KEYS[name] | PROVENANCE
    assert got["platform"] == "cpu" and got["trials"] == 1
    assert got["recovery_seconds"] > 0
    assert got.get("failover_seconds", 1) > 0


def test_suite_host_without_a_card_skips_the_recovery_entries(
        tmp_path, monkeypatch):
    """Under --suite-host on a host with no card the two entries are
    recorded as skipped (a noted divergence: the reference runs them
    wherever JAX runs) and no process is started."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    real_popen = subprocess.Popen

    def popen(*a, **k):
        started.append(a[0] if a else k.get("args"))
        return real_popen(*a, **k)

    monkeypatch.setattr(subprocess, "Popen", popen)
    stub = {"platform": "cpu", "device": "cpu"}
    entries = [n for n in dir(bench) if n.startswith("bench_")
               and n not in ("bench_fleet_restart_recovery",
                             "bench_fleet_failover_recovery")]
    for n in entries:
        monkeypatch.setattr(bench, n, lambda *a, **k: dict(stub))
    monkeypatch.setattr(bench, "bench_cohort", lambda *a, **k: dict(
        stub, gbases_per_sec=1.0, numpy_kernel_gbases_per_sec=1.0,
        samples=1, ref_bp=1, coverage=1, wall_seconds_warm=1.0,
        stage_seconds={}, nvidia_smi="not available"))
    out = bench.OutDir(str(tmp_path / "o"))
    _, errors = bench.run_suite(out, CPU, quick=True, suite_host=True)
    assert errors == [] and started == []
    det = bench._read_json(out.details)
    for key in ("torch_fleet_restart_recovery_s",
                "torch_fleet_failover_recovery_s"):
        assert det[key] == bench.NO_CARD_SKIP
        assert "card" in det[key]["skipped"]
