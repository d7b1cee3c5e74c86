"""The port's obs/provenance.py against the JAX package's: the one place
that answers "what ran this" for the run manifest, the device spans and
the bench; its environment block has the reference's keys; the card's
backend block is asked once a process and device type; the module loads
no torch at import; and a host command's manifest keeps its blocks."""

import json
import os
import subprocess
import sys

import pytest

from goleft_tpu.obs import provenance as jprov
from goleft_tpu_torch import bench, cli, obs
from goleft_tpu_torch.obs import manifest
from goleft_tpu_torch.obs import provenance as prov

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_module_loads_no_torch():
    code = ("import sys\n"
            "import goleft_tpu_torch.obs.provenance as p\n"
            "p.env_provenance(); p.nvidia_smi_line()\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
            "             & {'torch', 'jax', 'jaxlib', 'goleft_tpu'})\n"
            "print('LOADED', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_callers_take_provenance_from_the_one_module():
    from goleft_tpu_torch import device

    assert manifest.backend_provenance is prov.backend_provenance
    assert manifest.env_provenance is prov.env_provenance
    for name in ("backend_provenance", "card_provenance",
                 "nvidia_smi_line", "env_provenance"):
        assert not hasattr(device, name), name
    assert not hasattr(obs, "_device_attrs")
    src = open(bench.__file__).read()
    assert "from .obs.provenance import nvidia_smi_line" in src


@pytest.mark.parametrize("knobs", [{}, {"GOLEFT_TPU_PROBE": "0"}])
def test_env_provenance_keys_are_the_references(monkeypatch, knobs):
    for k in list(os.environ):
        if k.startswith(("GOLEFT_TPU_", "JAX_PLATFORM",
                         "CUDA_VISIBLE_DEVICES")):
            monkeypatch.delenv(k)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    got, want = prov.env_provenance(), jprov.env_provenance()
    assert set(got) == set(want)
    assert {k: got[k] for k in got if k != "env_knobs"} \
        == {k: want[k] for k in want if k != "env_knobs"}
    assert got.get("env_knobs") == want.get("env_knobs") \
        == (knobs or None)


def test_env_knobs_are_the_ports_prefixes(monkeypatch):
    monkeypatch.setenv("GOLEFT_TPU_DEVICE_WATCHDOG_SECONDS", "9")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    knobs = prov.env_provenance()["env_knobs"]
    assert knobs["GOLEFT_TPU_DEVICE_WATCHDOG_SECONDS"] == "9"
    assert knobs["CUDA_VISIBLE_DEVICES"] == "0"
    assert "JAX_PLATFORMS" not in knobs


def test_backend_provenance_is_asked_once_a_device_type(monkeypatch):
    calls = []
    real = prov.card_provenance

    def counted():
        calls.append(1)
        return real()

    monkeypatch.setattr(prov, "card_provenance", counted)
    monkeypatch.setattr(prov, "_backend", {})
    a = prov.backend_provenance()
    b = prov.backend_provenance("cuda")
    c = prov.backend_provenance("cuda:0")
    assert a == b == c and len(calls) == 1
    a["platform"] = "changed"  # a copy: the cache is not the caller's
    assert prov.backend_provenance()["platform"] != "changed"
    cpu = prov.backend_provenance("cpu")
    assert len(calls) == 2
    assert cpu["platform"] == "cpu" and cpu["device_kind"] == "cpu" \
        and cpu["device_count"] == 1
    prov._backend.clear()  # a new process
    prov.backend_provenance("cuda")
    assert len(calls) == 3


def test_backend_block_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    rec = prov.backend_provenance("cuda")
    assert rec == {"torch": torch.__version__, "cuda": torch.version.cuda,
                   "device": "cpu", "device_count": 1,
                   "nvidia_smi": "not available", "platform": "cpu",
                   "device_kind": "cpu"}


def test_device_spans_carry_the_backend_block(monkeypatch):
    monkeypatch.setattr(prov, "_backend", {
        "cuda": {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
                 "device_count": 1, "device": "NVIDIA H100 80GB HBM3",
                 "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"}})
    assert prov.device_span_attrs() == {
        "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
        "device_count": 1}
    tracer = obs.get_tracer()
    tracer.clear()
    with obs.device_span("device.x", "cuda", fenced=True):
        pass
    (span,) = [s for s in tracer.snapshot() if s.name == "device.x"]
    assert {k: span.attrs[k] for k in ("platform", "device_kind",
                                       "device_count")} \
        == prov.device_span_attrs("cuda")
    tracer.clear()


def test_manifest_backend_is_the_provenance_block(tmp_path):
    doc = manifest.write_manifest(str(tmp_path / "m.json"), argv=["x"],
                                  device="cpu")
    assert doc["backend"] == prov.backend_provenance("cpu")
    assert set(doc["env"]) <= set(prov.env_provenance()) | {"env_knobs"}


#: a host command's manifest: the blocks and keys it had before
#: obs/provenance.py, and the reference's spans_dropped / spans_truncated
HOST_KEYS = ["schema", "ts", "argv", "env", "backend", "spans",
             "spans_dropped", "spans_truncated", "metrics", "trace_id",
             "command", "exit_code", "import_seconds", "kernel_launches",
             "native_io"]


def test_host_command_manifest_is_unchanged(tmp_path, capsys):
    from goleft_tpu.obs.manifest import load_manifest

    path = str(tmp_path / "m.json")
    obs.get_tracer().clear()  # no other test's spans in the ring
    assert cli.main(["--metrics-out", path, "samplename", "/dev/null"]) == 1
    capsys.readouterr()
    with open(path) as fh:
        doc = json.load(fh)
    assert list(doc) == HOST_KEYS
    assert doc["backend"] == manifest.HOST_BACKEND == {
        "platform": "cpu", "device_kind": "cpu", "device_count": 1,
        "device": "none (host command)"}
    assert doc["kernel_launches"] == {} and doc["exit_code"] == 1
    assert doc["spans_dropped"] == 0 and doc["spans_truncated"] is False
    assert set(doc["env"]) <= {"python", "machine", "node",
                               "effective_cores", "pid", "env_knobs"}
    assert load_manifest(path)["command"] == "samplename"
    ref = jprov.env_provenance()
    assert set(doc["env"]) - {"env_knobs"} == set(ref) - {"env_knobs"}
