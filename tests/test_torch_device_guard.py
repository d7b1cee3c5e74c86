"""The port's device bring-up guard (goleft_tpu_torch/utils/device_guard.py)
against the JAX package's tests/test_device_guard.py: the watchdog warns
on a slow bring-up and stays silent on a fast one, the subprocess probe
records a hung child's traceback, and its caches behave as the
reference's. Where the reference steps down to the host (a failed,
hung or cached-failed probe), the port raises NoCudaDevice with one
line; ``GOLEFT_TPU_CPU`` does not exist in the port."""

import logging
import os
import subprocess
import sys
import textwrap
import time

import pytest

from goleft_tpu.utils import device_guard as jguard
from goleft_tpu_torch import cli
from goleft_tpu_torch.errors import NoCudaDevice
from goleft_tpu_torch.utils import device_guard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGGER = "goleft-tpu-torch.device"

HANG = [sys.executable, "-c", "import time; time.sleep(3)"]
FAIL = [sys.executable, "-c", "raise SystemExit('no device')"]
OK = [sys.executable, "-c", "pass"]


def test_logger_is_the_ports():
    assert device_guard.log.name == LOGGER


def test_watchdog_warns_on_slow_bringup(caplog):
    def slow():
        time.sleep(0.25)
        return ["dev0"]

    with caplog.at_level(logging.WARNING, logger=LOGGER):
        out = device_guard.devices_with_watchdog(seconds=0.05,
                                                 discover=slow)
    assert out == ["dev0"]
    msgs = [r.getMessage() for r in caplog.records]
    assert any("CUDA bring-up has taken" in m for m in msgs), msgs
    # no escape hatch the port lacks
    assert not any("GOLEFT_TPU_CPU" in m for m in msgs)


def test_watchdog_silent_on_fast_bringup(caplog):
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        out = device_guard.devices_with_watchdog(
            seconds=5, discover=lambda: ["dev0"])
    time.sleep(0.05)
    assert out == ["dev0"]
    assert not caplog.records


def test_watchdog_default_discovery_without_a_card_lists_none():
    """On a host without CUDA the default discovery lists no card; the
    command's own resolve_device then raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert device_guard.devices_with_watchdog(seconds=5) == []


def test_watchdog_seconds_env(monkeypatch):
    monkeypatch.setenv("GOLEFT_TPU_DEVICE_WATCHDOG_SECONDS", "7.5")
    assert device_guard._watchdog_seconds() == 7.5
    monkeypatch.setenv("GOLEFT_TPU_DEVICE_WATCHDOG_SECONDS", "soon")
    assert device_guard._watchdog_seconds() == 30.0
    monkeypatch.setenv("GOLEFT_TPU_DEVICE_WATCHDOG_SECONDS", "-1")
    assert device_guard._watchdog_seconds() == 30.0 \
        == jguard._watchdog_seconds()


def _clear_probe_skips(monkeypatch, tmp_path):
    """No skip variable set, and both caches in ``tmp_path``."""
    for k in ("GOLEFT_TPU_PROBE", "GOLEFT_TPU_COORDINATOR",
              "GOLEFT_TPU_PROBE_TTL_SECONDS",
              "GOLEFT_TPU_PROBE_FAIL_TTL_SECONDS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(
        device_guard, "_probe_cache_path",
        lambda kind="ok": str(tmp_path / f"probe-{kind}"))


def test_probe_cache_paths_are_the_ports_own():
    for kind in ("ok", "fail"):
        ours = device_guard._probe_cache_path(kind)
        assert os.path.basename(ours).startswith(
            f"goleft-tpu-torch-probe-{kind}-")
        assert ours != jguard._probe_cache_path(kind)


def test_probe_hang_raises_one_line(monkeypatch, tmp_path):
    """A hung bring-up (a child that does not exit) raises NoCudaDevice
    with one line naming the timeout, where the reference steps down to
    the host. The sleeping child stands in for a wedged driver."""
    _clear_probe_skips(monkeypatch, tmp_path)
    monkeypatch.setattr(device_guard, "WATCHDOG_SECONDS", 0.4)
    t0 = time.monotonic()
    with pytest.raises(NoCudaDevice) as ei:
        device_guard.ensure_card(probe_argv=HANG)
    assert time.monotonic() - t0 < 2.5
    msg = str(ei.value)
    assert "\n" not in msg and "hung past 0.4s" in msg, msg


def test_probe_timeout_captures_child_traceback():
    """A hung child leaves its own stack in the probe record
    (faulthandler armed at 0.8 x the timeout)."""
    snippet = device_guard.arm_traceback_snippet(
        "import time; time.sleep(3)", 1.2)
    # -S: a shorter interpreter start-up, so faulthandler arms in time
    rec = device_guard.probe_device(
        timeout_s=1.5, argv=[sys.executable, "-S", "-c", snippet])
    assert rec["ok"] is False and rec["rc"] is None
    tail = rec.get("traceback_tail", "")
    assert "Timeout" in tail and "Thread" in tail, rec


def test_hung_probe_line_names_its_traceback_file(monkeypatch, tmp_path):
    _clear_probe_skips(monkeypatch, tmp_path)
    monkeypatch.setattr(device_guard, "WATCHDOG_SECONDS", 1.5)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    argv = [sys.executable, "-S", "-c", device_guard.arm_traceback_snippet(
        "import time; time.sleep(3)", 1.2)]
    with pytest.raises(NoCudaDevice) as ei:
        device_guard.ensure_card(probe_argv=argv)
    msg = str(ei.value)
    assert "\n" not in msg and "hung past 1.5s" in msg
    path = msg.rsplit(" ", 1)[-1]
    assert path.startswith(str(tmp_path)) and "Timeout" in open(path).read()


def test_probe_failure_raises_one_line(monkeypatch, tmp_path):
    _clear_probe_skips(monkeypatch, tmp_path)
    with pytest.raises(NoCudaDevice) as ei:
        device_guard.ensure_card(probe_argv=FAIL)
    assert str(ei.value) == \
        "CUDA device probe failed (exit 1): no device"


def test_probe_success_keeps_the_card(monkeypatch, tmp_path):
    _clear_probe_skips(monkeypatch, tmp_path)
    assert device_guard.ensure_card(probe_argv=OK) == "probed"
    rec = device_guard.probe_device(argv=OK)
    assert rec["ok"] and rec["rc"] == 0 and rec["seconds"] < 30


def test_probe_skips(monkeypatch, tmp_path):
    _clear_probe_skips(monkeypatch, tmp_path)
    monkeypatch.setattr(device_guard, "probe_device", None)  # not called
    monkeypatch.setenv("GOLEFT_TPU_PROBE", "0")
    assert device_guard.ensure_card() == "unprobed"
    _clear_probe_skips(monkeypatch, tmp_path)
    monkeypatch.setenv("GOLEFT_TPU_COORDINATOR", "127.0.0.1:1")
    assert device_guard.ensure_card() == "unprobed"


def test_default_probe_without_a_card_names_the_cause(monkeypatch,
                                                      tmp_path):
    """The real probe child on a host without CUDA: one line carrying
    the child's own last stderr line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    _clear_probe_skips(monkeypatch, tmp_path)
    with pytest.raises(NoCudaDevice) as ei:
        device_guard.ensure_card()
    assert str(ei.value) == ("CUDA device probe failed (exit 1): no CUDA "
                             "device is visible")


def _failing_probe(calls, error="wedged"):
    def probe(timeout_s=None, argv=None):
        calls.append(1)
        return {"ok": False, "rc": None, "error": error}

    return probe


def test_probe_failure_is_cached_briefly(monkeypatch, tmp_path):
    """A wedged card costs the probe's timeout once, not once a command:
    a failure caches for a short TTL (120 s) and fails fast with the same
    line and how to re-probe; a success clears the failure."""
    _clear_probe_skips(monkeypatch, tmp_path)
    calls = []
    monkeypatch.setattr(device_guard, "probe_device", _failing_probe(calls))
    with pytest.raises(NoCudaDevice) as first:
        device_guard.ensure_card()
    with pytest.raises(NoCudaDevice) as second:
        device_guard.ensure_card()
    assert len(calls) == 1, "the second command must hit the fail cache"
    assert str(first.value) == "CUDA device probe wedged"
    msg = str(second.value)
    assert msg.startswith("CUDA device probe wedged (") and "\n" not in msg
    assert "cached" in msg and "GOLEFT_TPU_PROBE_FAIL_TTL_SECONDS=0" in msg

    # TTL expiry re-probes
    old = time.time() - 10_000
    os.utime(str(tmp_path / "probe-fail"), (old, old))
    with pytest.raises(NoCudaDevice):
        device_guard.ensure_card()
    assert len(calls) == 2

    # recovery clears the failure record and caches the success
    monkeypatch.setattr(
        device_guard, "probe_device",
        lambda timeout_s=None, argv=None: {"ok": True, "rc": 0,
                                           "stdout": "card"})
    os.utime(str(tmp_path / "probe-fail"))  # a fresh failure on file...
    monkeypatch.setenv("GOLEFT_TPU_PROBE_FAIL_TTL_SECONDS", "0")
    assert device_guard.ensure_card() == "probed"
    monkeypatch.delenv("GOLEFT_TPU_PROBE_FAIL_TTL_SECONDS")
    assert not os.path.exists(str(tmp_path / "probe-fail"))
    monkeypatch.setattr(device_guard, "probe_device", None)  # not called
    assert device_guard.ensure_card() == "cached"
    old = time.time() - 301
    os.utime(str(tmp_path / "probe-ok"), (old, old))
    monkeypatch.setattr(device_guard, "probe_device", _failing_probe(calls))
    with pytest.raises(NoCudaDevice):
        device_guard.ensure_card()  # past the success TTL: probed again


def test_probe_cache_disable_and_spawn_failures(monkeypatch, tmp_path):
    """GOLEFT_TPU_PROBE_TTL_SECONDS=0 turns caching off both ways, and a
    spawn failure (this host's moment, not the card) is never cached."""
    _clear_probe_skips(monkeypatch, tmp_path)
    calls = []
    monkeypatch.setattr(device_guard, "probe_device", _failing_probe(calls))
    monkeypatch.setenv("GOLEFT_TPU_PROBE_TTL_SECONDS", "0")
    for _ in range(2):
        with pytest.raises(NoCudaDevice):
            device_guard.ensure_card()
    assert len(calls) == 2, "TTL=0 must re-probe every run"
    assert not os.path.exists(str(tmp_path / "probe-fail"))
    # ...but its own fail TTL turns failure caching back on alone
    monkeypatch.setenv("GOLEFT_TPU_PROBE_FAIL_TTL_SECONDS", "300")
    for _ in range(2):
        with pytest.raises(NoCudaDevice):
            device_guard.ensure_card()
    assert len(calls) == 3

    _clear_probe_skips(monkeypatch, tmp_path)
    os.remove(str(tmp_path / "probe-fail"))
    monkeypatch.setattr(device_guard, "probe_device", _failing_probe(
        calls, "spawn failed: OSError(12, 'ENOMEM')"))
    with pytest.raises(NoCudaDevice) as ei:
        device_guard.ensure_card()
    assert "spawn failed" in str(ei.value)
    assert not os.path.exists(str(tmp_path / "probe-fail"))


def test_probe_argv_bypasses_both_caches(monkeypatch, tmp_path):
    _clear_probe_skips(monkeypatch, tmp_path)
    (tmp_path / "probe-ok").write_text("card\n")
    with pytest.raises(NoCudaDevice):
        device_guard.ensure_card(probe_argv=FAIL)
    assert not os.path.exists(str(tmp_path / "probe-fail"))


def test_reference_success_never_stands_for_the_card(monkeypatch, tmp_path):
    """A fresh success file of the reference's probe is not the port's."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    for k in ("GOLEFT_TPU_PROBE", "GOLEFT_TPU_COORDINATOR",
              "GOLEFT_TPU_PROBE_TTL_SECONDS",
              "GOLEFT_TPU_PROBE_FAIL_TTL_SECONDS"):
        monkeypatch.delenv(k, raising=False)
    open(jguard._probe_cache_path("ok"), "w").close()
    calls = []
    monkeypatch.setattr(device_guard, "probe_device", _failing_probe(calls))
    with pytest.raises(NoCudaDevice):
        device_guard.ensure_card()
    assert calls == [1]


_FAILING_PROBE_CLI = textwrap.dedent("""\
    import functools, json, sys
    sys.path.insert(0, {root!r})
    from goleft_tpu_torch.utils import device_guard
    device_guard.ensure_card = functools.partial(
        device_guard.ensure_card, probe_argv={argv!r})
    from goleft_tpu_torch import cli
    # the modules loaded when the command has finished, before the
    # manifest is written
    loaded = []
    write = cli._write_manifest
    def snapshot(*a, **k):
        loaded.extend(m for m in sys.modules if m.startswith(
            ("goleft_tpu_torch.ops", "torch")))
        return write(*a, **k)
    cli._write_manifest = snapshot
    rc = cli.main(sys.argv[1:])
    print(json.dumps(sorted(loaded)))
    sys.exit(rc)
    """)


@pytest.mark.parametrize("argv,line,hung", [
    (FAIL, "CUDA device probe failed (exit 1): no device", False),
    ([sys.executable, "-c", "import time; time.sleep(4)"],
     "CUDA device probe hung past 1s (child left to finish)", True),
])
def test_device_command_with_a_failing_probe_exits_1_in_one_line(
        tmp_path, argv, line, hung):
    """``depth`` with a failing or hung probe: exit 1, one stderr line,
    no kernel module (nor torch) imported before the manifest. The
    manifest of a failed probe is the one a run without a card wrote
    before the guard; a hung probe's asks CUDA nothing: the guard's
    line as the reference's backend error record, no kernel launch."""
    runner = tmp_path / "cli.py"
    runner.write_text(_FAILING_PROBE_CLI.format(root=ROOT, argv=argv))
    env = dict(os.environ, GOLEFT_TPU_DEVICE_WATCHDOG_SECONDS="1")
    env.pop("GOLEFT_TPU_PROBE", None)
    man = str(tmp_path / "m.json")
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, str(runner), "--metrics-out", man,
                        "depth", "--prefix", str(tmp_path / "o"), "x.bam"],
                       capture_output=True, text=True, env=env, timeout=120,
                       cwd=str(tmp_path))
    assert r.returncode == 1, r.stderr
    assert r.stderr.splitlines() == [f"goleft-tpu-torch depth: {line}"]
    assert r.stdout.splitlines()[-1] == "[]"  # nothing of the card loaded
    from goleft_tpu.obs.manifest import load_manifest

    doc = load_manifest(man)
    assert doc["exit_code"] == 1
    assert doc["metrics"]["counters"]["device.probe_total"] == 1
    assert doc["spans"]["device-probe"]["calls"] == 1
    if hung:
        assert doc["backend"] == {"error": line}
        assert doc["kernel_launches"] == {}
    else:
        assert doc["backend"]["platform"] in ("cpu", "gpu")
        assert doc["kernel_launches"] == {
            "depth": 0, "pairhmm": 0, "rans": 0, "indexcov_norm": 0,
            "swalign": 0}
    assert time.monotonic() - t0 < 60


def test_cached_hang_stays_a_hang(monkeypatch, tmp_path):
    """A failure cached from a hung probe raises ProbeHung again, so the
    run that finds it asks CUDA nothing either."""
    _clear_probe_skips(monkeypatch, tmp_path)
    calls = []
    monkeypatch.setattr(device_guard, "probe_device", _failing_probe(calls))
    for _ in range(2):
        with pytest.raises(device_guard.ProbeHung):
            device_guard.ensure_card()
    monkeypatch.setattr(device_guard, "probe_device", lambda **k: {
        "ok": False, "rc": 1, "error": "no CUDA device is visible"})
    os.remove(str(tmp_path / "probe-fail"))
    for _ in range(2):
        with pytest.raises(NoCudaDevice) as ei:
            device_guard.ensure_card()
        assert not isinstance(ei.value, device_guard.ProbeHung)
    assert len(calls) == 1


def test_reference_cpu_pin_does_not_move_a_device_command(monkeypatch,
                                                          capsys):
    """Noted divergence: the reference's GOLEFT_TPU_CPU=1 runs a device
    command on the host; the port has no such switch. With it set, a
    device command still asks for the card (here, without one, it
    fails with the guard's line) and never runs on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    monkeypatch.setenv("GOLEFT_TPU_CPU", "1")
    for k in ("GOLEFT_TPU_PROBE", "GOLEFT_TPU_COORDINATOR",
              "GOLEFT_TPU_PROBE_FAIL_TTL_SECONDS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GOLEFT_TPU_PROBE_TTL_SECONDS", "0")
    ran = []
    monkeypatch.setitem(cli.PROGS, "depth", (
        cli.PROGS["depth"][0], lambda argv: ran.append(argv) or 0, True))
    assert cli.main(["depth", "x.bam"]) == 1
    assert ran == []
    err = capsys.readouterr().err
    assert err == ("goleft-tpu-torch depth: CUDA device probe failed "
                   "(exit 1): no CUDA device is visible\n")
    assert not hasattr(device_guard, "maybe_force_cpu")
    assert not hasattr(device_guard, "ensure_usable_backend")


def test_dcnv_runs_on_the_cpu_and_probes_no_card():
    """dcnv is a device command in the reference's table, but its path
    is host numpy: the port runs it on the CPU and probes no card."""
    from goleft_tpu import cli as jcli

    assert jcli.PROGS["dcnv"][2] is True
    assert cli._device_of("dcnv", ["-f", "r.fa", "m.tsv"]) == "cpu"
    assert cli._device_of("depth", ["x.bam"]) == "cuda"
    assert cli._device_of("samplename", ["x.bam"]) is None
