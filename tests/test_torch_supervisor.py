"""Fleet supervisor tests of the port (the reference's
tests/test_supervisor.py on goleft_tpu_torch's copies): lifecycle state
machine, crash-loop quarantine, hang detection, elastic scaling,
startup cleanup.

The supervisor takes an injectable ``spawn_fn``, so these tests
supervise REAL subprocesses (kill/SIGSTOP/reap semantics are the
point) that are cheap torch-free stdlib HTTP stubs, so the suite stays
fast while the process-lifecycle story runs against real PIDs. The
end-to-end story with real port workers on the card is chip_smoke.py's
fleet phase.
"""

import signal
import subprocess
import sys
import time

import pytest

from goleft_tpu_torch.fleet.supervisor import (
    HEALTHY, QUARANTINED, RESTARTING, STOPPED, Supervisor,
    WorkerSpawnError, read_announce,
)
from goleft_tpu_torch.resilience.policy import RetryPolicy

_STUB = r"""
import json, sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

class H(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    def log_message(self, *a):
        pass
    def do_GET(self):
        data = json.dumps({"status": "ok"}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
print(f"stub: listening on http://127.0.0.1:{srv.server_address[1]}",
      flush=True)
srv.serve_forever()
"""

#: fast deterministic backoff for tests
_FAST_BACKOFF = RetryPolicy(base_delay_s=0.01, max_delay_s=0.05)


@pytest.fixture()
def stub_script(tmp_path):
    p = tmp_path / "stubworker.py"
    p.write_text(_STUB)
    return str(p)


def _stub_spawn(script):
    def spawn(index):
        child = subprocess.Popen([sys.executable, script],
                                 stdout=subprocess.PIPE, text=True)
        url = read_announce(child, timeout_s=30.0)
        if url is None:
            child.kill()
            raise WorkerSpawnError(f"stub {index} never announced")
        return child, url

    return spawn


def _supervisor(script, **kw):
    kw.setdefault("restart_backoff", _FAST_BACKOFF)
    kw.setdefault("hang_timeout_s", 0.5)
    kw.setdefault("interval_s", 0.05)
    return Supervisor(spawn_fn=_stub_spawn(script), **kw)


def _drive(sup, pred, timeout_s=30.0, what="condition"):
    """Tick the supervisor manually (deterministic: no loop thread)
    until ``pred()`` holds."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        sup.tick()
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"supervisor never reached {what}")


def test_spawn_initial_and_close(stub_script):
    sup = _supervisor(stub_script, min_workers=2)
    urls = sup.spawn_initial(2)
    try:
        assert len(urls) == 2 and len(set(urls)) == 2
        assert sup.capacity == 2
        assert all(s.state == HEALTHY for s in sup.slots())
        procs = [s.proc for s in sup.slots()]
        assert all(p.poll() is None for p in procs)
    finally:
        sup.close()
    assert all(p.poll() is not None for p in procs)
    assert all(s.state == STOPPED for s in sup.slots())


def test_spawn_initial_failure_kills_earlier_workers(stub_script):
    """Satellite contract: if worker i of N fails to spawn, the
    already-spawned children are killed before the error propagates
    — no orphan daemons."""
    spawned = []
    real = _stub_spawn(stub_script)

    def flaky(index):
        if index == 2:
            raise WorkerSpawnError("boom")
        proc, url = real(index)
        spawned.append(proc)
        return proc, url

    sup = Supervisor(spawn_fn=flaky, min_workers=3,
                     restart_backoff=_FAST_BACKOFF)
    with pytest.raises(WorkerSpawnError):
        sup.spawn_initial(3)
    assert len(spawned) == 2
    for p in spawned:
        assert p.wait(timeout=10) is not None  # killed, reaped
    assert sup.capacity == 0


def test_death_restarts_with_new_process(stub_script):
    sup = _supervisor(stub_script, min_workers=1,
                      crash_limit=5, crash_window_s=60.0)
    sup.spawn_initial(1)
    try:
        slot = sup.slots()[0]
        pid0 = slot.proc.pid
        slot.proc.kill()
        slot.proc.wait(timeout=10)
        sup.tick()
        assert slot.state == RESTARTING  # backoff pending
        _drive(sup, lambda: slot.state == HEALTHY, what="restart")
        assert slot.proc.pid != pid0
        assert slot.restarts == 1
        assert sup.registry.counter(
            "fleet.restarts_total").value == 1
        assert sup.capacity == 1
    finally:
        sup.close()


def test_crash_loop_quarantines_slot(stub_script):
    sup = _supervisor(stub_script, min_workers=2,
                      crash_limit=3, crash_window_s=60.0)
    sup.spawn_initial(2)
    try:
        slot = sup.slots()[0]

        def kill_if_up():
            if slot.state == HEALTHY and slot.proc.poll() is None:
                slot.proc.kill()
                slot.proc.wait(timeout=10)
            return slot.state == QUARANTINED

        _drive(sup, kill_if_up, what="quarantine")
        assert slot.state == QUARANTINED
        assert slot.proc is None
        assert sup.capacity == 1           # degraded, not dead
        assert sup.quarantined_slots == 1
        assert len(sup.quarantine) == 1
        entry = sup.quarantine.summary()["quarantined"][0]
        assert entry["classification"] == "crash-loop"
        assert entry["phase"] == "serve"
        assert sup.registry.counter(
            "fleet.slot_quarantines").value == 1
        # the sibling is untouched
        assert sup.slots()[1].state == HEALTHY
        # quarantined slots are never respawned
        before = sup.registry.counter("fleet.restarts_total").value
        for _ in range(5):
            sup.tick()
        assert sup.registry.counter(
            "fleet.restarts_total").value == before
    finally:
        sup.close()


def test_sigstop_hang_detected_and_recycled(stub_script):
    sup = _supervisor(stub_script, min_workers=1, hang_after=2,
                      crash_limit=5, crash_window_s=60.0)
    sup.spawn_initial(1)
    try:
        slot = sup.slots()[0]
        pid0 = slot.proc.pid
        slot.proc.send_signal(signal.SIGSTOP)
        _drive(sup, lambda: slot.state == HEALTHY
               and slot.restarts == 1, what="hang recycle")
        assert slot.proc.pid != pid0
        assert sup.registry.counter("fleet.hangs_total").value == 1
    finally:
        sup.close()


def test_autoscaler_scales_up_and_down_with_hysteresis(stub_script):
    age = {"v": 0.0}
    sup = _supervisor(stub_script, min_workers=1, max_workers=3,
                      target_queue_age_s=1.0,
                      scale_cooldown_s=0.0,
                      scale_down_idle_ticks=3,
                      queue_age_fn=lambda: age["v"])
    sup.spawn_initial(1)
    try:
        # below target: nothing happens
        for _ in range(5):
            sup.tick()
        assert sup.capacity == 1
        # backlog above target: one worker per evaluation until max
        age["v"] = 2.5
        _drive(sup, lambda: sup.capacity == 3, what="scale to max")
        for _ in range(3):
            sup.tick()
        assert sup.capacity == 3  # ceiling respected
        assert sup.registry.counter(
            "fleet.scale_up_total").value == 2
        # idle: scale-down only after N consecutive idle ticks
        age["v"] = 0.0
        sup.tick()
        sup.tick()
        assert sup.capacity == 3  # hysteresis: not yet
        _drive(sup, lambda: sup.capacity == 1, what="scale to min")
        for _ in range(5):
            sup.tick()
        assert sup.capacity == 1  # floor respected
        assert sup.registry.counter(
            "fleet.scale_down_total").value == 2
        assert sup.registry.counter(
            "fleet.scale_events").value == 4
    finally:
        sup.close()


def test_scale_down_respects_min_and_victim_choice(stub_script):
    sup = _supervisor(stub_script, min_workers=1, max_workers=2)
    sup.spawn_initial(1)
    try:
        assert sup.scale_down() is None  # at the floor already
        url2 = sup.scale_up()
        assert url2 is not None and sup.capacity == 2
        assert sup.scale_up() is None    # at the ceiling
        victim = sup.pick_scale_down_victim()
        assert victim is not None
        gone = sup.scale_down()
        assert gone == victim.url
        assert sup.capacity == 1
        assert victim.state == STOPPED
        assert victim.proc.poll() is not None
    finally:
        sup.close()


def test_read_announce_timeout_returns_none():
    child = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(30)"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.monotonic()
        assert read_announce(child, timeout_s=0.3) is None
        assert time.monotonic() - t0 < 5.0
    finally:
        child.kill()
        child.wait(timeout=10)
        child.stdout.close()


def test_supervisor_constructor_validation(stub_script):
    with pytest.raises(ValueError):
        Supervisor(spawn_fn=_stub_spawn(stub_script), min_workers=0)
    with pytest.raises(ValueError):
        Supervisor(spawn_fn=_stub_spawn(stub_script),
                   min_workers=3, max_workers=2)


def test_supervisor_module_does_not_import_jax():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; import goleft_tpu_torch.fleet.supervisor; "
         "sys.exit(1 if {'torch', 'jax', 'goleft_tpu'} "
         "& set(sys.modules) else 0)"],
        capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()


# ---------------- fleet observability plane ----------------


def test_burn_rate_breach_scales_up_with_quiet_queue(stub_script):
    """The acceptance pin: an injected SLO burn-rate breach scales
    the fleet up while queue age sits BELOW target — errors/latency
    burn budget without aging the queue, so queue age alone would
    never trigger."""
    burn = {"v": 0.4}
    sup = _supervisor(stub_script, min_workers=1, max_workers=3,
                      target_queue_age_s=5.0,  # queue trigger armed
                      scale_cooldown_s=0.0,
                      burn_threshold=1.0,
                      burn_rate_fn=lambda: burn["v"],
                      queue_age_fn=lambda: 0.0)  # queue ALWAYS quiet
    sup.spawn_initial(1)
    try:
        sup.tick()
        assert sup.capacity == 1  # burn below threshold: no scaling
        burn["v"] = 2.5  # breach
        _drive(sup, lambda: sup.capacity == 2, what="burn scale-up")
        ev = [e["type"] for e in sup.events.block()["recent"]]
        assert "scale_up" in ev
        reasons = [e.get("reason", "") for e
                   in sup.events.block()["recent"]
                   if e["type"] == "scale_up"]
        assert any("burn_rate 2.5" in r for r in reasons)
        # burn cleared + queue quiet: the idle path may scale back
        # down eventually, but a live breach never counts as idle
        assert sup._idle_ticks == 0
    finally:
        sup.close()


def test_events_journal_records_lifecycle(stub_script, tmp_path):
    """Every transition lands in events.jsonl (fsync'd, replayable):
    spawn → kill -9 → death + backoff + restart, then queryable with
    the filters the CLI exposes."""
    journal = str(tmp_path / "events.jsonl")
    sup = _supervisor(stub_script, min_workers=1,
                      crash_limit=5, crash_window_s=60.0,
                      events_journal=journal)
    sup.spawn_initial(1)
    try:
        slot = sup.slots()[0]
        pid = slot.proc.pid
        slot.proc.kill()
        slot.proc.wait(timeout=10)
        _drive(sup, lambda: sup.slots()[0].restarts == 1,
               what="restart after SIGKILL")
    finally:
        sup.close()
    from goleft_tpu_torch.obs.events import read_events

    evs = read_events(journal)
    types = [e["type"] for e in evs]
    for expected in ("spawn", "death", "backoff", "restart", "stop"):
        assert expected in types, (expected, types)
    # ordering tells the story: spawn before death before restart
    assert types.index("spawn") < types.index("death") \
        < types.index("restart")
    death = next(e for e in evs if e["type"] == "death")
    assert death["slot"] == 0 and death["pid"] == pid
    assert "rc=-9" in death["why"]
    # filters (the `goleft-tpu fleet events` surface)
    assert all(e["type"] == "death"
               for e in read_events(journal, type="death"))
    assert read_events(journal, slot=99) == []
    # the /metrics block: counters + newest-first ring
    block = sup.events.block()
    assert block["journal"] == journal
    assert block["recent"][0]["type"] == "stop"


def test_fleet_events_cli_json_schema_stable(stub_script, tmp_path):
    """`goleft-tpu fleet events --json` is a schema-stable document
    (the acceptance pin) and the filters narrow it."""
    import json as _json

    journal = str(tmp_path / "events.jsonl")
    from goleft_tpu_torch.obs.events import EventJournal

    with EventJournal(journal) as j:
        j.append("spawn", slot=0, worker="http://w0", pid=1)
        j.append("death", slot=0, worker="http://w0", why="rc=-9")
        j.append("scale_up", slot=1, worker="http://w1",
                 reason="slo burn_rate 2.00 > 1")
    import contextlib
    import io

    from goleft_tpu_torch.commands.fleet import events_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = events_main(["--journal", journal, "--json"])
    assert rc == 0
    doc = _json.loads(buf.getvalue())
    assert doc["schema"] == "goleft-tpu.fleet-events/1"
    assert doc["count"] == 3
    assert [e["type"] for e in doc["events"]] \
        == ["spawn", "death", "scale_up"]
    assert all(e["schema"] == "goleft-tpu.fleet-event/1"
               for e in doc["events"])
    # stable key order (sort_keys) — byte-identical on re-render
    buf2 = io.StringIO()
    with contextlib.redirect_stdout(buf2):
        events_main(["--journal", journal, "--json"])
    assert buf.getvalue() == buf2.getvalue()
    # filtered
    buf3 = io.StringIO()
    with contextlib.redirect_stdout(buf3):
        events_main(["--journal", journal, "--json", "--type",
                     "scale_up"])
    assert _json.loads(buf3.getvalue())["count"] == 1
    # human table goes to stdout without crashing
    buf4 = io.StringIO()
    with contextlib.redirect_stdout(buf4):
        assert events_main(["--journal", journal]) == 0
    assert "scale_up" in buf4.getvalue()
    # missing journal: loud exit 1
    assert events_main(["--journal",
                        str(tmp_path / "nope.jsonl")]) == 1
