"""The serve daemon's failure domains on the port (``ServeApp(device=
"cpu")``), the semantics of tests/test_serve_hardening.py: poison
bisection (a stand-in executor, and a corrupt BAM through the real depth
executor against the reference's bytes), breaker trip and recovery,
the watchdog's requeue, concurrent identical requests deduplicated to
one pass, a checkpointed cohortdepth request resumed by a fresh app,
and an idempotent, concurrent ``close``.

Ordering between threads is by ``threading.Event``; the breaker runs on
an injected clock; every wait has a timeout.
"""

import threading
import time

import numpy as np
import pytest

from goleft_tpu.serve.server import ServeApp as RefApp
from goleft_tpu_torch.resilience.breaker import CircuitBreaker
from goleft_tpu_torch.serve.batcher import DeadlineExceeded, WatchdogTimeout
from goleft_tpu_torch.serve.server import ServeApp
from helpers import random_reads, write_bam_and_bai, write_fasta

TIMEOUT = 60


class StubExec:
    """Per-payload stand-in executor: 'poison*' names raise ValueError
    (permanent); a pass sets ``started`` and waits on its gate, one of
    ``gates`` a pass."""

    def __init__(self, gates=(), kind="depth"):
        self.kind = kind
        self.calls = []
        self.gates = list(gates)
        self.started = threading.Event()
        self._lock = threading.Lock()

    def validate(self, req):
        pass

    def group_key(self, req):
        return (self.kind, "stub")

    def cache_files(self, req):
        return []

    def run(self, reqs):
        with self._lock:
            self.calls.append([r["name"] for r in reqs])
            gate = self.gates.pop(0) if self.gates else None
        self.started.set()
        if gate is not None:
            gate.wait(timeout=TIMEOUT)
        for r in reqs:
            if r["name"].startswith("poison"):
                raise ValueError(f"bad payload {r['name']}")
        return [{"ok": r["name"]} for r in reqs]


def _fire_all(app, reqs, kind="depth"):
    codes, bodies = [None] * len(reqs), [None] * len(reqs)

    def one(i):
        codes[i], bodies[i] = app.handle(kind, reqs[i])

    ts = [threading.Thread(target=one, args=(i,)) for i in range(len(reqs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
    return codes, bodies


def test_poison_request_isolated_in_a_batch_of_8():
    """One permanent failure in a coalesced batch of 8: seven 200s with
    their own results and one 400 marked poison."""
    gate = threading.Event()
    app = ServeApp(batch_window_s=0.0, max_batch=8, watchdog_s=None,
                   device="cpu")
    stub = app.executors["depth"] = StubExec(gates=[gate])
    try:
        # a first pass holds the dispatcher until all 8 are queued, so
        # the 8 form one batch
        t0 = threading.Thread(target=app.handle,
                              args=("depth", {"name": "anchor"}))
        t0.start()
        assert stub.started.wait(timeout=TIMEOUT)
        reqs = [{"name": f"r{i}"} for i in range(8)]
        reqs[3] = {"name": "poison-3"}
        out = {}
        fired = threading.Thread(
            target=lambda: out.update(r=_fire_all(app, reqs)))
        fired.start()
        _wait_for(lambda: app.batcher.queue_depth() == 8)
        gate.set()
        fired.join(timeout=TIMEOUT)
        t0.join(timeout=TIMEOUT)
        codes, bodies = out["r"]
        assert sorted(codes) == [200] * 7 + [400]
        for req, code, body in zip(reqs, codes, bodies):
            if req["name"] == "poison-3":
                assert body.get("poison") is True
                assert "poison-3" in body["error"]
            else:
                assert body == {"ok": req["name"]}
        counters = app.metrics.snapshot()["counters"]
        assert counters["poison_total"] == 1
        assert counters["bisect_splits_total"] >= 1
        assert len(stub.calls[1]) == 8  # coalesced: one pass of 8
    finally:
        gate.set()
        app.close()


def test_systemic_batch_failure_stays_500_not_poison():
    app = ServeApp(batch_window_s=0.3, max_batch=4, watchdog_s=None,
                   batch_mode="window", device="cpu")
    app.executors["depth"] = StubExec()
    try:
        codes, bodies = _fire_all(
            app, [{"name": f"poison-{i}"} for i in range(3)])
        assert codes == [500] * 3
        assert all("poison" not in b for b in bodies)
        assert "poison_total" not in app.metrics.snapshot()["counters"]
    finally:
        app.close()


def _cohort(tmp_path, n=3, ref_len=4000, seed=21):
    rng = np.random.default_rng(seed)
    fa = write_fasta(str(tmp_path / "r.fa"), {"chr1": "A" * ref_len})
    from goleft_tpu_torch.io.fai import write_fai

    write_fai(fa)
    bams = []
    for i in range(n):
        hdr = ("@HD\tVN:1.6\tSO:coordinate\n"
               f"@SQ\tSN:chr1\tLN:{ref_len}\n@RG\tID:r\tSM:s{i}\n")
        p = str(tmp_path / f"s{i}.bam")
        write_bam_and_bai(p, random_reads(rng, 400, 0, ref_len),
                          ref_names=("chr1",), ref_lens=(ref_len,),
                          header_text=hdr)
        bams.append(p)
    return fa, bams


def test_corrupt_bam_poisons_alone_through_the_real_executor(tmp_path):
    """A corrupt BAM in a batch of 3 through the port's depth executor:
    a 400 alone; its siblings' bodies are the reference's."""
    fa, bams = _cohort(tmp_path)
    ref = RefApp(batch_window_s=0.0, watchdog_s=None)
    try:
        want = {p: ref.handle("depth", {"bam": p, "fai": fa + ".fai",
                                        "window": 200})
                for p in (bams[0], bams[2])}
    finally:
        ref.close()
    with open(bams[1], "r+b") as fh:
        fh.write(b"\x00" * 64)  # the BGZF header gone
    app = ServeApp(batch_window_s=0.0, max_batch=8, watchdog_s=None,
                   device="cpu")
    gate = threading.Event()
    hold = app.executors["hold"] = StubExec(gates=[gate], kind="hold")
    held = threading.Thread(target=app.handle,
                            args=("hold", {"name": "hold"}))
    try:
        # a held pass keeps the dispatcher until the 3 are queued, so
        # they form one batch
        held.start()
        assert hold.started.wait(timeout=TIMEOUT)
        reqs = [{"bam": p, "fai": fa + ".fai", "window": 200}
                for p in bams]
        out = {}
        fired = threading.Thread(
            target=lambda: out.update(r=_fire_all(app, reqs)))
        fired.start()
        _wait_for(lambda: app.batcher.queue_depth() == 3)
        gate.set()
        fired.join(timeout=TIMEOUT)
        codes, bodies = out["r"]
        assert codes[1] == 400 and bodies[1].get("poison") is True
        assert (codes[0], bodies[0]) == want[bams[0]]
        assert (codes[2], bodies[2]) == want[bams[2]]
    finally:
        gate.set()
        held.join(timeout=TIMEOUT)
        app.close()


def test_breaker_trips_sheds_and_recovers():
    app = ServeApp(batch_window_s=0.0, max_batch=1, watchdog_s=None,
                   device="cpu")
    stub = app.executors["depth"] = StubExec()
    now = {"t": 0.0}
    gauge = app.metrics.registry.gauge("serve.breaker.state.depth")
    app.breakers["depth"] = CircuitBreaker(
        name="serve.depth", failure_threshold=3, cooldown_s=10.0,
        on_state=gauge.set, clock=lambda: now["t"])
    try:
        for i in range(3):
            assert app.handle("depth", {"name": f"poison-{i}"})[0] == 500
        code, body = app.handle("depth", {"name": "r-shed"})
        assert code == 503 and "circuit breaker" in body["error"]
        assert body["retry_after_s"] == pytest.approx(10.0)
        assert all("r-shed" not in c for call in stub.calls for c in call)
        assert gauge.value == 2
        snap = app.metrics_snapshot()
        assert snap["breakers"]["depth"] == "open"
        assert snap["counters"]["breaker_rejected_total.depth"] == 1
        now["t"] = 10.5  # the cooldown has passed: a half-open probe
        code, body = app.handle("depth", {"name": "r-probe"})
        assert code == 200 and body == {"ok": "r-probe"}
        assert app.metrics_snapshot()["breakers"]["depth"] == "closed"
        assert gauge.value == 0
    finally:
        app.close()


@pytest.mark.parametrize("hangs,code", [(1, 200), (2, 504)])
def test_watchdog_requeues_a_hung_dispatch(hangs, code):
    """A pass past the watchdog is abandoned and its request queued once
    more: served when the second pass runs, 504 when it hangs too."""
    gates = [threading.Event() for _ in range(hangs)]
    app = ServeApp(batch_window_s=0.0, max_batch=1, watchdog_s=1.0,
                   watchdog_requeues=1, device="cpu")
    app.executors["depth"] = StubExec(gates=gates)
    try:
        got, body = app.handle("depth", {"name": "r0"})
        assert got == code
        if code == 200:
            assert body == {"ok": "r0"}
        else:
            assert "watchdog" in body["error"]
        assert app.metrics.snapshot()["counters"][
            "watchdog_requeues_total"] == hangs
    finally:
        for g in gates:
            g.set()
        app.close()
    assert issubclass(WatchdogTimeout, DeadlineExceeded)


def test_concurrent_identical_requests_share_one_pass():
    """Two identical concurrent requests: one pass, the follower's body
    identical; a later repeat computes again (in flight only)."""
    gate = threading.Event()
    app = ServeApp(batch_window_s=0.0, max_batch=1, device="cpu")
    stub = app.executors["depth"] = StubExec(gates=[gate])
    out = [None, None]

    def fire(i):
        out[i] = app.handle("depth", {"name": "same"})

    before = _deduped()
    try:
        t0 = threading.Thread(target=fire, args=(0,))
        t0.start()
        assert stub.started.wait(timeout=TIMEOUT)
        t1 = threading.Thread(target=fire, args=(1,))
        t1.start()
        _wait_for(lambda: _deduped() > before)  # the follower parked
        gate.set()
        for t in (t0, t1):
            t.join(timeout=TIMEOUT)
        assert out[0] == (200, {"ok": "same"}) and out[1] == out[0]
        assert len(stub.calls) == 1
        counters = app.metrics.snapshot()["counters"]
        assert counters["request_deduped_total.depth"] == 1
        assert app.handle("depth", {"name": "same"})[0] == 200
        assert len(stub.calls) == 2
    finally:
        gate.set()
        app.close()


def _deduped() -> int:
    from goleft_tpu_torch.obs import get_registry

    return get_registry().counter("plan.steps_deduped_total").value


def _wait_for(pred) -> None:
    """Poll ``pred`` until true (a bounded wait; fails on timeout)."""
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < TIMEOUT, "timed out waiting"
        time.sleep(0.005)


def test_checkpointed_cohortdepth_resumes_in_a_fresh_app(tmp_path,
                                                         monkeypatch):
    """A checkpointed request sent again to a fresh app (a restarted
    daemon) resumes from the committed regions: no decode, the same
    matrix; without --checkpoint-root it is a 400."""
    from goleft_tpu_torch.commands import cohortdepth as cd
    from goleft_tpu_torch.commands import depth as depth_mod

    monkeypatch.setattr(depth_mod, "STEP", 1000)  # 4 regions
    fa, bams = _cohort(tmp_path)
    root = str(tmp_path / "serve-ck")
    req = {"bams": bams, "fai": fa + ".fai", "window": 200,
           "engine": "device", "checkpoint": True}
    bare = ServeApp(batch_window_s=0.0, watchdog_s=None, device="cpu")
    try:
        code, body = bare.handle("cohortdepth", dict(req))
        assert code == 400 and "--checkpoint-root" in body["error"]
    finally:
        bare.close()
    app1 = ServeApp(batch_window_s=0.0, checkpoint_root=root,
                    watchdog_s=None, device="cpu")
    try:
        code, cold = app1.handle("cohortdepth", dict(req))
        assert code == 200
        code, plain = app1.handle("cohortdepth", {
            k: v for k, v in req.items() if k != "checkpoint"})
        assert code == 200 and plain["matrix_tsv"] == cold["matrix_tsv"]
    finally:
        app1.close()
    calls = {"n": 0}
    real = cd._decode_shard_segments

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(cd, "_decode_shard_segments", counting)
    app2 = ServeApp(batch_window_s=0.0, checkpoint_root=root,
                    watchdog_s=None, device="cpu")
    try:
        code, warm = app2.handle("cohortdepth", dict(req))
        assert code == 200 and warm["matrix_tsv"] == cold["matrix_tsv"]
        assert calls["n"] == 0
    finally:
        app2.close()


def test_close_is_idempotent_and_runs_once_under_concurrency():
    app = ServeApp(batch_window_s=0.0, watchdog_s=None, device="cpu")
    closes = {"n": 0}
    real_close = app.batcher.close
    entered = threading.Event()

    def counting_close(drain=True):
        closes["n"] += 1
        entered.set()
        real_close(drain=drain)

    app.batcher.close = counting_close
    barrier = threading.Barrier(8)

    def closer():
        barrier.wait(timeout=TIMEOUT)
        app.close()

    ts = [threading.Thread(target=closer) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
    assert entered.is_set() and closes["n"] == 1
    app.close()  # and once more, sequentially
    assert closes["n"] == 1 and app.draining
    code, body = app.healthz()
    assert code == 503 and body["status"] == "draining"


def test_a_kernel_fault_is_a_500_the_breaker_counts(tmp_path, monkeypatch):
    """A KernelFault out of the batched depth launch fails the request
    (500, not retried) and counts as a breaker failure; nothing answers
    from another path."""
    from goleft_tpu_torch.commands.depth import DepthEngine
    from goleft_tpu_torch.device import KernelFault

    calls = {"n": 0}

    def faulty(self, segs, start, end):
        calls["n"] += 1
        raise KernelFault("depth kernel launch failed: injected")

    monkeypatch.setattr(DepthEngine, "run_segments_batch", faulty)
    fa, bams = _cohort(tmp_path, n=1)
    app = ServeApp(batch_window_s=0.0, watchdog_s=None,
                   breaker_threshold=2, device="cpu")
    try:
        req = {"bam": bams[0], "fai": fa + ".fai", "window": 200}
        for _ in range(2):
            code, body = app.handle("depth", dict(req))
            assert code == 500 and "KernelFault" in body["error"]
        assert calls["n"] == 2  # one attempt a request: not retried
        assert app.metrics_snapshot()["breakers"]["depth"] == "open"
        assert app.handle("depth", dict(req))[0] == 503
    finally:
        app.close()


def test_concurrent_requests_index_a_reference_once_whole(tmp_path):
    """8 concurrent depth requests naming a FASTA without its .fai: each
    handler may write the index, and none reads half of one (every
    response has the rows of its BAM)."""
    fa, bams = _cohort(tmp_path, n=1)
    import os

    os.remove(fa + ".fai")
    app = ServeApp(batch_window_s=0.0, max_batch=8, watchdog_s=None,
                   device="cpu")
    try:
        codes, bodies = _fire_all(app, [
            {"bam": bams[0], "reference": fa, "window": 200, "n": i}
            for i in range(8)])
        assert codes == [200] * 8
        assert len({b["depth_bed"] for b in bodies}) == 1
        assert bodies[0]["depth_bed"].count("\n") == 20
    finally:
        app.close()
