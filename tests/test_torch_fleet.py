"""Fleet tests of the port (the reference's tests/test_fleet.py run on
goleft_tpu_torch's copies): hash ring, admission control, router
behavior over real HTTP against stub workers, continuous batcher
semantics, and the retry-aware client.

Stub workers keep these cheap: the router is deliberately
workload-ignorant, so its contracts (affinity, failover, breaker
import, quotas, fairness) are all provable without torch ever loading.
The end-to-end story against real port workers is
tests/test_torch_fleet_e2e.py here and chip_smoke.py's fleet phase on
the card.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from goleft_tpu_torch.fleet.admission import (
    FairScheduler, QuotaExceeded, QuotaTable, SchedulerTimeout,
    TokenBucket,
)
from goleft_tpu_torch.fleet.router import HashRing, RouterApp, RouterThread
from goleft_tpu_torch.serve.batcher import ContinuousBatcher
from goleft_tpu_torch.serve.client import ServeClient, ServeError


# ---------------- stub workers ----------------


class _StubHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _json(self, code, body):
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(data)
        self.close_connection = True

    def do_GET(self):  # noqa: N802
        s = self.server.state
        if self.path == "/healthz":
            self._json(200, {"status": s.get("status", "ok")})
        elif self.path.startswith("/metrics"):
            self._json(200, {"breakers": s.get("breakers", {}),
                             "slo": s.get("slo", {})})
        else:
            self._json(404, {"error": "?"})

    def do_POST(self):  # noqa: N802
        s = self.server.state
        n = int(self.headers.get("Content-Length", "0"))
        req = json.loads(self.rfile.read(n) or b"{}")
        kind = self.path[len("/v1/"):].strip("/")
        s.setdefault("requests", []).append((kind, req))
        shed = s.get("shed_kinds", set())
        if kind in shed:
            self._json(503, {"error": f"breaker open for {kind!r}",
                             "retry_after_s": 0.5})
            return
        self._json(200, {"worker": s["name"], "kind": kind,
                         "echo": req.get("bam") or req.get("input")})


class _StubWorker:
    def __init__(self, name: str):
        self.state = {"name": name}
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                         _StubHandler)
        self.httpd.state = self.state
        self._t = threading.Thread(target=self.httpd.serve_forever,
                                   kwargs={"poll_interval": 0.02},
                                   daemon=True)
        self._t.start()
        host, port = self.httpd.server_address[:2]
        self.url = f"http://{host}:{port}"

    def kill(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._t.join(timeout=10)

    def requests(self, kind=None):
        reqs = self.state.get("requests", [])
        return [r for k, r in reqs if kind is None or k == kind]


@pytest.fixture()
def two_workers():
    ws = [_StubWorker("w0"), _StubWorker("w1")]
    try:
        yield ws
    finally:
        for w in ws:
            try:
                w.kill()
            except Exception:  # noqa: BLE001 — already killed is fine
                pass


def _router(ws, **kw):
    kw.setdefault("poll_interval_s", 0.2)
    kw.setdefault("down_after", 1)
    return RouterApp([w.url for w in ws], **kw)


def _wait_until(pred, timeout=10.0, what="condition"):
    """Poll ``pred`` until true: a bounded wait that fails on timeout
    (orders the test's threads without a fixed sleep)."""
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, f"timed out: {what}"
        time.sleep(0.002)


# ---------------- hash ring ----------------


def test_ring_deterministic_and_covers_all_nodes():
    nodes = [f"http://w{i}" for i in range(4)]
    ring = HashRing(nodes)
    for key in ("a.bam", "b.bam", "c.bam"):
        order = ring.candidates(key)
        assert order == ring.candidates(key)  # stable
        assert sorted(order) == sorted(nodes)  # full failover order


def test_ring_spreads_and_moves_minimally():
    nodes = [f"http://w{i}" for i in range(3)]
    ring = HashRing(nodes)
    homes = {f"f{i}.bam": ring.candidates(f"f{i}.bam")[0]
             for i in range(120)}
    by_node = {n: sum(1 for h in homes.values() if h == n)
               for n in nodes}
    assert all(v > 0 for v in by_node.values()), by_node
    # removing one node relocates ONLY that node's keys
    small = HashRing(nodes[:2])
    for key, home in homes.items():
        if home in nodes[:2]:
            assert small.candidates(key)[0] == home


def test_ring_resize_moves_only_the_resized_nodes_keys():
    """Dynamic membership: adding a node moves ONLY keys the new node
    now owns; removing it moves ONLY its keys back — and surviving
    nodes keep their exact candidate order (the byte-identity /
    cache-locality contract across fleet resizes)."""
    nodes = [f"http://w{i}" for i in range(3)]
    ring = HashRing(nodes)
    keys = [f"f{i}.bam" for i in range(400)]
    homes = {k: ring.candidates(k)[0] for k in keys}

    grown = ring.with_node("http://w3")
    moved = [k for k in keys if grown.candidates(k)[0] != homes[k]]
    # every moved key moved TO the new node, nowhere else
    assert all(grown.candidates(k)[0] == "http://w3" for k in moved)
    # ~1/4 of the keyspace, generously bounded (64 vnodes of wobble)
    assert 0 < len(moved) / len(keys) < 0.45
    # candidate order over the ORIGINAL nodes is unchanged for all
    for k in keys:
        assert [n for n in grown.candidates(k) if n != "http://w3"] \
            == ring.candidates(k)

    # removal is the exact inverse: back to the original assignment
    shrunk = grown.without_node("http://w3")
    assert all(shrunk.candidates(k) == ring.candidates(k)
               for k in keys)

    # membership ops are idempotent + copy-on-write
    assert grown.with_node("http://w3") is grown
    assert ring.without_node("http://nope") is ring
    only = HashRing(["http://solo"])
    assert only.without_node("http://solo") is only  # never empty


def test_ring_ownership_fractions():
    ring = HashRing([f"http://w{i}" for i in range(4)])
    owned = ring.ownership()
    assert set(owned) == set(ring.nodes)
    assert sum(owned.values()) == pytest.approx(1.0)
    assert all(v > 0 for v in owned.values())


def test_ring_candidates_deterministic_across_processes():
    """The supervisor and the fleet rely on every process computing
    the same plan from the same membership: ring positions are pure
    sha256 of (node, vnode), nothing process-local."""
    import subprocess
    import sys

    nodes = [f"http://w{i}" for i in range(3)]
    keys = ["a.bam", "b.bam", "c.bam", "d.bam"]
    local = [HashRing(nodes).candidates(k) for k in keys]
    code = (
        "import json\n"
        "from goleft_tpu_torch.fleet.router import HashRing\n"
        f"ring = HashRing({nodes!r})\n"
        f"print(json.dumps([ring.candidates(k) for k in {keys!r}]))\n"
    )
    r = subprocess.run([sys.executable, "-c", code],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout) == local


# ---------------- token buckets / quotas ----------------


def test_token_bucket_refills_and_hints():
    t = {"now": 0.0}
    b = TokenBucket(rate=2.0, burst=2, clock=lambda: t["now"])
    assert b.take() == (True, 0.0)
    assert b.take() == (True, 0.0)
    ok, retry = b.take()
    assert not ok and retry == pytest.approx(0.5)
    t["now"] += 0.5  # one token refilled
    assert b.take() == (True, 0.0)


def test_quota_table_isolates_tenants():
    t = {"now": 0.0}
    q = QuotaTable(["alice=1:2", "*=100:100"],
                   clock=lambda: t["now"])
    q.check("alice")
    q.check("alice")
    with pytest.raises(QuotaExceeded) as ei:
        q.check("alice")
    assert ei.value.retry_after_s > 0
    q.check("bob")  # separate bucket, untouched by alice's flood
    q.check(None)   # "default" rides the * spec


def test_quota_table_unmetered_without_star():
    q = QuotaTable(["alice=1:1"])
    q.check("alice")
    with pytest.raises(QuotaExceeded):
        q.check("alice")
    for _ in range(50):
        q.check("mallory")  # unlisted + no '*': unmetered


def test_quota_spec_validation():
    with pytest.raises(ValueError):
        QuotaTable(["nope"])
    with pytest.raises(ValueError):
        QuotaTable(["a=fast"])
    with pytest.raises(ValueError):
        QuotaTable(["a=0:5"])  # rate must be > 0


# ---------------- fair scheduler ----------------


def test_scheduler_grants_in_priority_order():
    fs = FairScheduler(max_inflight=1, aging_rate=0.0)
    assert fs.acquire("t", 0, timeout_s=5) == 0.0  # slot taken
    order = []

    def waiter(name, prio):
        fs.acquire("t", prio, timeout_s=10)
        order.append(name)
        fs.release()

    ts = []
    for k, (name, prio) in enumerate((("low", 5), ("mid", 3),
                                      ("high", 0)), 1):
        th = threading.Thread(target=waiter, args=(name, prio))
        th.start()
        ts.append(th)
        # deterministic arrival order: this waiter is queued
        _wait_until(lambda k=k: fs.queue_depth() == k, what="queued")
    fs.release()  # free the slot: grants should go high, mid, low
    for th in ts:
        th.join(timeout=10)
    assert order == ["high", "mid", "low"]


def test_scheduler_aging_prevents_starvation():
    # a low-priority waiter ages past fresh high-priority arrivals:
    # after 1s at aging_rate=5 its effective priority is 5 - 5 < 0
    fs = FairScheduler(max_inflight=1, aging_rate=5.0)
    fs.acquire("t", 0, timeout_s=5)
    got = {}

    def old_low():
        got["low"] = fs.acquire("t", 4, timeout_s=10)
        fs.release()

    t_low = threading.Thread(target=old_low)
    t_low.start()
    time.sleep(1.0)  # let it age
    fresh = threading.Thread(
        target=lambda: (fs.acquire("t", 0, timeout_s=10),
                        fs.release()))
    fresh.start()
    _wait_until(lambda: fs.queue_depth() == 2, what="both queued")
    fs.release()
    t_low.join(timeout=10)
    fresh.join(timeout=10)
    assert "low" in got and got["low"] >= 1.0  # aged waiter won


def test_scheduler_deadline_times_out():
    fs = FairScheduler(max_inflight=1)
    fs.acquire("t", 0, timeout_s=5)
    t0 = time.monotonic()
    with pytest.raises(SchedulerTimeout):
        fs.acquire("t", 0, timeout_s=0.2)
    assert time.monotonic() - t0 < 2.0
    fs.release()
    assert fs.acquire("t", 0, timeout_s=1) >= 0  # recovered


# ---------------- router over real HTTP ----------------


def test_router_affinity_same_key_same_worker(two_workers, tmp_path):
    f = tmp_path / "a.bam"
    f.write_bytes(b"x" * 100)
    app = _router(two_workers)
    with RouterThread(app) as url:
        client = ServeClient(url, timeout_s=10)
        homes = {client.depth(str(f))["worker"] for _ in range(5)}
        assert len(homes) == 1  # every repeat landed on its home
        # counters: all routed, all affinity hits
        m = client.metrics()
        routed = sum(v for k, v in m["counters"].items()
                     if k.startswith("fleet.routed_total."))
        assert routed == 5
        assert m["counters"]["fleet.affinity_hits_total.depth"] == 5


def test_router_spreads_distinct_keys(two_workers, tmp_path):
    paths = []
    for i in range(16):
        f = tmp_path / f"s{i}.bam"
        f.write_bytes(bytes([i]) * (50 + i))
        paths.append(str(f))
    app = _router(two_workers)
    with RouterThread(app) as url:
        client = ServeClient(url, timeout_s=10)
        homes = {p: client.depth(p)["worker"] for p in paths}
    assert set(homes.values()) == {"w0", "w1"}  # both workers used


def test_router_retries_on_dead_worker(two_workers, tmp_path):
    """A worker that dies (connection refused) is ejected and its
    traffic retried on the sibling — the client sees one clean 200.
    The poller is held off (a long interval) so that the request, not
    a poll, is what finds the dead worker."""
    f = tmp_path / "a.bam"
    f.write_bytes(b"y" * 80)
    app = _router(two_workers, poll_interval_s=600.0)
    with RouterThread(app) as url:
        client = ServeClient(url, timeout_s=10)
        home = client.depth(str(f))["worker"]
        victim = next(w for w in two_workers
                      if w.state["name"] == home)
        survivor = next(w for w in two_workers if w is not victim)
        victim.kill()
        r = client.depth(str(f))
        assert r["worker"] == survivor.state["name"]
        m = client.metrics()
        assert m["counters"]["fleet.retries_total"] >= 1
        assert m["workers"][victim.url]["healthy"] is False


def test_router_breaker_import_sheds_per_kind(two_workers, tmp_path):
    """A worker reporting an OPEN pairhmm breaker loses ONLY its
    pairhmm traffic; depth keeps landing on it (the affinity home)."""
    f = tmp_path / "doc.json"
    f.write_text("{}")
    app = _router(two_workers)
    with RouterThread(app) as url:
        client = ServeClient(url, timeout_s=10)
        home = client.pairhmm(str(f))["worker"]
        victim = next(w for w in two_workers
                      if w.state["name"] == home)
        sibling = next(w for w in two_workers if w is not victim)
        victim.state["breakers"] = {"pairhmm": "open",
                                    "depth": "closed"}
        app.pool.poll_all()  # import the breaker state now
        assert client.pairhmm(str(f))["worker"] \
            == sibling.state["name"]
        # depth traffic with the same affinity key still lands home
        # (content differs but same file: same ring position)
        assert client.depth(str(f))["worker"] == home


def test_router_reroutes_worker_503_reactively(two_workers, tmp_path):
    """A worker 503ing (breaker answered before the poller noticed)
    is skipped mid-request: the client sees the sibling's 200."""
    f = tmp_path / "b.bam"
    f.write_bytes(b"z" * 64)
    app = _router(two_workers, poll_interval_s=30.0)  # poller idle
    with RouterThread(app) as url:
        client = ServeClient(url, timeout_s=10)
        home = client.depth(str(f))["worker"]
        victim = next(w for w in two_workers
                      if w.state["name"] == home)
        victim.state["shed_kinds"] = {"depth"}
        r = client.depth(str(f))
        assert r["worker"] != home
        m = client.metrics()
        assert sum(v for k, v in m["counters"].items()
                   if k.startswith("fleet.worker_shed_total.")) >= 1


def test_router_quota_429_isolated_per_tenant(two_workers, tmp_path):
    f = tmp_path / "q.bam"
    f.write_bytes(b"q" * 32)
    app = _router(two_workers, quotas=["alice=0.5:2"])
    with RouterThread(app) as url:
        client = ServeClient(url, timeout_s=10)
        client.depth(str(f), tenant="alice")
        client.depth(str(f), tenant="alice")
        with pytest.raises(ServeError) as ei:
            client.depth(str(f), tenant="alice")
        assert ei.value.status == 429
        assert ei.value.retry_after_s > 0
        # an unmetered tenant is untouched by alice's exhaustion
        assert client.depth(str(f), tenant="bob")["worker"]
        m = client.metrics()
        assert m["counters"]["fleet.quota_rejected_total.alice"] == 1


def test_router_redirect_mode_and_client_follow(two_workers,
                                                tmp_path):
    f = tmp_path / "r.bam"
    f.write_bytes(b"r" * 48)
    app = _router(two_workers, redirect=True)
    with RouterThread(app) as url:
        client = ServeClient(url, timeout_s=10)
        r = client.depth(str(f))  # follows the 307 to the worker
        assert r["worker"] in ("w0", "w1")
        # the worker, not the router, saw the POST body
        victim = next(w for w in two_workers
                      if w.state["name"] == r["worker"])
        assert victim.requests("depth")[-1]["bam"] == str(f)


def test_client_honors_retry_after_on_429(two_workers, tmp_path):
    """retries=1: the client sleeps the 429's retry_after_s and the
    refilled bucket admits the retry."""
    f = tmp_path / "h.bam"
    f.write_bytes(b"h" * 16)
    app = _router(two_workers, quotas=["*=5:1"])  # refills in 0.2s
    with RouterThread(app) as url:
        client = ServeClient(url, timeout_s=10, retries=1)
        assert client.depth(str(f))["worker"]  # burst token
        t0 = time.monotonic()
        assert client.depth(str(f))["worker"]  # 429 -> sleep -> 200
        assert time.monotonic() - t0 >= 0.15
        strict = ServeClient(url, timeout_s=10)  # no retries: raises
        with pytest.raises(ServeError) as ei:
            strict.depth(str(f))
        assert ei.value.status == 429


def test_router_plan_endpoint(two_workers, tmp_path):
    f = tmp_path / "p.bam"
    f.write_bytes(b"p" * 24)
    app = _router(two_workers)
    with RouterThread(app) as url:
        client = ServeClient(url, timeout_s=10)
        plan = client.route_plan("depth", bam=str(f))
        assert sorted(plan) == sorted(w.url for w in two_workers)
        assert client.depth(str(f))["worker"] == next(
            w.state["name"] for w in two_workers
            if w.url == plan[0])


def test_router_dynamic_add_and_drain_worker(two_workers, tmp_path):
    """Supervisor levers: a worker added at runtime starts receiving
    its share of traffic; a drained worker stops receiving NEW
    traffic while staying in the pool until removed."""
    app = _router(two_workers)
    w2 = _StubWorker("w2")
    try:
        with RouterThread(app) as url:
            client = ServeClient(url, timeout_s=10)
            app.add_worker(w2.url)
            assert w2.url in app.ring.nodes
            assert w2.url in app.pool.eligible("depth")
            # with enough distinct keys the new worker gets traffic
            names = set()
            for i in range(36):
                f = tmp_path / f"g{i}.bam"
                f.write_bytes(bytes([i]) * (40 + i))
                names.add(client.depth(str(f))["worker"])
            assert names == {"w0", "w1", "w2"}
            # drain w2: new traffic avoids it, it stays known
            app.drain_worker(w2.url)
            assert w2.url not in app.pool.eligible("depth")
            assert w2.url in app.pool.workers
            assert app.pool.inflight(w2.url) == 0
            before = len(w2.requests())
            for i in range(12):
                f = tmp_path / f"h{i}.bam"
                f.write_bytes(bytes([100 + i]) * 30)
                assert client.depth(str(f))["worker"] in ("w0", "w1")
            assert len(w2.requests()) == before
            # remove: gone from ring and pool
            app.remove_worker(w2.url)
            assert w2.url not in app.ring.nodes
            assert w2.url not in app.pool.workers
    finally:
        w2.kill()


def test_client_retry_budget_bounds_total_wait(two_workers, tmp_path):
    """A client with a retry budget stops honoring retry_after_s
    hints once sleeping again would overspend the budget — even with
    retries left."""
    f = tmp_path / "b.bam"
    f.write_bytes(b"b" * 40)
    for w in two_workers:
        w.state["shed_kinds"] = {"depth"}  # all workers shed: 503s
    app = _router(two_workers, poll_interval_s=30.0)
    with RouterThread(app) as url:
        patient = ServeClient(url, timeout_s=10, retries=50,
                              retry_budget_s=0.6)
        t0 = time.monotonic()
        with pytest.raises(ServeError) as ei:
            patient.depth(str(f))
        assert ei.value.status == 503
        # the stub hints 0.5s per retry; a 50-retry client without
        # the budget would sleep ~25s — the budget caps it
        assert time.monotonic() - t0 < 2.0


def test_client_rides_out_draining_window(two_workers, tmp_path):
    """The serve daemon's draining 503 carries retry_after_s; a
    retry-aware client rides out the window (restart/resize) and
    lands the 200 when shedding clears."""
    f = tmp_path / "r.bam"
    f.write_bytes(b"r" * 52)
    app = _router(two_workers, poll_interval_s=30.0)
    with RouterThread(app) as url:
        client = ServeClient(url, timeout_s=10, retries=8,
                             retry_cap_s=1.0, retry_budget_s=10.0)
        for w in two_workers:
            w.state["shed_kinds"] = {"depth"}

        def clear():
            # clear the shed once the client has been turned away on
            # both workers (it is retrying through the window)
            _wait_until(lambda: sum(len(w.requests("depth"))
                                    for w in two_workers) >= 2,
                        what="two shed answers")
            for w in two_workers:
                w.state["shed_kinds"] = set()

        t = threading.Thread(target=clear)
        t.start()
        try:
            r = client.depth(str(f))  # 503s, sleeps, then 200
            assert r["worker"] in ("w0", "w1")
        finally:
            t.join()


# ---------------- continuous batcher ----------------


def test_continuous_batcher_dispatches_immediately():
    """An idle service pays ZERO window latency: one lone request is
    dispatched the moment the dispatcher sees it."""
    batches = []

    def run(key, payloads):
        batches.append(list(payloads))
        return [p * 2 for p in payloads]

    with ContinuousBatcher(run) as cb:
        t0 = time.monotonic()
        assert cb.submit(("k",), 21, timeout_s=5) == 42
        assert time.monotonic() - t0 < 0.5
    assert batches == [[21]]


def test_continuous_batcher_coalesces_arrivals_during_pass():
    """Requests arriving while a pass is in flight ride the NEXT
    dispatch together — the in-flight pass is the coalescing window."""
    release_first = threading.Event()
    in_first = threading.Event()
    batches = []

    def run(key, payloads):
        batches.append(list(payloads))
        if len(batches) == 1:
            in_first.set()
            release_first.wait(timeout=10)
        return list(payloads)

    with ContinuousBatcher(run, max_batch=8) as cb:
        out = []
        lock = threading.Lock()

        def fire(i):
            r = cb.submit(("k",), i, timeout_s=30)
            with lock:
                out.append(r)

        t0 = threading.Thread(target=fire, args=(0,))
        t0.start()
        # pass 1 (just [0]) now blocked in run()
        assert in_first.wait(timeout=10)
        ts = [threading.Thread(target=fire, args=(i,))
              for i in range(1, 6)]
        for t in ts:
            t.start()
        # all five queued behind the in-flight pass
        _wait_until(lambda: cb.queue_depth() == 5, what="five queued")
        release_first.set()
        for t in [t0] + ts:
            t.join(timeout=30)
    assert sorted(out) == list(range(6))
    assert len(batches) == 2, batches  # [0] then [1..5] coalesced
    assert sorted(batches[1]) == [1, 2, 3, 4, 5]


def test_continuous_batcher_respects_max_batch():
    gate = threading.Event()
    in_first = threading.Event()
    batches = []

    def run(key, payloads):
        batches.append(list(payloads))
        if len(batches) == 1:
            in_first.set()
            gate.wait(timeout=10)
        return list(payloads)

    with ContinuousBatcher(run, max_batch=2) as cb:
        ts = [threading.Thread(
            target=lambda i=i: cb.submit(("k",), i, timeout_s=30))
            for i in range(5)]
        ts[0].start()
        assert in_first.wait(timeout=10)
        for t in ts[1:]:
            t.start()
        _wait_until(lambda: cb.queue_depth() == 4, what="four queued")
        gate.set()
        for t in ts:
            t.join(timeout=30)
    assert all(len(b) <= 2 for b in batches)
    assert sum(len(b) for b in batches) == 5


# ---------------- hygiene ----------------


def test_router_file_key_matches_scheduler_definition(tmp_path):
    """The router carries its own _file_key so the router process
    never imports goleft_tpu_torch.parallel; the two definitions must
    stay identical."""
    from goleft_tpu_torch.fleet.router import _file_key
    from goleft_tpu_torch.parallel.scheduler import file_key

    f = tmp_path / "k.bam"
    f.write_bytes(b"k" * 77)
    assert _file_key(str(f)) == file_key(str(f))


def test_fleet_modules_do_not_import_jax():
    """The router's whole point is being a cheap torch-free forwarder:
    importing the fleet package (in a fresh interpreter) must pull in
    neither torch nor jax nor the JAX package."""
    import subprocess
    import sys

    code = ("import sys; import goleft_tpu_torch.fleet; "
            "import goleft_tpu_torch.commands.fleet; "
            "sys.exit(1 if {'torch', 'jax', 'goleft_tpu'} "
            "& set(sys.modules) else 0)")
    r = subprocess.run([sys.executable, "-c", code],
                      capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()


# ---------------- poll-schedule lock discipline ----------------
# Regression for the lck-foreign-write lint finding: the poller
# loop used to read/advance _Worker.next_poll_at WITHOUT the pool
# lock, racing the supervisor's add() (which writes the new worker's
# phase offset under it). Every schedule access now shares the lock;
# these tests pin both the discipline and the schedule semantics the
# refactor had to preserve.


def _quiet_pool(urls, interval=10.0):
    from goleft_tpu_torch.fleet.router import WorkerPool

    return WorkerPool(urls, poll_interval_s=interval)


def test_pool_schedule_access_holds_the_pool_lock():
    pool = _quiet_pool(["http://127.0.0.1:9301"])
    w = next(iter(pool.workers.values()))
    entered = threading.Event()
    done = threading.Event()

    def advance():
        entered.set()
        pool._advance_schedule(w)
        done.set()

    with pool._lock:
        t = threading.Thread(target=advance)
        t.start()
        assert entered.wait(2.0)
        # the schedule write must BLOCK while we hold the pool lock
        assert not done.wait(0.15)
    assert done.wait(2.0)
    t.join(timeout=5.0)

    # _due_workers takes the same lock
    done2 = threading.Event()

    def due():
        pool._due_workers(time.monotonic())
        done2.set()

    with pool._lock:
        t2 = threading.Thread(target=due)
        t2.start()
        assert not done2.wait(0.15)
    assert done2.wait(2.0)
    t2.join(timeout=5.0)


def test_pool_schedule_semantics_preserved():
    pool = _quiet_pool(["http://127.0.0.1:9302",
                        "http://127.0.0.1:9303"], interval=10.0)
    ws = sorted(pool.workers.values(), key=lambda w: w.url)
    now = time.monotonic()
    ws[0].next_poll_at = now - 1.0   # due
    ws[1].next_poll_at = now + 5.0   # not yet
    due = pool._due_workers(now)
    assert due == [ws[0]]
    # on-schedule advance: exactly one interval
    ws[0].next_poll_at = now + 9.0
    pool._advance_schedule(ws[0])
    assert abs(ws[0].next_poll_at - (now + 19.0)) < 0.5
    # fell-behind worker is re-phased from NOW, not burst-caught-up
    ws[0].next_poll_at = now - 100.0
    pool._advance_schedule(ws[0])
    assert ws[0].next_poll_at > time.monotonic() + 9.0


def test_pool_add_mid_run_keeps_jittered_phase():
    from goleft_tpu_torch.obs.fleetplane import poll_jitter_frac

    pool = _quiet_pool(["http://127.0.0.1:9304"], interval=10.0)
    url = "http://127.0.0.1:9305"
    t0 = time.monotonic()
    pool.add(url)
    w = pool.workers[url]
    expect = poll_jitter_frac(url) * 10.0
    assert abs((w.next_poll_at - t0) - expect) < 0.5
    # not swept into an immediate poll: the phase offset holds
    if expect > 1.0:
        assert w not in pool._due_workers(time.monotonic())


def test_federation_schedule_access_holds_the_pool_lock():
    from goleft_tpu_torch.fleet.federation import FleetPool

    pool = FleetPool(["http://127.0.0.1:9306"],
                     poll_interval_s=10.0)
    f = next(iter(pool.fleets.values()))
    done = threading.Event()

    def advance():
        pool._advance_schedule(f)
        done.set()

    with pool._lock:
        t = threading.Thread(target=advance)
        t.start()
        assert not done.wait(0.15)
    assert done.wait(2.0)
    t.join(timeout=5.0)
    # and the semantics match the router's
    now = time.monotonic()
    f.next_poll_at = now - 1.0
    assert pool._due_fleets(now) == [f]
    f.next_poll_at = now - 100.0
    pool._advance_schedule(f)
    assert f.next_poll_at > time.monotonic() + 9.0


# ---------------- the listen backlog ----------------


class _BulkHandler(BaseHTTPRequestHandler):
    """A worker that answers every POST after 50 ms with a 0.5 MB body:
    the router's handler threads then hold the GIL long enough that its
    accept loop falls behind a burst."""

    BODY = json.dumps({"depth_bed": "x" * 500_000}).encode()

    def log_message(self, *a):
        pass

    def do_GET(self):  # noqa: N802
        data = b'{"status": "ok"}'
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length", "0")))
        time.sleep(0.05)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(self.BODY)))
        self.end_headers()
        self.wfile.write(self.BODY)


def test_router_answers_a_burst_past_the_default_backlog():
    """Rounds of 32 concurrent clients through the router: every request
    is answered. With socketserver's listen backlog of 5 (the JAX
    package's router keeps it) about a third of them got a connection
    reset; so did one request of chip_smoke.py's burst of 8 on the card.
    The serve daemon and the federation share the backlog."""
    import urllib.request

    from goleft_tpu_torch.fleet import federation, router
    from goleft_tpu_torch.serve import server

    class Big(ThreadingHTTPServer):
        request_queue_size = 128  # the stub workers are not under test

    ws = [Big(("127.0.0.1", 0), _BulkHandler) for _ in range(2)]
    threads = [threading.Thread(target=w.serve_forever, daemon=True)
               for w in ws]
    for t in threads:
        t.start()
    app = RouterApp([f"http://127.0.0.1:{w.server_address[1]}"
                     for w in ws], poll_interval_s=600.0)
    bad = []
    try:
        with RouterThread(app) as url:
            for rnd in range(5):
                go = threading.Event()

                def fire(i, rnd=rnd):
                    go.wait(timeout=30)
                    req = urllib.request.Request(
                        url + "/v1/depth",
                        data=json.dumps({"bam": f"/x/{rnd}-{i}.bam"})
                        .encode(),
                        headers={"Content-Type": "application/json"})
                    try:
                        with urllib.request.urlopen(req, timeout=60) as r:
                            assert len(r.read()) == len(_BulkHandler.BODY)
                    except OSError as e:
                        bad.append(repr(e))

                ts = [threading.Thread(target=fire, args=(i,))
                      for i in range(32)]
                for t in ts:
                    t.start()
                go.set()
                for t in ts:
                    t.join(timeout=120)
                    assert not t.is_alive()
    finally:
        for w in ws:
            w.shutdown()
            w.server_close()
    assert bad == [], f"{len(bad)} of 160 requests failed: {bad[:3]}"
    assert server.LISTEN_BACKLOG >= 128
    for cls in (router._RouterServer, federation._FederationServer,
                server._Server):
        assert cls.request_queue_size == server.LISTEN_BACKLOG, cls
