"""Federation tier of the port (the reference's tests/test_federation.py
on goleft_tpu_torch's copies): fleet-level affinity + failover +
half-open rejoin, saturation spillover with key migration,
tenant-scoped burn shedding, cross-fleet trace stitching, client
redirect hygiene and the shared-cache eviction lease.

Everything here is torch-free and cheap (stub fleets are tiny stdlib
HTTP servers); chip_smoke.py's fleet phase runs a federation over a
real port fleet on the card.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from goleft_tpu_torch.fleet import federation as fd
from goleft_tpu_torch.obs import fleetplane as fp
from goleft_tpu_torch.obs.metrics import MetricsRegistry


# ---------------- TenantSLOTracker ----------------


def test_tenant_tracker_rates_and_burn_window():
    clk = [100.0]
    tr = fd.TenantSLOTracker(window_s=60.0, p99_target_s=1.0,
                             clock=lambda: clk[0])
    for _ in range(8):
        tr.record("alice", 200, seconds=0.1)
    for _ in range(6):
        tr.record("mallory", 429, seconds=0.05)
    tr.record("mallory", 200, seconds=0.05)
    tr.record("mallory", 503, seconds=0.05)
    snap = tr.snapshot()
    assert snap["alice"]["error_rate"] == 0.0
    assert snap["alice"]["window_requests"] == 8
    # 429 AND 5xx burn the tenant's budget; a 200 does not
    assert snap["mallory"]["window_requests"] == 8
    assert snap["mallory"]["error_rate"] == pytest.approx(7 / 8)
    # p99 ratio vs the 1s target
    assert snap["alice"]["p99_latency_ratio"] == pytest.approx(
        0.1, abs=0.01)
    # burn_clear_s: the oldest burned outcome ages out with the window
    assert tr.burn_clear_s("mallory") == pytest.approx(60.0, abs=1.0)
    assert tr.burn_clear_s("alice") == 0.0
    # outcomes age out
    clk[0] += 61.0
    assert tr.snapshot() == {}
    assert tr.burn_clear_s("mallory") == 0.0


def test_tenant_tracker_bounds_tenant_count():
    tr = fd.TenantSLOTracker(max_tenants=4)
    for i in range(10):
        tr.record(f"t{i}", 200)
    snap = tr.snapshot()
    assert len(snap) <= 4
    assert "t9" in snap  # newest survives, stalest evicted


def test_merge_tenant_slos_weighted_and_worst():
    merged = fp.merge_tenant_slos([
        {"mallory": {"window_requests": 10, "error_rate": 1.0,
                     "p99_latency_ratio": 0.5},
         "alice": {"window_requests": 50, "error_rate": 0.0}},
        {"mallory": {"window_requests": 30, "error_rate": 0.5,
                     "p99_latency_ratio": 2.0}},
    ], error_budget=0.01)
    m = merged["mallory"]
    assert m["window_requests"] == 40
    assert m["error_rate"] == pytest.approx((10 * 1.0 + 30 * 0.5)
                                            / 40)
    assert m["p99_latency_ratio"] == pytest.approx(2.0)  # worst
    assert m["burn_rate"] == pytest.approx(m["error_rate"] / 0.01)
    assert merged["alice"]["burn_rate"] == 0.0


# ---------------- affinity, spillover, failover plan ------------


def _fed(urls=None, **kw):
    kw.setdefault("spill_threshold", 1.0)
    return fd.FederationRouter(
        urls or ["http://127.0.0.1:7001", "http://127.0.0.1:7002",
                 "http://127.0.0.1:7003"], **kw)


def _set(fed, url, **attrs):
    f = fed.pool.fleets[url]
    for k, v in attrs.items():
        setattr(f, k, v)


def test_affinity_stable_and_plan_prefers_target():
    fed = _fed()
    try:
        key = fed.affinity_key("depth", {"bam": "/no/such.bam"})
        home = fed.ring.candidates(key)[0]
        assert fed.resolve_target("depth", key) == home
        # stable across calls (the _homes table remembers)
        assert fed.resolve_target("depth", key) == home
        plan = fed.plan("depth", {"bam": "/no/such.bam"})
        assert plan[0] == home and set(plan) == set(fed.ring.nodes)
    finally:
        fed.close()


def test_new_key_spills_off_saturated_home_and_migrates_back():
    fed = _fed()
    try:
        key = "spill-me"
        order = fed.ring.candidates(key)
        home, alt = order[0], order[1]
        # the home fleet is alive but burning past the threshold
        _set(fed, home, saturated=True, burn_rate=2.5)
        got = fed.resolve_target("depth", key)
        assert got == alt
        c = fed.registry.snapshot()["counters"]
        assert c["federation.spills_total"] == 1
        # the spilled key STAYS at its spill target while home burns
        assert fed.resolve_target("depth", key) == alt
        # recovery: the key migrates home (cache locality reclaimed)
        _set(fed, home, saturated=False, burn_rate=0.2)
        assert fed.resolve_target("depth", key) == home
        c = fed.registry.snapshot()["counters"]
        assert c["federation.spill_migrations_total"] == 1
        # and sticks there
        assert fed.resolve_target("depth", key) == home
    finally:
        fed.close()


def test_existing_key_keeps_saturated_home():
    fed = _fed()
    try:
        key = "warm-key"
        home = fed.ring.candidates(key)[0]
        assert fed.resolve_target("depth", key) == home  # homed warm
        _set(fed, home, saturated=True, burn_rate=9.9)
        # existing keys stay for cache warmth until it trips fully
        assert fed.resolve_target("depth", key) == home
        assert "federation.spills_total" not in \
            fed.registry.snapshot()["counters"]
    finally:
        fed.close()


def test_down_home_is_failover_not_spill():
    fed = _fed()
    try:
        key = "dead-home-key"
        order = fed.ring.candidates(key)
        home = order[0]
        _set(fed, home, state=fd.DOWN)
        # resolve keeps the ring home (failover is per-request, the
        # home is not rewritten) but the PLAN puts a live fleet first
        # after the ineligible target
        assert fed.resolve_target("depth", key) == home
        plan = fed.plan("depth", key_req := {"bam": "zzz"})
        assert set(plan) == set(fed.ring.nodes)
        # the spilled-keys table stays empty: down ≠ saturated
        assert fed.registry.snapshot()["counters"].get(
            "federation.spills_total", 0) == 0
        del key_req
    finally:
        fed.close()


def test_fleet_pool_half_open_probe_discipline():
    fed = _fed()
    try:
        url = fed.ring.nodes[0]
        fed.pool.mark_failed(url)
        assert fed.pool.fleets[url].state == fd.DOWN
        assert url not in fed.pool.eligible()
        assert not fed.pool.try_begin_forward(url)
        # healthz answers again → half-open (the poller's transition,
        # driven directly here)
        _set(fed, url, state=fd.PROBE, probing=False)
        assert url in fed.pool.eligible()
        assert url not in fed.pool.spill_targets()  # no NEW keys yet
        # exactly one probe at a time
        assert fed.pool.try_begin_forward(url)
        assert not fed.pool.try_begin_forward(url)
        # a failed probe goes straight back down…
        fed.pool.mark_failed(url)
        assert fed.pool.fleets[url].state == fd.DOWN
        # …and a successful one rejoins
        _set(fed, url, state=fd.PROBE, probing=False)
        assert fed.pool.try_begin_forward(url)
        fed.pool.settle_forward(url, ok=True)
        assert fed.pool.fleets[url].state == fd.UP
        assert url in fed.pool.spill_targets()
        c = fed.registry.snapshot()["counters"]
        assert c["federation.fleet_rejoin_total"] == 1
    finally:
        fed.close()


# ---------------- tenant-scoped shed (injected burn) ------------


def test_injected_tenant_burn_drives_gauges_and_shed():
    fed = _fed(tenant_burn_threshold=2.0, tenant_shed_min_requests=4)
    try:
        # inject the burn: mallory's window is all 429s (the
        # supervisor-trigger test pattern, one tier up)
        for _ in range(6):
            fed.tenants.record("mallory", 429, seconds=0.01)
        for _ in range(6):
            fed.tenants.record("alice", 200, seconds=0.01)
        burns = fed.tenant_burn_rates()
        assert burns["mallory"]["burn_rate"] > 2.0
        assert burns["alice"]["burn_rate"] < 0.1  # tiny p99 share
        # the gauges ARE the decision surface: both encodings carry
        # federation.tenant.burn_rate.<tenant>
        snap = fed.metrics_snapshot()
        assert snap["gauges"][
            "federation.tenant.burn_rate.mallory"] > 2.0
        assert snap["gauges"][
            "federation.tenant.burn_rate.alice"] < 0.1
        prom = fed.metrics_prometheus()
        assert "federation_tenant_burn_rate_mallory" in prom
        assert "federation_tenant_burn_rate_alice" in prom
        # best-effort mallory sheds 429 with an honest retry hint…
        code, body = fed.handle(
            "depth", json.dumps({"bam": "x.bam",
                                 "tenant": "mallory",
                                 "priority": 1}).encode())
        assert code == 429
        assert body["shed"] == "tenant-burn"
        assert body["retry_after_s"] >= 1.0
        c = fed.registry.snapshot()["counters"]
        assert c["federation.tenant_shed_total.mallory"] == 1
        # …interactive mallory traffic (priority 0) is NOT shed here
        code, body = fed.handle(
            "depth", json.dumps({"bam": "x.bam",
                                 "tenant": "mallory"}).encode())
        assert code != 429 or body.get("shed") != "tenant-burn"
        # …and a breaching-but-thin tenant is protected by the
        # min-evidence gate
        fed.tenants.record("newbie", 503, seconds=0.01)
        code, body = fed.handle(
            "depth", json.dumps({"bam": "x.bam", "tenant": "newbie",
                                 "priority": 1}).encode())
        assert body.get("shed") != "tenant-burn"
    finally:
        fed.close()


def test_tenant_burn_merges_downstream_fleet_blocks():
    fed = _fed(tenant_burn_threshold=2.0)
    try:
        # no local evidence; a fleet's rolled-up slo.tenants block
        # (polled) carries the burn — the federation must see it
        _set(fed, fed.ring.nodes[0], tenants={
            "mallory": {"window_requests": 20, "error_rate": 0.8}})
        burns = fed.tenant_burn_rates()
        assert burns["mallory"]["burn_rate"] == pytest.approx(80.0)
    finally:
        fed.close()


# ---------------- stitch_federation ----------------


def _fed_record(trace_id, span_id=1, fwd_span=7):
    return {
        "name": "federation.request.depth", "trace_id": trace_id,
        "span_id": span_id, "start_ms": 0.0, "duration_ms": 12.0,
        "pid": 111, "ts": "2026-08-04T00:00:00.000+00:00",
        "children": [
            {"name": "federation.forward.depth", "span_id": fwd_span,
             "start_ms": 1.0, "duration_ms": 10.0, "children": []},
        ],
    }


def _fleet_doc(trace_id, remote_parent, ts_offset_s=0.0):
    import datetime

    base = datetime.datetime.fromisoformat(
        "2026-08-04T00:00:00.000+00:00")
    ts = (base + datetime.timedelta(seconds=ts_offset_s)) \
        .isoformat(timespec="milliseconds")
    return {
        "trace_id": trace_id,
        "processes": {"router": {"pid": 222, "spans": 2},
                      "worker:9001": {"pid": 333, "spans": 1}},
        "span_count": 3,
        "tree": {
            "name": "fleet.request.depth", "trace_id": trace_id,
            "span_id": 5, "start_ms": 0.0, "duration_ms": 8.0,
            "pid": 222, "ts": ts, "process": "router",
            "attrs": {"remote_parent": remote_parent},
            "children": [
                {"name": "request.depth", "span_id": 9,
                 "start_ms": 2.0, "duration_ms": 5.0,
                 "process": "worker:9001", "children": []},
            ],
        },
    }


def test_stitch_federation_grafts_under_forward_span():
    tid = "serve-cli-1-1"
    doc = fp.stitch_federation(
        tid, [_fed_record(tid, fwd_span=7)],
        {"http://f:8090": _fleet_doc(tid, remote_parent=7,
                                     ts_offset_s=0.002)})
    assert doc["trace_id"] == tid
    # fleet processes are namespaced so two fleets' routers stay
    # distinct tracks
    assert "fleet:8090/router" in doc["processes"]
    assert "fleet:8090/worker:9001" in doc["processes"]
    assert "federation" in doc["processes"]
    fwd = doc["tree"]["children"][0]
    assert fwd["name"] == "federation.forward.depth"
    graft = fwd["children"][0]
    assert graft["name"] == "fleet.request.depth"
    assert graft["process"] == "fleet:8090/router"
    # clock rebase: the fleet root's wall ts (2ms after the fed root)
    assert graft["start_ms"] == pytest.approx(2.0, abs=0.5)
    assert doc["span_count"] == 2 + 3
    # perfetto renders it with distinct tracks
    perf = fp.perfetto_export(tid, doc)
    procs = {e["args"]["name"] for e in perf["traceEvents"]
             if e.get("name") == "process_name"}
    assert {"federation", "fleet:8090/router",
            "fleet:8090/worker:9001"} <= procs


def test_stitch_federation_clock_offset_corrects_skew():
    tid = "serve-cli-1-2"
    # the fleet's clock runs 5s AHEAD; the poller's handshake knows
    doc = fp.stitch_federation(
        tid, [_fed_record(tid, fwd_span=7)],
        {"http://f:8090": _fleet_doc(tid, remote_parent=7,
                                     ts_offset_s=5.0)},
        clock_offsets={"http://f:8090": 5.0})
    graft = doc["tree"]["children"][0]["children"][0]
    assert graft["start_ms"] == pytest.approx(0.0, abs=1.0)


def test_stitch_federation_synthesizes_root_and_404s():
    tid = "serve-cli-1-3"
    assert fp.stitch_federation(tid, [], {"http://f:1": None}) is None
    doc = fp.stitch_federation(
        tid, [], {"http://f:8090": _fleet_doc(tid, remote_parent=7)})
    assert doc["tree"].get("synthesized") is True
    assert doc["tree"]["children"][0]["name"] == "fleet.request.depth"


# ---------------- HTTP surface over stub fleets ----------------


class _StubFleetHandler(BaseHTTPRequestHandler):
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
            self._json(200, {"status": "ok", "healthy": 1,
                             "now": time.time()
                             + s.get("clock_skew_s", 0.0)})
        elif self.path.startswith("/fleet/metrics"):
            self._json(200, {"slo": s.get("slo", {
                "burn_rate_max": 0.1, "tenants": {}})})
        elif self.path.startswith("/fleet/trace/"):
            tid = self.path[len("/fleet/trace/"):]
            seen = s.get("trace_ctx")
            if seen and seen[0] == tid:
                self._json(200, _fleet_doc(tid,
                                           remote_parent=seen[1]))
            else:
                self._json(404, {"error": "no trace"})
        else:
            self._json(404, {"error": "?"})

    def do_POST(self):  # noqa: N802
        s = self.server.state
        n = int(self.headers.get("Content-Length", "0"))
        body = json.loads(self.rfile.read(n) or b"{}")
        ctx = fp.parse_trace_header(
            self.headers.get("x-goleft-trace"))
        if ctx:
            s["trace_ctx"] = ctx
        if s.get("shed_503"):
            self._json(503, {"error": "no healthy worker",
                             "retry_after_s": 0.5})
            return
        self._json(200, {"fleet": s["name"],
                         "echo": body.get("bam")})


class _StubFleet:
    def __init__(self, name, **state):
        self.state = {"name": name, **state}
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                         _StubFleetHandler)
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


@pytest.fixture()
def stub_fleets():
    fleets = [_StubFleet("f0"), _StubFleet("f1")]
    try:
        yield fleets
    finally:
        for f in fleets:
            try:
                f.kill()
            except Exception:  # noqa: BLE001 — already killed in-test
                pass


def test_federation_routes_and_fails_over_http(stub_fleets):
    from goleft_tpu_torch.serve.client import ServeClient

    # a LONG poll interval pins the REACTIVE path: the forward (not
    # the poller) must discover the dead fleet and retry mid-request
    app = fd.FederationRouter([f.url for f in stub_fleets],
                              poll_interval_s=30.0, down_after=2)
    with fd.FederationThread(app) as url:
        client = ServeClient(url, timeout_s=30.0)
        r = client.depth("whatever.bam")
        assert r["fleet"] in ("f0", "f1")
        home_name = r["fleet"]
        # affinity: the same request keeps landing on the same fleet
        assert client.depth("whatever.bam")["fleet"] == home_name
        plan = client.route_plan("depth", bam="whatever.bam")
        assert plan[0] == next(f.url for f in stub_fleets
                               if f.state["name"] == home_name)
        # SIGKILL the home fleet (socket gone): the next request
        # fails over to the surviving fleet, same answer shape
        next(f for f in stub_fleets
             if f.state["name"] == home_name).kill()
        r2 = client.depth("whatever.bam")
        assert r2["fleet"] != home_name
        snap = app.registry.snapshot()["counters"]
        assert snap.get("federation.fleet_down_total", 0) >= 1
        assert snap.get("federation.retries_total", 0) >= 1
        # healthz reports the degraded tier honestly
        h = client.healthz()
        assert h["fleets"] == 2 and h["fleets_up"] <= 1


def test_federation_reactive_spill_on_fleet_503(stub_fleets):
    from goleft_tpu_torch.serve.client import ServeClient

    app = fd.FederationRouter([f.url for f in stub_fleets],
                              poll_interval_s=30.0, down_after=2)
    with fd.FederationThread(app) as url:
        client = ServeClient(url, timeout_s=30.0)
        home = client.depth("spillover.bam")["fleet"]
        # the home fleet starts answering 503 (no healthy worker):
        # requests re-route reactively, before any poll notices
        next(f for f in stub_fleets
             if f.state["name"] == home).state["shed_503"] = True
        r = client.depth("spillover.bam")
        assert r["fleet"] != home
        c = app.registry.snapshot()["counters"]
        assert any(k.startswith("federation.fleet_shed_total.")
                   for k in c)


def test_federation_trace_stitched_over_http(stub_fleets):
    from goleft_tpu_torch.serve.client import ServeClient

    app = fd.FederationRouter([f.url for f in stub_fleets],
                              poll_interval_s=0.2, down_after=1)
    with fd.FederationThread(app) as url:
        client = ServeClient(url, timeout_s=30.0, trace=True)
        client.depth("traced.bam")
        tid = client.last_trace_id
        assert tid
        doc = client.fleet_trace(tid)
        assert doc["trace_id"] == tid
        tree = doc["tree"]
        assert tree["name"] == "federation.request.depth"
        fwd = next(n for n in _walk(tree)
                   if n["name"] == "federation.forward.depth")
        graft = next(n for n in fwd["children"]
                     if n["name"] == "fleet.request.depth")
        assert graft["process"].startswith("fleet:")
        assert any(n["name"] == "request.depth"
                   for n in _walk(graft))
        assert doc["perfetto"]["traceEvents"]
        # unknown id → 404
        from goleft_tpu_torch.serve.client import ServeError

        with pytest.raises(ServeError) as ei:
            client.fleet_trace("serve-cli-never-1")
        assert ei.value.status == 404


def _walk(node):
    yield node
    for c in node.get("children", ()):
        yield from _walk(c)


def test_federation_poller_estimates_fleet_clock_offset():
    skewed = _StubFleet("skew", clock_skew_s=5.0)
    try:
        app = fd.FederationRouter([skewed.url],
                                  poll_interval_s=30.0, down_after=1)
        try:
            app.pool.poll_all()
            offs = app.pool.clock_offsets()
            assert offs[skewed.url] == pytest.approx(5.0, abs=1.0)
        finally:
            app.close()
    finally:
        skewed.kill()


def test_federation_imports_no_jax():
    import subprocess
    import sys

    code = ("import sys\n"
            "import goleft_tpu_torch.fleet.federation\n"
            "import goleft_tpu_torch.commands.federation\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'torch', 'goleft_tpu')]\n"
            "assert not bad, bad\n")
    cp = subprocess.run([sys.executable, "-c", code],
                        capture_output=True, text=True, timeout=120)
    assert cp.returncode == 0, cp.stderr[-800:]


# ---------------- satellite: client redirect hygiene ------------


class _RedirectHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_POST(self):  # noqa: N802
        s = self.server.state
        n = int(self.headers.get("Content-Length", "0"))
        self.rfile.read(n)
        s.setdefault("trace_headers", []).append(
            self.headers.get("x-goleft-trace"))
        s["hits"] = s.get("hits", 0) + 1
        if s["hits"] <= s.get("redirects", 0):
            data = json.dumps({"location": s["base"]
                               + self.path}).encode()
            self.send_response(307)
            self.send_header("Location", s["base"] + self.path)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(data)
        else:
            data = json.dumps({"ok": True,
                               "hops": s["hits"]}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(data)
        self.close_connection = True


@pytest.fixture()
def redirect_server():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _RedirectHandler)
    httpd.state = {}
    t = threading.Thread(target=httpd.serve_forever,
                         kwargs={"poll_interval": 0.02}, daemon=True)
    t.start()
    host, port = httpd.server_address[:2]
    httpd.state["base"] = f"http://{host}:{port}"
    try:
        yield httpd
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def test_client_follows_bounded_redirects_reattaching_trace(
        redirect_server):
    from goleft_tpu_torch.serve.client import ServeClient

    st = redirect_server.state
    st["redirects"] = 3
    client = ServeClient(st["base"], timeout_s=10.0,
                         max_redirects=4, trace=True)
    r = client.depth("r.bam")
    assert r["ok"] is True and r["hops"] == 4
    tid = client.last_trace_id
    # EVERY hop's re-POST carried the trace header (the fixed bug:
    # only the original request was guaranteed to)
    assert len(st["trace_headers"]) == 4
    assert all(h == tid for h in st["trace_headers"])


def test_client_caps_total_redirects_per_request(redirect_server):
    from goleft_tpu_torch.serve.client import ServeClient, ServeError

    st = redirect_server.state
    st["redirects"] = 10**9  # redirect forever
    client = ServeClient(st["base"], timeout_s=10.0, max_redirects=3)
    with pytest.raises(ServeError) as ei:
        client.depth("loop.bam")
    assert ei.value.status == 508
    # the cap is per REQUEST: 1 original + 3 follows = 4 exchanges
    assert st["hits"] == 4


def test_client_redirects_count_against_retry_budget(
        redirect_server):
    from goleft_tpu_torch.serve.client import ServeClient, ServeError

    st = redirect_server.state
    st["redirects"] = 10**9
    client = ServeClient(st["base"], timeout_s=10.0,
                         max_redirects=10**6, retry_budget_s=0.0)
    with pytest.raises(ServeError) as ei:
        client.depth("budget.bam")
    assert ei.value.status == 508
    assert "budget" in ei.value.message
    # the budget stopped the chain after the first follow decision
    assert st["hits"] <= 2


# ---------------- satellite: shared-cache eviction lease --------


def test_cache_eviction_single_elected_sweeper(tmp_path):
    from goleft_tpu_torch.obs import get_registry
    from goleft_tpu_torch.parallel.scheduler import EVICT_LEASE, ResultCache

    reg = get_registry()

    def counters():
        s = reg.snapshot()["counters"]
        return (s.get("cache.evict_sweeps_total", 0),
                s.get("cache.evict_lease_steals_total", 0))

    d = str(tmp_path / "shared")
    c1 = ResultCache(d, max_bytes=128)
    c2 = ResultCache(d, max_bytes=128)
    sweeps0, steals0 = counters()
    c1.put(("a",), b"x" * 64)
    sweeps1, steals1 = counters()
    assert sweeps1 == sweeps0 + 1  # c1 took the lease and swept
    assert steals1 == steals0
    # c2 contends while the lease is live: NO second sweeper
    c2.put(("b",), b"y" * 64)
    sweeps2, steals2 = counters()
    assert sweeps2 == sweeps1
    assert steals2 == steals1
    # the holder keeps sweeping (renewal)
    c1.put(("c",), b"z" * 64)
    assert counters()[0] == sweeps2 + 1
    # stale lease (holder crashed): c2 takes over, counted
    import os

    lease = os.path.join(d, EVICT_LEASE)
    old = time.time() - 3600
    os.utime(lease, (old, old))
    c2.put(("d",), b"w" * 64)
    sweeps3, steals3 = counters()
    assert sweeps3 == sweeps2 + 2
    assert steals3 == steals1 + 1
    # the bound is still enforced by whoever sweeps
    assert c2.stats()["bytes"] <= 128 + 64


def test_cache_two_worker_contention_under_threads(tmp_path):
    from goleft_tpu_torch.parallel.scheduler import ResultCache

    d = str(tmp_path / "contend")
    caches = [ResultCache(d, max_bytes=512) for _ in range(2)]
    errs = []

    def worker(cache, base):
        try:
            for i in range(25):
                cache.put((base, i), bytes(64))
                cache.get((base, (i * 7) % 25))
        except Exception as e:  # noqa: BLE001 — the assertion
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(c, i))
          for i, c in enumerate(caches)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errs
    # the bound is enforced by the HOLDER's sweeps — a non-holder's
    # final put legitimately leaves the directory over-bound until
    # the holder sweeps again. Settle: one more put from each side
    # (whichever holds the lease sweeps) and the bound must stand,
    # modulo the entries that landed after that sweep.
    caches[0].put(("settle", 0), b"")
    caches[1].put(("settle", 1), b"")
    assert caches[0].stats()["bytes"] <= 512 + 3 * 96
