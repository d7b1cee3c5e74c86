"""Fleet observability plane of the port (the reference's
tests/test_fleetplane.py on goleft_tpu_torch's copies): trace
propagation + stitching, metrics rollup + burn rate, the event journal,
and the router HTTP surface (/fleet/metrics, /fleet/trace) over stub
workers.

Everything here is torch-free and cheap: the plane's contracts (header
grammar, merge arithmetic, graft rules, journal durability) are
pure-stdlib; the parity of each function with the reference's is in
tests/test_torch_fleet_parity.py.
"""

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from goleft_tpu_torch import obs
from goleft_tpu_torch.obs import fleetplane as fp
from goleft_tpu_torch.obs.events import (
    EventJournal, EventLog, parse_since, read_events,
)
from goleft_tpu_torch.serve.flight import FlightRecorder


# ---------------- trace header grammar ----------------


def test_trace_header_round_trip():
    assert fp.parse_trace_header(fp.format_trace_header("t-1", 42)) \
        == ("t-1", 42)
    assert fp.parse_trace_header(fp.format_trace_header("t-1")) \
        == ("t-1", None)


@pytest.mark.parametrize("bad", [
    None, "", "has space;3", "t;" + "x",  # non-int span
    "x" * 200,                            # over MAX_TRACE_ID
    "evil\x00id", "tab\tid;1",
])
def test_trace_header_rejects_garbage(bad):
    assert fp.parse_trace_header(bad) is None


def test_mint_trace_id_unique_and_watched_prefix():
    a, b = fp.mint_trace_id(), fp.mint_trace_id()
    assert a != b
    # the serve flight recorder only retains watched prefixes: a
    # client-minted id must be retained end to end
    from goleft_tpu_torch.serve.flight import WATCH_PREFIXES

    assert a.startswith(WATCH_PREFIXES)
    assert fp.parse_trace_header(a) == (a, None)


def test_tracer_adopts_remote_context():
    tracer = obs.get_tracer()
    with tracer.trace("request.depth", kind="serve",
                      trace_id="serve-cli-9-1",
                      remote_parent=77) as root:
        assert root.trace_id == "serve-cli-9-1"
        assert tracer.current_trace_id() == "serve-cli-9-1"
        assert root.attrs["remote_parent"] == 77
        # local parent chain untouched: the root is still a root
        assert root.parent_id is None
    assert tracer.current_trace_id() is None


# ---------------- poller jitter ----------------


def test_poll_jitter_deterministic_and_spread():
    urls = [f"http://127.0.0.1:{8000 + i}" for i in range(16)]
    offs = [fp.poll_jitter_frac(u) for u in urls]
    assert offs == [fp.poll_jitter_frac(u) for u in urls]  # stable
    assert all(0.0 <= o < 1.0 for o in offs)
    # spread, not a burst: 16 workers must not collapse onto a tick —
    # pairwise distinct and covering a wide swath of the interval
    assert len(set(offs)) == len(offs)
    assert max(offs) - min(offs) > 0.5
    # and both halves of the interval are populated
    assert any(o < 0.5 for o in offs) and any(o >= 0.5 for o in offs)


def test_worker_pool_schedules_offset_polls():
    from goleft_tpu_torch.fleet.router import WorkerPool

    urls = [f"http://127.0.0.1:{9000 + i}" for i in range(6)]
    pool = WorkerPool(urls, poll_interval_s=10.0)
    now = time.monotonic()
    offsets = sorted(w.next_poll_at - now
                     for w in pool.workers.values())
    assert all(0.0 <= o <= 10.0 for o in offsets)
    # not all in the same tick burst
    assert offsets[-1] - offsets[0] > 2.0


# ---------------- metrics rollup ----------------


def _worker_snap(reqs_depth, err_rate, p99_ratio, window=50,
                 queue_depth=1):
    return {
        "uptime_s": 10.0,
        "queue_depth": queue_depth,
        "queue_age_s": 0.0,
        "counters": {"requests_total.depth": reqs_depth,
                     "responses_total.200": reqs_depth},
        "batch_size_hist": {"1": reqs_depth},
        "latency_s": {"depth": {"p50": 0.1, "p95": 0.2, "p99": 0.3,
                                "max": 0.4, "count": reqs_depth,
                                "sum": 0.1 * reqs_depth}},
        "slo": {"error_rate": err_rate,
                "availability": 1 - err_rate,
                "window_requests": window,
                "p99_latency_ratio": {"depth": p99_ratio}},
    }


def test_merge_counters_sum_and_gauges_min_max():
    merged = fp.merge_worker_metrics({
        "8001": _worker_snap(3, 0.0, 0.1, queue_depth=2),
        "8002": _worker_snap(5, 0.0, 0.2, queue_depth=7),
    })
    assert merged["workers"] == 2
    assert merged["counters"]["requests_total.depth"] == 8
    assert merged["batch_size_hist"]["1"] == 8
    g = merged["gauges"]["queue_depth"]
    assert (g["min"], g["max"], g["sum"]) == (2, 7, 9)
    assert g["workers"] == {"8001": 2, "8002": 7}


def test_merge_histograms_exact_counts_weighted_quantiles():
    a = {"p50": 0.1, "p99": 1.0, "max": 2.0, "count": 10, "sum": 1.0}
    b = {"p50": 0.3, "p99": 3.0, "max": 1.0, "count": 30, "sum": 9.0}
    m = fp.merge_histogram_summaries([a, b, {}, {"count": 0}])
    assert m["count"] == 40          # exact
    assert m["sum"] == pytest.approx(10.0)   # exact
    assert m["max"] == pytest.approx(2.0)    # exact
    # count-weighted mean (documented approximation)
    assert m["p99"] == pytest.approx((10 * 1.0 + 30 * 3.0) / 40)
    assert fp.merge_histogram_summaries([]) == {"count": 0}


def test_burn_rate_latency_and_error_driven():
    # latency-driven: p99 ratio 2.5 dominates a clean error rate
    merged = fp.merge_worker_metrics(
        {"a": _worker_snap(1, 0.0, 2.5)}, error_budget=0.01)
    assert merged["slo"]["burn_rate"]["depth"] == pytest.approx(2.5)
    assert merged["slo"]["burn_rate_max"] == pytest.approx(2.5)
    # error-driven: 5% errors against a 1% budget = burn 5, even with
    # healthy latency
    merged = fp.merge_worker_metrics(
        {"a": _worker_snap(1, 0.05, 0.2)}, error_budget=0.01)
    assert merged["slo"]["burn_rate"]["depth"] == pytest.approx(5.0)
    # weighted error rate across workers
    merged = fp.merge_worker_metrics({
        "a": _worker_snap(1, 0.10, 0.1, window=10),
        "b": _worker_snap(1, 0.00, 0.1, window=90),
    }, error_budget=0.01)
    assert merged["slo"]["error_rate"] == pytest.approx(0.01)
    assert merged["slo"]["window_requests"] == 100


def test_idle_fleet_burns_nothing():
    merged = fp.merge_worker_metrics({}, error_budget=0.01)
    assert merged["workers"] == 0
    assert merged["slo"]["burn_rate_max"] == 0.0
    assert merged["slo"]["availability"] == 1.0


def test_rollup_prometheus_grammar_valid():
    from goleft_tpu_torch.obs import prometheus

    merged = fp.merge_worker_metrics({
        "8001": _worker_snap(3, 0.02, 1.5),
        "8002": _worker_snap(5, 0.0, 0.5),
    })
    text = prometheus.render(fp.rollup_registry_snapshot(merged))
    assert "# TYPE fleet_worker_requests_total_depth counter" in text
    assert "fleet_worker_requests_total_depth 8" in text
    assert "fleet_slo_burn_rate_depth" in text
    assert "fleet_worker_queue_depth_min" in text
    assert 'fleet_worker_latency_s_depth{quantile="0.5"}' in text
    for line in text.splitlines():
        if line.startswith("#") or not line:
            continue
        name = line.split("{")[0].split(" ")[0]
        assert prometheus._NAME_OK.match(name), name


# ---------------- stitching ----------------


def _record(tracer, fr, run):
    tracer.add_listener(fr.on_span)
    try:
        run()
    finally:
        tracer.remove_listener(fr.on_span)


def _router_worker_records(tid):
    """Fabricate one router tree + one worker (request + batch) tree
    through REAL tracers/recorders, exactly as the processes would."""
    tracer = obs.get_tracer()
    router_fr = FlightRecorder()
    fwd_id = {}

    def router_side():
        with tracer.trace("fleet.request.depth", kind="serve",
                          trace_id=tid) as root:
            root.attrs["status"] = 200
            with tracer.span("fleet.forward.depth",
                             url="http://w") as fsp:
                fwd_id["v"] = fsp.span_id

    _record(tracer, router_fr, router_side)

    worker_fr = FlightRecorder()
    step_id = {}

    def worker_side():
        with tracer.trace("request.depth", kind="serve",
                          trace_id=tid,
                          remote_parent=fwd_id["v"]) as root:
            root.attrs["status"] = 200
            with tracer.span("plan.step.depth") as sp:
                step_id["v"] = sp.span_id
        # the batch runs under its OWN trace, linked by attrs — the
        # batcher's exact shape
        with tracer.trace("batch.depth", kind="serve-batch",
                          parent_trace=tid,
                          parent_span=step_id["v"]):
            with tracer.span("serve.depth.dispatch",
                             category="device"):
                pass

    _record(tracer, worker_fr, worker_side)
    return router_fr, worker_fr


def test_stitch_grafts_worker_and_batch_trees():
    tid = "serve-cli-1-stitch"
    router_fr, worker_fr = _router_worker_records(tid)
    worker_recs = worker_fr.snapshot(trace_id=tid)
    assert len(worker_recs) == 2  # request tree + linked batch tree
    stitched = fp.stitch_trace(
        tid, router_fr.snapshot(trace_id=tid),
        {"http://127.0.0.1:7001": worker_recs})
    assert stitched is not None
    assert stitched["trace_id"] == tid
    assert set(stitched["processes"]) == {"router", "worker:7001"}
    tree = stitched["tree"]
    assert tree["name"] == "fleet.request.depth"
    fwd = tree["children"][0]
    assert fwd["name"] == "fleet.forward.depth"
    # worker request tree grafted under the forward span it rode
    req = next(c for c in fwd["children"]
               if c["name"] == "request.depth")
    assert req["process"] == "worker:7001"
    step = next(c for c in req["children"]
                if c["name"] == "plan.step.depth")
    # batch tree grafted under the plan step that submitted it
    batch = next(c for c in step["children"]
                 if c["name"] == "batch.depth")
    assert [c["name"] for c in batch["children"]] \
        == ["serve.depth.dispatch"]
    # spans from >= 2 processes in one tree
    procs = set()

    def walk(n):
        procs.add(n["process"])
        for c in n["children"]:
            walk(c)

    walk(tree)
    assert {"router", "worker:7001"} <= procs


def test_stitch_missing_trace_404s_and_orphan_worker_survives():
    assert fp.stitch_trace("nope", [], {"http://w": []}) is None
    # worker still holds the tree after the router ring evicted it:
    # stitch synthesizes a root rather than losing the evidence
    tid = "serve-cli-1-orphan"
    _, worker_fr = _router_worker_records(tid)
    stitched = fp.stitch_trace(
        tid, [], {"http://127.0.0.1:7002":
                  worker_fr.snapshot(trace_id=tid)})
    assert stitched["tree"].get("synthesized") is True
    assert "worker:7002" in stitched["processes"]


def test_perfetto_export_distinct_process_tracks():
    tid = "serve-cli-1-perfetto"
    router_fr, worker_fr = _router_worker_records(tid)
    stitched = fp.stitch_trace(
        tid, router_fr.snapshot(trace_id=tid),
        {"http://127.0.0.1:7003": worker_fr.snapshot(trace_id=tid)})
    doc = fp.perfetto_export(tid, stitched)
    evs = doc["traceEvents"]
    names = [e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"]
    assert "router" in names and "worker:7003" in names
    # both tests run in ONE process here, so the recorders share a
    # pid — the export must still keep the tracks distinct
    pids = {e["pid"] for e in evs
            if e["ph"] == "M" and e["name"] == "process_name"}
    assert len(pids) == 2
    xs = [e for e in evs if e["ph"] == "X"]
    assert all(set(e) >= {"name", "ts", "dur", "pid", "tid"}
               for e in xs)
    assert [e["ts"] for e in xs] == sorted(e["ts"] for e in xs)
    assert any(e["name"] == "serve.depth.dispatch" for e in xs)
    # pretty renderer covers every span without crashing
    text = fp.format_tree(stitched)
    assert "fleet.forward.depth" in text
    assert "serve.depth.dispatch" in text


# ---------------- event journal ----------------


def test_event_journal_appends_and_filters(tmp_path, monkeypatch):
    # a stepping clock: records a millisecond apart at least, so the
    # --since cut is exact (three appends can share a millisecond)
    import goleft_tpu_torch.obs.events as events_mod

    ticks = iter(1_700_000_000.0 + 0.25 * i for i in range(100))
    monkeypatch.setattr(events_mod.time, "time", lambda: next(ticks))
    path = str(tmp_path / "events.jsonl")
    with EventJournal(path) as j:
        j.append("spawn", slot=0, worker="http://w0", pid=11)
        j.append("death", slot=0, worker="http://w0", why="rc=-9")
        j.append("spawn", slot=1, worker="http://w1", pid=12)
    evs = read_events(path)
    assert [e["type"] for e in evs] == ["spawn", "death", "spawn"]
    assert all(e["schema"] == "goleft-tpu.fleet-event/1" for e in evs)
    assert [e["type"] for e in read_events(path, slot=0)] \
        == ["spawn", "death"]
    assert [e["slot"] for e in read_events(path, type="spawn")] \
        == [0, 1]
    cutoff = evs[1]["t"]
    assert len(read_events(path, since=cutoff)) == 2


def test_event_journal_torn_tail_and_restart_survival(tmp_path):
    path = str(tmp_path / "events.jsonl")
    with EventJournal(path) as j:
        j.append("spawn", slot=0)
        j.append("death", slot=0)
    # a SIGKILL mid-append leaves a torn (newline-less) tail
    with open(path, "a") as fh:
        fh.write('{"schema": "goleft-tpu.fleet-ev')
    evs = read_events(path)
    assert [e["type"] for e in evs] == ["spawn", "death"]
    # the restarted supervisor CONTINUES the same journal; its first
    # append lands on a fresh line, so replay sees old + new
    with EventJournal(path) as j:
        j.append("restart", slot=0)
    evs = read_events(path)
    assert [e["type"] for e in evs] == ["spawn", "death", "restart"]


def test_parse_since_grammar():
    now = time.time()
    assert parse_since("1000.5") == pytest.approx(1000.5)
    assert parse_since("15m") == pytest.approx(now - 900, abs=5)
    assert parse_since("2h") == pytest.approx(now - 7200, abs=5)
    iso = parse_since("2026-08-04T00:00:00+00:00")
    assert iso == pytest.approx(1785801600.0, abs=86400 * 2)
    with pytest.raises(ValueError):
        parse_since("yesterday-ish")


def test_event_log_counts_and_block(tmp_path):
    from goleft_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    log = EventLog(EventJournal(str(tmp_path / "e.jsonl")),
                   registry=reg, recent=4)
    for _ in range(3):
        log.emit("death", slot=0)
    log.emit("restart", slot=0)
    log.emit("scale_up", slot=1)
    block = log.block()
    assert block["recent"][0]["type"] == "scale_up"  # newest first
    assert block["recent_counts"]["death"] >= 2
    snap = reg.snapshot()["counters"]
    assert snap["fleet.events_total.death"] == 3
    assert snap["fleet.events_total.scale_up"] == 1
    log.close()


# ---------------- router HTTP surface over stub workers -------------


class _ObsStubHandler(BaseHTTPRequestHandler):
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
            self._json(200, {"status": "ok"})
        elif self.path.startswith("/metrics"):
            self._json(200, s.get("metrics", {}))
        elif self.path.startswith("/debug/flight"):
            from urllib.parse import parse_qs, urlparse

            q = parse_qs(urlparse(self.path).query)
            tid = q.get("trace_id", [None])[0]
            fr: FlightRecorder = s["flight"]
            self._json(200, fr.to_dict(trace_id=tid))
        else:
            self._json(404, {"error": "?"})

    def do_POST(self):  # noqa: N802
        s = self.server.state
        n = int(self.headers.get("Content-Length", "0"))
        json.loads(self.rfile.read(n) or b"{}")
        s.setdefault("trace_headers", []).append(
            self.headers.get("x-goleft-trace"))
        # record a worker-side request tree under the forwarded trace
        # context, exactly as ServeApp.handle would
        ctx = fp.parse_trace_header(self.headers.get("x-goleft-trace"))
        tid, parent = ctx if ctx else (None, None)
        tracer = obs.get_tracer()
        fr: FlightRecorder = s["flight"]
        tracer.add_listener(fr.on_span)
        try:
            kind = self.path[len("/v1/"):].strip("/")
            with tracer.trace(f"request.{kind}", kind="serve",
                              trace_id=tid,
                              remote_parent=parent) as root:
                root.attrs["status"] = 200
                with tracer.span(f"plan.step.{kind}"):
                    pass
        finally:
            tracer.remove_listener(fr.on_span)
        self._json(200, {"worker": s["name"]})


class _ObsStubWorker:
    def __init__(self, name, metrics=None):
        self.state = {"name": name, "metrics": metrics or {},
                      "flight": FlightRecorder()}
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                         _ObsStubHandler)
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
def obs_workers():
    ws = [_ObsStubWorker("w0", metrics=_worker_snap(3, 0.0, 0.5)),
          _ObsStubWorker("w1", metrics=_worker_snap(7, 0.0, 1.5))]
    try:
        yield ws
    finally:
        for w in ws:
            w.kill()


def _get(url, accept=None):
    req = urllib.request.Request(
        url, headers={"Accept": accept} if accept else {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def test_fleet_metrics_counters_equal_worker_sum(obs_workers,
                                                 tmp_path):
    from goleft_tpu_torch.fleet.router import RouterApp, RouterThread

    app = RouterApp([w.url for w in obs_workers],
                    poll_interval_s=0.2, down_after=1)
    with RouterThread(app) as url:
        status, _, body = _get(url + "/fleet/metrics")
        assert status == 200
        doc = json.loads(body)
        assert doc["workers"] == 2
        # the pinned arithmetic: fleet counter == sum of live workers
        assert doc["counters"]["requests_total.depth"] == 3 + 7
        assert doc["slo"]["burn_rate"]["depth"] == pytest.approx(1.5)
        assert "router" in doc  # router registry rides alongside
        # burn gauges also surface on the plain /metrics body
        status, _, body = _get(url + "/metrics")
        g = json.loads(body)["gauges"]
        assert g["fleet.slo.burn_rate.depth"] == pytest.approx(1.5)
        # prometheus encoding: grammar-valid, same numbers
        status, hdrs, text = _get(url + "/fleet/metrics?format=prom")
        assert status == 200
        assert hdrs["Content-Type"].startswith(
            "text/plain; version=0.0.4")
        assert "fleet_worker_requests_total_depth 10" in text
        assert "fleet_slo_burn_rate_depth 1.5" in text
        from goleft_tpu_torch.obs import prometheus

        for line in text.splitlines():
            if line.startswith("#") or not line:
                continue
            name = line.split("{")[0].split(" ")[0]
            assert prometheus._NAME_OK.match(name), name


def test_router_trace_end_to_end_over_http(obs_workers, tmp_path):
    from goleft_tpu_torch.fleet.router import RouterApp, RouterThread
    from goleft_tpu_torch.serve.client import ServeClient

    app = RouterApp([w.url for w in obs_workers],
                    poll_interval_s=0.2, down_after=1)
    with RouterThread(app) as url:
        client = ServeClient(url, timeout_s=30.0, trace=True)
        client.depth("/tmp/nonexistent.bam", fai="x.fai")
        tid = client.last_trace_id
        assert tid and tid.startswith("serve-cli-")
        # the worker saw the forwarded header carrying OUR trace id
        hdrs = [h for w in obs_workers
                for h in w.state.get("trace_headers", [])]
        assert any(h and h.startswith(tid + ";") for h in hdrs)
        # the stitched trace: router forward + worker request tree
        doc = client.fleet_trace(tid)
        assert doc["trace_id"] == tid
        assert len(doc["processes"]) >= 2
        tree = doc["tree"]
        assert tree["name"] == "fleet.request.depth"
        fwd = next(c for c in tree["children"]
                   if c["name"] == "fleet.forward.depth")
        req = next(c for c in fwd["children"]
                   if c["name"] == "request.depth")
        assert any(c["name"] == "plan.step.depth"
                   for c in req["children"])
        assert doc["perfetto"]["traceEvents"]
        # unknown trace → 404 with a clear error
        from goleft_tpu_torch.serve.client import ServeError

        with pytest.raises(ServeError) as ei:
            client.fleet_trace("serve-cli-0-never")
        assert ei.value.status == 404
    app2 = None  # RouterThread closed app


def test_router_echoes_minted_trace_header(obs_workers):
    from goleft_tpu_torch.fleet.router import RouterApp, RouterThread

    app = RouterApp([w.url for w in obs_workers],
                    poll_interval_s=0.2, down_after=1)
    with RouterThread(app) as url:
        req = urllib.request.Request(
            url + "/v1/depth",
            data=json.dumps({"bam": "b.bam"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            echoed = r.headers.get("x-goleft-trace")
        # no client header: the ROUTER minted the fleet id and told us
        assert echoed and echoed.startswith("serve-")


# ---------------- exact quantiles from raw windows ----------------


def test_merge_histograms_exact_from_raw_windows():
    a = {"p50": 0.1, "p99": 1.0, "max": 1.0, "count": 3, "sum": 1.2}
    b = {"p50": 0.3, "p99": 3.0, "max": 3.0, "count": 3, "sum": 3.6}
    wa, wb = [0.1, 0.1, 1.0], [0.3, 0.3, 3.0]
    m = fp.merge_histogram_summaries([a, b], windows=[wa, wb])
    assert m["quantile_source"] == "exact"
    # the EXACT quantiles: the same windowed estimator one process
    # holding all six samples would use
    from goleft_tpu_torch.utils.profiling import percentiles

    want = percentiles(wa + wb)
    assert m["p99"] == pytest.approx(want["p99"])
    assert m["p50"] == pytest.approx(want["p50"])
    assert m["max"] == pytest.approx(3.0)
    # sum/count equality pinned unchanged (the additive merge)
    assert m["count"] == 6
    assert m["sum"] == pytest.approx(4.8)


def test_merge_histograms_falls_back_without_full_windows():
    a = {"p99": 1.0, "count": 10, "sum": 1.0}
    b = {"p99": 3.0, "count": 30, "sum": 9.0}
    # one worker missing its window → the WHOLE merge falls back (a
    # mixed answer would claim precision it doesn't have)
    m = fp.merge_histogram_summaries([a, b], windows=[[0.1], None])
    assert m["quantile_source"] == "approximate"
    assert m["p99"] == pytest.approx((10 * 1.0 + 30 * 3.0) / 40)
    assert m["count"] == 40 and m["sum"] == pytest.approx(10.0)


def test_merge_worker_metrics_uses_shipped_windows():
    def snap(lat_window):
        s = _worker_snap(len(lat_window), 0.0, 0.5)
        s["latency_s"] = {"depth": {
            "p99": max(lat_window), "count": len(lat_window),
            "sum": round(sum(lat_window), 4),
            "max": max(lat_window)}}
        s["latency_windows"] = {"depth": lat_window}
        return s

    merged = fp.merge_worker_metrics({
        "8001": snap([0.1, 0.1, 0.1]),
        "8002": snap([0.2, 0.2, 5.0]),
    })
    h = merged["histograms"]["latency_s.depth"]
    assert h["quantile_source"] == "exact"
    from goleft_tpu_torch.utils.profiling import percentiles

    assert h["p99"] == pytest.approx(
        percentiles([0.1, 0.1, 0.1, 0.2, 0.2, 5.0])["p99"])
    assert h["count"] == 6


def test_serve_metrics_ship_latency_windows_and_merge_exact():
    from goleft_tpu_torch.serve.metrics import ServeMetrics

    w1, w2 = ServeMetrics(), ServeMetrics()
    for v in (0.1, 0.2, 0.3):
        w1.observe_latency("depth", v)
    for v in (0.4, 9.0):
        w2.observe_latency("depth", v)
    snaps = {"8001": w1.snapshot(), "8002": w2.snapshot()}
    assert snaps["8001"]["latency_windows"]["depth"] \
        == [0.1, 0.2, 0.3]
    merged = fp.merge_worker_metrics(snaps)
    h = merged["histograms"]["latency_s.depth"]
    assert h["quantile_source"] == "exact"
    assert h["count"] == 5
    from goleft_tpu_torch.utils.profiling import percentiles

    assert h["p99"] == pytest.approx(
        percentiles([0.1, 0.2, 0.3, 0.4, 9.0])["p99"])


# ---------------- cross-host clock handshake ----------------


class _SkewedWorkerHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    skew_s = 0.0

    def log_message(self, *a):
        pass

    def _json(self, body):
        data = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(data)
        self.close_connection = True

    def do_GET(self):  # noqa: N802
        if self.path == "/healthz":
            self._json({"status": "ok",
                        "now": time.time() + self.server.skew_s})
        else:
            self._json({})


@pytest.mark.parametrize("skew", [5.0, -5.0])
def test_worker_pool_estimates_clock_offset(skew):
    from goleft_tpu_torch.fleet.router import WorkerPool

    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                _SkewedWorkerHandler)
    httpd.skew_s = skew
    t = threading.Thread(target=httpd.serve_forever,
                         kwargs={"poll_interval": 0.02}, daemon=True)
    t.start()
    host, port = httpd.server_address[:2]
    url = f"http://{host}:{port}"
    pool = WorkerPool([url], poll_interval_s=30.0)
    try:
        pool.poll_all()
        offs = pool.clock_offsets()
        # midpoint estimate lands within network-time noise of the
        # planted ±5s skew
        assert offs[url] == pytest.approx(skew, abs=1.0)
        # EWMA: a second poll stays near the skew (smoothed, stable)
        pool.poll_all()
        assert pool.clock_offsets()[url] == pytest.approx(skew,
                                                          abs=1.0)
    finally:
        pool.close()
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def test_stitch_trace_applies_clock_offsets():
    tid = "serve-cli-9-skew"
    router_fr, worker_fr = _router_worker_records(tid)
    worker_recs = worker_fr.snapshot(trace_id=tid)
    # forge the worker's wall clock 5s AHEAD (a skewed host)
    import copy
    import datetime

    skewed = []
    for rec in worker_recs:
        rec = copy.deepcopy(rec)
        ts = datetime.datetime.fromisoformat(rec["ts"]) \
            + datetime.timedelta(seconds=5)
        rec["ts"] = ts.isoformat(timespec="milliseconds")
        skewed.append(rec)
    url = "http://127.0.0.1:7001"
    naive = fp.stitch_trace(tid,
                            router_fr.snapshot(trace_id=tid),
                            {url: copy.deepcopy(skewed)})
    corrected = fp.stitch_trace(tid,
                                router_fr.snapshot(trace_id=tid),
                                {url: copy.deepcopy(skewed)},
                                clock_offsets={url: 5.0})

    def first_req(doc):
        def walk(n):
            yield n
            for c in n["children"]:
                yield from walk(c)
        return next(n for n in walk(doc["tree"])
                    if n["name"] == "request.depth")

    # trusting raw wall clocks shears the worker tree ~5s late;
    # the handshake offset pulls it back onto the router's clock
    assert first_req(naive)["start_ms"] \
        >= first_req(corrected)["start_ms"] + 4000


# ---------------- per-tenant rollup dimension ----------------


def test_worker_tenant_outcomes_roll_up_to_fleet_burn():
    from goleft_tpu_torch.serve.metrics import ServeMetrics

    w1, w2 = ServeMetrics(), ServeMetrics()
    for _ in range(4):
        w1.record_tenant("mallory", 429, seconds=0.01)
        w2.record_tenant("mallory", 503, seconds=0.01)
        w1.record_tenant("alice", 200, seconds=0.01)
    # 404s are the client's problem, never tenant burn
    w1.record_tenant("alice", 404, seconds=0.01)
    s1 = w1.slo_snapshot(window_s=300.0)
    assert s1["tenants"]["mallory"]["error_rate"] == 1.0
    assert s1["tenants"]["alice"]["error_rate"] == 0.0
    assert w1.registry.counter(
        "serve.tenant.requests_total.mallory").value == 4
    assert w1.registry.counter(
        "serve.tenant.burned_total.mallory").value == 4
    # the fleet rollup: request-weighted tenant merge + burn gauges
    merged = fp.merge_worker_metrics({
        "8001": {"slo": s1},
        "8002": {"slo": w2.slo_snapshot(window_s=300.0)},
    }, error_budget=0.01)
    tens = merged["slo"]["tenants"]
    assert tens["mallory"]["window_requests"] == 8
    assert tens["mallory"]["burn_rate"] == pytest.approx(100.0)
    assert tens["alice"]["burn_rate"] < 0.1
    flat = fp.rollup_registry_snapshot(merged)
    assert flat["gauges"]["fleet.slo.tenant.burn_rate.mallory"] \
        == pytest.approx(100.0)
