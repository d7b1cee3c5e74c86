"""The port's serve daemon (goleft_tpu_torch/serve, ``ServeApp(device=
"cpu")``: every kernel as its plain version) against the JAX package's
``ServeApp`` on the same payloads.

Every ``/v1/*`` response body of the port is the byte string the
reference's ``_respond`` would send for the same payload (``json.dumps``
of its dict; no body carries a timing field). One exception is held
apart: ``/v1/cohortscan``'s .ped, whose PC columns hold per component up
to sign (two libraries' float32 SVDs; chip_smoke.py::_compare_ped),
like the one-shot command's. Also: a burst of 8 depth requests coalesced
into at most 2 passes, a session cache written by the reference replayed
by the port, a warmup manifest of the reference validated, loaded and
replayed by the port (and the reverse), the 400/404/429/504 paths and
the Prometheus encoding.

Each app has a private metrics registry; ordering between threads is by
``threading.Event``; every wait has a timeout.
"""

import base64
import gzip
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from chip_smoke import _compare_ped
from goleft_tpu.serve.server import ServeApp as RefApp
from goleft_tpu_torch.serve.client import ServeClient, ServeError
from goleft_tpu_torch.serve.server import ServeApp, ServerThread
from test_cohortscan import LENS, REFS, _make_cohort
from test_pairhmm import _windows_doc
from test_serve import make_cohort
from test_torch_map_cmd import _fixture as map_fixture

TIMEOUT = 120


def _wait_for(pred, timeout=TIMEOUT):
    """Poll ``pred`` until true (a bounded wait; fails on timeout)."""
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, "timed out waiting"
        time.sleep(0.005)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    bams, fai = make_cohort(d, 8)
    for sub in ("scan", "map"):
        (d / sub).mkdir()
    scan_bams = _make_cohort(d / "scan", n=5)
    scan_fai = str(d / "scan.fai")
    with open(scan_fai, "w") as fh:
        for name, length in zip(REFS, LENS):
            fh.write(f"{name}\t{length}\t0\t60\t61\n")
    windows = str(d / "w.json")
    _windows_doc(windows)
    map_ref, fastq, _ = map_fixture(d / "map")
    port = ServeApp(batch_window_s=0.2, max_batch=8, device="cpu",
                    cache_dir=str(d / "port-cache"))
    ref = RefApp(batch_window_s=0.2, max_batch=8)
    payloads = {
        "depth": {"bam": bams[0], "fai": fai, "window": 250},
        "indexcov": {"bams": bams[:3], "fai": fai},
        "cohortdepth": {"bams": bams[:3], "fai": fai, "window": 500},
        "cohortscan": {"bams": scan_bams, "fai": scan_fai,
                       "extranormalize": True, "chunk_samples": 2},
        "pairhmm": {"input": windows},
        "map": {"fastq": fastq, "reference": map_ref, "window": 100},
    }
    with ServerThread(port) as url:
        yield {"url": url, "port": port, "ref": ref, "bams": bams,
               "fai": fai, "dir": d, "payloads": payloads}
    ref.close()


def _post_raw(url: str, kind: str, payload: dict) -> tuple[int, bytes]:
    req = urllib.request.Request(
        f"{url}/v1/{kind}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("kind", ["depth", "indexcov", "cohortdepth",
                                  "cohortscan", "pairhmm", "map"])
def test_endpoint_bodies_match_the_reference(served, kind, tmp_path):
    payload = dict(served["payloads"][kind], cache_buster="bodies")
    code, raw = _post_raw(served["url"], kind, payload)
    want_code, want = served["ref"].handle(kind, dict(payload))
    assert code == want_code == 200, raw[:300]
    if kind != "cohortscan":
        assert raw == json.dumps(want).encode()
        return
    got = json.loads(raw)
    for field in set(want) - {"ped", "bed_gz_b64"}:
        assert got[field] == want[field], field
    assert gzip.decompress(base64.b64decode(got["bed_gz_b64"])) \
        == gzip.decompress(base64.b64decode(want["bed_gz_b64"]))
    (tmp_path / "want.ped").write_text(want["ped"])
    (tmp_path / "got.ped").write_text(got["ped"])
    _compare_ped(str(tmp_path / "want.ped"), str(tmp_path / "got.ped"))


def test_depth_burst_coalesces_and_matches_the_reference(served):
    """8 concurrent depth requests queued behind a held pass form at most
    2 passes (here one, of 8), each response the reference's for that
    BAM served alone."""
    port, ref, url = served["port"], served["ref"], served["url"]
    params = dict(fai=served["fai"], window=125)
    hold = port.executors["hold"] = _GatedExec("hold")
    before = dict(port.metrics.snapshot()["batch_size_hist"])
    results, errs = [None] * 8, []

    def fire(i):
        try:
            results[i] = ServeClient(url, timeout_s=TIMEOUT).depth(
                served["bams"][i], **params, cache_buster=i)
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    held = threading.Thread(target=port.handle, args=("hold", {}))
    ts = [threading.Thread(target=fire, args=(i,)) for i in range(8)]
    try:
        held.start()
        assert hold.started.wait(timeout=TIMEOUT)  # the dispatcher is held
        for t in ts:
            t.start()
        _wait_for(lambda: port.batcher.queue_depth() == 8)
    finally:
        hold.gate.set()
        for t in [held] + ts:
            t.join(timeout=TIMEOUT)
        del port.executors["hold"]
    assert not errs
    after = port.metrics.snapshot()["batch_size_hist"]
    new = {int(k): after.get(k, 0) - before.get(k, 0) for k in after}
    new[1] -= 1  # the held pass
    new = {k: v for k, v in new.items() if v}
    assert sum(k * v for k, v in new.items()) == 8, new
    assert sum(new.values()) <= 2, new
    for i, bam in enumerate(served["bams"]):
        code, want = ref.handle("depth", {"bam": bam, **params,
                                          "cache_buster": i})
        assert code == 200 and results[i] == want


def test_reference_session_cache_replays_under_the_port(served, tmp_path):
    """A --cache directory the reference wrote answers the port's request
    with cached: true, the same bytes and no pass."""
    cache = str(tmp_path / "shared-cache")
    payload = dict(served["payloads"]["depth"], window=200)
    ref = RefApp(batch_window_s=0.0, cache_dir=cache)
    try:
        code, want = ref.handle("depth", dict(payload))
        assert code == 200
    finally:
        ref.close()
    port = ServeApp(batch_window_s=0.0, cache_dir=cache, device="cpu")
    try:
        code, got = port.handle("depth", dict(payload))
        assert code == 200 and got == {**want, "cached": True}
        assert port.metrics.snapshot()["counters"].get(
            "device_passes_total", 0) == 0
    finally:
        port.close()


def _stats_of_every_kind():
    from goleft_tpu.obs.compiles import canonical_signature as sig

    rec = {"hits": 3, "compiles": 1, "compile_seconds": 0.5}
    return {
        ("depth", sig({"b": 2, "bucket": 1024, "length": 20_000,
                       "window": 250}), "cpu"): rec,
        ("pairhmm", sig({"r_pad": 64, "h_pad": 128, "b": 3,
                         "rescale": True, "dtype": "float32"}), "cpu"): rec,
        ("swalign", sig({"stage": "extend", "r_pad": 160, "w_pad": 256,
                         "b": 2}), "cpu"): rec,
        ("swalign", sig({"stage": "seed", "r_pad": 160}), "cpu"): rec,
        ("rans", sig({"n": 4}), "tpu"): rec,
        ("unattributed", "", "tpu"): dict(rec, hits=1),
    }


def test_reference_warmup_manifest_loads_and_replays_under_the_port(
        tmp_path):
    from goleft_tpu.obs import compiles as rc
    from goleft_tpu_torch.obs import compiles as tc
    from goleft_tpu_torch.serve.warmstart import warm_start

    path = str(tmp_path / "warm.json")
    rc.save_warmup_manifest(path, rc.build_warmup_manifest(
        _stats_of_every_kind()))
    doc = tc.load_warmup_manifest(path)
    assert doc == rc.load_warmup_manifest(path)
    counts = warm_start(path, top_k=8, device="cpu")
    assert (counts["warmed"], counts["skipped"], counts["failed"]) \
        == (3, 3, 0)
    seen = {(f, s) for f, s, _ in tc.TRACKER.stats()}
    want = {(f, s) for f, s, _ in _stats_of_every_kind()
            if f in ("depth", "pairhmm") or '"extend"' in s}
    assert want <= seen
    # and the reverse: the port's manifest under the reference
    back = str(tmp_path / "port.json")
    tc.save_warmup_manifest(back, tc.TRACKER.to_doc())
    assert rc.load_warmup_manifest(back)["signatures"]


def test_bad_requests_get_400_and_404(served):
    client = ServeClient(served["url"], timeout_s=30)
    for payload in ({"bam": str(served["dir"] / "nope.bam"),
                     "fai": served["fai"]}, {}):
        with pytest.raises(ServeError) as ei:
            client._request("/v1/depth", payload)
        assert ei.value.status == 400
    with pytest.raises(ServeError) as ei:
        client._request("/v1/unknown-kind", {})
    assert ei.value.status == 404
    code, raw = _post_raw(served["url"], "depth", ["not", "an", "object"])
    assert code == 400 and b"bad JSON body" in raw


class _GatedExec:
    """An executor stand-in of ``kind`` whose pass waits on ``gate``
    after setting ``started``."""

    def __init__(self, kind="depth"):
        self.kind = kind
        self.started = threading.Event()
        self.gate = threading.Event()

    def validate(self, req):
        pass

    def group_key(self, req):
        return (self.kind, "stub")

    def cache_files(self, req):
        return []

    def run(self, reqs):
        self.started.set()
        self.gate.wait(timeout=TIMEOUT)
        return [{"ok": r.get("bam")} for r in reqs]


@pytest.mark.parametrize("path", ["429", "504"])
def test_overload_and_deadline_paths(path):
    app = ServeApp(batch_window_s=0.0, max_batch=1, max_queue=1,
                   device="cpu")
    stub = app.executors["depth"] = _GatedExec()
    out = {}

    def fire(i, **kw):
        out[i] = app.handle("depth", {"bam": f"x{i}", **kw})

    try:
        t0 = threading.Thread(target=fire, args=(0,))
        t0.start()
        assert stub.started.wait(timeout=TIMEOUT)  # dispatcher holds it
        if path == "429":
            t1 = threading.Thread(target=fire, args=(1,))
            t1.start()
            _wait_for(lambda: app.batcher.queue_depth() == 1)
            codes = [app.handle("depth", {"bam": f"y{i}"})[0]
                     for i in range(3)]
            assert codes == [429, 429, 429]
            stub.gate.set()
            for t in (t0, t1):
                t.join(timeout=TIMEOUT)
            assert out[0][0] == out[1][0] == 200
        else:
            code, body = app.handle("depth", {"bam": "late",
                                              "timeout_s": 0.1})
            assert code == 504 and "expired" in body["error"]
            stub.gate.set()
            t0.join(timeout=TIMEOUT)
            assert out[0] == (200, {"ok": "x0"})
    finally:
        stub.gate.set()
        app.close()


def test_prometheus_encoding_is_the_references(served):
    from goleft_tpu.obs import prometheus as rp
    from goleft_tpu_torch.obs import prometheus as tp

    assert served["port"].handle("depth", dict(
        served["payloads"]["depth"], cache_buster="prom"))[0] == 200
    snap = served["port"].metrics.registry.snapshot()
    assert tp.render(snap) == rp.render(snap)
    req = urllib.request.Request(served["url"] + "/metrics?format=prom")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        assert r.headers["Content-Type"] == tp.CONTENT_TYPE
        text = r.read().decode()
    assert "# TYPE serve_requests_total_depth counter" in text
    assert "serve_queue_depth" in text


def test_healthz_and_debug_surfaces(served):
    client = ServeClient(served["url"], timeout_s=30)
    h = client.healthz()
    assert h["status"] == "ok" and h["platform"] == "cpu" \
        and h["devices"] == 1
    m = client.metrics()
    assert {"counters", "batch_size_hist", "latency_s", "stage_seconds",
            "queue_depth", "cache", "uptime_s", "slo", "breakers"} <= set(m)
    for path in ("/debug/compiles", "/debug/memory", "/debug/flight"):
        doc = client._request(path)
        assert isinstance(doc, dict) and doc
    assert client._request("/debug/memory")["schema"] \
        == "goleft-tpu.memory/1"


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_result_cache_bound_and_format_are_the_references(tmp_path, writer):
    """``ResultCache(max_bytes=...)`` evicts the least recently used
    entries as the reference's does, and an entry either package wrote
    is read by the other."""
    import os

    from goleft_tpu.parallel.scheduler import ResultCache as RefCache
    from goleft_tpu_torch.parallel.scheduler import ResultCache

    mk = RefCache if writer == "reference" else ResultCache
    rd = ResultCache if writer == "reference" else RefCache
    w = mk(str(tmp_path), max_bytes=3500)
    keys = [("depth", "{}", ((f"/x{i}.bam", 10, i),)) for i in range(5)]
    for i, k in enumerate(keys):
        w.put(k, {"depth_bed": "x" * 1000, "i": i})
        path = w._path(k)
        os.utime(path, ns=(10**18 + i, 10**18 + i))  # a strict LRU order
    r = rd(str(tmp_path))
    assert [r.get(k) is not None for k in keys] == [False, False] + [True] * 3
    assert r.get(keys[4]) == {"depth_bed": "x" * 1000, "i": 4}
    assert w._path(keys[0]) == r._path(keys[0])
