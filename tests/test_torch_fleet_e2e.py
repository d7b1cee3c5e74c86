"""The port's fleet in front of real port serve workers, on the CPU.

- A port ``RouterThread`` in front of two port
  ``ServerThread(ServeApp(device="cpu"))`` answers ``/v1/depth``, and a
  burst of 8 concurrent ones, with the bytes the reference's ``ServeApp``
  gives for the same payloads; ``/fleet/plan``'s first candidate is the
  worker that answered. Every other ``/v1/*`` body through the router is
  the reference's too (``/v1/cohortscan``'s .ped up to the PCs' signs,
  as tests/test_torch_serve.py holds it).
- The crossed pair: a reference router in front of the port workers,
  and a port router in front of reference workers, give the same bodies
  and the same ``/fleet/plan`` candidates as the router of the other
  package.
- ``trace``: two port workers in their own processes (the serve command
  on the CPU) behind a port router and behind a reference router; the
  port's ``trace`` prints the tree the reference's prints, span for
  span, and ``--perfetto`` writes JSON.

Each app has a private metrics registry; ordering between threads is by
``threading.Event``; every wait has a timeout.
"""

import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.request

import pytest

from goleft_tpu.commands import trace_cmd as ref_trace_cmd
from goleft_tpu.fleet.router import RouterApp as RefRouter
from goleft_tpu.fleet.router import RouterThread as RefRouterThread
from goleft_tpu.serve.client import ServeClient as RefClient
from goleft_tpu.serve.server import ServeApp as RefApp
from goleft_tpu.serve.server import ServerThread as RefServerThread
from goleft_tpu_torch.commands import trace_cmd
from goleft_tpu_torch.fleet.router import RouterApp, RouterThread
from goleft_tpu_torch.fleet.supervisor import read_announce
from goleft_tpu_torch.serve.client import ServeClient
from goleft_tpu_torch.serve.server import ServeApp, ServerThread
from test_serve import make_cohort
from test_torch_serve import _compare_ped
from test_torch_serve import served  # noqa: F401 (a fixture)

TIMEOUT = 60
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: ``python -m goleft_tpu_torch serve`` with the device resolved to the
#: CPU (the command itself has no CPU switch: it runs on the card)
CPU_SERVE = (
    "import os, sys, torch\n"
    "os.environ['GOLEFT_TPU_PROBE'] = '0'  # no card to probe\n"
    "import goleft_tpu_torch.device as d\n"
    "d.resolve_device = lambda device=None: torch.device('cpu')\n"
    "from goleft_tpu_torch.cli import main\n"
    "sys.exit(main(sys.argv[1:]))\n")


def _router(urls, cls=RouterApp, **kw):
    # a long poll interval: the routers never mark a live worker down
    # between requests (the workers start healthy)
    return cls(list(urls), poll_interval_s=600.0, **kw)


def _post(url: str, kind: str, payload: dict) -> tuple[int, bytes]:
    req = urllib.request.Request(
        f"{url}/v1/{kind}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _plan(url: str, kind: str, payload: dict) -> list[str]:
    req = urllib.request.Request(
        f"{url}/fleet/plan", data=json.dumps(
            {"kind": kind, **payload}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())["candidates"]


def _depth_requests(app) -> int:
    return int(app.metrics.snapshot()["counters"]
               .get("requests_total.depth", 0))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    bams, fai = make_cohort(d, 8)
    ref = RefApp(batch_window_s=0.05, max_batch=8)
    want = {}
    for b in bams:
        code, body = ref.handle("depth", {"bam": b, "fai": fai,
                                          "window": 250})
        assert code == 200
        want[b] = json.dumps(body).encode()
    ref.close()
    return {"bams": bams, "fai": fai, "want": want, "dir": d}


@pytest.fixture(scope="module")
def port_workers(cohort):
    apps = [ServeApp(batch_window_s=0.05, max_batch=8, device="cpu")
            for _ in range(2)]
    threads = [ServerThread(a) for a in apps]
    urls = [t.__enter__() for t in threads]
    try:
        yield list(zip(urls, apps))
    finally:
        for t in threads:
            t.__exit__(None, None, None)


def test_port_router_depth_and_burst_match_the_reference(cohort,
                                                         port_workers):
    bams, fai, want = cohort["bams"], cohort["fai"], cohort["want"]
    apps = dict(port_workers)
    with RouterThread(_router(apps)) as url:
        payload = {"bam": bams[0], "fai": fai, "window": 250}
        home = _plan(url, "depth", payload)[0]
        before = {u: _depth_requests(a) for u, a in apps.items()}
        code, raw = _post(url, "depth", payload)
        assert code == 200 and raw == want[bams[0]]
        after = {u: _depth_requests(a) for u, a in apps.items()}
        assert [u for u in apps if after[u] > before[u]] == [home]

        # the burst: 8 requests released together, one per BAM
        go = threading.Event()
        got: dict = {}

        def fire(b):
            go.wait(timeout=TIMEOUT)
            got[b] = _post(url, "depth", {"bam": b, "fai": fai,
                                          "window": 250})

        ts = [threading.Thread(target=fire, args=(b,)) for b in bams]
        for t in ts:
            t.start()
        go.set()
        for t in ts:
            t.join(timeout=TIMEOUT)
        assert {b: got[b] for b in bams} \
            == {b: (200, want[b]) for b in bams}
        homes = {b: _plan(url, "depth", {"bam": b, "fai": fai,
                                         "window": 250})[0]
                 for b in bams}
        counts = {u: _depth_requests(a) - after[u]
                  for u, a in apps.items()}
        assert counts == {u: sum(1 for h in homes.values() if h == u)
                          for u in apps}
        m = json.loads(urllib.request.urlopen(
            url + "/metrics", timeout=TIMEOUT).read())
        assert sum(v for k, v in m["counters"].items()
                   if k.startswith("fleet.routed_total.")) == 9


@pytest.mark.parametrize("kind", ["depth", "indexcov", "cohortdepth",
                                  "cohortscan", "pairhmm", "map"])
def test_every_endpoint_through_the_router_is_the_reference_body(
        served, kind, tmp_path):  # noqa: F811 (the fixture)
    import base64
    import gzip

    payload = dict(served["payloads"][kind], cache_buster="router")
    with RouterThread(_router([served["url"]])) as url:
        code, raw = _post(url, kind, payload)
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


def test_reference_router_in_front_of_port_workers(cohort, port_workers):
    bams, fai, want = cohort["bams"], cohort["fai"], cohort["want"]
    urls = [u for u, _ in port_workers]
    with RefRouterThread(_router(urls, RefRouter)) as ref_url, \
            RouterThread(_router(urls)) as port_url:
        for b in bams[:3]:
            p = {"bam": b, "fai": fai, "window": 250}
            assert _plan(ref_url, "depth", p) == _plan(port_url, "depth", p)
            assert _post(ref_url, "depth", p) == (200, want[b])
        p = {"bams": bams[:2], "fai": fai}
        assert _plan(ref_url, "indexcov", p) \
            == _plan(port_url, "indexcov", p)


def test_port_router_in_front_of_reference_workers(cohort):
    bams, fai, want = cohort["bams"], cohort["fai"], cohort["want"]
    threads = [RefServerThread(RefApp(batch_window_s=0.05, max_batch=8))
               for _ in range(2)]
    urls = [t.__enter__() for t in threads]
    try:
        with RefRouterThread(_router(urls, RefRouter)) as ref_url, \
                RouterThread(_router(urls)) as port_url:
            for b in bams[3:6]:
                p = {"bam": b, "fai": fai, "window": 250}
                assert _plan(port_url, "depth", p) \
                    == _plan(ref_url, "depth", p)
                assert _post(port_url, "depth", p) == (200, want[b])
            code, raw = _post(port_url, "depth", {"fai": fai})
            assert code == 400 and raw == _post(ref_url, "depth",
                                                {"fai": fai})[1]
    finally:
        for t in threads:
            t.__exit__(None, None, None)


def test_fleet_surfaces_over_port_workers(cohort, port_workers,
                                          monkeypatch, tmp_path):
    """A port worker's ``/debug/memory`` is on the reference's wire
    (``device.by_family``: family → bytes), so both packages' routers
    merge it; the port's ``warmup``, ``memory`` and ``profile`` clients
    read the port router's ``/fleet/*`` surfaces. The worker's device
    families are what a dispatch on the card records."""
    import contextlib

    from goleft_tpu_torch.commands import memory_cmd, profile_cmd, warmup
    from goleft_tpu_torch.obs import memplane
    from goleft_tpu_torch.obs.compiles import validate_warmup_manifest

    monkeypatch.setitem(memplane.TRACKER._families, "depth", {
        "retained_bytes": 4096, "peak_bytes": 65536, "dispatches": 3})
    urls = [u for u, _ in port_workers]
    body = json.loads(urllib.request.urlopen(
        urls[0] + "/debug/memory", timeout=TIMEOUT).read())
    assert body["device"]["by_family"] == {"depth": 4096}
    with RefRouterThread(_router(urls, RefRouter)) as ref_url, \
            RouterThread(_router(urls)) as port_url:
        docs = [json.loads(urllib.request.urlopen(
            u + "/fleet/memory", timeout=TIMEOUT).read())
            for u in (ref_url, port_url)]
        for d in docs:
            assert d["workers"] == 2
            assert d["device_by_family"] == {"depth": 8192}
        assert set(docs[0]) == set(docs[1])
        assert docs[0]["counters"].keys() == docs[1]["counters"].keys()

        def run(mod, argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = mod.main(argv)
            return rc, buf.getvalue()

        rc, text = run(memory_cmd, ["--router", port_url, "--json"])
        assert rc == 0 and json.loads(text)["device_by_family"] \
            == {"depth": 8192}
        rc, text = run(memory_cmd, ["--url", urls[0]])
        assert rc == 0 and "depth" in text
        out = str(tmp_path / "w.json")
        rc, _ = run(warmup, ["export", "--router", "--url", port_url,
                             "--out", out])
        assert rc == 0
        with open(out) as fh:
            validate_warmup_manifest(json.load(fh))
        rc, text = run(profile_cmd, ["--router", port_url, "--seconds",
                                     "0.2", "--json"])
        assert rc == 0 and json.loads(text)["schema"] \
            == "goleft-tpu.profile/1"


# ---------------- trace across processes ----------------


@pytest.fixture(scope="module")
def process_workers(tmp_path_factory):
    """Two port serve workers in their own processes, on the CPU."""
    d = tmp_path_factory.mktemp("procs")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs, urls = [], []
    try:
        for i in range(2):
            p = subprocess.Popen(
                [sys.executable, "-c", CPU_SERVE, "serve", "--port", "0",
                 "--no-warmup", "--flight-dir", str(d)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True, env=env, cwd=str(d))
            procs.append(p)
        for p in procs:
            url = read_announce(p, timeout_s=TIMEOUT)
            assert url, "a CPU serve worker did not announce its URL"
            urls.append(url)
        yield urls
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
            if p.stdout is not None:
                p.stdout.close()


def _shape(tree_text: str) -> list[str]:
    """The span tree of a ``trace`` rendering: each span's indent and
    name, without durations, process labels or the trace id."""
    body = tree_text.split("\n\n", 1)[1]
    return [re.sub(r"\s+[\d.]+ms\s+\[[^\]]*\]\s*$", "", line)
            for line in body.splitlines() if line.strip()]


def test_trace_stitches_across_processes_like_the_reference(
        cohort, process_workers, tmp_path):
    bams, fai, want = cohort["bams"], cohort["fai"], cohort["want"]
    # one request on each worker first, so that neither traced request
    # below carries a first launch's span, whichever worker it lands on
    for url in process_workers:
        assert _post(url, "depth", {"bam": bams[5], "fai": fai,
                                    "window": 250}) == (200, want[bams[5]])
    out = {}
    with RouterThread(_router(process_workers)) as port_url, \
            RefRouterThread(_router(process_workers, RefRouter)) \
            as ref_url:
        for name, url, client_cls, runner, bam in (
                ("port", port_url, ServeClient, trace_cmd.run_trace,
                 bams[6]),
                ("ref", ref_url, RefClient, ref_trace_cmd.run_trace,
                 bams[7])):
            client = client_cls(url, timeout_s=TIMEOUT, trace=True)
            raw = client.depth(bam, fai=fai, window=250)
            assert json.dumps(raw).encode() == want[bam]
            tid = client.last_trace_id
            buf = io.StringIO()
            perfetto = str(tmp_path / f"{name}.json")
            assert runner(tid, url, out=buf, perfetto=perfetto) == 0
            out[name] = buf.getvalue()
            with open(perfetto) as fh:
                doc = json.load(fh)
            assert doc["traceEvents"]
        port_lines = _shape(out["port"])
        assert port_lines == _shape(out["ref"])
        assert port_lines[0] == "fleet.request.depth"
        assert port_lines[1] == "  fleet.forward.depth"
        assert "    request.depth" in port_lines
        assert any(line.strip() == "batch.depth" for line in port_lines)
        head = out["port"].splitlines()[0]
        assert re.search(r"2 process\(es\)", head), head
        # a main() run: the command line prints the same tree
        assert trace_cmd.main([tid_of(out["port"]), "--router",
                               port_url, "--json"]) == 0


def tid_of(text: str) -> str:
    return text.split()[1]


def test_fleet_without_a_card_spawns_no_cpu_worker(tmp_path):
    """``fleet --workers 1`` where no card is visible: the worker it
    spawns (``python -m goleft_tpu_torch serve``) exits 1, the
    supervisor reports the failed spawn, and the fleet exits 1 without
    listening: no worker falls back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    journal = str(tmp_path / "ev.jsonl")
    r = subprocess.run(
        [sys.executable, "-m", "goleft_tpu_torch", "fleet", "--port", "0",
         "--workers", "1", "--spawn-timeout-s", str(TIMEOUT),
         "--events-journal", journal],
        capture_output=True, text=True, timeout=2 * TIMEOUT,
        cwd=str(tmp_path), env=env)
    assert r.returncode == 1, (r.stdout, r.stderr[-2000:])
    assert "listening on" not in r.stdout
    assert "failed to spawn" in r.stderr, r.stderr[-2000:]
    from goleft_tpu_torch.obs.events import read_events

    assert [e["type"] for e in read_events(journal)][:1] \
        == ["spawn_failure"]
