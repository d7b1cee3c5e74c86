"""The port's fleet tier against the JAX package's, function by function.

The same numpy-seeded inputs go through both packages' pure functions
and must give equal results: the hash ring's plans and ownership, the
affinity key, the admission gates on an injected clock, trace stitching
(one fleet and a federation), the Perfetto export and the tree
rendering, the metrics roll-up and its registry snapshot, the memory,
profile and warmup merges, and the events journal (written by one
package, read by the other, and printed by both ``fleet events``).
These are what makes the two tiers interchangeable on the wire.
"""

import contextlib
import copy
import datetime
import io
import json

import numpy as np
import pytest

from goleft_tpu.commands import fleet as ref_fleet_cmd
from goleft_tpu.fleet import admission as ref_adm
from goleft_tpu.fleet import router as ref_router
from goleft_tpu.obs import compiles as ref_compiles
from goleft_tpu.obs import events as ref_events
from goleft_tpu.obs import fleetplane as ref_fp
from goleft_tpu.obs import memplane as ref_mem
from goleft_tpu.obs import profiler as ref_prof
from goleft_tpu_torch.commands import fleet as port_fleet_cmd
from goleft_tpu_torch.fleet import admission as port_adm
from goleft_tpu_torch.fleet import router as port_router
from goleft_tpu_torch.obs import compiles as port_compiles
from goleft_tpu_torch.obs import events as port_events
from goleft_tpu_torch.obs import fleetplane as port_fp
from goleft_tpu_torch.obs import memplane as port_mem
from goleft_tpu_torch.obs import profiler as port_prof

SEEDS = [0, 1, 2]


def _both(fn_ref, fn_port, *args, **kw):
    """Call both functions on independent deep copies of the inputs and
    require equal results (neither may see the other's mutations)."""
    want = fn_ref(*copy.deepcopy(args), **copy.deepcopy(kw))
    got = fn_port(*copy.deepcopy(args), **copy.deepcopy(kw))
    assert got == want
    return got


# ---------------- ring and affinity ----------------


@pytest.mark.parametrize("seed", SEEDS)
def test_ring_plans_and_ownership_match(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 7))
    nodes = [f"http://127.0.0.1:{int(p)}"
             for p in rng.choice(np.arange(20000, 30000), n,
                                 replace=False)]
    vnodes = int(rng.choice([8, 64, 128]))
    ref = ref_router.HashRing(nodes, vnodes=vnodes)
    port = port_router.HashRing(nodes, vnodes=vnodes)
    keys = [f"/data/s{int(k)}.bam" for k in rng.integers(0, 10**9, 200)]
    assert [port.candidates(k) for k in keys] \
        == [ref.candidates(k) for k in keys]
    assert port.ownership() == ref.ownership()
    gone = nodes[int(rng.integers(0, n))]
    assert [port.without_node(gone).candidates(k) for k in keys] \
        == [ref.without_node(gone).candidates(k) for k in keys]
    assert [port.with_node("http://new:1").candidates(k) for k in keys] \
        == [ref.with_node("http://new:1").candidates(k) for k in keys]


@pytest.mark.parametrize("seed", SEEDS)
def test_request_affinity_key_matches(seed, tmp_path):
    rng = np.random.default_rng(seed)
    files = []
    for i in range(4):
        f = tmp_path / f"s{i}.bam"
        f.write_bytes(rng.integers(0, 255, int(rng.integers(1, 500)),
                                   dtype=np.uint8).tobytes())
        files.append(str(f))
    missing = str(tmp_path / "absent.bam")
    reqs = [
        ("depth", {"bam": files[0], "window": 250}),
        ("depth", {"bam": missing}),
        ("indexcov", {"bams": files[:3], "fai": files[3]}),
        ("cohortdepth", {"bams": files, "tenant": "a", "priority": 1}),
        ("pairhmm", {"input": files[1]}),
        ("map", {"fastq": files[2], "reference": files[3]}),
        ("cohortscan", {"bams": [files[0], missing]}),
        ("depth", {"window": int(rng.integers(1, 1000)),
                   "timeout_s": 3}),
        ("nope", {"x": [1, 2], "bam": files[0]}),
    ]
    for kind, req in reqs:
        _both(ref_router.request_affinity_key,
              port_router.request_affinity_key, kind, req)
    assert ref_router.AFFINITY_FIELDS == port_router.AFFINITY_FIELDS


# ---------------- admission on an injected clock ----------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _quota_trace(mod, specs, steps):
    clock = _Clock()
    table = mod.QuotaTable(specs, clock=clock)
    out = []
    for dt, tenant in steps:
        clock.t += dt
        try:
            table.check(tenant)
            out.append(("ok", tenant))
        except mod.QuotaExceeded as e:
            out.append(("429", tenant, round(e.retry_after_s, 9)))
    return out, table.metered


@pytest.mark.parametrize("seed", SEEDS)
def test_quota_table_decisions_match(seed):
    rng = np.random.default_rng(seed)
    specs = ["alice=5:2", "bob=1", f"*={int(rng.integers(1, 4))}:3"]
    tenants = ["alice", "bob", "carol", "dave", None]
    steps = [(float(rng.choice([0.0, 0.01, 0.1, 0.5])),
              tenants[int(rng.integers(0, len(tenants)))])
             for _ in range(120)]
    want = _quota_trace(ref_adm, specs, steps)
    assert _quota_trace(port_adm, specs, steps) == want
    assert _quota_trace(port_adm, ["alice=2"], steps) \
        == _quota_trace(ref_adm, ["alice=2"], steps)
    for bad in (["x"], ["a=0"], ["a=-1:2"], ["=3"]):
        for mod in (ref_adm, port_adm):
            with pytest.raises(ValueError):
                mod.QuotaTable(bad)


def test_fair_scheduler_free_slots_match():
    """Without contention both schedulers grant at once, count the same
    inflight and report the same (empty) queue."""
    for mod in (ref_adm, port_adm):
        clock = _Clock()
        fs = mod.FairScheduler(max_inflight=3, aging_rate=0.5,
                               clock=clock)
        waits = [fs.acquire("t", p, timeout_s=1) for p in (0, 2, 5)]
        assert waits == [0.0, 0.0, 0.0]
        assert (fs.inflight(), fs.queue_depth(), fs.queue_age_s()) \
            == (3, 0, 0.0)
        fs.release()
        assert fs.inflight() == 2


# ---------------- trace stitching ----------------


def _iso(epoch: float) -> str:
    return datetime.datetime.fromtimestamp(
        epoch, datetime.timezone.utc).isoformat(timespec="milliseconds")


class _Ids:
    def __init__(self, start=1):
        self.n = start

    def __call__(self):
        self.n += 1
        return self.n - 1


def _span(ids, rng, name, start, children=(), attrs=None,
          category="span"):
    node = {"name": name, "category": category, "span_id": ids(),
            "start_ms": round(float(start), 3),
            "duration_ms": round(float(rng.uniform(0.05, 30.0)), 3),
            "thread": f"t{int(rng.integers(0, 3))}",
            "children": list(children)}
    if attrs:
        node["attrs"] = attrs
    return node


def _count(node):
    return 1 + sum(_count(c) for c in node.get("children", []))


def _as_record(node, trace_id, pid, epoch):
    node.update(trace_id=trace_id, pid=pid, ts=_iso(epoch),
                span_count=_count(node))
    return node


def _fleet_records(rng, tid, epoch, remote_parent=None, n_workers=3):
    """A router record (one forward span per attempt) and, per worker,
    the request tree that answered one forward plus the batch tree
    linked to its plan step; some workers hold nothing (evicted)."""
    ids = _Ids()
    attempts = int(rng.integers(1, n_workers + 1))
    fwds = [_span(ids, rng, "fleet.forward.depth", 0.5 + 3 * i,
                  attrs={"url": f"http://w{i}", "attempt": i})
            for i in range(attempts)]
    root_attrs = {"status": 200}
    if remote_parent is not None:
        root_attrs["remote_parent"] = remote_parent
    root = _span(ids, rng, "fleet.request.depth", 0.0, fwds, root_attrs)
    router_recs = [_as_record(root, tid, 100, epoch)]
    workers = {}
    for i, fwd in enumerate(fwds):
        url = f"http://w{i}"
        if rng.random() < 0.2:
            workers[url] = []
            continue
        wids = _Ids(1 + 100 * (i + 1))
        step = _span(wids, rng, "plan.step.depth", 0.2)
        req = _span(wids, rng, "request.depth", 0.0, [step],
                    {"remote_parent": fwd["span_id"], "status": 200})
        dispatch = _span(wids, rng, "serve.depth.dispatch", 0.1,
                         category="device")
        batch = _span(wids, rng, "batch.depth", 0.0, [dispatch],
                      {"parent_trace": tid,
                       "parent_span": step["span_id"]})
        w_epoch = epoch + float(rng.uniform(0.0005, 0.02))
        recs = [_as_record(batch, f"serve-batch-{i}-1", 200 + i,
                           w_epoch + 0.001),
                _as_record(req, tid, 200 + i, w_epoch)]
        if rng.random() < 0.2:
            # an orphan: a request tree whose forward the router lost
            orphan = _span(wids, rng, "request.depth", 0.0,
                           attrs={"remote_parent": 9999})
            recs.append(_as_record(orphan, tid, 200 + i, w_epoch))
        workers[url] = recs
    offsets = {u: round(float(rng.uniform(-0.05, 0.05)), 6)
               for u in workers if rng.random() < 0.6}
    return router_recs, workers, offsets


@pytest.mark.parametrize("seed", SEEDS)
def test_stitch_perfetto_and_tree_match(seed):
    rng = np.random.default_rng(seed)
    tid = f"serve-cli-{seed}-parity"
    router_recs, workers, offsets = _fleet_records(
        rng, tid, 1.7e9 + seed)
    for recs, offs in ((router_recs, offsets), (router_recs, None),
                       ([], offsets)):
        st = _both(ref_fp.stitch_trace, port_fp.stitch_trace, tid,
                   recs, workers, offs)
        if st is None:
            continue
        _both(ref_fp.perfetto_export, port_fp.perfetto_export, tid, st)
        _both(ref_fp.format_tree, port_fp.format_tree, st)
        _both(ref_fp.format_tree, port_fp.format_tree, st, width=40)
    assert port_fp.stitch_trace("absent", [], {"http://w0": []}) \
        is ref_fp.stitch_trace("absent", [], {"http://w0": []}) is None


@pytest.mark.parametrize("seed", SEEDS)
def test_stitch_federation_matches(seed):
    rng = np.random.default_rng(100 + seed)
    tid = f"serve-cli-{seed}-fed"
    epoch = 1.7e9 + seed
    ids = _Ids(5000)
    n_fleets = int(rng.integers(1, 4))
    fwds = [_span(ids, rng, "federation.forward.depth", 0.3 + 2 * i,
                  attrs={"fleet": f"http://f{i}", "attempt": i})
            for i in range(n_fleets)]
    fed_root = _span(ids, rng, "federation.request.depth", 0.0, fwds,
                     {"status": 200})
    fed_recs = [_as_record(fed_root, tid, 50, epoch)]
    docs = {}
    for i, fwd in enumerate(fwds):
        if rng.random() < 0.2:
            docs[f"http://f{i}"] = None
            continue
        r, w, o = _fleet_records(rng, tid, epoch + 0.002,
                                 remote_parent=fwd["span_id"])
        docs[f"http://f{i}"] = ref_fp.stitch_trace(tid, r, w, o)
    offsets = {u: round(float(rng.uniform(-0.01, 0.01)), 6)
               for u in docs}
    for recs in (fed_recs, []):
        st = _both(ref_fp.stitch_federation, port_fp.stitch_federation,
                   tid, recs, docs, offsets)
        if st is not None:
            _both(ref_fp.perfetto_export, port_fp.perfetto_export,
                  tid, st)
            _both(ref_fp.format_tree, port_fp.format_tree, st)


def test_trace_header_grammar_matches():
    for h in (None, "", "abc", "abc;12", "abc; 7 ", "a b;1", "x;y",
              "z" * 200, "ok;-3", "\x01;1"):
        _both(ref_fp.parse_trace_header, port_fp.parse_trace_header, h)
    for tid, sid in (("t", None), ("t", 0), ("serve-x-1", 99)):
        _both(ref_fp.format_trace_header, port_fp.format_trace_header,
              tid, sid)
    for name in ("http://w0", "http://127.0.0.1:8081", "fleet-a"):
        for seed in (0, 7):
            _both(ref_fp.poll_jitter_frac, port_fp.poll_jitter_frac,
                  name, seed)


# ---------------- metrics roll-up ----------------


def _worker_metrics(rng, with_windows: bool) -> dict:
    n = int(rng.integers(0, 60))
    lat = np.round(rng.exponential(0.2, n), 6).tolist()
    eps = ("depth", "indexcov", "pairhmm")
    snap = {
        "uptime_s": float(np.round(rng.uniform(1, 500), 3)),
        "queue_depth": int(rng.integers(0, 9)),
        "queue_age_s": float(np.round(rng.uniform(0, 2), 4)),
        "counters": {f"requests_total.{ep}": int(rng.integers(0, 50))
                     for ep in eps[:int(rng.integers(1, 4))]},
        "batch_size_hist": {str(int(b)): int(rng.integers(1, 9))
                            for b in rng.integers(1, 9, 3)},
        "latency_s": {},
        "slo": {
            "error_rate": float(np.round(rng.uniform(0, 0.1), 6)),
            "window_requests": n,
            "p99_latency_ratio": {
                ep: float(np.round(rng.uniform(0, 3), 4))
                for ep in eps[:int(rng.integers(0, 4))]},
            "tenants": {
                t: {"window_requests": int(rng.integers(0, 30)),
                    "error_rate": float(np.round(rng.uniform(0, .2), 6)),
                    "p99_latency_ratio": float(
                        np.round(rng.uniform(0, 2), 4))}
                for t in ("alice", "bob")[:int(rng.integers(0, 3))]},
        },
    }
    if n:
        s = sorted(lat)
        snap["latency_s"]["depth"] = {
            "p50": s[n // 2], "p95": s[int(n * .95)],
            "p99": s[min(n - 1, int(n * .99))], "max": s[-1],
            "count": n, "sum": round(sum(lat), 6)}
        if with_windows:
            snap["latency_windows"] = {"depth": lat}
    return snap


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_worker_metrics_and_rollup_match(seed):
    rng = np.random.default_rng(200 + seed)
    for all_windows in (True, False):
        snaps = {str(8000 + i): _worker_metrics(
                     rng, all_windows or bool(rng.random() < 0.5))
                 for i in range(int(rng.integers(1, 5)))}
        budget = float(rng.choice([0.01, 0.05]))
        merged = _both(ref_fp.merge_worker_metrics,
                       port_fp.merge_worker_metrics, snaps,
                       error_budget=budget)
        _both(ref_fp.rollup_registry_snapshot,
              port_fp.rollup_registry_snapshot, merged)
        _both(ref_fp.merge_tenant_slos, port_fp.merge_tenant_slos,
              [s["slo"].get("tenants") or {} for s in snaps.values()],
              budget)


# ---------------- memory, profile and warmup merges ----------------


def _memory_body(rng) -> dict:
    fams = ("depth", "pairhmm", "rans")
    return {
        "schema": "goleft-tpu.memory/1",
        "enabled": bool(rng.random() < 0.5),
        "host": {"rss_bytes": int(rng.integers(1 << 20, 1 << 32))},
        "pressure": {"state": str(rng.choice(["ok", "pressure"]))},
        "counters": {f"memory.{k}_total": int(rng.integers(0, 1000))
                     for k in ("samples", "sheds", "recycles")[
                         :int(rng.integers(1, 4))]},
        "gauges": {f"memory.{k}": float(np.round(rng.uniform(0, 1e9), 1))
                   for k in ("rss_bytes", "hwm_bytes", "pss_bytes")[
                       :int(rng.integers(1, 4))]},
        "device": {"by_family": {
            f: int(rng.integers(0, 1 << 30))
            for f in fams[:int(rng.integers(0, 4))]}},
    }


@pytest.mark.parametrize("seed", SEEDS)
def test_memory_merges_match(seed):
    rng = np.random.default_rng(300 + seed)
    fleets = []
    for _ in range(int(rng.integers(1, 4))):
        bodies = [_memory_body(rng)
                  for _ in range(int(rng.integers(1, 5)))]
        bodies.append({"error": "worker mid-restart"})
        merged = _both(ref_mem.merge_memory, port_mem.merge_memory,
                       bodies)
        _both(ref_mem.flatten_merged, port_mem.flatten_merged, merged)
        fleets.append(merged)
    fed = _both(ref_mem.merge_merged_memory,
                port_mem.merge_merged_memory, fleets + ["junk"])
    _both(ref_mem.flatten_merged, port_mem.flatten_merged, fed)
    assert port_mem.MEMORY_SCHEMA == ref_mem.MEMORY_SCHEMA


@pytest.mark.parametrize("seed", SEEDS)
def test_profile_and_warmup_merges_match(seed):
    rng = np.random.default_rng(400 + seed)
    frames = ["serve.py:run", "batcher.py:_loop", "executors.py:depth",
              "depth_kernel.py:fused", "threading.py:wait"]
    bodies = []
    for _ in range(int(rng.integers(1, 5))):
        stacks = {}
        for _ in range(int(rng.integers(0, 12))):
            k = int(rng.integers(1, len(frames) + 1))
            stacks[";".join(frames[:k])] = int(rng.integers(1, 100))
        bodies.append({
            "schema": "goleft-tpu.profile/1",
            "enabled": bool(rng.random() < 0.8),
            "hz": float(rng.choice([0.0, 50.0, 100.0])),
            "samples_total": int(sum(stacks.values())),
            "stacks_dropped": int(rng.integers(0, 3)),
            "stacks": stacks,
            "trace_ids": {f"serve-{int(t)}": int(rng.integers(1, 5))
                          for t in rng.integers(0, 5, 2)},
        })
    bodies.append({"error": "profiling disabled"})
    merged = _both(ref_prof.merge_profiles, port_prof.merge_profiles,
                   bodies)
    _both(ref_prof.to_collapsed, port_prof.to_collapsed, merged)

    docs = []
    for _ in range(int(rng.integers(1, 4))):
        sigs = [{"family": str(rng.choice(["depth", "pairhmm", "rans"])),
                 "signature": f"b{int(rng.integers(1, 4))}x"
                              f"{int(rng.integers(1, 5)) * 128}",
                 "backend": str(rng.choice(["gpu", "cpu"])),
                 "hits": int(rng.integers(0, 20)),
                 "compiles": int(rng.integers(0, 3)),
                 "compile_seconds": float(np.round(
                     rng.uniform(0, 2), 6))}
                for _ in range(int(rng.integers(0, 6)))]
        docs.append({"schema": "goleft-tpu.warmup-manifest/1",
                     "signatures": sigs})
    w = _both(ref_compiles.merge_warmup_docs,
              port_compiles.merge_warmup_docs, *docs)
    assert port_compiles.validate_warmup_manifest(w) == w
    assert ref_compiles.validate_warmup_manifest(w) == w


# ---------------- the events journal across packages ----------------


def _write_journal(mod, path, rng):
    with mod.EventJournal(path) as j:
        for i in range(8):
            j.append(str(rng.choice(mod.EVENT_TYPES)),
                     slot=int(rng.integers(0, 3)),
                     worker=f"http://w{int(rng.integers(0, 3))}",
                     pid=int(rng.integers(100, 999)),
                     why=f"rc={-int(rng.integers(1, 15))}")


def _events_cli(mod, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = mod.events_main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_events_journal_crosses_packages(writer, tmp_path):
    rng = np.random.default_rng(7)
    path = str(tmp_path / "events.jsonl")
    _write_journal(ref_events if writer == "reference" else port_events,
                   path, rng)
    with open(path, "a") as fh:
        fh.write('{"schema": "goleft-tpu.fleet-ev')  # a torn tail
    # a second writer continues the journal past the torn line
    _write_journal(port_events if writer == "reference" else ref_events,
                   path, rng)
    assert port_events.SCHEMA == ref_events.SCHEMA
    assert port_events.EVENT_TYPES == ref_events.EVENT_TYPES
    evs = _both(ref_events.read_events, port_events.read_events, path)
    assert len(evs) == 16
    since = evs[5]["t"]
    for kw in ({"slot": 1}, {"type": evs[3]["type"]}, {"since": since}):
        _both(ref_events.read_events, port_events.read_events, path, **kw)
    for argv in (["--journal", path, "--json"],
                 ["--journal", path, "--slot", "2"],
                 ["--journal", path, "--json", "--type", evs[0]["type"]]):
        assert _events_cli(port_fleet_cmd, argv) \
            == _events_cli(ref_fleet_cmd, argv)
    doc = json.loads(_events_cli(port_fleet_cmd,
                                 ["--journal", path, "--json"])[1])
    assert doc["schema"] == "goleft-tpu.fleet-events/1"
    assert doc["count"] == 16
