"""The port's global flags and its tracing, held against the JAX package
on the CPU.

- ``_extract_global_flags``: the port and goleft_tpu/cli.py agree on a
  set of argvs (options, rest of argv, errors); ``-v`` alone prints the
  version.
- The fault grammar: ``parse_faults`` of both packages agree on a set of
  specs, errors included; installed plans fire at the same per-site
  indices (``p=``/``seed=`` too); a ``kill`` clause SIGKILLs a process.
- The tracer: the Tracer cases of tests/test_obs.py (the golden export
  shape, capture/attach across threads, the ring bound) on the port's
  Tracer; StageTimer stages mirrored onto it.
- ``--trace-out`` on the CPU for ``depth``, ``cohortdepth
  --decode-device`` and ``pairhmm``: valid Chrome trace JSON with one
  ``run.<command>`` root, every span parented under it, fenced
  ``device.<kernel>`` spans, and the manifest's ``trace_id`` equal to
  the trace's; ``--log-level`` and ``-v`` set the logger tree.
- ``depth --cache``: byte-identical to ``goleft_tpu depth``, a rerun
  hits every shard, a touched BAM misses; ``depth --profile`` writes a
  torch.profiler Chrome trace.

The CLI runs on the CPU here by pointing the commands' default device
there (the port's CLI has no CPU switch).
"""

import io
import json
import logging
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from goleft_tpu import cli as jcli
from goleft_tpu.commands import depth as jdepth
from goleft_tpu.obs.manifest import load_manifest
from goleft_tpu.obs.smoke import validate_trace
from goleft_tpu.ops.decode_smoke import make_cram_cohort
from goleft_tpu.resilience import faults as jfaults
from goleft_tpu_torch import cli, obs
from goleft_tpu_torch import device as tdev
from goleft_tpu_torch.commands import cohortdepth as pcd
from goleft_tpu_torch.commands import depth as pdepth
from goleft_tpu_torch.obs.tracing import Tracer
from goleft_tpu_torch.ops import pairhmm as tph
from goleft_tpu_torch.resilience import faults as pfaults
from goleft_tpu_torch.utils.profiling import StageTimer
from helpers import random_reads, write_bam_and_bai, write_fasta
from test_pairhmm import _windows_doc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "obs_trace_golden.json")


@pytest.fixture()
def cpu_cli(monkeypatch):
    """The port's CLI with the commands' default device on the CPU; the
    process state a CLI run sets (device events, the fault plan, the
    log level, the tracer's spans) is put back afterwards."""
    cpu = lambda d=None: tdev.resolve_device("cpu" if d is None else d)  # noqa: E731
    for mod in (pdepth, pcd, tph):
        monkeypatch.setattr(mod, "resolve_device", cpu)
    # the card's subprocess probe is skipped: the commands run on the
    # CPU here (utils/device_guard.py)
    monkeypatch.setenv("GOLEFT_TPU_PROBE", "0")
    obs.get_tracer().clear()
    yield cli.main
    obs.set_device_events(False)
    pfaults.install(None)
    obs.configure_logging("warning")
    obs.get_tracer().clear()


# ---- global flags ----------------------------------------------------

ARGVS = [
    ["--trace-out", "t.json", "depth", "--metrics-out=m.json", "-v",
     "--prefix", "o", "x.bam"],
    ["-vv", "pairhmm", "w.json"],
    ["--log-level=debug", "cohortdepth", "-v", "-v", "a.cram"],
    ["depth", "--inject-faults", "shard:after=3:kill", "--prefix", "o"],
    ["--inject-faults=cache:p=0.2:seed=7:transient;shard:after=2:"
     "permanent", "depth"],
    ["--log-level", "ERROR", "--trace-out=", "depth"],
    ["depth", "--trace-out"],
    ["--metrics-out"],
    ["--log-level", "loud", "depth"],
    ["--inject-faults", "shard", "depth"],
    ["--inject-faults", "shard:after=1:every=2", "depth"],
    ["depth", "--inject-faults=shard:p=2"],
]


def _flags(fn, argv):
    try:
        return fn(list(argv))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) for a in ARGVS])
def test_global_flags_match_reference(argv):
    assert _flags(cli._extract_global_flags, argv) \
        == _flags(jcli._extract_global_flags, argv)


def test_dash_v_alone_is_the_version(capsys):
    import goleft_tpu_torch

    assert cli.main(["-v"]) == 0
    assert capsys.readouterr().out.strip() == goleft_tpu_torch.__version__
    assert cli.main(["--log-level", "loud", "depth"]) == 1
    assert "unknown log level" in capsys.readouterr().err
    assert cli.main(["--inject-faults", "shard:nope", "depth"]) == 1
    assert "unknown part" in capsys.readouterr().err


def test_usage_lists_the_global_flags():
    text = cli.usage()
    for flag in ("--trace-out", "--metrics-out", "--log-level", "-v / -vv",
                 "--inject-faults"):
        assert flag in text


@pytest.mark.parametrize("argv,level", [
    (["-v"], logging.INFO), (["-vv"], logging.DEBUG),
    (["--log-level", "error"], logging.ERROR), ([], logging.WARNING)])
def test_log_level_flags_set_the_tree(cpu_cli, tmp_path, argv, level):
    assert cpu_cli(["pairhmm", *argv, str(tmp_path / "nope.json")]) == 1
    root = logging.getLogger("goleft-tpu-torch")
    assert root.level == level
    assert sum(getattr(h, "_goleft_cli", False)
               for h in root.handlers) == 1


# ---- the fault grammar -------------------------------------------------

SPECS = [
    "shard:after=3:kill", "bgzf:every=100:p=0",
    "cache:p=0.2:seed=7:transient;shard:after=2:permanent",
    "fetch:every=2:hang=0.5", "decode:after=1:hang", "pairhmm:every=3:"
    "times=2:permanent", " shard : after=4 ; ", "x:p=1", "shard",
    "shard:kill", "shard:after=x", "shard:p=2", "shard:after=1:every=2",
    "shard:after=1:bogus", "", ";",
]


def _clauses(mod, spec):
    try:
        return [(c.site, c.kind, c.hang_s, c.after, c.every, c.p, c.seed,
                 c.times, c.spec) for c in mod.parse_faults(spec)]
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("spec", SPECS)
def test_fault_grammar_matches_reference(spec):
    assert _clauses(pfaults, spec) == _clauses(jfaults, spec)


def _fired(mod, spec, sites, n):
    plan = mod.install(spec)
    out = []
    try:
        for i in range(n):
            for site in sites:
                try:
                    plan.check(site, (site, i))
                except mod.InjectedPermanentFault as e:
                    out.append((site, e.index, "permanent"))
                except mod.InjectedFault as e:
                    out.append((site, e.index, "transient"))
        return out, plan.counts()
    finally:
        mod.install(None)


@pytest.mark.parametrize("spec", [
    "shard:p=0.3:seed=11", "shard:p=0.5;cache:p=0.25:seed=3:permanent",
    "bgzf:every=7:times=3;shard:after=5:permanent", "fetch:p=0.1:seed=2"])
def test_installed_plans_fire_at_the_reference_indices(spec):
    sites = ("shard", "cache", "bgzf", "fetch")
    got = _fired(pfaults, spec, sites, 200)
    assert got == _fired(jfaults, spec, sites, 200)
    assert got[0] and got[1] == {s: 200 for s in sites}


def test_kill_clause_sigkills_the_process():
    script = ("import sys; sys.path.insert(0, %r)\n"
              "from goleft_tpu_torch.resilience import faults\n"
              "faults.install('shard:after=2:kill')\n"
              "faults.maybe_fail('shard'); print('one', flush=True)\n"
              "faults.maybe_fail('shard'); print('two', flush=True)\n"
              % ROOT)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == -9, r.stderr
    assert r.stdout.split() == ["one"]
    assert "injected KILL at site shard invocation 2" in r.stderr


# ---- the tracer --------------------------------------------------------

def _golden_span_script(tracer: Tracer) -> None:
    """tests/test_obs.py's fixed scenario: a CLI-style root, two stages
    (one with device attributes), and a span from a worker thread under
    an attached context."""
    with tracer.trace("run.golden", kind="cli", argv="golden") as root:
        assert root.trace_id.startswith("cli-")
        with tracer.span("decode", category="stage", shard=0):
            pass
        with tracer.span("compute", category="device",
                         platform="cpu", fenced=True):
            pass
        ctx = tracer.capture()

        def worker():
            with tracer.attach(ctx):
                with tracer.span("stage", category="stage"):
                    pass

        t = threading.Thread(target=worker, name="goleft-prefetch-0")
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()


def _normalize(doc: dict) -> dict:
    """tests/test_obs.py's normalization: volatile fields stripped, the
    id topology kept."""
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    tid_map: dict = {}
    span_map: dict = {}
    for e in xs:
        tid_map.setdefault(e["tid"], f"T{len(tid_map)}")
        span_map.setdefault(e["args"]["span_id"], f"S{len(span_map)}")
    events = []
    for e in xs:
        args = dict(e["args"])
        args["span_id"] = span_map[args["span_id"]]
        if "parent_id" in args:
            args["parent_id"] = span_map[args["parent_id"]]
        args["trace_id"] = "TRACE"
        events.append({"name": e["name"], "cat": e["cat"], "ph": "X",
                       "ts": 0, "dur": 0, "pid": "PID",
                       "tid": tid_map[e["tid"]], "args": args})
    meta = [{"name": "thread_name", "ph": "M", "pid": "PID", "tid": t}
            for t in sorted(set(tid_map.values()))]
    return {"traceEvents": meta + events,
            "displayTimeUnit": doc["displayTimeUnit"],
            "otherData": {"producer": doc["otherData"]["producer"],
                          "spans_dropped": doc["otherData"]["spans_dropped"]}}


def test_export_shape_matches_the_reference_golden():
    tracer = Tracer()
    _golden_span_script(tracer)
    got = _normalize(tracer.to_chrome_trace())
    with open(GOLDEN) as fh:
        want = json.load(fh)
    want["otherData"]["producer"] = "goleft-tpu-torch obs"
    assert got == want


def test_export_round_trips_and_parents_across_threads(tmp_path):
    tracer = Tracer()
    _golden_span_script(tracer)
    p = str(tmp_path / "t.json")
    tracer.write_chrome_trace(p)
    doc = validate_trace(p)
    assert _normalize(doc) == _normalize(tracer.to_chrome_trace())
    by_name = {e["name"]: e for e in doc["traceEvents"]
               if e.get("ph") == "X"}
    root, stage = by_name["run.golden"], by_name["stage"]
    assert stage["args"]["parent_id"] == root["args"]["span_id"]
    assert stage["args"]["trace_id"] == root["args"]["trace_id"]
    assert stage["tid"] != root["tid"]
    summary = tracer.summary(trace_id=root["args"]["trace_id"])
    assert {k: v["calls"] for k, v in summary.items()} == {
        "compute": 1, "decode": 1, "run.golden": 1, "stage": 1}


def test_ring_bounds_spans_and_counts_drops():
    tracer = Tracer(max_spans=4)
    for i in range(10):
        with tracer.span(f"s{i}"):
            pass
    tracer.record_span("late", 1.0, 2.0)
    assert [sp.name for sp in tracer.snapshot()] == ["s7", "s8", "s9",
                                                     "late"]
    assert tracer.spans_dropped == 7
    doc = tracer.to_chrome_trace()
    meta = [e for e in doc["traceEvents"] if e["name"] == "spans_dropped"]
    assert meta[0]["args"]["spans_dropped"] == 7
    assert doc["otherData"]["spans_dropped"] == 7
    tracer.clear()
    assert tracer.snapshot() == [] and tracer.spans_dropped == 0


def test_stage_timer_mirrors_onto_the_tracer():
    tracer = obs.get_tracer()
    tracer.clear()
    timer = StageTimer()
    with obs.trace("run.t", kind="cli") as root:
        with timer.stage("decode"):
            pass
        ctx = obs.capture()

        def worker():
            with obs.attach(ctx), timer.stage("decode"):
                pass

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    spans = [sp for sp in tracer.snapshot() if sp.name == "decode"]
    assert len(spans) == 2 and timer.counts["decode"] == 2
    assert all(sp.parent_id == root.span_id and sp.category == "stage"
               and sp.trace_id == root.trace_id for sp in spans)
    tracer.clear()


def test_dispatch_is_a_plain_call_with_device_events_off():
    tracer = obs.get_tracer()
    tracer.clear()
    obs.set_device_events(False)
    assert obs.dispatch("depth", lambda a, b=0: a + b, 1, b=2) == 3
    assert tracer.snapshot() == []
    obs.set_device_events(True)
    try:
        import torch

        out = obs.dispatch("depth", torch.ones, 3)
        assert out.tolist() == [1.0, 1.0, 1.0]
    finally:
        obs.set_device_events(False)
    sp, = tracer.snapshot()
    assert (sp.name, sp.category) == ("device.depth", "device")
    assert sp.attrs["fenced"] is True and sp.attrs["platform"] == "cpu"
    tracer.clear()


# ---- --trace-out on the CPU --------------------------------------------

def _check_trace(path, manifest, prog, stages, device_span):
    """One run.<prog> root; every other span's parent chain reaches it;
    ``stages`` present; fenced ``device_span`` spans; the manifest's
    trace id is the trace's. → the span events."""
    doc = validate_trace(path)
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    roots = [e for e in xs if e["name"].startswith("run.")]
    assert [e["name"] for e in roots] == [f"run.{prog}"]
    root = roots[0]
    by_id = {e["args"]["span_id"]: e for e in xs}
    for e in xs:
        hops = 0
        while e is not root:
            e = by_id[e["args"]["parent_id"]]
            hops += 1
            assert hops < 20
    assert set(stages) <= {e["name"] for e in xs}
    dev = [e for e in xs if e["name"] == device_span]
    assert dev and all(e["cat"] == "device" and e["args"]["fenced"]
                       and e["args"]["platform"] == "cpu" for e in dev)
    man = load_manifest(manifest)
    assert man["trace_id"] == root["args"]["trace_id"]
    assert man["trace_id"].startswith("cli-")
    assert man["command"] == prog and man["exit_code"] == 0
    return xs


@pytest.fixture(scope="module")
def depth_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_flags_depth")
    rng = np.random.default_rng(5)
    ref_len = 20_000
    bam = str(tmp / "t.bam")
    write_bam_and_bai(bam, random_reads(rng, 300, 0, ref_len, mapq_lo=20),
                      ref_names=("chr1",), ref_lens=(ref_len,),
                      header_text="@HD\tVN:1.6\tSO:coordinate\n"
                                  f"@SQ\tSN:chr1\tLN:{ref_len}\n"
                                  "@RG\tID:r\tSM:s1\n")
    fa = write_fasta(str(tmp / "ref.fa"), {"chr1": "ACGT" * (ref_len // 4)})
    return tmp, bam, fa


def test_depth_trace_out(cpu_cli, depth_fixture, tmp_path):
    _, bam, fa = depth_fixture
    t, m = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    assert cpu_cli(["depth", "--trace-out", t, "--metrics-out", m,
                    "--prefix", str(tmp_path / "o"), "-r", fa, bam]) == 0
    assert os.path.exists(tmp_path / "o.depth.bed")
    xs = _check_trace(t, m, "depth", {"setup", "shard-loop", "host-decode",
                                      "device-compute", "write-output"},
                      "device.depth")
    dev = [e for e in xs if e["name"] == "device.depth"]
    parents = {e["args"]["span_id"]: e["name"] for e in xs}
    assert {parents[e["args"]["parent_id"]] for e in dev} \
        == {"device-compute"}
    assert load_manifest(m)["metrics"]["counters"]["depth.shards_total"] \
        == len(dev)


def test_trace_written_when_the_command_fails(cpu_cli, tmp_path):
    t = str(tmp_path / "t.json")
    assert cpu_cli(["--trace-out", t, "pairhmm",
                    str(tmp_path / "nope.json")]) == 1
    doc = validate_trace(t)
    root, = [e for e in doc["traceEvents"] if e.get("ph") == "X"
             and e["name"] == "run.pairhmm"]
    assert root["args"]["exit_code"] == 1


def test_cohortdepth_decode_device_trace_out(cpu_cli, tmp_path):
    from goleft_tpu_torch.obs import get_registry

    crams, fai = make_cram_cohort(str(tmp_path))
    t, m = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    buf = io.StringIO()
    before = get_registry().snapshot()["counters"].get(
        "decode.device_blocks_total", 0)
    real = sys.stdout
    sys.stdout = buf
    try:
        rc = cpu_cli(["--trace-out", t, "--metrics-out", m, "cohortdepth",
                      "--fai", fai, "-w", "500", "--decode-device",
                      "-p", "4", *crams])
    finally:
        sys.stdout = real
    assert rc == 0
    want = io.StringIO()
    from goleft_tpu.commands.cohortdepth import run_cohortdepth as jax_run

    assert jax_run(crams, fai=fai, window=500, out=want) == 0
    assert buf.getvalue() == want.getvalue()
    xs = _check_trace(t, m, "cohortdepth",
                      {"sample-shard", "cram.blocks", "decode.device",
                       "format"}, "device.rans")
    assert get_registry().snapshot()["counters"][
        "decode.device_blocks_total"] > before
    # the sample threads' spans are on other threads than the root's
    root, = [e for e in xs if e["name"] == "run.cohortdepth"]
    assert any(e["tid"] != root["tid"] for e in xs
               if e["name"] == "device.rans")


def test_pairhmm_trace_out(cpu_cli, tmp_path):
    from goleft_tpu.commands import pairhmm_cmd as jcmd

    _windows_doc(str(tmp_path / "w.json"))
    t, m = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    got, want = str(tmp_path / "got.tsv"), str(tmp_path / "want.tsv")
    assert cpu_cli(["--trace-out", t, "--metrics-out", m, "pairhmm",
                    "--out", got, str(tmp_path / "w.json")]) == 0
    assert jcmd.main(["--out", want, str(tmp_path / "w.json")]) == 0
    assert open(got).read() == open(want).read()
    xs = _check_trace(t, m, "pairhmm", {"encode-pack", "device-kernel",
                                        "host-fold"}, "device.pairhmm")
    buckets = load_manifest(m)["metrics"]["counters"][
        "pairhmm.buckets_total"]
    assert sum(e["name"] == "device.pairhmm" for e in xs) == buckets


# ---- depth --cache and --profile ---------------------------------------

def _hits():
    from goleft_tpu_torch.obs import get_registry

    return get_registry().counter("result_cache.hits_total").value


def test_depth_cache_replays_every_shard(depth_fixture, tmp_path,
                                         monkeypatch):
    _, bam, fa = depth_fixture
    monkeypatch.setattr(jdepth, "STEP", 5000)
    monkeypatch.setattr(pdepth, "STEP", 5000)  # 4 shards
    want = jdepth.run_depth(bam, str(tmp_path / "j"), reference=fa,
                            window=100)
    cache = str(tmp_path / "cache")
    outs = []
    for run in ("cold", "warm"):
        h0 = _hits()
        outs.append((pdepth.run_depth(bam, str(tmp_path / run),
                                      reference=fa, window=100,
                                      cache_dir=cache, device="cpu"),
                     _hits() - h0))
    (cold, cold_hits), (warm, warm_hits) = outs
    assert (cold_hits, warm_hits) == (0, 4)
    for paths in (cold, warm):
        for a, b in zip(paths, want):
            assert open(a).read() == open(b).read()
    st = os.stat(bam)
    os.utime(bam, ns=(st.st_atime_ns, st.st_mtime_ns + 1000))
    h0 = _hits()
    pdepth.run_depth(bam, str(tmp_path / "touched"), reference=fa,
                     window=100, cache_dir=cache, device="cpu")
    assert _hits() == h0
    assert len(os.listdir(cache)) == 8


def test_depth_cache_values_are_host_arrays(depth_fixture, tmp_path):
    import pickle

    _, bam, fa = depth_fixture
    cache = tmp_path / "cache"
    pdepth.run_depth(bam, str(tmp_path / "o"), reference=fa, window=100,
                     cache_dir=str(cache), device="cpu")
    entry, = cache.iterdir()
    with open(entry, "rb") as fh:
        value = pickle.load(fh)
    assert len(value) == 4
    assert all(isinstance(v, np.ndarray) for v in value)


def test_depth_profile_writes_a_chrome_trace(cpu_cli, depth_fixture,
                                             tmp_path, caplog):
    _, bam, fa = depth_fixture
    pdir = tmp_path / "prof"
    with caplog.at_level(logging.INFO, logger="goleft-tpu-torch"):
        assert cpu_cli(["depth", "-v", "--profile", str(pdir), "--prefix",
                        str(tmp_path / "o"), "-r", fa, bam]) == 0
    with open(pdir / "trace.json") as fh:
        doc = json.load(fh)
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    logged = caplog.text
    assert "profiler trace written to" in logged
    assert "host-decode" in logged and "device-compute" in logged


def test_cache_fault_site_never_fails_a_shard(depth_fixture, tmp_path):
    """The ``cache`` site fires in ResultCache get and put; a cache
    failure costs the lookup, never the shard (as in the JAX package)."""
    from goleft_tpu_torch.obs import get_registry

    _, bam, fa = depth_fixture
    want = jdepth.run_depth(bam, str(tmp_path / "j"), reference=fa,
                            window=100)
    errors = get_registry().counter("result_cache.io_errors_total")
    before = errors.value
    plan = pfaults.install("cache:every=1:permanent")
    try:
        got = pdepth.run_depth(bam, str(tmp_path / "p"), reference=fa,
                               window=100, cache_dir=str(tmp_path / "c"),
                               device="cpu")
        counts = plan.counts()
    finally:
        pfaults.install(None)
    assert counts == {"cache": 2, "shard": 1}
    assert errors.value == before + 2
    for a, b in zip(got, want):
        assert open(a).read() == open(b).read()


@pytest.mark.parametrize("spec", ["bgzf:after=3:transient",
                                  "bgzf:every=2:permanent:times=1"])
def test_bgzf_fault_site_fires_at_the_reference_block(depth_fixture, spec):
    """The portable BGZF reader's per-block inflate is the ``bgzf`` site
    in both packages: the same spec fires at the same block."""
    from goleft_tpu.io.bam import BamReader as JReader
    from goleft_tpu_torch.io.bam import BamReader as PReader

    _, bam, _ = depth_fixture
    data = open(bam, "rb").read()
    seen = []
    for mod, reader in ((jfaults, JReader), (pfaults, PReader)):
        mod.install(spec)
        try:
            with pytest.raises(mod.InjectedFault) as e:
                reader(data).read_columns()
            seen.append((type(e.value).__name__, e.value.index))
        finally:
            mod.install(None)
    assert seen[0] == seen[1]


def test_result_cache_keeps_entries_and_heals_corrupt_ones(tmp_path):
    from goleft_tpu_torch.parallel.scheduler import ResultCache

    blob = np.zeros(100, np.int64)
    rc = ResultCache(str(tmp_path / "c"))
    for i in range(5):
        rc.put(("k", i), blob)
    kept = [i for i in range(5) if os.path.exists(rc._path(("k", i)))]
    assert kept == [0, 1, 2, 3, 4]
    assert rc.get(("k", 7)) is None and rc.misses == 1
    with open(rc._path(("k", 4)), "wb") as fh:
        fh.write(b"garbled")
    assert rc.get(("k", 4)) is None and rc.misses == 2
    assert not os.path.exists(rc._path(("k", 4)))
    rc.put(("k", 9), blob)
    np.testing.assert_array_equal(rc.get(("k", 9)), blob)
    assert rc.hits == 1
