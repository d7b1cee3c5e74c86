"""Fleet observability plane: one telemetry story across processes. The
port's copy of the JAX package's obs/fleetplane.py, with the same wire
(the header, the record and document shapes), so a reference router can
stitch a port worker's records and the reverse.

A request's life is split across a router and a supervised worker
fleet, each process with its own spans, metrics registry and flight
recorder. This module is the glue that makes the fleet observable as
one system, in three stdlib-only pieces shared by the router (which
never imports torch) and the serve workers:

  - **trace context propagation**: the ``x-goleft-trace`` header (a
    W3C-traceparent-style ``<trace_id>;<parent_span_id>`` pair) minted
    by the client or the router and forwarded on every proxied
    request. The worker's ``request.<kind>`` root adopts the remote
    trace id (``Tracer.trace(trace_id=...)``) and records the remote
    parent span id as the ``remote_parent`` attribute — span ids stay
    process-local, so adoption never aliases a foreign id into the
    local parent chain.
  - **cross-process trace stitching**: :func:`stitch_trace` takes the
    router's flight record for a trace id plus each worker's matching
    records (``/debug/flight?trace_id=``) and rebuilds the Dapper-style
    request tree: worker ``request.*`` trees graft under the router
    ``fleet.forward.*`` span named by their ``remote_parent``, and
    worker ``batch.*`` trees (which run on the dispatcher thread under
    their own trace) graft under the plan-step span recorded in their
    ``parent_trace``/``parent_span`` link attributes.
    :func:`perfetto_export` renders the same records as Chrome
    trace-event JSON with one process track per OS process.
    Cross-process timestamps align via each record's wall-clock root
    ``ts`` (millisecond precision — good enough to read a request's
    shape, not to measure a syscall).
  - **metrics rollup**: :func:`merge_worker_metrics` folds the polled
    per-worker ``/metrics`` bodies into one fleet view — counters
    summed, gauges kept per-worker plus min/max/sum, histogram
    summaries merged (counts and sums exactly; quantiles as
    count-weighted means of the per-worker quantiles, which is an
    APPROXIMATION — quantiles are not mergeable from summaries, see
    the JAX package's docs/observability.md) — and computes the fleet SLO burn-rate
    gauges (``fleet.slo.burn_rate.<endpoint>``) the supervisor's
    autoscaler consumes.
"""

from __future__ import annotations

import datetime
import hashlib
import itertools
import os
import time

#: the cross-process trace header (request AND response)
TRACE_HEADER = "x-goleft-trace"

#: longest trace id accepted from the wire (the flight ring keys on
#: it; an unbounded attacker-chosen string must not become one)
MAX_TRACE_ID = 128

_mint_seq = itertools.count(1)


def format_trace_header(trace_id: str, span_id: int | None = None) -> str:
    """``<trace_id>`` or ``<trace_id>;<parent_span_id>``."""
    if span_id is None:
        return trace_id
    return f"{trace_id};{span_id}"


def parse_trace_header(value: str | None) -> tuple[str, int | None] | None:
    """(trace_id, parent_span_id|None), or None for absent/garbage.

    The header crosses a trust boundary (any client can send one), so
    parsing is strict: bounded length, printable non-space id, integer
    span. A bad header degrades to "no header" — propagation is an
    observability feature and must never 400 a request.
    """
    if not value:
        return None
    head, _, tail = value.strip().partition(";")
    if not head or len(head) > MAX_TRACE_ID \
            or any(c.isspace() or not c.isprintable() for c in head):
        return None
    span_id: int | None = None
    if tail:
        try:
            span_id = int(tail.strip())
        except ValueError:
            return None
    return head, span_id


def mint_trace_id(component: str = "cli") -> str:
    """A fleet-unique trace id for a process WITHOUT a tracer (the
    stdlib client): ``serve-<component>-<pid>-<ms>-<n>``. The
    ``serve-`` prefix is what the workers' flight recorders watch, so
    a client-minted trace is retained end to end."""
    return (f"serve-{component}-{os.getpid()}-"
            f"{int(time.time() * 1000)}-{next(_mint_seq)}")


def poll_jitter_frac(name: str, seed: int = 0) -> float:
    """Deterministic per-worker scrape offset in [0, 1) — the
    RetryPolicy jitter trick applied to the poller's schedule, so N
    workers spread across the poll interval instead of being scraped
    in one tick burst. Same (name, seed), same offset, every process."""
    h = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


# ---------------------------------------------------------------------------
# metrics rollup
# ---------------------------------------------------------------------------

#: scalar top-level fields of a worker /metrics body treated as gauges
GAUGE_FIELDS = ("queue_depth", "queue_age_s", "uptime_s")

#: histogram-summary keys merged as count-weighted means (approximate)
_QUANTILE_KEYS = ("p50", "p95", "p99")


def _merge_counter_maps(maps: list[dict]) -> dict:
    out: dict[str, int] = {}
    for m in maps:
        for k, v in m.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            out[k] = out.get(k, 0) + v
    return {k: out[k] for k in sorted(out)}


def merge_histogram_summaries(summaries: list[dict],
                              windows: list[list] | None = None) \
        -> dict:
    """One merged summary from per-worker summaries produced by
    :meth:`~goleft_tpu_torch.obs.metrics.Histogram.summary`.

    ``count`` and ``sum`` merge exactly (they are additive); ``max``
    is the max of maxes (exact). Quantiles come in two grades:

      - **exact** — when ``windows`` carries every live worker's
        bounded raw observation window (the ``latency_windows``
        block workers ship in /metrics), the merged quantiles are
        computed over the CONCATENATED windows: the same windowed
        estimator a single worker uses, applied to the union, so the
        fleet p99 is exactly what one process holding all the samples
        would report (``quantile_source: "exact"``).
      - **approximate** — without raw windows the quantiles fall back
        to count-weighted means of the per-worker quantiles, which is
        an approximation (true quantiles cannot be recovered from
        summaries; ``quantile_source: "approximate"``).
    """
    live = [(i, s) for i, s in enumerate(summaries)
            if s and s.get("count")]
    if not live:
        return {"count": 0}
    total = sum(s.get("count", 0) for _, s in live)
    out: dict = {"count": total}
    sums = [s["sum"] for _, s in live if isinstance(s.get("sum"),
                                                    (int, float))]
    if sums:
        out["sum"] = round(sum(sums), 4)
    maxes = [s["max"] for _, s in live if isinstance(s.get("max"),
                                                     (int, float))]
    if maxes:
        out["max"] = round(max(maxes), 6)
    wins = None
    if windows is not None:
        wins = [windows[i] if i < len(windows) else None
                for i, _ in live]
        if not all(isinstance(w, (list, tuple)) and w for w in wins):
            wins = None  # any live worker missing its window → fall
            # back for the whole merge (a mixed exact/approx answer
            # would claim precision it doesn't have)
    if wins is not None:
        from ..utils.profiling import percentiles

        merged = percentiles(
            [float(v) for w in wins for v in w
             if isinstance(v, (int, float))])
        for q in _QUANTILE_KEYS:
            if merged.get(q) is not None:
                out[q] = round(merged[q], 6)
        if merged.get("max") is not None:
            out["max"] = round(merged["max"], 6)
        out["quantile_source"] = "exact"
        return out
    for q in _QUANTILE_KEYS:
        pairs = [(s.get("count", 0), s[q]) for _, s in live
                 if isinstance(s.get(q), (int, float))]
        w = sum(c for c, _ in pairs)
        if pairs and w > 0:
            out[q] = round(sum(c * v for c, v in pairs) / w, 6)
    out["quantile_source"] = "approximate"
    return out


def merge_worker_metrics(snaps: dict[str, dict],
                         error_budget: float = 0.01) -> dict:
    """Fold per-worker ``/metrics`` JSON bodies into the fleet view.

    ``snaps`` maps a stable worker label (the router uses the port) to
    the worker's last polled metrics body. Returns::

        {"workers": N,
         "counters": {...summed...},
         "batch_size_hist": {...summed per bucket...},
         "gauges": {name: {"min","max","sum","workers":{label: v}}},
         "histograms": {name: merged summary},
         "slo": {"error_rate", "availability", "window_requests",
                 "p99_latency_ratio": {ep: worst},
                 "burn_rate": {ep: rate}, "burn_rate_max": rate,
                 "error_budget": budget},
         "quantile_note": "..."}

    Merge rules: counters sum; gauges keep per-worker values plus
    min/max/sum; histograms merge via
    :func:`merge_histogram_summaries`; the SLO block's error rate is
    the window-request-weighted mean, p99 ratios take the WORST worker
    (the one a new request might land on), and the burn rate per
    endpoint is ``max(p99_ratio, error_rate / error_budget)`` — above
    1.0 the fleet is burning its budget faster than it earns it, the
    autoscaler's scale-up trigger.
    """
    labels = sorted(snaps)
    out: dict = {
        "workers": len(labels),
        "counters": _merge_counter_maps(
            [snaps[w].get("counters") or {} for w in labels]),
        "batch_size_hist": _merge_counter_maps(
            [snaps[w].get("batch_size_hist") or {} for w in labels]),
        "gauges": {},
        "histograms": {},
        "quantile_note": ("histogram quantiles are EXACT (computed "
                          "over the workers' concatenated raw "
                          "latency windows) when every live worker "
                          "ships its window, else count-weighted "
                          "means of per-worker summaries "
                          "(approximate); counts and sums are exact "
                          "either way — see each merged summary's "
                          "quantile_source"),
    }
    for gname in GAUGE_FIELDS:
        per = {w: snaps[w][gname] for w in labels
               if isinstance(snaps[w].get(gname), (int, float))
               and not isinstance(snaps[w].get(gname), bool)}
        if not per:
            continue
        vals = list(per.values())
        out["gauges"][gname] = {
            "min": round(min(vals), 4), "max": round(max(vals), 4),
            "sum": round(sum(vals), 4), "workers": per,
        }
    hist_names = sorted({n for w in labels
                         for n in (snaps[w].get("latency_s") or {})})
    for name in hist_names:
        out["histograms"][f"latency_s.{name}"] = \
            merge_histogram_summaries(
                [(snaps[w].get("latency_s") or {}).get(name) or {}
                 for w in labels],
                windows=[(snaps[w].get("latency_windows") or {})
                         .get(name) for w in labels])
    out["slo"] = _merge_slo(
        [snaps[w].get("slo") or {} for w in labels], error_budget)
    return out


def _merge_slo(slos: list[dict], error_budget: float) -> dict:
    live = [s for s in slos if s]
    weights = [(s.get("window_requests") or 0, s.get("error_rate"))
               for s in live]
    w_total = sum(w for w, er in weights if isinstance(er, (int, float)))
    if w_total > 0:
        error_rate = sum(w * er for w, er in weights
                         if isinstance(er, (int, float))) / w_total
    else:
        # no windowed traffic anywhere: idle fleet, zero burn
        error_rate = 0.0
    ratios: dict[str, float] = {}
    for s in live:
        for ep, r in (s.get("p99_latency_ratio") or {}).items():
            if isinstance(r, (int, float)):
                ratios[ep] = max(ratios.get(ep, 0.0), r)
    budget = max(error_budget, 1e-9)
    err_burn = error_rate / budget
    burn = {ep: round(max(r, err_burn), 4)
            for ep, r in sorted(ratios.items())}
    burn_max = max(burn.values(), default=round(err_burn, 4))
    return {
        "error_rate": round(error_rate, 6),
        "availability": round(1.0 - error_rate, 6),
        "window_requests": sum(s.get("window_requests") or 0
                               for s in live),
        "p99_latency_ratio": {ep: round(r, 4)
                              for ep, r in sorted(ratios.items())},
        "error_budget": error_budget,
        "burn_rate": burn,
        "burn_rate_max": round(burn_max, 4),
        "tenants": merge_tenant_slos(
            [s.get("tenants") or {} for s in live], budget),
    }


def merge_tenant_slos(blocks: list[dict],
                      error_budget: float) -> dict:
    """Fold per-source ``tenants`` SLO blocks (the per-tenant
    dimension workers — and, one level up, fleets — publish) into one
    view with a burn rate per tenant.

    Error rates merge request-weighted; p99 ratios take the WORST
    source; ``burn_rate`` is ``max(p99_ratio, error_rate / budget)``
    — the same definition as the endpoint burn, scoped to one
    tenant. This is the gauge the federation's tenant-scoped shed is
    driven by (``federation.tenant.burn_rate.<tenant>``)."""
    budget = max(error_budget, 1e-9)
    agg: dict[str, dict] = {}
    for block in blocks:
        for tenant, rec in sorted((block or {}).items()):
            a = agg.setdefault(tenant, {"n": 0, "err_w": 0.0,
                                        "p99": 0.0})
            n = rec.get("window_requests") or 0
            er = rec.get("error_rate")
            if isinstance(er, (int, float)) and n:
                a["n"] += n
                a["err_w"] += n * er
            r = rec.get("p99_latency_ratio")
            if isinstance(r, (int, float)):
                a["p99"] = max(a["p99"], r)
    out: dict = {}
    for tenant, a in sorted(agg.items()):
        er = (a["err_w"] / a["n"]) if a["n"] else 0.0
        out[tenant] = {
            "window_requests": a["n"],
            "error_rate": round(er, 6),
            "p99_latency_ratio": round(a["p99"], 4),
            "burn_rate": round(max(a["p99"], er / budget), 4),
        }
    return out


def rollup_registry_snapshot(merged: dict) -> dict:
    """Flatten a :func:`merge_worker_metrics` result into the
    registry-snapshot shape :func:`goleft_tpu_torch.obs.prometheus.render`
    consumes — one snapshot, two encodings, same numbers.

    Counters keep their worker-side names under ``fleet.worker.``;
    per-worker gauge values become ``fleet.worker.<name>.w.<label>``
    alongside ``.min/.max/.sum`` (the text exposition has no labels in
    this renderer, so the label rides the name); merged histograms
    render as summaries under ``fleet.worker.latency_s.*``; the SLO
    block lands as ``fleet.slo.*`` gauges.
    """
    counters = {f"fleet.worker.{n}": v
                for n, v in merged.get("counters", {}).items()}
    for size, v in merged.get("batch_size_hist", {}).items():
        counters[f"fleet.worker.batch_size.{size}"] = v
    gauges: dict[str, float] = {
        "fleet.workers_reporting": merged.get("workers", 0)}
    for name, rec in merged.get("gauges", {}).items():
        for stat in ("min", "max", "sum"):
            gauges[f"fleet.worker.{name}.{stat}"] = rec[stat]
        for label, v in sorted(rec.get("workers", {}).items()):
            gauges[f"fleet.worker.{name}.w.{label}"] = round(v, 4)
    slo = merged.get("slo") or {}
    for k in ("error_rate", "availability", "window_requests",
              "burn_rate_max"):
        if isinstance(slo.get(k), (int, float)):
            gauges[f"fleet.slo.{k}"] = slo[k]
    for ep, r in (slo.get("burn_rate") or {}).items():
        gauges[f"fleet.slo.burn_rate.{ep}"] = r
    for ep, r in (slo.get("p99_latency_ratio") or {}).items():
        gauges[f"fleet.slo.p99_latency_ratio.{ep}"] = r
    for tenant, rec in (slo.get("tenants") or {}).items():
        if isinstance(rec.get("burn_rate"), (int, float)):
            gauges[f"fleet.slo.tenant.burn_rate.{tenant}"] = \
                rec["burn_rate"]
    hists = {f"fleet.worker.{n}": s
             for n, s in merged.get("histograms", {}).items()
             if s.get("count")}
    return {"counters": counters, "gauges": gauges,
            "histograms": hists}


# ---------------------------------------------------------------------------
# cross-process trace stitching
# ---------------------------------------------------------------------------

def record_epoch(rec: dict) -> float | None:
    """Epoch seconds of a flight record's root (its ``ts`` ISO stamp),
    None when absent/garbled — the cross-process alignment anchor."""
    ts = rec.get("ts")
    if not ts:
        return None
    try:
        return datetime.datetime.fromisoformat(ts).timestamp()
    except ValueError:
        return None


def _walk(node: dict):
    yield node
    for c in node.get("children", ()):
        yield from _walk(c)


def _shift(node: dict, delta_ms: float) -> None:
    for n in _walk(node):
        n["start_ms"] = round(n.get("start_ms", 0.0) + delta_ms, 3)


def _annotate(node: dict, process: str) -> None:
    for n in _walk(node):
        n["process"] = process


def _find_span(root: dict, span_id) -> dict | None:
    if span_id is None:
        return None
    for n in _walk(root):
        if n.get("span_id") == span_id:
            return n
    return None


def stitch_trace(trace_id: str, router_records: list[dict],
                 worker_records: dict[str, list[dict]],
                 clock_offsets: dict[str, float] | None = None) \
        -> dict | None:
    """One stitched cross-process tree for ``trace_id``.

    ``router_records``: the router's own flight records matching the
    id (newest first); ``worker_records``: per-worker-url lists pulled
    from ``/debug/flight?trace_id=``. ``clock_offsets`` optionally
    maps a worker url to its estimated wall-clock offset in seconds
    (positive = that worker's clock runs AHEAD of the router's — the
    poller's midpoint handshake estimate); a record's epoch is
    corrected by it before rebasing, so cross-HOST skew does not
    shear the stitched timeline. Returns None when NOBODY has the
    trace. Grafting:

      - the router's ``fleet.request.*`` tree is the stitched root
        (synthesized when the router ring already evicted it but a
        worker still holds the tree);
      - a worker ``request.*`` tree attaches under the router span
        whose ``span_id`` equals the tree's ``remote_parent`` attr
        (the forward span that carried it), else under the root;
      - a worker ``batch.*`` tree (its own trace, linked by
        ``parent_trace``/``parent_span`` attrs) attaches under the
        span of that worker's request tree whose ``span_id`` equals
        ``parent_span`` — the plan step that submitted the work.

    Every node gains a ``process`` label; ``start_ms`` is rebased onto
    the stitched root's clock via each record's wall-clock ``ts``.
    """
    import copy

    root = None
    for rec in router_records:
        if rec.get("trace_id") == trace_id:
            root = copy.deepcopy(rec)
            break
    have_workers = any(worker_records.get(u) for u in worker_records)
    if root is None and not have_workers:
        return None
    if root is None:
        root = {"name": f"trace.{trace_id}", "trace_id": trace_id,
                "category": "synthetic", "start_ms": 0.0,
                "duration_ms": 0.0, "children": [],
                "synthesized": True}
    _annotate(root, "router")
    root_epoch = record_epoch(root)
    processes: dict[str, dict] = {
        "router": {"pid": root.get("pid"), "spans": sum(
            1 for _ in _walk(root))}}

    for url in sorted(worker_records):
        recs = worker_records[url] or []
        label = f"worker:{url.rsplit(':', 1)[-1]}"
        req_roots: list[dict] = []
        batches: list[dict] = []
        for rec in recs:
            rec = copy.deepcopy(rec)
            if rec.get("trace_id") == trace_id:
                req_roots.append(rec)
            elif (rec.get("attrs") or {}).get("parent_trace") \
                    == trace_id:
                batches.append(rec)
        if not req_roots and not batches:
            continue
        off = float((clock_offsets or {}).get(url) or 0.0)
        n_spans = 0
        for rec in req_roots + batches:
            _annotate(rec, label)
            n_spans += sum(1 for _ in _walk(rec))
            ep = record_epoch(rec)
            if root_epoch is not None and ep is not None:
                _shift(rec, (ep - off - root_epoch) * 1e3
                       - rec.get("start_ms", 0.0))
        processes[label] = {
            "pid": (req_roots + batches)[0].get("pid"),
            "spans": n_spans}
        for rec in req_roots:
            remote = (rec.get("attrs") or {}).get("remote_parent")
            parent = _find_span(root, remote) or root
            parent["children"].append(rec)
        for rec in batches:
            pspan = (rec.get("attrs") or {}).get("parent_span")
            parent = None
            for req in req_roots:
                parent = _find_span(req, pspan)
                if parent is not None:
                    break
            if parent is None:
                parent = req_roots[0] if req_roots else root
            parent["children"].append(rec)
    for n in _walk(root):
        n["children"].sort(key=lambda c: c.get("start_ms", 0.0))
    return {
        "trace_id": trace_id,
        "processes": processes,
        "span_count": sum(p["spans"] for p in processes.values()),
        "tree": root,
    }


def stitch_federation(trace_id: str, fed_records: list[dict],
                      fleet_docs: dict[str, dict | None],
                      clock_offsets: dict[str, float] | None = None) \
        -> dict | None:
    """Compose ONE federation-wide tree from per-fleet stitched docs.

    The graft rules are :func:`stitch_trace`'s applied one level up —
    a federation hop is just one more ``remote_parent`` level:

      - the federation router's ``federation.request.*`` flight record
        is the stitched root (synthesized when its ring already
        evicted the trace but a fleet still holds it);
      - each fleet's stitched document (the ``GET /fleet/trace/<id>``
        answer — its own router + worker tree) grafts under the
        federation ``federation.forward.*`` span whose ``span_id``
        equals the fleet tree's ``remote_parent`` attr (the forward
        that carried the request), else under the root;
      - process labels are namespaced ``fleet:<port>/<process>`` so
        two fleets' routers (both "router" locally) stay distinct
        tracks in the Perfetto export;
      - ``start_ms`` rebases via each fleet root's wall ``ts``,
        corrected by the federation poller's per-fleet clock offset
        (the same midpoint handshake the fleet router applies to its
        workers).

    Returns the same shape as :func:`stitch_trace` — ``format_tree``
    and :func:`perfetto_export` consume it unchanged. None when no
    process holds the trace.
    """
    import copy

    root = None
    for rec in fed_records:
        if rec.get("trace_id") == trace_id:
            root = copy.deepcopy(rec)
            break
    have_fleets = any(d for d in fleet_docs.values())
    if root is None and not have_fleets:
        return None
    if root is None:
        root = {"name": f"trace.{trace_id}", "trace_id": trace_id,
                "category": "synthetic", "start_ms": 0.0,
                "duration_ms": 0.0, "children": [],
                "synthesized": True}
    _annotate(root, "federation")
    root_epoch = record_epoch(root)
    processes: dict[str, dict] = {
        "federation": {"pid": root.get("pid"), "spans": sum(
            1 for _ in _walk(root))}}
    for url in sorted(fleet_docs):
        doc = fleet_docs[url]
        if not doc or not doc.get("tree"):
            continue
        label = f"fleet:{url.rsplit(':', 1)[-1]}"
        tree = copy.deepcopy(doc["tree"])
        for n in _walk(tree):
            n["process"] = f"{label}/{n.get('process', '?')}"
        off = float((clock_offsets or {}).get(url) or 0.0)
        ep = record_epoch(tree)
        if root_epoch is not None and ep is not None:
            _shift(tree, (ep - off - root_epoch) * 1e3
                   - tree.get("start_ms", 0.0))
        remote = (tree.get("attrs") or {}).get("remote_parent")
        parent = _find_span(root, remote) or root
        parent.setdefault("children", []).append(tree)
        for pname, pinfo in sorted((doc.get("processes")
                                    or {}).items()):
            processes[f"{label}/{pname}"] = dict(pinfo)
    for n in _walk(root):
        n.setdefault("children", []).sort(
            key=lambda c: c.get("start_ms", 0.0))
    return {
        "trace_id": trace_id,
        "processes": processes,
        "span_count": sum(p.get("spans", 0)
                          for p in processes.values()),
        "tree": root,
    }


def perfetto_export(trace_id: str,
                    stitched: dict) -> dict:
    """A :func:`stitch_trace` result as Chrome trace-event JSON with
    one PROCESS TRACK per OS process (router + each worker), loadable
    in Perfetto. Timestamps are the stitched tree's rebased clock
    (absolute epoch µs when the root carried a wall stamp)."""
    tree = stitched["tree"]
    base_epoch = record_epoch(tree) or 0.0
    base_us = base_epoch * 1e6
    pids: dict[str, int] = {}
    tids: dict[tuple, int] = {}
    events: list[dict] = []
    meta: list[dict] = []
    for n in _walk(tree):
        proc = n.get("process", "router")
        if proc not in pids:
            pid = n.get("pid") or (100000 + len(pids))
            # two processes can recycle a pid across restarts: keep
            # tracks distinct by falling back to a synthetic id
            if pid in pids.values():
                pid = 100000 + len(pids)
            pids[proc] = pid
            meta.append({"name": "process_name", "ph": "M",
                         "pid": pid, "tid": 0,
                         "args": {"name": proc}})
        pid = pids[proc]
        tkey = (proc, n.get("thread", ""))
        if tkey not in tids:
            tids[tkey] = len(tids) + 1
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": pid, "tid": tids[tkey],
                         "args": {"name": n.get("thread", "") or
                                  f"thread-{tids[tkey]}"}})
        args = {"trace_id": trace_id, "process": proc}
        if n.get("span_id") is not None:
            args["span_id"] = n["span_id"]
        for k, v in (n.get("attrs") or {}).items():
            args.setdefault(k, v)
        events.append({
            "name": n["name"], "cat": n.get("category") or "span",
            "ph": "X",
            "ts": round(base_us + n.get("start_ms", 0.0) * 1e3, 3),
            "dur": round(n.get("duration_ms", 0.0) * 1e3, 3),
            "pid": pid, "tid": tids[tkey], "args": args,
        })
    events.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "goleft-tpu fleetplane",
                      "trace_id": trace_id,
                      "processes": sorted(pids)},
    }


def format_tree(stitched: dict, width: int = 78) -> str:
    """Human-readable stitched tree (the ``goleft-tpu-torch trace`` body):
    one line per span — indent, name, duration, process."""
    lines = [f"trace {stitched['trace_id']} — "
             f"{stitched['span_count']} span(s), "
             f"{len(stitched['processes'])} process(es)"]
    for proc in sorted(stitched["processes"]):
        info = stitched["processes"][proc]
        lines.append(f"  process {proc}: pid={info.get('pid')} "
                     f"spans={info['spans']}")

    def _fmt(node: dict, depth: int) -> None:
        pad = "  " * depth
        dur = node.get("duration_ms", 0.0)
        head = f"{pad}{node['name']}"
        tail = f"{dur:9.3f}ms  [{node.get('process', '?')}]"
        gap = max(1, width - len(head) - len(tail))
        lines.append(head + " " * gap + tail)
        for c in node.get("children", ()):
            _fmt(c, depth + 1)

    lines.append("")
    _fmt(stitched["tree"], 0)
    return "\n".join(lines)
