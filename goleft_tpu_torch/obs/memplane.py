"""Memory plane of the port: host memory, the pressure band, device
bytes per dispatch family, and the chunk auto-sizing that ``cohortscan
--chunk-samples 0`` consumes. The counterpart of the JAX package's
obs/memplane.py. The router merges its workers' bodies
(:func:`merge_memory`) and the federation merges the routers'
(:func:`merge_merged_memory`), as the reference's do.

- Host memory is read from procfs (``/proc/self/statm`` for RSS,
  ``status`` ``VmHWM`` for the peak, ``smaps_rollup`` ``Pss``).
- Pressure is a two-sided band: above ``high_water_bytes`` the serve
  daemon sheds admissions with 503 + ``retry_after_s`` until RSS is back
  at or below ``low_water_bytes``.
- Device bytes come from PyTorch's caching allocator
  (``torch.cuda.memory_allocated`` / ``memory_reserved`` /
  ``max_memory_allocated``), where the JAX package reads
  ``jax.live_arrays``: :meth:`MemoryTracker.observe`, around one
  dispatch, attributes the bytes the dispatch left allocated, and its
  peak above what was there before, to the dispatch's family.
- Off costs nothing: ``interval_s=0`` starts no thread and the tracker
  stays disarmed; ``snapshot()`` (``GET /debug/memory``) answers on
  demand.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

from .metrics import get_registry

#: response schema of /debug/memory (the JAX package's)
MEMORY_SCHEMA = "goleft-tpu.memory/1"

#: bounded per-family attribution table
MAX_FAMILIES = 256

#: tracemalloc top-N table size under --mem-trace
TRACE_TOP_N = 20

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def read_host_memory(pss: bool = True) -> dict:
    """Current host memory of THIS process, stdlib-only.

    ``rss_bytes`` comes from ``/proc/self/statm`` (resident pages ×
    page size — one 32-byte read, cheap enough to run per span);
    ``rss_peak_bytes`` from ``/proc/self/status`` ``VmHWM`` (the
    kernel's process-lifetime high-water mark); ``pss_bytes`` from
    ``/proc/self/smaps_rollup`` when the kernel provides it (0
    otherwise). ``pss=False`` skips the rollup read — the kernel
    walks every VMA to answer it (~1.5ms on a loaded process, ~50×
    the rest of this function combined), so the periodic sampling
    tick passes False and only on-demand snapshots pay for Pss. On a
    platform without procfs every field is 0 and ``source`` says so —
    an honest empty, never an error, because the fleet rollup must
    merge mixed fleets."""
    out = {"rss_bytes": 0, "rss_peak_bytes": 0, "pss_bytes": 0,
           "source": "procfs"}
    try:
        with open("/proc/self/statm") as fh:
            out["rss_bytes"] = int(fh.read().split()[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        out["source"] = "unavailable"
        return out
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    out["rss_peak_bytes"] = \
                        int(line.split()[1]) * 1024
                    break
    except (OSError, IndexError, ValueError):
        pass
    if not pss:
        return out
    try:
        with open("/proc/self/smaps_rollup") as fh:
            for line in fh:
                if line.startswith("Pss:"):
                    out["pss_bytes"] = int(line.split()[1]) * 1024
                    break
    except (OSError, IndexError, ValueError):
        pass
    return out


def quick_rss() -> int:
    """Just the resident byte count (the per-span delta probe)."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        return 0


class PressureController:
    """Two-sided hysteresis over host RSS: trip above ``high``,
    recover only at/below ``low`` (the autoscaler band pattern — a
    worker hovering at the cap must not flap between shedding and
    admitting). ``high=0`` disables the controller entirely."""

    def __init__(self, high_water_bytes: int = 0,
                 low_water_bytes: int = 0,
                 retry_after_s: float = 1.0):
        if high_water_bytes and low_water_bytes > high_water_bytes:
            raise ValueError(
                f"memory pressure band inverted: low water "
                f"{low_water_bytes} > high water {high_water_bytes}")
        self.high_water_bytes = int(high_water_bytes)
        self.low_water_bytes = int(low_water_bytes) \
            or int(high_water_bytes * 0.8)
        self.retry_after_s = float(retry_after_s)
        self._tripped = False
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.high_water_bytes > 0

    def update(self, rss_bytes: int) -> str:
        """Feed one RSS observation; returns the (possibly new)
        state, ``"ok"`` or ``"pressure"``."""
        if not self.enabled:
            return "ok"
        with self._lock:
            if self._tripped:
                if rss_bytes <= self.low_water_bytes:
                    self._tripped = False
            elif rss_bytes > self.high_water_bytes:
                self._tripped = True
            return "pressure" if self._tripped else "ok"

    @property
    def state(self) -> str:
        with self._lock:
            return "pressure" if self._tripped else "ok"

    def should_shed(self) -> bool:
        with self._lock:
            return self._tripped

    def to_dict(self) -> dict:
        return {
            "state": self.state,
            "high_water_bytes": self.high_water_bytes,
            "low_water_bytes": (self.low_water_bytes
                                if self.enabled else 0),
            "retry_after_s": self.retry_after_s,
        }


class MemoryTracker:
    """Device bytes per dispatch family, read off PyTorch's caching
    allocator (no per-buffer table: the allocator's counters are
    exact). Disarmed until an enabled :class:`MemorySampler` starts, and
    then :meth:`observe` reads the allocator around each dispatch."""

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        # family -> {"retained_bytes", "peak_bytes", "dispatches"}
        self._families: dict[str, dict] = {}
        self._registry = registry
        self.armed = False

    def _reg(self):
        return self._registry if self._registry is not None \
            else get_registry()

    @staticmethod
    def _cuda():
        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_available():
            return None
        return torch.cuda

    @contextlib.contextmanager
    def observe(self, family: str):
        """Wrap one dispatch: the bytes it left allocated and its peak
        above the bytes allocated before. A bare yield until armed."""
        cuda = self._cuda() if self.armed else None
        if cuda is None:
            yield
            return
        before = cuda.memory_allocated()
        cuda.reset_peak_memory_stats()
        try:
            yield
        finally:
            after = cuda.memory_allocated()
            peak = cuda.max_memory_allocated()
            with self._lock:
                rec = self._families.get(family)
                if rec is None:
                    if len(self._families) >= MAX_FAMILIES:
                        return
                    rec = self._families[family] = {
                        "retained_bytes": 0, "peak_bytes": 0,
                        "dispatches": 0}
                rec["retained_bytes"] = max(0, after - before)
                rec["peak_bytes"] = max(rec["peak_bytes"],
                                        max(0, peak - before))
                rec["dispatches"] += 1

    def device_doc(self) -> dict:
        """{total_bytes (allocated now), reserved_bytes, peak_bytes,
        by_device, by_family} and the family gauges. ``by_family`` is
        the reference's wire: family → the bytes the family's last
        dispatch left allocated (a router's :func:`merge_memory` sums
        it)."""
        cuda = self._cuda()
        total = reserved = peak = 0
        by_device: dict[str, int] = {}
        if cuda is not None:
            for i in range(cuda.device_count()):
                nb = int(cuda.memory_allocated(i))
                by_device[f"cuda:{i}"] = nb
                total += nb
                reserved += int(cuda.memory_reserved(i))
                peak = max(peak, int(cuda.max_memory_allocated(i)))
        with self._lock:
            by_family = {f: r["retained_bytes"] for f, r in
                         sorted(self._families.items())}
        reg = self._reg()
        reg.gauge("memory.device_live_bytes_total").set(total)
        for fam, nb in by_family.items():
            reg.gauge(f"memory.device_live_bytes.{fam}").set(nb)
        return {"total_bytes": total, "reserved_bytes": reserved,
                "peak_bytes": peak, "by_device": by_device,
                "by_family": by_family, "buffers_dropped": 0}

    def attributed(self) -> bool:
        with self._lock:
            return bool(self._families)


#: the process singleton the dispatch seams feed
TRACKER = MemoryTracker()


def get_tracker() -> MemoryTracker:
    return TRACKER


class MemorySampler:
    """The per-process memory observatory behind ``/debug/memory``.

    ``interval_s=0`` (the default) spawns no thread — a sampler
    nobody asked for costs literally nothing; ``snapshot()`` still
    answers on demand. ``high_water_bytes`` arms the pressure
    controller. ``trace_top > 0`` starts ``tracemalloc`` and ships
    the top-N allocation sites in every snapshot (``--mem-trace``:
    real overhead, opt-in only). ``clock`` is injectable for tests;
    ``registry=None`` publishes into the process registry."""

    def __init__(self, interval_s: float = 0.0, registry=None,
                 tracer=None, high_water_bytes: int = 0,
                 low_water_bytes: int = 0, trace_top: int = 0,
                 tracker: MemoryTracker | None = None, clock=None):
        if interval_s < 0:
            raise ValueError(
                f"memory sample interval must be >= 0 "
                f"(got {interval_s})")
        self.interval_s = float(interval_s)
        self.trace_top = int(trace_top)
        self._registry = registry
        self._tracer = tracer
        self._tracker = tracker if tracker is not None else TRACKER
        self._clock = clock if clock is not None else time.monotonic
        self.pressure = PressureController(
            high_water_bytes=high_water_bytes,
            low_water_bytes=low_water_bytes)
        self._lock = threading.Lock()
        self._samples_total = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._trace_started = False

    def _reg(self):
        return self._registry if self._registry is not None \
            else get_registry()

    @property
    def enabled(self) -> bool:
        return self.interval_s > 0

    # ---- lifecycle ----

    def start(self) -> "MemorySampler":
        """Spawn the sampler thread (no-op when disabled), a daemon
        thread joined on close, and arm the family attribution."""
        if self.trace_top > 0 and not self._trace_started:
            import tracemalloc

            if not tracemalloc.is_tracing():
                tracemalloc.start()
                self._trace_started = True
        if self.enabled:
            # arm family attribution process-wide (never disarmed: a
            # process that asked for the plane once keeps it — the
            # table is bounded and scans are per-dispatch only)
            self._tracker.armed = True
        if not self.enabled or self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="goleft-memplane")
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop and join the sampler (idempotent)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._trace_started:
            import tracemalloc

            tracemalloc.stop()
            self._trace_started = False

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_once()

    # ---- sampling ----

    def sample_once(self, pss: bool = False) -> dict:
        """Take one sample: host RSS/peak into the gauges, a device
        live-buffer scan, one pressure-band evaluation. Returns the
        host dict (the overhead bench drives this directly). The
        periodic tick skips the expensive smaps_rollup Pss read —
        see :func:`read_host_memory`."""
        host = read_host_memory(pss=pss)
        reg = self._reg()
        reg.gauge("memory.rss_bytes").set(host["rss_bytes"])
        reg.gauge("memory.rss_peak_bytes").set(host["rss_peak_bytes"])
        state = self.pressure.update(host["rss_bytes"])
        reg.gauge("memory.pressure_state").set(
            1.0 if state == "pressure" else 0.0)
        self._tracker.device_doc()
        with self._lock:
            self._samples_total += 1
        reg.counter("memory.samples_total").inc()
        return host

    def _tracemalloc_top(self) -> list[dict]:
        if self.trace_top <= 0:
            return []
        import tracemalloc

        if not tracemalloc.is_tracing():
            return []
        snap = tracemalloc.take_snapshot()
        stats = snap.statistics("lineno")
        out = []
        for st in stats[: self.trace_top]:
            fr = st.traceback[0] if st.traceback else None
            out.append({
                "site": (f"{fr.filename}:{fr.lineno}" if fr
                         else "?"),
                "size_bytes": int(st.size),
                "count": int(st.count),
            })
        return out

    def snapshot(self) -> dict:
        """The full on-demand document behind ``GET /debug/memory``
        (always answers, sampler thread or not). ``counters`` and
        ``gauges`` blocks carry the registry names verbatim so the
        fleet merge is a mechanical sum over the same namespace the
        /metrics body exposes."""
        host = self.sample_once(pss=True)
        device = self._tracker.device_doc()
        reg = self._reg()
        with self._lock:
            samples = self._samples_total
        doc = {
            "schema": MEMORY_SCHEMA,
            "enabled": self.enabled,
            "interval_s": self.interval_s,
            "pid": os.getpid(),
            "host": host,
            "device": device,
            "pressure": self.pressure.to_dict(),
            "counters": {
                "memory.samples_total": samples,
                "memory.sheds_total":
                    reg.counter("memory.sheds_total").value,
            },
            "gauges": {
                "memory.rss_bytes": host["rss_bytes"],
                "memory.rss_peak_bytes": host["rss_peak_bytes"],
                "memory.device_live_bytes_total":
                    device["total_bytes"],
                # the caching allocator's hold and high-water mark:
                # merged across a fleet as min/max/sum like any gauge
                "memory.device_reserved_bytes": device["reserved_bytes"],
                "memory.device_peak_bytes": device["peak_bytes"],
                "memory.pressure_state":
                    1.0 if self.pressure.state == "pressure"
                    else 0.0,
            },
        }
        top = self._tracemalloc_top()
        if top:
            doc["tracemalloc_top"] = top
        return doc

    def manifest_section(self) -> dict | None:
        """The run manifest's ``memory`` block: the final host/device
        picture. ``None`` (section omitted, zero side effects) when
        the process never sampled, isn't sampling, and holds no
        device attribution — a run that never looked at memory writes
        the same manifest it always did."""
        with self._lock:
            sampled = self._samples_total > 0
        if not self.enabled and not sampled \
                and not self._tracker.attributed():
            return None
        return {
            "host": read_host_memory(),
            "device": self._tracker.device_doc(),
            "pressure": self.pressure.to_dict(),
        }


#: the process singleton behind the CLI manifest section; serve
#: daemons build their own (private registry, flag-driven bands)
SAMPLER = MemorySampler()


def under_pressure() -> bool:
    """Is ANY armed controller in this process tripped? The prefetch
    staging pipeline polls this to clamp its depth to 1 while the
    band is high — backpressure without a config plumb-through."""
    return _armed_controller_tripped()


_CONTROLLERS: list = []  # weakly-ordered: serve app registers its own
_CONTROLLERS_LOCK = threading.Lock()


def register_controller(ctl: PressureController) -> None:
    """Make a controller visible to :func:`under_pressure` (the serve
    daemon registers its flag-armed one at startup)."""
    with _CONTROLLERS_LOCK:
        if ctl not in _CONTROLLERS:
            _CONTROLLERS.append(ctl)


def unregister_controller(ctl: PressureController) -> None:
    with _CONTROLLERS_LOCK:
        if ctl in _CONTROLLERS:
            _CONTROLLERS.remove(ctl)


def _armed_controller_tripped() -> bool:
    with _CONTROLLERS_LOCK:
        ctls = list(_CONTROLLERS)
    return any(c.should_shed() for c in ctls)


# ---- fleet merge ----


def merge_memory(bodies: list[dict]) -> dict:
    """Merge worker ``/debug/memory`` bodies: counters as EXACT
    arithmetic sums (pinned by test to equal the sum of the inputs, in
    both the JSON and prom encodings), gauges as
    per-worker {min, max, sum}, device family bytes summed
    family-wise. Non-dict bodies are skipped (a worker mid-restart
    must not poison the merge); ``per_worker`` is the caller's to
    attach."""
    counters: dict[str, int] = {}
    gauges: dict[str, dict] = {}
    by_family: dict[str, int] = {}
    workers = 0
    in_pressure = 0
    enabled = False
    for b in bodies:
        if not isinstance(b, dict) or "host" not in b:
            continue
        workers += 1
        enabled = enabled or bool(b.get("enabled"))
        if (b.get("pressure") or {}).get("state") == "pressure":
            in_pressure += 1
        for k, v in (b.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + int(v)
        for k, v in (b.get("gauges") or {}).items():
            g = gauges.get(k)
            v = float(v)
            if g is None:
                gauges[k] = {"min": v, "max": v, "sum": v}
            else:
                g["min"] = min(g["min"], v)
                g["max"] = max(g["max"], v)
                g["sum"] = g["sum"] + v
        fams = ((b.get("device") or {}).get("by_family") or {})
        for fam, nb in fams.items():
            by_family[fam] = by_family.get(fam, 0) + int(nb)
    return {
        "schema": MEMORY_SCHEMA,
        "workers": workers,
        "enabled": enabled,
        "workers_in_pressure": in_pressure,
        "counters": dict(sorted(counters.items())),
        "gauges": {k: {m: gauges[k][m] for m in ("min", "max",
                                                 "sum")}
                   for k in sorted(gauges)},
        "device_by_family": dict(sorted(by_family.items())),
    }


def merge_merged_memory(bodies: list[dict]) -> dict:
    """Merge already-merged ``/fleet/memory`` documents one tier up
    (the federation over its fleets): counter sums stay exact sums,
    gauge aggregates compose as min-of-mins / max-of-maxes /
    sum-of-sums, worker tallies and family bytes add. Composition is
    associative by construction — the federation's numbers equal a
    flat merge over every worker."""
    counters: dict[str, int] = {}
    gauges: dict[str, dict] = {}
    by_family: dict[str, int] = {}
    workers = 0
    in_pressure = 0
    enabled = False
    for b in bodies:
        if not isinstance(b, dict) or "counters" not in b:
            continue
        workers += int(b.get("workers") or 0)
        in_pressure += int(b.get("workers_in_pressure") or 0)
        enabled = enabled or bool(b.get("enabled"))
        for k, v in (b.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + int(v)
        for k, agg in (b.get("gauges") or {}).items():
            g = gauges.get(k)
            if g is None:
                gauges[k] = {m: float(agg[m])
                             for m in ("min", "max", "sum")}
            else:
                g["min"] = min(g["min"], float(agg["min"]))
                g["max"] = max(g["max"], float(agg["max"]))
                g["sum"] = g["sum"] + float(agg["sum"])
        for fam, nb in (b.get("device_by_family") or {}).items():
            by_family[fam] = by_family.get(fam, 0) + int(nb)
    return {
        "schema": MEMORY_SCHEMA,
        "workers": workers,
        "enabled": enabled,
        "workers_in_pressure": in_pressure,
        "counters": dict(sorted(counters.items())),
        "gauges": {k: gauges[k] for k in sorted(gauges)},
        "device_by_family": dict(sorted(by_family.items())),
    }


def flatten_merged(merged: dict) -> dict:
    """A merged /fleet/memory document as a registry-style snapshot
    {counters, gauges} for ``obs.prometheus.render`` — counter names
    ride verbatim (the prom body's ``memory_*_total`` lines ARE the
    exact sums), gauges flatten to ``<name>.min/.max/.sum``."""
    counters = dict(merged.get("counters") or {})
    gauges: dict[str, float] = {
        "memory.fleet_workers": merged.get("workers", 0),
        "memory.fleet_workers_in_pressure":
            merged.get("workers_in_pressure", 0),
    }
    for k, agg in (merged.get("gauges") or {}).items():
        for m in ("min", "max", "sum"):
            gauges[f"{k}.{m}"] = agg[m]
    for fam, nb in (merged.get("device_by_family") or {}).items():
        gauges[f"memory.device_live_bytes.{fam}.sum"] = nb
    return {"counters": dict(sorted(counters.items())),
            "gauges": dict(sorted(gauges.items())),
            "histograms": {}}


def auto_chunk_samples(per_sample_bytes: int, budget_bytes: int,
                       n_samples: int, minimum: int = 8,
                       maximum: int = 4096) -> int:
    """Size a cohort chunk so one chunk's matrices fit the budget:
    ``budget / per_sample`` clamped to [minimum, min(maximum,
    n_samples)]. A zero/unknown per-sample measurement falls back to
    the maximum (no evidence → no constraint)."""
    if per_sample_bytes <= 0 or budget_bytes <= 0:
        return min(maximum, max(minimum, n_samples))
    fit = budget_bytes // per_sample_bytes
    return int(max(minimum, min(maximum, n_samples, fit)))
