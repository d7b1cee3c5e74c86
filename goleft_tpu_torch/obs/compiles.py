"""The compile observatory of the port: kernel builds and first launches.

The counterpart of the JAX package's obs/compiles.py. The port compiles
nothing per shape: each kernel source is built once by ``nvcc``
(ops/_nvcc.py::build) and every launch geometry runs the same code. So
its "compile events" are of two kinds:

  - a build: ``ops/_nvcc.py::build`` records the kernel family, the
    seconds and whether the library was already built
    (:meth:`CompileTracker.record_build`; counters
    ``compile.builds_total.<family>``, ``compile.build_seconds_total.
    <family>``);
  - a first launch: :meth:`CompileTracker.observe`, around one dispatch
    (``plan/executor.py::run_device_step(signature=...)``), counts a hit
    for (family, signature, backend), and the first one of a signature
    in this process counts as its compile: the dispatch's wall seconds,
    a ``kernel.first_launch.<family>`` span nested where the dispatch
    ran, counters ``compile.events_total.<family>`` and
    ``compile.seconds_total.<family>``.

The (family, signature, backend) table is the warmup manifest, on the
JAX package's schema (``goleft-tpu.warmup-manifest/1``), so a manifest
a JAX worker exported validates and loads here and the reverse:
``to_doc`` (``GET /debug/compiles``, with the builds beside it),
``manifest_section``, ``build_warmup_manifest``,
``validate_warmup_manifest``, ``merge_warmup_docs``,
``save_warmup_manifest`` and ``load_warmup_manifest``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass

from .metrics import get_registry
from .tracing import get_tracer

#: warmup-manifest schema id (the JAX package's)
WARMUP_SCHEMA = "goleft-tpu.warmup-manifest/1"

#: bounded event ring and signature table
MAX_EVENTS = 512
MAX_SIGNATURES = 1024


def family_of_dispatch(name: str) -> str:
    """``serve.depth.dispatch`` -> ``depth``; other names pass through."""
    fam = name
    if fam.startswith("serve."):
        fam = fam[len("serve."):]
    if fam.endswith(".dispatch"):
        fam = fam[:-len(".dispatch")]
    return fam


def canonical_signature(sig) -> str:
    """One stable string per signature: JSON with tuples as lists and
    sorted keys; None -> ""."""
    if sig is None:
        return ""
    if isinstance(sig, str):
        return sig

    def lower(x):
        if isinstance(x, (list, tuple)):
            return [lower(v) for v in x]
        if isinstance(x, dict):
            return {str(k): lower(v) for k, v in sorted(x.items())}
        if isinstance(x, (int, float, bool)) or x is None:
            return x
        return str(x)

    return json.dumps(lower(sig), sort_keys=True, separators=(",", ":"))


@dataclass
class CompileEvent:
    """One first launch (``trigger`` the dispatch) or one build
    (``trigger`` "nvcc")."""

    family: str
    signature: str
    backend: str
    duration_s: float
    compiles: int
    pid: int
    trigger: str
    ts: float  # epoch seconds
    names: tuple = ()

    def to_dict(self) -> dict:
        return {
            "family": self.family, "signature": self.signature,
            "backend": self.backend,
            "duration_s": round(self.duration_s, 6),
            "compiles": self.compiles, "pid": self.pid,
            "trigger": self.trigger, "ts": round(self.ts, 3),
            "names": list(self.names),
        }


class CompileTracker:
    """Process-wide build and first-launch accounting behind
    ``/debug/compiles`` and the warmup manifest."""

    def __init__(self, registry=None, tracer=None):
        self._lock = threading.Lock()
        self._events: deque[CompileEvent] = deque(maxlen=MAX_EVENTS)
        # (family, signature, backend) -> {hits, compiles, compile_seconds}
        self._stats: dict[tuple, dict] = {}
        self._builds: list[dict] = []
        self.events_total = 0
        self.compiles_total = 0
        self.signatures_dropped = 0
        self._registry = registry
        self._tracer = tracer
        #: the backend a signature is recorded under: "gpu" or "cpu"
        #: (serve sets it from its device; default: whether a card is
        #: visible)
        self.backend: str | None = None

    def _reg(self):
        return self._registry if self._registry is not None \
            else get_registry()

    def _trc(self):
        return self._tracer if self._tracer is not None else get_tracer()

    def _backend_name(self) -> str:
        if self.backend is None:
            torch = sys.modules.get("torch")
            return "gpu" if torch is not None \
                and torch.cuda.is_available() else "cpu"
        return self.backend

    # ---- the seams ----

    def record_build(self, family: str, seconds: float,
                     cached: bool) -> None:
        """One kernel library built by nvcc (or found built)."""
        rec = {"family": family, "seconds": round(seconds, 6),
               "cached": bool(cached), "pid": os.getpid(),
               "ts": round(time.time(), 3)}
        with self._lock:
            self._builds.append(rec)
            if not cached:
                self._events.append(CompileEvent(
                    family=family, signature="", backend="gpu",
                    duration_s=seconds, compiles=1, pid=os.getpid(),
                    trigger="nvcc", ts=time.time()))
        reg = self._reg()
        reg.counter(f"compile.builds_total.{family}").inc()
        if not cached:
            reg.counter(f"compile.build_seconds_total.{family}").inc(
                round(seconds, 6))

    @contextlib.contextmanager
    def observe(self, family: str, signature=None, trigger: str = ""):
        """Wrap one dispatch: a hit for (family, signature, backend); the
        first of a signature in this process is its compile. Exceptions
        pass through."""
        sig = canonical_signature(signature)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._record(family, sig, trigger or family, t0,
                         time.perf_counter())

    def _record(self, family: str, sig: str, trigger: str, t0: float,
                t1: float) -> None:
        key = (family, sig, self._backend_name())
        wall = t1 - t0
        with self._lock:
            rec = self._stats.get(key)
            first = rec is None
            if first:
                if len(self._stats) >= MAX_SIGNATURES:
                    self.signatures_dropped += 1
                    return
                self._stats[key] = rec = {
                    "hits": 0, "compiles": 0, "compile_seconds": 0.0}
            rec["hits"] += 1
            if first:
                rec["compiles"] += 1
                rec["compile_seconds"] += wall
                self.events_total += 1
                self.compiles_total += 1
                self._events.append(CompileEvent(
                    family=family, signature=sig, backend=key[2],
                    duration_s=wall, compiles=1, pid=os.getpid(),
                    trigger=trigger, ts=time.time()))
                live = len(self._stats)
        if not first:
            return
        reg = self._reg()
        reg.counter(f"compile.events_total.{family}").inc()
        reg.counter(f"compile.seconds_total.{family}").inc(round(wall, 6))
        reg.gauge("compile.signatures_live").set(live)
        self._trc().record_span(
            f"kernel.first_launch.{family}", t0, t1, category="compile",
            family=family, signature=sig, backend=key[2], trigger=trigger)

    # ---- inspection / export ----

    def stats(self) -> dict[tuple, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._stats.items()}

    def builds(self) -> list[dict]:
        with self._lock:
            return [dict(b) for b in self._builds]

    def recent_events(self, n: int = 64) -> list[dict]:
        with self._lock:
            evs = list(self._events)[-n:]
        return [e.to_dict() for e in evs]

    def to_doc(self) -> dict:
        """The ``GET /debug/compiles`` body: the ranked warmup manifest,
        the kernels' builds, the recent events and the totals."""
        doc = build_warmup_manifest(self.stats())
        with self._lock:
            doc.update(events_total=self.events_total,
                       compiles_total=self.compiles_total,
                       signatures_dropped=self.signatures_dropped,
                       pid=os.getpid())
        doc["builds"] = self.builds()
        doc["events"] = self.recent_events()
        return doc

    def manifest_section(self) -> dict | None:
        """A run manifest's ``compiles`` block (None when nothing was
        launched under observation)."""
        stats = self.stats()
        if not any(r["compiles"] for r in stats.values()):
            return None
        top = build_warmup_manifest(stats)["signatures"][:16]
        with self._lock:
            return {
                "events_total": self.events_total,
                "compiles_total": self.compiles_total,
                "seconds_total": round(
                    sum(r["compile_seconds"] for r in stats.values()), 4),
                "signatures": top,
            }

    def reset(self) -> None:
        """Tests only."""
        with self._lock:
            self._events.clear()
            self._stats.clear()
            self._builds.clear()
            self.events_total = 0
            self.compiles_total = 0
            self.signatures_dropped = 0


#: the process-wide tracker
TRACKER = CompileTracker()


def get_tracker() -> CompileTracker:
    return TRACKER


# ---- warmup manifest (the JAX package's schema and ranking) ----

def _rank_key(entry: dict):
    return (-entry["hits"] * entry["compile_seconds"],
            -entry["compiles"], -entry["hits"],
            entry["family"], entry["signature"], entry["backend"])


def build_warmup_manifest(stats: dict[tuple, dict]) -> dict:
    """Rank a stats table into the warmup-manifest document: hits x
    first-launch seconds first."""
    sigs = []
    for (family, signature, backend), rec in stats.items():
        sigs.append({
            "family": family, "signature": signature,
            "backend": backend, "hits": int(rec["hits"]),
            "compiles": int(rec["compiles"]),
            "compile_seconds": round(float(rec["compile_seconds"]), 6),
        })
    sigs.sort(key=_rank_key)
    for i, s in enumerate(sigs):
        s["rank"] = i + 1
    return {"schema": WARMUP_SCHEMA, "signatures": sigs}


def validate_warmup_manifest(doc: dict) -> dict:
    """Schema-check a warmup manifest; raises ValueError."""
    if not isinstance(doc, dict):
        raise ValueError("warmup manifest: not a JSON object")
    if doc.get("schema") != WARMUP_SCHEMA:
        raise ValueError(
            f"warmup manifest: schema {doc.get('schema')!r}, want "
            f"{WARMUP_SCHEMA!r}")
    sigs = doc.get("signatures")
    if not isinstance(sigs, list):
        raise ValueError("warmup manifest: 'signatures' must be a list")
    for s in sigs:
        if not isinstance(s, dict):
            raise ValueError("warmup manifest: signature entries must be "
                             "objects")
        for k, typ in (("family", str), ("signature", str),
                       ("backend", str), ("hits", int), ("compiles", int),
                       ("compile_seconds", (int, float))):
            if not isinstance(s.get(k), typ) or isinstance(s.get(k), bool):
                raise ValueError(
                    f"warmup manifest: entry missing/bad {k!r}: "
                    f"{s.get(k)!r}")
        if s["hits"] < 0 or s["compiles"] < 0 or s["compile_seconds"] < 0:
            raise ValueError(
                "warmup manifest: negative tallies are impossible "
                f"(entry {s['family']}/{s['signature']})")
    return doc


def merge_warmup_docs(*docs: dict) -> dict:
    """Sum hits, compiles and seconds per (family, signature, backend)
    and rank again."""
    acc: dict[tuple, dict] = {}
    for doc in docs:
        validate_warmup_manifest(doc)
        for s in doc["signatures"]:
            key = (s["family"], s["signature"], s["backend"])
            rec = acc.setdefault(key, {
                "hits": 0, "compiles": 0, "compile_seconds": 0.0})
            rec["hits"] += s["hits"]
            rec["compiles"] += s["compiles"]
            rec["compile_seconds"] += s["compile_seconds"]
    return build_warmup_manifest(acc)


def save_warmup_manifest(path: str, doc: dict) -> dict:
    """Write atomically (tmp, fsync, rename), merged into a valid
    manifest already at ``path``."""
    validate_warmup_manifest(doc)
    try:
        doc = merge_warmup_docs(load_warmup_manifest(path), doc)
    except (OSError, ValueError):
        pass
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return doc


def load_warmup_manifest(path: str) -> dict:
    with open(path) as fh:
        return validate_warmup_manifest(json.load(fh))
