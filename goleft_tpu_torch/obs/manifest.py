"""The run manifest: ``--metrics-out run.json``.

The port's copy of the JAX package's obs/manifest.py: one JSON document
per invocation, of the same schema (``goleft-tpu.run-manifest/1.3``) and
``REQUIRED_KEYS``, so the reference's ``load_manifest`` and the perf
ledger's ingestion read it as they read the reference's. Its blocks:

- ``env``: the host and the ``GOLEFT_TPU_*`` / ``CUDA_VISIBLE_DEVICES``
  knobs (:func:`env_provenance`);
- ``backend``: ``device.backend_provenance()``, with ``platform`` "gpu"
  on the card and "cpu" when the run was asked onto the CPU or no card
  is visible: a "cpu" manifest is never device evidence;
- ``spans``: ``{name: {seconds, calls}}``, the shape of the reference's
  ``Tracer.summary``; the port fills it from utils/profiling.py's stage
  totals and the caller's root span (the CLI's ``run.<command>``);
- ``metrics``: the counter registry's snapshot;
- ``trace_id``: the run's trace id (the CLI's ``run.<command>`` root,
  as in the trace ``--trace-out`` writes), else a fresh hex id.

The caller's own fields go in through ``extra`` (the CLI's ``command``,
``exit_code``, ``import_seconds``, ``kernel_launches``, ``native_io``).
"""

from __future__ import annotations

import datetime
import json
import os
import secrets

#: keys every manifest must carry (the reference's contract)
REQUIRED_KEYS = ("schema", "ts", "argv", "env", "backend", "spans",
                 "metrics", "trace_id")

#: writer version. Minor revisions (1.x) only add fields; a major one
#: changes REQUIRED_KEYS and old readers must refuse it.
SCHEMA_PREFIX = "goleft-tpu.run-manifest/"
SCHEMA_MAJOR = 1
SCHEMA = f"{SCHEMA_PREFIX}1.3"


def parse_schema_version(schema: str) -> tuple[int, int]:
    """``goleft-tpu.run-manifest/1.2`` -> (1, 2); a bare ``/1`` means
    (1, 0). Raises ValueError on anything else."""
    if not isinstance(schema, str) \
            or not schema.startswith(SCHEMA_PREFIX):
        raise ValueError(f"not a run-manifest schema id: {schema!r}")
    major, _, minor = schema[len(SCHEMA_PREFIX):].partition(".")
    try:
        return int(major), int(minor) if minor else 0
    except ValueError:
        raise ValueError(
            f"unparseable run-manifest version: {schema!r}") from None


def env_provenance() -> dict:
    """Host and environment block of the manifest."""
    import platform as _platform
    import sys

    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = os.cpu_count()
    rec = {
        "python": sys.version.split()[0],
        "machine": _platform.machine(),
        "node": _platform.node(),
        "effective_cores": cores,
        "pid": os.getpid(),
    }
    knobs = {k: v for k, v in os.environ.items()
             if k.startswith(("GOLEFT_TPU_", "CUDA_VISIBLE_DEVICES"))}
    if knobs:
        rec["env_knobs"] = knobs
    return rec


def build_manifest(argv: list[str] | None = None,
                   spans: dict | None = None, device=None,
                   extra: dict | None = None,
                   trace_id: str | None = None) -> dict:
    """The manifest of this process's run. ``spans`` are added to the
    stage totals (the caller's root span); ``device`` is the run's
    device as ``resolve_device`` takes it (None: the card)."""
    from ..device import backend_provenance
    from ..utils.profiling import process_spans
    from .metrics import get_registry

    doc = {
        "schema": SCHEMA,
        "ts": datetime.datetime.now(datetime.timezone.utc)
                .isoformat(timespec="seconds"),
        "argv": list(argv) if argv is not None else None,
        "env": env_provenance(),
        "backend": backend_provenance(device),
        "spans": dict(sorted({**process_spans(), **(spans or {})}
                             .items())),
        "metrics": get_registry().snapshot(),
        "trace_id": trace_id or secrets.token_hex(8),
    }
    if extra:
        doc.update(extra)
    return doc


def write_manifest(path: str, **kw) -> dict:
    """Build the manifest and replace ``path`` with it atomically."""
    doc = build_manifest(**kw)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=False)
        fh.write("\n")
    os.replace(tmp, path)
    return doc


def load_manifest(path: str) -> dict:
    """Parse and validate a manifest: every REQUIRED_KEYS entry, a
    ``1.x`` schema (minor revisions load; another major is refused), and
    a backend block with either ``platform`` or ``error``."""
    with open(path) as fh:
        doc = json.load(fh)
    missing = [k for k in REQUIRED_KEYS if k not in doc]
    if missing:
        raise ValueError(f"manifest {path}: missing keys {missing}")
    major, _minor = parse_schema_version(doc["schema"])
    if major != SCHEMA_MAJOR:
        raise ValueError(
            f"manifest {path}: unsupported schema major version "
            f"{major} ({doc['schema']!r}); this reader supports "
            f"{SCHEMA_MAJOR}.x")
    backend = doc["backend"]
    if "error" not in backend and "platform" not in backend:
        raise ValueError(
            f"manifest {path}: backend block has neither platform "
            "nor error")
    return doc
