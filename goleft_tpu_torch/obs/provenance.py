"""Backend and platform provenance: the one place that answers "what ran
this", shared by the run manifest (obs/manifest.py), the device spans
(obs/__init__.py) and the bench's entries (bench.py), so their
platform and device fields cannot drift apart. The port's copy of the
JAX package's obs/provenance.py, asking torch and ``nvidia-smi`` where
the reference asks jax.

Importing this module does not import torch: :func:`backend_provenance`
and :func:`card_provenance` do, when first called. A ``cuda`` run
without a card has raised ``NoCudaDevice`` at ``resolve_device`` before
any of them is asked, so there is no ``{"error": ...}`` record here.
"""

from __future__ import annotations

import os
import subprocess
import threading

_lock = threading.Lock()
_backend: dict[str, dict] = {}


def nvidia_smi_line() -> str:
    """The card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (first card), or "not available"."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines \
        else "not available"


def card_provenance() -> dict:
    """torch / CUDA versions, the visible device and its power limit."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "nvidia_smi": nvidia_smi_line() if cuda else "not available",
    }


def _device_type(device) -> str:
    """"cuda" for None (the default device), else the type of
    ``device`` (a ``torch.device`` or a string such as "cuda:1")."""
    if device is None:
        return "cuda"
    return getattr(device, "type", None) or str(device).split(":")[0]


def backend_provenance(device=None) -> dict:
    """The run manifest's backend block: :func:`card_provenance` plus
    ``platform`` ("gpu" when the run's device, as ``resolve_device``
    takes it, is a visible card; "cpu" when the caller asked for the CPU
    or no card is visible), ``device_kind`` and ``device_count``.

    Cached once a process and a device type: the answer cannot change
    within a process, and the card's asks ``nvidia-smi``."""
    kind = _device_type(device)
    with _lock:
        hit = _backend.get(kind)
    if hit is not None:
        return dict(hit)
    import torch

    prov = card_provenance()
    gpu = kind == "cuda" and torch.cuda.is_available()
    rec = {**prov, "platform": "gpu" if gpu else "cpu",
           "device_kind": prov["device"] if gpu else "cpu",
           "device_count": prov["device_count"] if gpu else 1}
    with _lock:
        _backend[kind] = rec
    return dict(rec)


def device_span_attrs(device_type: str = "cuda") -> dict:
    """The attributes every device span carries: platform, device kind
    and device count of ``device_type``, from
    :func:`backend_provenance`."""
    prov = backend_provenance(device_type)
    return {"platform": prov["platform"],
            "device_kind": prov["device_kind"],
            "device_count": prov["device_count"]}


def env_provenance() -> dict:
    """The host and environment block of the run manifest: the
    reference's keys, with the knobs the port reads (``GOLEFT_TPU_*``
    and ``CUDA_VISIBLE_DEVICES``) under ``env_knobs``."""
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
