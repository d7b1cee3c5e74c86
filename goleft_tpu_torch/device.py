"""Device selection and card provenance.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``), where every kernel runs as its plain PyTorch
version. Without a visible CUDA device a default run raises; it never
drops quietly to the CPU.
"""

from __future__ import annotations

import subprocess

import torch

from .errors import KernelFault, NoCudaDevice  # noqa: F401 (re-exported)


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` → the current CUDA device (raises
    :class:`NoCudaDevice` without one); ``"cpu"`` → the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise NoCudaDevice(
            "no CUDA device is visible; pass device='cpu' to run the "
            "plain PyTorch path")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_devices(devices=None, device=None) -> list[torch.device]:
    """The devices a split runs on: ``devices`` (a list, each resolved
    as :func:`resolve_device`; ``["cpu", "cpu"]`` splits on the CPU),
    else ``[device]`` when the caller names one, else every visible
    card (raises :class:`NoCudaDevice` without one). On a one-card host
    the default is that card alone."""
    if devices is not None:
        out = [resolve_device(d) for d in devices]
        if not out:
            raise ValueError("an empty list of devices")
        return out
    if device is not None:
        return [resolve_device(device)]
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


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


def backend_provenance(device=None) -> dict:
    """The run manifest's backend block: :func:`card_provenance` plus
    ``platform`` ("gpu" when the run's device, as :func:`resolve_device`
    takes it, is a visible card; "cpu" when the caller asked for the CPU
    or no card is visible), ``device_kind`` and ``device_count``."""
    prov = card_provenance()
    gpu = (torch.device("cuda" if device is None else device).type
           == "cuda" and torch.cuda.is_available())
    return {**prov, "platform": "gpu" if gpu else "cpu",
            "device_kind": prov["device"] if gpu else "cpu",
            "device_count": prov["device_count"] if gpu else 1}


def card_provenance() -> dict:
    """torch / CUDA versions, the visible device and its power limit."""
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "nvidia_smi": nvidia_smi_line() if cuda else "not available",
    }
