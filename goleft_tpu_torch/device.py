"""Device selection and card provenance.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``), where every kernel runs as its plain PyTorch
version. Without a visible CUDA device a default run raises; it never
drops quietly to the CPU.
"""

from __future__ import annotations

import subprocess

import torch


class NoCudaDevice(RuntimeError):
    """A CUDA run was asked for (explicitly or by default) and no CUDA
    device is visible."""


class KernelFault(RuntimeError):
    """A kernel did not build, launch or finish on the card: a fault of
    the card or its toolchain, not of the data. The retry policy lets it
    through unretried and unquarantined, so the run fails with it."""


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
