"""Device selection.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``), where every kernel runs as its plain PyTorch
version. Without a visible CUDA device a default run raises; it never
drops quietly to the CPU. The card's provenance is obs/provenance.py's.
"""

from __future__ import annotations

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
