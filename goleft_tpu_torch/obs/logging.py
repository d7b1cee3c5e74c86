"""``goleft-tpu-torch.*`` logger naming: the counterpart of the JAX
package's obs/logging.py::get_logger. Every module logs under one root,
so one level setting configures the whole tree."""

from __future__ import annotations

import logging

ROOT = "goleft-tpu-torch"


def get_logger(area: str = "") -> logging.Logger:
    """``get_logger("resilience.faults")`` → the
    ``goleft-tpu-torch.resilience.faults`` logger."""
    return logging.getLogger(f"{ROOT}.{area}" if area else ROOT)
