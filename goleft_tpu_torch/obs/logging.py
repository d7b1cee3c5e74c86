"""``goleft-tpu-torch.*`` logger naming and the CLI's one level setting:
the counterpart of the JAX package's obs/logging.py. Every module logs
under one root, so ``--log-level`` / ``-v`` configures the whole tree and
leaves other libraries' loggers alone."""

from __future__ import annotations

import logging
import sys

ROOT = "goleft-tpu-torch"

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


def get_logger(area: str = "") -> logging.Logger:
    """``get_logger("resilience.faults")`` → the
    ``goleft-tpu-torch.resilience.faults`` logger."""
    return logging.getLogger(f"{ROOT}.{area}" if area else ROOT)


def parse_level(spec: str) -> int:
    try:
        return _LEVELS[spec.strip().lower()]
    except KeyError:
        raise ValueError(
            f"unknown log level {spec!r} (choose from "
            f"{'/'.join(_LEVELS)})")


def configure(level: int | str = logging.WARNING) -> logging.Logger:
    """Install (once) a stderr handler with one format on the
    ``goleft-tpu-torch`` root and set its level. Repeat calls only set
    the level, so nested CLI invocations never stack handlers.
    Propagation stays on (pytest's caplog captures through the root
    logger)."""
    if isinstance(level, str):
        level = parse_level(level)
    root = logging.getLogger(ROOT)
    if not any(getattr(h, "_goleft_cli", False) for h in root.handlers):
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s",
            datefmt="%H:%M:%S"))
        h._goleft_cli = True
        root.addHandler(h)
    root.setLevel(level)
    return root
