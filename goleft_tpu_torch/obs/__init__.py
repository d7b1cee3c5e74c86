"""Observability of the port: the process-wide counter registry and the
logger tree (trimmed copies of the JAX package's obs/metrics.py and
obs/logging.py). Spans and dispatch tracing are not ported; each kernel
wrapper's launch count stands in for them."""

from .logging import get_logger
from .metrics import Counter, MetricsRegistry, REGISTRY, get_registry

__all__ = ["Counter", "MetricsRegistry", "REGISTRY", "get_logger",
           "get_registry"]
