"""Observability of the port: the process-wide counter registry, the
logger tree and the run manifest (trimmed copies of the JAX package's
obs/metrics.py, obs/logging.py and obs/manifest.py). Dispatch tracing is
not ported: the manifest's spans are utils/profiling.py's stage totals,
and each kernel wrapper's launch count stands in for device spans."""

from .logging import get_logger
from .metrics import Counter, MetricsRegistry, REGISTRY, get_registry

__all__ = ["Counter", "MetricsRegistry", "REGISTRY", "get_logger",
           "get_registry"]
