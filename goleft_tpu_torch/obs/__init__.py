"""Observability of the port: the process-wide counter registry, the
logger tree, the span tracer and the run manifest (trimmed copies of the
JAX package's obs/metrics.py, obs/logging.py, obs/tracing.py and
obs/manifest.py), and the device spans of the kernel launch sites.

Importing this package does not import torch: the CLI reaches it before
the first ``import torch``, and :func:`dispatch` imports torch only when
device events are on.
"""

from __future__ import annotations

from .logging import configure as configure_logging, get_logger
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
                      get_registry)
from .tracing import Span, SpanContext, TRACER, Tracer, get_tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY", "Span",
    "SpanContext",
    "TRACER", "Tracer", "attach", "capture", "configure_logging",
    "device_events_enabled", "device_span", "dispatch", "get_logger",
    "get_registry", "get_tracer", "set_device_events", "span", "trace",
]


# ---- the process tracer ----

def span(name: str, category: str = "", **attrs):
    """Context manager: a span on the process tracer."""
    return TRACER.span(name, category=category, **attrs)


def trace(name: str, kind: str = "run", trace_id: str | None = None,
          remote_parent: int | None = None, **attrs):
    """Context manager: a run-scoped root span under a fresh trace id
    (or the given one; ``remote_parent`` records a remote caller's
    span)."""
    return TRACER.trace(name, kind=kind, trace_id=trace_id,
                        remote_parent=remote_parent, **attrs)


def capture() -> SpanContext:
    return TRACER.capture()


def attach(ctx: SpanContext | None):
    return TRACER.attach(ctx)


# ---- device events ----

def device_events_enabled() -> bool:
    return TRACER.device_events


def set_device_events(enabled: bool) -> None:
    """Turn the fenced device spans of :func:`dispatch` on or off (the
    CLI's ``--trace-out`` sets it)."""
    TRACER.device_events = bool(enabled)


def device_span(name: str, device_type: str = "cuda", **attrs):
    """A ``category="device"`` span carrying the platform and device
    kind of ``device_type``: for a site that waits on its own work."""
    from .provenance import device_span_attrs

    return TRACER.span(name, category="device",
                       **device_span_attrs(device_type), **attrs)


def _tensor_device(obj):
    """The device of the first tensor in ``obj`` (tuples, lists and dict
    values searched), or None."""
    if hasattr(obj, "device") and hasattr(obj, "is_cuda"):
        return obj.device
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        for x in obj:
            d = _tensor_device(x)
            if d is not None:
                return d
    return None


def dispatch(name: str, fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)``, a kernel launch, as a device event.

    With device events off (the default) this is a plain call: no span,
    no wait, the launch stays asynchronous. With them on (``--trace-out``)
    the call runs inside a ``device.<name>`` span (``fenced=True``, the
    platform and device kind of the inputs' device) that ends only when
    the launch has finished: on the card the fence waits on the
    launching thread's current stream, never on the whole device (a device-wide wait would make each sample thread wait on the
    others' launches). An error the kernel left on the card surfaces at
    the fence as ``device.KernelFault``."""
    if not TRACER.device_events:
        return fn(*args, **kwargs)
    dev = _tensor_device((args, kwargs))
    on_card = dev is not None and dev.type == "cuda"
    with device_span(f"device.{name}", "cuda" if on_card else "cpu",
                     fenced=True):
        out = fn(*args, **kwargs)
        if on_card:
            import torch

            from ..device import KernelFault

            try:
                torch.cuda.current_stream(dev).synchronize()
            except RuntimeError as e:
                raise KernelFault(
                    f"{name} kernel failed on the card: {e}") from e
    return out
