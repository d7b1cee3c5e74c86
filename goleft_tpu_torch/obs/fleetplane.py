"""Trace context across processes: the ``x-goleft-trace`` header, a copy
of the part of the JAX package's obs/fleetplane.py that a serve worker
and its client need (the stitching and the metrics roll-up of the fleet
router are not ported).

The header is ``<trace_id>`` or ``<trace_id>;<parent_span_id>``: a
client mints it, the worker's ``request.<kind>`` root adopts the trace
id and records the remote parent span id as the ``remote_parent``
attribute.
"""

from __future__ import annotations

import itertools
import os
import time

TRACE_HEADER = "x-goleft-trace"

#: longest trace id accepted from the wire (the flight ring keys on it;
#: an unbounded string chosen by a client must not become one)
MAX_TRACE_ID = 128

_mint_seq = itertools.count(1)


def parse_trace_header(value: str | None) -> tuple[str, int | None] | None:
    """(trace_id, parent_span_id | None), or None for an absent or
    malformed header. Strict, since any client can send one: a bounded
    printable id without spaces and an integer span; a bad header counts
    as none (it never fails a request)."""
    if not value:
        return None
    head, _, tail = value.strip().partition(";")
    if not head or len(head) > MAX_TRACE_ID \
            or any(c.isspace() or not c.isprintable() for c in head):
        return None
    span_id: int | None = None
    if tail:
        try:
            span_id = int(tail.strip())
        except ValueError:
            return None
    return head, span_id


def mint_trace_id(component: str = "cli") -> str:
    """A trace id for a process without a tracer (the client):
    ``serve-<component>-<pid>-<ms>-<n>``; the ``serve-`` prefix is what
    the flight recorder keeps."""
    return (f"serve-{component}-{os.getpid()}-"
            f"{int(time.time() * 1000)}-{next(_mint_seq)}")
