"""Prometheus text exposition (format 0.0.4) over the metrics registry.

The serve daemon's /metrics has always been a JSON document (and stays
one, byte-for-byte — scripts and tests pin it); this module renders
the SAME :meth:`MetricsRegistry.snapshot` as the plain-text format a
Prometheus scraper ingests, so pointing a scrape job at
``/metrics?format=prom`` (or sending ``Accept: text/plain``) needs no
sidecar exporter. One snapshot, two encodings — the numbers cannot
disagree.

Mapping:

  - counters  -> ``# TYPE <name> counter`` + one sample
  - gauges    -> ``# TYPE <name> gauge``
  - histograms (bounded-window summaries) -> a Prometheus *summary*:
    ``<name>{quantile="0.5"}`` per recorded percentile plus
    ``<name>_sum`` / ``<name>_count`` (count is all-time, matching the
    JSON body)

Names are sanitized to the Prometheus grammar
(``[a-zA-Z_:][a-zA-Z0-9_:]*`` — the registry's dotted names become
underscored); every emitted family carries ``# HELP``/``# TYPE``.
Stdlib-only, no client library.
"""

from __future__ import annotations

import re

#: the content type a 0.0.4 text exposition must be served under
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_BAD = re.compile(r"[^a-zA-Z0-9_:]")

#: percentile keys in a histogram summary -> Prometheus quantile label
_QUANTILES = {"p50": "0.5", "p95": "0.95", "p99": "0.99",
              "max": "1"}


def sanitize_name(name: str) -> str:
    """Registry name -> legal Prometheus metric name (dots and every
    other illegal byte become ``_``; a leading digit is prefixed)."""
    out = _BAD.sub("_", name)
    if not _NAME_OK.match(out):
        out = "_" + out
    return out


def _fmt(v) -> str:
    # Prometheus floats: plain repr is fine, but ints stay ints so
    # counter samples read naturally
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def render(snapshot: dict, prefix: str = "",
           help_text: dict | None = None) -> str:
    """Render a ``MetricsRegistry.snapshot()`` dict as exposition text.

    ``prefix`` is prepended to every metric name (after sanitizing);
    ``help_text`` optionally maps ORIGINAL registry names to HELP
    strings. Deterministic: sorted names, one trailing newline.
    """
    help_text = help_text or {}
    lines: list[str] = []

    def emit(orig: str, kind: str, samples: list[tuple[str, object]]):
        name = sanitize_name(prefix + orig)
        hlp = help_text.get(orig, f"goleft-tpu metric {orig}")
        lines.append(f"# HELP {name} {hlp}")
        lines.append(f"# TYPE {name} {kind}")
        for suffix_or_labels, v in samples:
            lines.append(f"{name}{suffix_or_labels} {_fmt(v)}")

    for n, v in sorted(snapshot.get("counters", {}).items()):
        emit(n, "counter", [("", v)])
    for n, v in sorted(snapshot.get("gauges", {}).items()):
        emit(n, "gauge", [("", v)])
    for n, summ in sorted(snapshot.get("histograms", {}).items()):
        samples = [(f'{{quantile="{q}"}}', summ[pk])
                   for pk, q in _QUANTILES.items() if pk in summ]
        if "sum" in summ:
            samples.append(("_sum", summ["sum"]))
        samples.append(("_count", summ.get("count", 0)))
        emit(n, "summary", samples)
    return "\n".join(lines) + "\n"
