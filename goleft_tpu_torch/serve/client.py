"""Thin stdlib client for the serve daemon and the fleet router.

urllib-only, so scripts and chip_smoke.py need nothing beyond this
repo (a copy of the JAX package's serve/client.py). Methods mirror the
routes; non-2xx responses raise
:class:`ServeError` carrying the HTTP status, the server's error
message and (when the server sent one) its ``retry_after_s`` hint —
so a 429 is distinguishable from a 504 at the call site.

Routing-aware behavior (what the fleet layer leans on):

  - **redirects**: a ``307``/``308`` whose body/headers carry the
    target (the router's redirect mode — it hands the client the
    affinity worker's URL and steps out of the data path) is followed
    once per hop, re-POSTing the same body. urllib alone refuses to
    follow redirected POSTs; this client implements them explicitly.
  - **retry_after honor** (``retries > 0``): a 429 (quota) or 503
    (breaker open, worker draining during a restart/resize window,
    fleet shedding) carrying ``retry_after_s`` is retried after
    sleeping that hint (never more than ``retry_cap_s``), up to
    ``retries`` times AND within ``retry_budget_s`` total wall clock
    — the budget bounds the worst case where every attempt lands in
    a long drain window re-hinting "soon". Responses without the
    hint fail immediately — the server didn't promise recovery.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

#: statuses whose retry_after_s hint the client will honor
_RETRYABLE = (429, 503)
_REDIRECT = (307, 308)


class ServeError(RuntimeError):
    def __init__(self, status: int, message: str,
                 retry_after_s: float | None = None):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message
        self.retry_after_s = retry_after_s


class ServeClient:
    def __init__(self, base_url: str, timeout_s: float = 120.0,
                 retries: int = 0, retry_cap_s: float = 30.0,
                 retry_budget_s: float | None = None,
                 max_redirects: int = 4, trace: bool = False):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.retries = retries
        self.retry_cap_s = retry_cap_s
        # total wall-clock retry budget across ALL attempts of one
        # request (None: bounded by retries × retry_cap_s only)
        self.retry_budget_s = retry_budget_s
        self.max_redirects = max_redirects
        # trace=True mints a fleet-wide trace id per workload request
        # and sends it as x-goleft-trace: the router/worker adopt it,
        # and `last_trace_id` is what you hand to
        # `goleft-tpu trace <id> --router URL` afterwards
        self.trace = trace
        self.last_trace_id: str | None = None

    def _post_once(self, url: str, data: bytes | None,
                   headers: dict, hops: list[int],
                   deadline: float | None) -> dict:
        """One HTTP exchange, following router redirects (re-POSTing
        the same body); raises :class:`ServeError` on non-2xx.

        Redirect hygiene (each a fixed bug class):

          - ``hops`` is the request-WIDE remaining-follows budget,
            shared across retry ATTEMPTS — previously each attempt
            got a fresh ``max_redirects`` allowance, so a redirect
            loop times retries could multiply the cap away
          - every re-POST rebuilds its header dict and explicitly
            re-attaches ``x-goleft-trace`` — the original request was
            the only one guaranteed to carry it, which broke the
            stitched trace exactly on redirected (router-bypass) hops
          - follows are counted against ``retry_budget_s``: a
            redirect chain spends the same wall-clock budget a
            retry-after sleep does
        """
        from ..obs.fleetplane import TRACE_HEADER

        traced = TRACE_HEADER in headers
        while True:
            hdrs = dict(headers)
            if traced and self.last_trace_id:
                hdrs[TRACE_HEADER] = self.last_trace_id
            req = urllib.request.Request(url, data=data,
                                         headers=hdrs)
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as r:
                    # the fleet router echoes the trace id it used
                    # (ours, or one it minted) — keep it so callers
                    # can fetch the stitched trace afterwards
                    tid = r.headers.get("x-goleft-trace")
                    if tid:
                        self.last_trace_id = tid
                    return json.loads(r.read().decode())
            except urllib.error.HTTPError as e:
                raw = e.read()
                try:
                    body = json.loads(raw.decode())
                except ValueError:
                    body = {}
                if e.code in _REDIRECT:
                    target = e.headers.get("Location") \
                        or body.get("location")
                    if target:
                        if hops[0] <= 0:
                            raise ServeError(
                                508,
                                f"too many redirects (> "
                                f"{self.max_redirects} for this "
                                f"request) from {url}") from e
                        if deadline is not None \
                                and time.monotonic() >= deadline:
                            raise ServeError(
                                508,
                                f"retry budget "
                                f"{self.retry_budget_s:g}s exhausted "
                                f"while following a redirect from "
                                f"{url}") from e
                        hops[0] -= 1
                        url = target
                        continue
                raise ServeError(
                    e.code,
                    body.get("error", "") or (e.reason or ""),
                    retry_after_s=body.get("retry_after_s"),
                ) from e

    def _request(self, path: str, payload: dict | None = None) -> dict:
        url = self.base_url + path
        data = None
        headers = {"Accept": "application/json"}
        if payload is not None:
            data = json.dumps(payload).encode()
            headers["Content-Type"] = "application/json"
            if self.trace:
                from ..obs.fleetplane import (
                    TRACE_HEADER, mint_trace_id,
                )

                self.last_trace_id = mint_trace_id("cli")
                headers[TRACE_HEADER] = self.last_trace_id
        attempt = 0
        t0 = time.monotonic()
        deadline = t0 + self.retry_budget_s \
            if self.retry_budget_s is not None else None
        # the total 307/308 budget for THIS request, across all retry
        # attempts (a mutable cell so _post_once draws it down)
        hops = [self.max_redirects]
        while True:
            try:
                return self._post_once(url, data, headers, hops,
                                       deadline)
            except ServeError as e:
                if attempt >= self.retries \
                        or e.status not in _RETRYABLE \
                        or e.retry_after_s is None:
                    raise
                delay = min(max(0.0, e.retry_after_s),
                            self.retry_cap_s)
                if self.retry_budget_s is not None and (
                        time.monotonic() - t0 + delay
                        > self.retry_budget_s):
                    # honoring the hint would overspend the budget:
                    # fail with the server's last answer rather than
                    # sleep past what the caller was willing to wait
                    raise
                attempt += 1
                time.sleep(delay)

    # ---- operability ----

    def healthz(self) -> dict:
        return self._request("/healthz")

    def metrics(self) -> dict:
        return self._request("/metrics")

    def metrics_prometheus(self) -> str:
        """The same metrics as Prometheus text exposition (0.0.4)."""
        req = urllib.request.Request(
            self.base_url + "/metrics?format=prom",
            headers={"Accept": "text/plain"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return r.read().decode()

    def flight(self, n: int | None = None,
               trace_id: str | None = None,
               kind: str | None = None) -> dict:
        """The flight recorder ring: span trees of the most recent
        completed requests/batches, newest first. ``trace_id`` /
        ``kind`` filter server-side (trace_id also matches batch trees
        linked to the request trace)."""
        from urllib.parse import urlencode

        params = {k: v for k, v in
                  (("n", n), ("trace_id", trace_id), ("kind", kind))
                  if v is not None}
        path = "/debug/flight" + \
            (f"?{urlencode(params)}" if params else "")
        return self._request(path)

    def fleet_trace(self, trace_id: str) -> dict:
        """Fleet router only: the stitched cross-process trace for
        ``trace_id`` — the router's forward spans plus every worker's
        matching request/batch trees, with a Perfetto export inside
        (``goleft-tpu-torch trace <id> --router URL`` pretty-prints it)."""
        from urllib.parse import quote

        return self._request(f"/fleet/trace/{quote(trace_id)}")

    def fleet_metrics(self) -> dict:
        """Fleet router only: the rolled-up worker metrics (counters
        summed, gauges per-worker + min/max/sum, merged histogram
        summaries, fleet SLO burn rates)."""
        return self._request("/fleet/metrics")

    def route_plan(self, kind: str, **params) -> list[str]:
        """Fleet router only: the candidate worker order a request
        with these params would route to (no forwarding): how a caller
        finds a request's affinity home."""
        return self._request("/fleet/plan",
                             {"kind": kind, **params})["candidates"]

    # ---- workloads ----

    def depth(self, bam: str, **params) -> dict:
        """→ {depth_bed, callable_bed, shards[, cached]} — the bytes
        the one-shot `goleft-tpu depth` CLI writes for the same
        fixture."""
        return self._request("/v1/depth", {"bam": bam, **params})

    def indexcov(self, bams: list[str], fai: str, **params) -> dict:
        """→ {samples, chroms, cn, bin_counters[, cached]}."""
        return self._request("/v1/indexcov",
                             {"bams": list(bams), "fai": fai,
                              **params})

    def cohortdepth(self, bams: list[str], **params) -> dict:
        """→ {matrix_tsv, samples, windows[, cached]}."""
        return self._request("/v1/cohortdepth",
                             {"bams": list(bams), **params})

    def pairhmm(self, input_path: str, **params) -> dict:
        """→ {likelihoods_tsv, windows[, cached]} — the bytes the
        one-shot `goleft-tpu pairhmm` CLI writes for the same
        windows document (+ optional candidates/gap params)."""
        return self._request("/v1/pairhmm",
                             {"input": input_path, **params})

    def map(self, fastq: str, reference: str, **params) -> dict:
        """→ {tuples_tsv, reads, mapped, unmapped, failed
        [, depth_bed][, cached]} — the tuple stream the one-shot
        `goleft-tpu map` CLI writes for the same FASTQ/reference
        (pass ``window=`` for the fused depth bed too)."""
        return self._request("/v1/map",
                             {"fastq": fastq,
                              "reference": reference, **params})
