"""Object-store data plane: ranged-read remote inputs, the counterpart of
the JAX package's io/remote.py (without its request-routing probes,
which are the fleet router's).

``https://`` (and endpoint-mapped ``s3://``) URLs work wherever a path
works: a :class:`ByteSource` sits beneath the io layer (bgzf, bam, cram
and the BAI/CRAI/FAI parsers).

- **ByteSource**: ``read(offset, size)`` over a length-pinned,
  identity-pinned object. :class:`LocalByteSource` wraps a plain file;
  :class:`HttpByteSource` speaks HTTP Range (206 + Content-Range)
  through a bounded keep-alive connection pool, with a sparse
  block-aligned range cache and sequential read-ahead.
- **content identity**: :func:`remote_file_key` mirrors
  ``parallel.scheduler.file_key``'s ``(abspath, size, mtime_ns)`` as
  ``(url, length, etag-token)``, so result caching and checkpoint keys
  compose unchanged. Every Range response is checked against the
  identity pinned at open: a drifted ETag raises
  :class:`StaleRemoteInput` (a ``ValueError``: permanent, never retried,
  never mixed into an output).
- **resilience**: each network fetch is a plan Step at the ``fetch``
  fault site, retried under the port's RetryPolicy.
- **observability**: ``fetch.*`` counters (requests, bytes, block cache
  hits/misses, read-ahead, stale detections) and a ``fetch.range`` span
  per network round trip.

HTTP statuses map onto the policy's classification: 404 →
``FileNotFoundError`` and 401/403 → ``PermissionError`` (permanent),
416 → ``ValueError`` (permanent), 5xx/429 and anything else →
``OSError`` (transient, retried). Connection and timeout errors are
``OSError`` already.

``s3://bucket/key`` URLs map onto the path-style gateway named by
``GOLEFT_TPU_S3_ENDPOINT`` (no SDK); without one they are a
configuration error.
"""

from __future__ import annotations

import collections
import email.utils
import http.client
import io as _io
import os
import threading
import time
import urllib.parse

from ..obs import get_registry, span
from ..plan.core import Step
from ..plan.executor import Executor
from ..resilience.policy import RetryPolicy

__all__ = [
    "ByteSource", "HttpByteSource", "LocalByteSource",
    "StaleRemoteInput", "exists", "fetch_bytes", "invalidate_identity",
    "is_remote", "open_source", "read_range", "remote_file_key",
    "resolve_url", "source_io",
]

#: schemes the data plane accepts (s3:// is endpoint-mapped onto http)
SCHEMES = ("http", "https", "s3")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _block_size() -> int:
    """Range-cache block size (bytes) — 1 MiB default: big enough to
    amortize a round trip, small enough that index-guided reads don't
    drag whole containers."""
    return max(1 << 12, _env_int("GOLEFT_TPU_FETCH_BLOCK", 1 << 20))


def _readahead_blocks() -> int:
    return max(0, _env_int("GOLEFT_TPU_FETCH_READAHEAD", 2))


def _timeout_s() -> float:
    return _env_float("GOLEFT_TPU_FETCH_TIMEOUT_S", 30.0)


def _routing_timeout_s() -> float:
    """Budget of an identity probe made on a request-routing path (the
    fleet router's affinity key): a slow object store must not stall
    routing for the full fetch retry budget."""
    return _env_float("GOLEFT_TPU_FETCH_ROUTING_TIMEOUT_S", 1.0)


#: blocks a ByteSource keeps (LRU beyond this)
CACHE_BLOCKS = 64
#: identities kept in the TTL cache (LRU beyond this)
IDENTITY_CAP = 4096
#: seconds a probed identity stays fresh
IDENTITY_TTL_S = 5.0
#: idle keep-alive connections pooled per host
POOL_PER_HOST = 4

#: the fetch tier's retry budget: transient network faults get a couple
#: of re-attempts with the standard deterministic-jitter backoff
FETCH_POLICY = RetryPolicy(retries=2, base_delay_s=0.05, max_delay_s=2.0,
                           deadline_s=120.0)


class StaleRemoteInput(ValueError):
    """The object behind a URL changed identity mid-read.

    A ``ValueError`` on purpose: the RetryPolicy classifies it
    *permanent* — re-reading a drifted object can only mix two
    versions' bytes, so the read fails fast (and quarantines only the
    affected sample under the cohort contract)."""

    def __init__(self, url: str, pinned: str, observed: str):
        super().__init__(
            f"stale remote input {url}: identity drifted from "
            f"{pinned!r} to {observed!r} mid-read")
        self.url = url
        self.pinned = pinned
        self.observed = observed


def is_remote(path) -> bool:
    """True when ``path`` is a URL the data plane serves."""
    if not isinstance(path, str) or "://" not in path:
        return False
    return path.split("://", 1)[0].lower() in SCHEMES


def resolve_url(url: str) -> str:
    """Map ``s3://bucket/key`` onto the path-style HTTP gateway named
    by ``GOLEFT_TPU_S3_ENDPOINT``; http(s) URLs pass through."""
    scheme = url.split("://", 1)[0].lower()
    if scheme in ("http", "https"):
        return url
    if scheme == "s3":
        endpoint = os.environ.get("GOLEFT_TPU_S3_ENDPOINT", "")
        if not endpoint:
            raise ValueError(
                f"s3 URL {url!r} requires GOLEFT_TPU_S3_ENDPOINT "
                "(path-style gateway, e.g. https://s3.example.com)")
        rest = url.split("://", 1)[1]
        return endpoint.rstrip("/") + "/" + rest
    raise ValueError(f"unsupported remote scheme in {url!r}")


# ---- bounded keep-alive connection pool ----

class _ConnectionPool:
    """Per-(scheme, host, port) pool of idle ``http.client``
    connections, bounded by ``POOL_PER_HOST`` per host. A
    connection that errors is discarded, never re-pooled."""

    def __init__(self):
        self._lock = threading.Lock()
        self._idle: dict = collections.defaultdict(list)

    def acquire(self, scheme: str, host: str, port: int,
                timeout_s: float | None = None):
        t = timeout_s if timeout_s is not None else _timeout_s()
        with self._lock:
            idle = self._idle.get((scheme, host, port))
            if idle:
                conn = idle.pop()
                # a pooled connection may carry the previous caller's
                # deadline: set this caller's on every acquire
                conn.timeout = t
                if getattr(conn, "sock", None) is not None:
                    conn.sock.settimeout(t)
                return conn
        if scheme == "https":
            return http.client.HTTPSConnection(host, port, timeout=t)
        return http.client.HTTPConnection(host, port, timeout=t)

    def release(self, scheme: str, host: str, port: int, conn) -> None:
        with self._lock:
            idle = self._idle[(scheme, host, port)]
            if len(idle) < POOL_PER_HOST:
                idle.append(conn)
                return
        conn.close()

    def discard(self, conn) -> None:
        try:
            conn.close()
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass


_POOL = _ConnectionPool()

#: the fetch tier's executor: every network round trip is one plan Step
#: at the ``fetch`` site
_EXECUTOR = Executor(policy=FETCH_POLICY)

#: the routing probe's executor: one attempt under a tight deadline
#: (routing falls back to the raw URL when the probe fails)
_PROBE_EXECUTOR = Executor(policy=RetryPolicy(
    retries=0, base_delay_s=0.01, max_delay_s=0.1,
    deadline_s=_routing_timeout_s()))

_MAX_REDIRECTS = 4


def _identity_token(headers) -> str:
    """The response's content-identity token: ETag preferred (quoted
    form kept verbatim — opaque but stable), else Last-Modified
    normalized to epoch seconds, else empty (length-only identity)."""
    etag = headers.get("ETag")
    if etag:
        return "etag:" + etag.strip()
    lm = headers.get("Last-Modified")
    if lm:
        try:
            return "lm:%d" % int(
                email.utils.parsedate_to_datetime(lm).timestamp())
        except (TypeError, ValueError):
            return "lm:" + lm.strip()
    return ""


def _status_error(url: str, status: int, reason: str) -> Exception:
    if status == 404:
        return FileNotFoundError(f"HTTP 404 for {url}")
    if status in (401, 403):
        return PermissionError(f"HTTP {status} for {url}")
    if status == 416:
        return ValueError(f"HTTP 416 (range not satisfiable) for {url}")
    # 5xx / 429 / anything else unexpected: plausibly environmental
    return OSError(f"HTTP {status} {reason} for {url}")


def _http_roundtrip(url: str, method: str, headers: dict,
                    timeout_s: float | None = None):
    """One HTTP request/response against the resolved URL, following
    a bounded number of redirects. Returns ``(status, headers, body)``
    for terminal 2xx; raises the mapped error otherwise. Never
    retries — retry lives in the plan Step above this."""
    reg = get_registry()
    target = url
    for _ in range(_MAX_REDIRECTS + 1):
        parts = urllib.parse.urlsplit(target)
        scheme = parts.scheme.lower()
        host = parts.hostname or ""
        port = parts.port or (443 if scheme == "https" else 80)
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        conn = _POOL.acquire(scheme, host, port, timeout_s=timeout_s)
        try:
            conn.request(method, path, headers=headers)
            resp = conn.getresponse()
            status = resp.status
            rheaders = dict(resp.getheaders())
            body = resp.read()
        except Exception:
            _POOL.discard(conn)
            raise
        _POOL.release(scheme, host, port, conn)
        reg.counter("fetch.requests_total").inc()
        if status in (301, 302, 303, 307, 308):
            loc = rheaders.get("Location")
            if not loc:
                raise _status_error(target, status, "redirect "
                                    "without Location")
            target = urllib.parse.urljoin(target, loc)
            continue
        if 200 <= status < 300:
            return status, rheaders, body
        raise _status_error(target, status, rheaders.get(
            "X-Goleft-Reason", "") or "error")
    raise OSError(f"too many redirects for {url}")


def _fetch_step(url: str, key: tuple, fn, what: str):
    """Run one network fetch as a retried plan Step at the ``fetch``
    site; raises the original cause on exhaustion (permanent errors —
    404, stale identity — fail fast by classification)."""
    return _EXECUTOR.run(Step(
        key=key, fn=fn, site="fetch", span="fetch.range",
        attrs={"url": url, "what": what}))


# ---- identity (HEAD) probing with a short TTL cache ----

_identity_lock = threading.Lock()
#: url -> (monotonic, (length, token)); insertion-ordered (oldest
#: first), bounded by ``IDENTITY_CAP``
_identity_cache: collections.OrderedDict = collections.OrderedDict()
#: url -> monotonic of the last failed routing probe: a dead endpoint
#: costs routing one short probe per TTL, not one per request
_identity_neg: collections.OrderedDict = collections.OrderedDict()


def _cache_insert(cache: collections.OrderedDict, url: str,
                  value) -> None:
    """Insert under ``_identity_lock``: newest at the back, expired
    entries swept from the front (insertion order is staleness order),
    LRU beyond the cap."""
    now = time.monotonic()
    cache[url] = value
    cache.move_to_end(url)
    while cache:
        ts = next(iter(cache.values()))
        ts = ts[0] if isinstance(ts, tuple) else ts
        if now - ts <= IDENTITY_TTL_S:
            break
        cache.popitem(last=False)
    while len(cache) > IDENTITY_CAP:
        cache.popitem(last=False)


def invalidate_identity(url: str | None = None) -> None:
    """Drop cached identities for one URL, or all (tests use it to see a
    server-side rewrite without waiting out the TTL)."""
    with _identity_lock:
        if url is None:
            _identity_cache.clear()
            _identity_neg.clear()
        else:
            _identity_cache.pop(url, None)
            _identity_neg.pop(url, None)


def _probe_identity(url: str, routing: bool = False) -> tuple:
    """HEAD the object: ``(length, token)``, cached for the identity
    TTL. Raises the mapped error (404 → FileNotFoundError); callers that
    want existence semantics catch it.

    ``routing=True`` is the request-routing variant: one attempt under
    ``_routing_timeout_s()`` instead of the fetch retry budget, and a
    failure is negative-cached for the identity TTL, so an unreachable
    store stalls at most one request per TTL."""
    now = time.monotonic()
    with _identity_lock:
        hit = _identity_cache.get(url)
        if hit is not None and now - hit[0] <= IDENTITY_TTL_S:
            return hit[1]
        if routing:
            neg = _identity_neg.get(url)
            if neg is not None and now - neg <= IDENTITY_TTL_S:
                get_registry().counter(
                    "fetch.identity_neg_hits_total").inc()
                raise OSError(
                    f"identity probe for {url} failed recently "
                    "(negative-cached)")
    resolved = resolve_url(url)

    def head():
        get_registry().counter("fetch.identity_probes_total").inc()
        status, headers, _body = _http_roundtrip(
            resolved, "HEAD", {},
            timeout_s=_routing_timeout_s() if routing else None)
        try:
            length = int(headers.get("Content-Length", "-1"))
        except ValueError:
            length = -1
        if length < 0:
            raise OSError(
                f"HEAD {url} carried no Content-Length "
                f"(status {status})")
        return (length, _identity_token(headers))

    executor = _PROBE_EXECUTOR if routing else _EXECUTOR
    try:
        ident = executor.run(Step(
            key=("fetch", "identity", url), fn=head, site="fetch",
            span="fetch.range", attrs={"url": url, "what": "identity"}))
    except Exception:
        if routing:
            with _identity_lock:
                _cache_insert(_identity_neg, url, time.monotonic())
        raise
    with _identity_lock:
        _cache_insert(_identity_cache, url, (time.monotonic(), ident))
        _identity_neg.pop(url, None)
    return ident


def remote_file_key(url: str) -> tuple:
    """``(url, length, token)``: the remote mirror of ``file_key``'s
    ``(abspath, size, mtime_ns)``, the same shape and the same property
    (an object rewrite changes the key)."""
    length, token = _probe_identity(url)
    return (url, length, token)


def routing_file_key(url: str) -> tuple:
    """:func:`remote_file_key` for the fleet router's affinity key: the
    same tuple on success, but one probe attempt under
    ``GOLEFT_TPU_FETCH_ROUTING_TIMEOUT_S`` and failures negative-cached
    for the identity TTL, so a slow or dead store cannot stall request
    routing for the fetch retry budget on every request."""
    length, token = _probe_identity(url, routing=True)
    return (url, length, token)


def exists(path) -> bool:
    """``os.path.exists`` extended over the data plane: a remote URL
    exists when its identity probe answers. Probe failures (404,
    unreachable host past the retry budget) read as absent — the same
    degrade-to-False contract local ``exists`` has on EPERM."""
    if not is_remote(path):
        return os.path.exists(path)
    try:
        _probe_identity(path)
        return True
    except Exception:  # noqa: BLE001 — absence, not failure
        return False


# ---- sources ----

class ByteSource:
    """Length- and identity-pinned random-access bytes."""

    url: str
    length: int

    def read(self, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def read_all(self) -> bytes:
        return self.read(0, self.length)

    def key(self) -> tuple:
        """The source's content-identity tuple (file_key shape)."""
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class LocalByteSource(ByteSource):
    """A plain local file behind the ByteSource interface."""

    def __init__(self, path: str):
        self.url = path
        st = os.stat(path)
        self.length = st.st_size
        self._key = (os.path.abspath(path), st.st_size, st.st_mtime_ns)
        self._fh = open(path, "rb")
        self._lock = threading.Lock()

    def read(self, offset: int, size: int) -> bytes:
        with self._lock:
            self._fh.seek(offset)
            return self._fh.read(max(0, size))

    def key(self) -> tuple:
        return self._key

    def close(self) -> None:
        self._fh.close()


class HttpByteSource(ByteSource):
    """HTTP Range reads with a sparse block cache and read-ahead.

    Identity is pinned at construction (one HEAD); every ranged
    response is validated against it — a drifted ETag/Last-Modified
    raises :class:`StaleRemoteInput` instead of mixing versions.
    Reads are served from a bounded LRU of block-aligned cache
    entries; a miss fetches the missing block PLUS up to
    ``GOLEFT_TPU_FETCH_READAHEAD`` following blocks in one coalesced
    Range request (sequential scans pay ~1 round trip per
    ``(1 + readahead) × block`` bytes)."""

    def __init__(self, url: str):
        self.url = url
        self._resolved = resolve_url(url)
        self.length, self.token = _probe_identity(url)
        self._block = _block_size()
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    # identity ----------------------------------------------------

    def key(self) -> tuple:
        return (self.url, self.length, self.token)

    def _validate(self, headers) -> None:
        observed = _identity_token(headers)
        if self.token and observed and observed != self.token:
            get_registry().counter("fetch.stale_total").inc()
            invalidate_identity(self.url)
            raise StaleRemoteInput(self.url, self.token, observed)

    # transport ---------------------------------------------------

    def _fetch_range(self, start: int, stop: int) -> bytes:
        """[start, stop) via one Range request (one retried Step)."""
        url = self.url

        def ranged():
            reg = get_registry()
            status, headers, body = _http_roundtrip(
                self._resolved, "GET",
                {"Range": f"bytes={start}-{stop - 1}"})
            self._validate(headers)
            if status == 200:
                # server ignored Range: slice the full body (legal
                # per RFC 7233 — correctness first, efficiency lost)
                body = body[start:stop]
            elif status == 206:
                cr = headers.get("Content-Range", "")
                if cr.startswith("bytes ") and "-" in cr:
                    try:
                        got = int(cr[6:].split("-", 1)[0])
                    except ValueError:
                        got = start
                    if got != start:
                        raise OSError(
                            f"Content-Range start {got} != requested "
                            f"{start} for {url}")
            if len(body) != stop - start:
                raise OSError(
                    f"short range read for {url}: wanted "
                    f"{stop - start} bytes [{start},{stop}), got "
                    f"{len(body)}")
            reg.counter("fetch.bytes_total").inc(len(body))
            return body

        return _fetch_step(
            url, ("fetch", url, self.token, start, stop), ranged,
            "range")

    # block cache -------------------------------------------------

    def _get_block(self, idx: int) -> bytes:
        reg = get_registry()
        with self._lock:
            hit = self._cache.get(idx)
            if hit is not None:
                self._cache.move_to_end(idx)
                reg.counter("fetch.block_cache_hits_total").inc()
                return hit
        reg.counter("fetch.block_cache_misses_total").inc()
        # coalesce the miss with read-ahead over blocks not yet cached
        last = min(idx + _readahead_blocks(),
                   max(idx, (self.length - 1) // self._block))
        with self._lock:
            while last > idx and (last in self._cache):
                last -= 1
        start = idx * self._block
        stop = min((last + 1) * self._block, self.length)
        data = self._fetch_range(start, stop)
        if last > idx:
            reg.counter("fetch.readahead_blocks_total").inc(last - idx)
        out = None
        with self._lock:
            for b in range(idx, last + 1):
                lo = (b - idx) * self._block
                chunk = data[lo:lo + self._block]
                if b == idx:
                    out = chunk
                self._cache[b] = chunk
                self._cache.move_to_end(b)
            while len(self._cache) > CACHE_BLOCKS:
                self._cache.popitem(last=False)
        return out

    # reads -------------------------------------------------------

    def read(self, offset: int, size: int) -> bytes:
        if size <= 0 or offset >= self.length:
            return b""
        stop = min(offset + size, self.length)
        first = offset // self._block
        last = (stop - 1) // self._block
        parts = []
        for b in range(first, last + 1):
            blk = self._get_block(b)
            lo = max(0, offset - b * self._block)
            hi = min(len(blk), stop - b * self._block)
            parts.append(blk[lo:hi])
        return b"".join(parts)

    def read_all(self) -> bytes:
        with span("fetch.read_all", url=self.url, bytes=self.length):
            return self.read(0, self.length)

    def close(self) -> None:
        with self._lock:
            self._cache.clear()


def open_source(path: str) -> ByteSource:
    """A ByteSource for a path or URL — the one constructor the io
    layer calls."""
    if is_remote(path):
        return HttpByteSource(path)
    return LocalByteSource(path)


def fetch_bytes(path: str) -> bytes:
    """The whole object's bytes (path or URL) — the drop-in for
    ``open(path, 'rb').read()`` at whole-file call sites."""
    if not is_remote(path):
        with open(path, "rb") as fh:
            return fh.read()
    with open_source(path) as src:
        return src.read_all()


def read_range(path: str, offset: int, size: int) -> bytes:
    """``[offset, offset+size)`` of a path or URL (short at EOF)."""
    if not is_remote(path):
        with open(path, "rb") as fh:
            fh.seek(offset)
            return fh.read(max(0, size))
    with open_source(path) as src:
        return src.read(offset, size)


class _SourceIO(_io.RawIOBase):
    """A seekable read-only file object over a ByteSource — what
    FASTA random access (``Faidx``) holds instead of an open file."""

    def __init__(self, src: ByteSource):
        self._src = src
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        elif whence == 2:
            self._pos = self._src.length + offset
        else:
            raise ValueError(f"bad whence {whence}")
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            size = max(0, self._src.length - self._pos)
        data = self._src.read(self._pos, size)
        self._pos += len(data)
        return data

    def close(self) -> None:
        self._src.close()
        super().close()


def source_io(path: str):
    """A binary file-like for a path or URL (remote: block-cached
    ranged reads behind a seekable wrapper)."""
    if is_remote(path):
        return _SourceIO(open_source(path))
    return open(path, "rb")
