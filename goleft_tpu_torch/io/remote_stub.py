"""A stdlib HTTP object store for testing the remote data plane.

Just enough of an S3/htsget-shaped server to exercise every contract
:mod:`goleft_tpu_torch.io.remote` depends on, with zero dependencies:

  - ``HEAD /name`` → 200 + ``Content-Length`` + ``ETag``
  - ``GET /name`` with ``Range: bytes=a-b`` → 206 + ``Content-Range``
    (or 200 full-body without a Range header)
  - strong ETags derived from content (sha256 prefix), so a mutated
    object *is* a new identity
  - deterministic fault injection: ``fail(name, times=N, status=S)``
    makes the next N requests for that object answer ``S`` — 503 for
    transient-retry legs, 403 for permanent ones
  - deterministic drift: ``flip_after(name, n, new_data)`` swaps the
    object's content (and therefore its ETag) once ``n`` requests
    have touched it — the mid-run ETag-drift scenario, no timing
    races
  - ``ignore_range(name)`` answers 200 full-body to Range requests
    (a server that ignores Range is legal per RFC 7233; the client
    must still produce correct bytes)

:class:`StubServer` is the harness: a context manager that binds a
loopback port and yields URLs. A copy of the JAX package's
io/remote_stub.py, used by the tests and the ``torch_remote_fetch``
bench entry; run directly it serves a directory::

    python -m goleft_tpu_torch.io.remote_stub [--dir D] [--port P]
"""

from __future__ import annotations

import argparse
import hashlib
import http.server
import os
import re
import sys
import threading

_RANGE_RE = re.compile(r"bytes=(\d+)-(\d*)$")


def _etag(data: bytes) -> str:
    return '"' + hashlib.sha256(data).hexdigest()[:16] + '"'


class ObjectStore:
    """The in-memory bucket: named blobs + per-name behaviors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objects: dict = {}
        self._faults: dict = {}
        self._flips: dict = {}
        self._ignore_range: set = set()
        self.request_counts: dict = {}

    def put(self, name: str, data: bytes) -> None:
        with self._lock:
            self._objects[name] = bytes(data)

    def delete(self, name: str) -> None:
        with self._lock:
            self._objects.pop(name, None)

    def etag(self, name: str) -> str:
        with self._lock:
            return _etag(self._objects[name])

    def fail(self, name: str, times: int = 1,
             status: int = 503) -> None:
        """The next ``times`` requests touching ``name`` answer
        ``status`` (then behavior reverts)."""
        with self._lock:
            self._faults[name] = [times, status]

    def flip_after(self, name: str, n: int, new_data: bytes) -> None:
        """Swap ``name``'s content (→ new ETag) once its request
        count reaches ``n`` — deterministic mid-run drift."""
        with self._lock:
            self._flips[name] = [n, bytes(new_data)]

    def ignore_range(self, name: str) -> None:
        with self._lock:
            self._ignore_range.add(name)

    # ---- the handler's one entry point ----

    def serve(self, name: str):
        """(status, data-or-None, etag, ranged) for one request —
        applies fault/flip bookkeeping under the lock."""
        with self._lock:
            count = self.request_counts.get(name, 0) + 1
            self.request_counts[name] = count
            fault = self._faults.get(name)
            if fault is not None and fault[0] > 0:
                fault[0] -= 1
                if fault[0] <= 0:
                    del self._faults[name]
                return fault[1], None, "", False
            flip = self._flips.get(name)
            if flip is not None and count >= flip[0]:
                self._objects[name] = flip[1]
                del self._flips[name]
            data = self._objects.get(name)
            if data is None:
                return 404, None, "", False
            return (200, data, _etag(data),
                    name not in self._ignore_range)


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    store: ObjectStore = None  # bound per-server subclass

    def log_message(self, *a):  # quiet: tests read stdout
        pass

    def _name(self) -> str:
        return self.path.lstrip("/").split("?", 1)[0]

    def _answer(self, head_only: bool) -> None:
        status, data, etag, ranged = self.store.serve(self._name())
        if data is None:
            self.send_response(status)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        rng = self.headers.get("Range")
        m = _RANGE_RE.match(rng.strip()) if rng and ranged else None
        if not head_only and m:
            start = int(m.group(1))
            stop = (int(m.group(2)) + 1) if m.group(2) else len(data)
            stop = min(stop, len(data))
            if start >= len(data):
                self.send_response(416)
                self.send_header("Content-Range",
                                 f"bytes */{len(data)}")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            body = data[start:stop]
            self.send_response(206)
            self.send_header(
                "Content-Range",
                f"bytes {start}-{stop - 1}/{len(data)}")
        else:
            body = data
            self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("ETag", etag)
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()
        if not head_only:
            self.wfile.write(body)

    def do_GET(self):
        self._answer(head_only=False)

    def do_HEAD(self):
        self._answer(head_only=True)


class StubServer:
    """Loopback object store harness::

        with StubServer() as srv:
            url = srv.put("a.bam", data)   # http://127.0.0.1:PORT/a.bam
    """

    def __init__(self, store: ObjectStore | None = None,
                 port: int = 0):
        self.store = store if store is not None else ObjectStore()
        handler = type("_BoundHandler", (_Handler,),
                       {"store": self.store})
        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def put(self, name: str, data: bytes) -> str:
        self.store.put(name, data)
        return f"{self.url}/{name}"

    def start(self) -> "StubServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)

    def __enter__(self) -> "StubServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def serve_directory(directory: str, port: int = 0,
                    announce=True) -> StubServer:
    """Load every file under ``directory`` (flat) into a store and
    serve it."""
    store = ObjectStore()
    for name in sorted(os.listdir(directory)):
        p = os.path.join(directory, name)
        if os.path.isfile(p):
            with open(p, "rb") as fh:
                store.put(name, fh.read())
    srv = StubServer(store, port=port).start()
    if announce:
        print(f"remote-stub listening on {srv.url}", flush=True)
    return srv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="stdlib HTTP object store (test harness)")
    ap.add_argument("--dir", required=True,
                    help="directory whose files become objects")
    ap.add_argument("--port", type=int, default=0)
    a = ap.parse_args(argv)
    srv = serve_directory(a.dir, port=a.port)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
