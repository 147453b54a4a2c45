"""HTTP object-store backend: storage that spans hosts with no shared fs
(port of ``mapreduce_tpu/storage/httpstore.py``; the blob protocol and
its gzip negotiation are the JAX package's byte for byte, so either
package's client reads and writes the other's server).

The third backend class the reference supports through ``sshfs`` —
map output written locally, pulled across machines with ``scp -CB``
(fs.lua:141-181) — rebuilt as the topology modern clusters actually use:
one central blob service (the role mongod+GridFS plays for the
reference's default backend) that every server/worker reaches over HTTP.
Plain stdlib on both sides; no ssh keys, no NFS mount.

* :class:`BlobServer` — a threading HTTP server over a
  :class:`LocalDirStorage` root: PUT stages + atomically publishes,
  GET streams, DELETE removes, ``/list`` enumerates.  Start one with
  ``python -m mapreduce_tpu_torch.cli blobserver DIR --port N``.
* :class:`HttpStorage` — the client ``Storage``; DSL
  ``"http:HOST:PORT"``.  Atomicity holds because the server publishes
  via tempfile+rename exactly like the shared backend.

Data-plane performance (the reference's whole published perf story is
this path — scp's ``-C`` flag compressed it; we negotiate the same win):

* the client rides a :class:`~..utils.httpclient.KeepAlivePool`, so a
  map job's per-partition PUTs and a reduce merge's Range-GETs overlap
  on the wire instead of queueing behind one socket;
* ``open_lines`` double-buffers: while the caller consumes chunk *k*,
  chunk *k+1*'s Range-GET is already in flight;
* gzip is content-negotiated per direction.  The server advertises
  support with an ``X-Mrtpu-Gzip: 1`` response header; a client that has
  seen the advertisement gzips PUT bodies (``Content-Encoding: gzip``)
  and asks for gzipped full GETs (``Accept-Encoding: gzip``).  Range
  GETs stay identity — their offsets address the STORED bytes.  Either
  side missing the feature degrades to identity transfers: an old
  client never sends the headers, an old server never advertises, so
  new<->old interops in both directions.
"""

from __future__ import annotations

import concurrent.futures
import gzip
import http.server
import os
import threading
import urllib.parse
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from ..obs import metrics as _metrics
from ..obs.metrics import storage_io, storage_op
from ..utils.httpclient import (
    DEFAULT_POOL_SIZE, KeepAlivePool, RetryPolicy, blob_policy, check_auth,
    default_auth_token)
from .base import Storage
from .localdir import LocalDirStorage

#: response header a gzip-capable BlobServer stamps on every reply; a
#: client remembers seeing it and starts compressing PUTs / requesting
#: compressed GETs from then on (its very first request is identity —
#: the one probe the negotiation costs).
GZIP_ADVERT = "X-Mrtpu-Gzip"

#: bodies below this aren't worth the gzip header + CPU.
GZIP_MIN_BYTES = 512

#: env switch: set to "0" to force identity transfers everywhere
#: (client side); the BlobServer side is the ``gzip_enabled`` ctor arg.
GZIP_ENV = "MAPREDUCE_TPU_GZIP"

_WIRE_BYTES = _metrics.counter(
    "mrtpu_blob_wire_bytes_total",
    "bytes actually moved over the blob plane's wire, after content "
    "negotiation (labels: direction=put|get, encoding=gzip|identity)")
_RAW_BYTES = _metrics.counter(
    "mrtpu_blob_raw_bytes_total",
    "payload bytes before compression / after decompression on the blob "
    "plane (labels: direction, encoding) — compare against "
    "mrtpu_blob_wire_bytes_total for the negotiated compression ratio")


def _count_xfer(direction: str, raw: int, wire: int, gzipped: bool) -> None:
    enc = "gzip" if gzipped else "identity"
    _RAW_BYTES.inc(raw, direction=direction, encoding=enc)
    _WIRE_BYTES.inc(wire, direction=direction, encoding=enc)


def _gzip_on() -> bool:
    return os.environ.get(GZIP_ENV, "1") != "0"


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    store: LocalDirStorage  # set by BlobServer
    auth_token: Optional[str]  # None = open server
    gzip_enabled: bool = True  # False emulates a pre-negotiation server

    def log_message(self, *a):  # quiet
        pass

    def _authed(self, body_length: int = 0) -> bool:
        """Bearer-token gate (httpclient.check_auth); drains *body_length*
        request bytes on rejection so the keep-alive stream stays usable."""
        if check_auth(self.auth_token, self.headers):
            return True
        if body_length:
            self.rfile.read(body_length)
        self._respond(401)
        return False

    def _name(self) -> Optional[str]:
        if not self.path.startswith("/blobs/"):
            return None
        return urllib.parse.unquote(self.path[len("/blobs/"):])

    def _send_head(self, code: int, length: int,
                   extra: Optional[Dict[str, str]] = None) -> None:
        self.send_response(code)
        if self.gzip_enabled:
            self.send_header(GZIP_ADVERT, "1")
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(length))
        self.end_headers()

    def _respond(self, code: int, body: bytes = b"",
                 extra: Optional[Dict[str, str]] = None) -> None:
        self._send_head(code, len(body), extra)
        self.wfile.write(body)

    def _respond_negotiated(self, body: bytes) -> None:
        """Full-content 200: gzip when the client asked and it pays."""
        if (self.gzip_enabled and len(body) >= GZIP_MIN_BYTES
                and "gzip" in self.headers.get("Accept-Encoding", "")):
            return self._respond(200, gzip.compress(body, compresslevel=1),
                                 extra={"Content-Encoding": "gzip"})
        self._respond(200, body)

    def do_GET(self) -> None:
        if not self._authed():
            return
        if self.path == "/list":
            # names are quoted per line: arbitrary blob names (including
            # embedded newlines) must round-trip like the other backends
            body = "\n".join(urllib.parse.quote(n, safe="")
                             for n in self.store.list()).encode()
            return self._respond_negotiated(body)
        name = self._name()
        if name is None:
            return self._respond(404)
        rng = self.headers.get("Range", "")
        if rng.startswith("bytes="):
            # bounded-memory slice for the client's streaming line reader;
            # published blobs are immutable so per-slice consistency
            # holds.  Always identity: the offsets address STORED bytes.
            try:
                start_s, _, end_s = rng[len("bytes="):].partition("-")
                start, end = int(start_s), int(end_s)
            except ValueError:
                return self._respond(400)
            if start < 0 or end < start:
                return self._respond(400)
            try:
                chunk = self.store.read_range(name, start, end - start + 1)
            except FileNotFoundError:
                return self._respond(404)
            return self._respond(206, chunk)
        try:  # read-then-404: no exists/read TOCTOU vs concurrent DELETE
            content = self.store.read_bytes(name)  # bytes-through: no
        except FileNotFoundError:                  # decode+re-encode copy
            return self._respond(404)
        self._respond_negotiated(content)

    def do_HEAD(self) -> None:
        if not self._authed():
            return
        name = self._name()
        code = 200 if (name is not None
                       and self.store.exists(name)) else 404
        self._send_head(code, 0)

    def do_PUT(self) -> None:
        length = int(self.headers.get("Content-Length", 0))
        if not self._authed(body_length=length):
            return
        name = self._name()
        if name is None:
            return self._respond(400)
        data = self.rfile.read(length)
        encoding = self.headers.get("Content-Encoding", "").strip().lower()
        if encoding:
            if encoding != "gzip" or not self.gzip_enabled:
                # refuse what we can't decode — a gzip-disabled server
                # storing a gzipped body VERBATIM would poison the blob
                # for every reader (the 415 also tells a client that
                # negotiated against a since-restarted server to drop
                # back to identity)
                return self._respond(415)
            try:
                data = gzip.decompress(data)
            except (OSError, EOFError, zlib.error):
                # corrupt encoding: refuse loudly — publishing garbage
                # under the blob's name would poison every reader
                return self._respond(400)
        # bytes-through: the body lands on disk as-is (blobs are utf-8
        # by contract; the old str round trip cost two full copies)
        self.store.write_bytes(name, data)  # tempfile+rename: atomic
        self._respond(201)

    def do_DELETE(self) -> None:
        if not self._authed():
            return
        name = self._name()
        if name is None:
            return self._respond(400)
        self.store.remove(name)
        self._respond(204)


class BlobServer:
    """Serve a LocalDirStorage root over HTTP (threaded, stdlib)."""

    def __init__(self, root: str, host: str = "127.0.0.1",
                 port: int = 0, auth_token: Optional[str] = None,
                 gzip_enabled: bool = True) -> None:
        handler = type("BoundHandler", (_Handler,),
                       {"store": LocalDirStorage(root),
                        "auth_token": default_auth_token(auth_token),
                        "gzip_enabled": bool(gzip_enabled)})
        self.httpd = http.server.ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start_background(self) -> "BlobServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=10)
        self.httpd.server_close()  # release the listening socket now


class HttpStorage(Storage):
    scheme = "http"

    def __init__(self, address: str,
                 auth_token: Optional[str] = None,
                 retry: Optional["RetryPolicy"] = None,
                 pool_size: Optional[int] = None,
                 compress: Optional[bool] = None) -> None:
        self._client = KeepAlivePool.from_address(
            address, what="http storage", auth_token=auth_token,
            retry=blob_policy(retry),
            size=pool_size if pool_size is not None else DEFAULT_POOL_SIZE)
        self.host, self.port = self._client.host, self._client.port
        self._compress = _gzip_on() if compress is None else bool(compress)
        #: None until a response tells us; True once the server's
        #: GZIP_ADVERT header has been seen (old servers never send it,
        #: so against one this stays falsy and every transfer is
        #: identity — the old-client-shaped traffic it expects)
        self._server_gzip: Optional[bool] = None

    def _request(self, method: str, path: str, body: Optional[bytes] = None,
                 headers: Optional[dict] = None) -> Tuple[int, bytes]:
        """The KeepAlivePool re-sends blindly under its RetryPolicy (any
        attempt may have been applied before its socket broke), which is
        safe ONLY because every mutating blob endpoint is idempotent: PUT
        publishes whole content atomically and DELETE converges.  A future
        non-idempotent endpoint must not ride this path — give it
        request-id dedupe like the docserver's mutating RPCs
        (coord/docserver.py)."""
        status, resp_headers, body_out = self._client.request_full(
            method, path, body=body, headers=headers)
        if status == 401:
            raise PermissionError(
                f"blob {method} {path}: auth rejected by "
                f"{self.host}:{self.port} (set $MAPREDUCE_TPU_AUTH or use "
                "http:TOKEN@HOST:PORT)")
        if status in (200, 201, 204, 206):
            # a definitive answer from the real server settles whether it
            # speaks gzip (fault-injected 5xx never gets here: the retry
            # loop eats it or raises)
            self._server_gzip = GZIP_ADVERT in resp_headers
        if resp_headers.get("Content-Encoding", "").lower() == "gzip":
            wire = len(body_out)
            body_out = gzip.decompress(body_out)
            _count_xfer("get", len(body_out), wire, gzipped=True)
        elif method == "GET" and status in (200, 206):
            _count_xfer("get", len(body_out), len(body_out), gzipped=False)
        return status, body_out

    def _blob_path(self, name: str) -> str:
        return "/blobs/" + urllib.parse.quote(name, safe="")

    def _publish(self, name: str, content: str) -> None:
        # str plane: the base FileBuilder counts storage_io/storage_op
        self._put_bytes(name, content.encode())

    def write_bytes(self, name: str, data: bytes) -> None:
        """Binary PUT (checkpoint shards ride this); counts its own
        ``storage_io{scheme=http}`` like the other backends' bytes
        planes — the str wrappers bypass this method, so nothing
        double-counts."""
        self._put_bytes(name, data)
        storage_io(self.scheme, "write", len(data))
        storage_op(self.scheme, "publish")

    def _put_bytes(self, name: str, data: bytes) -> None:
        """Transport: gzip-negotiated PUT; the server's bytes-through
        handler stores the body verbatim, so the str and bytes planes
        interoperate on utf-8 blobs."""
        raw = data
        data, headers = raw, None
        if (self._compress and self._server_gzip
                and len(raw) >= GZIP_MIN_BYTES):
            data = gzip.compress(raw, compresslevel=1)
            headers = {"Content-Encoding": "gzip"}
        status, _ = self._request("PUT", self._blob_path(name), data,
                                  headers=headers)
        if status == 415 and headers is not None:
            # the server stopped speaking gzip (e.g. restarted with
            # --no-gzip) since we negotiated: forget the advert and
            # re-send identity — the refusal is the negotiation signal
            self._server_gzip = False
            data, headers = raw, None
            status, _ = self._request("PUT", self._blob_path(name), data)
        if status != 201:
            raise IOError(f"blob PUT {name!r} failed: HTTP {status}")
        # counted only for PUTs that actually published — failed or
        # circuit-open sends must not inflate the compression-win counters
        _count_xfer("put", len(raw), len(data),
                    gzipped=headers is not None)

    def _accept_gzip(self) -> Optional[dict]:
        if self._compress:
            return {"Accept-Encoding": "gzip"}
        return None

    def _read(self, name: str) -> str:
        # str plane: the base read() wrapper counts storage_io
        return self._get_bytes(name).decode()

    def read_bytes(self, name: str) -> bytes:
        data = self._get_bytes(name)
        storage_io(self.scheme, "read", len(data))
        storage_op(self.scheme, "read")
        return data

    def _get_bytes(self, name: str) -> bytes:
        status, body = self._request("GET", self._blob_path(name),
                                     headers=self._accept_gzip())
        if status != 200:
            raise FileNotFoundError(f"{name!r}: HTTP {status}")
        return body

    #: Range-GET slice size for open_lines.  Memory held client-side is
    #: O(LINES_CHUNK + longest line), never the whole blob — the role of
    #: the reference's chunk-boundary-aware GridFS line iterator
    #: (utils.lua:133-200).
    LINES_CHUNK = 1 << 20

    def _open_lines(self, name: str) -> Iterator[str]:
        """Streaming line reader with a one-slice prefetch: while the
        caller consumes chunk *k*'s lines, chunk *k+1*'s Range-GET is
        already in flight on a pooled connection — the reduce merge
        never stalls on a fetch that could have overlapped the fold.
        One prefetch thread is REUSED for the blob's whole read (a
        single-worker executor), not spawned per slice."""
        chunk_size = self.LINES_CHUNK
        path = self._blob_path(name)

        def fetch(offset: int) -> Tuple[int, bytes]:
            return self._request(
                "GET", path,
                headers={"Range":
                         f"bytes={offset}-{offset + chunk_size - 1}"})

        ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        try:
            offset = 0
            inflight = ex.submit(fetch, offset)
            buf = b""
            while True:
                status, body = inflight.result()
                if status == 404:
                    raise FileNotFoundError(f"{name!r}: HTTP 404")
                if status == 200:
                    # server without Range support answered with the
                    # whole blob
                    buf, body = body, b""
                elif status != 206:
                    raise IOError(f"blob GET {name!r}: HTTP {status}")
                else:
                    buf += body
                last = status == 200 or len(body) < chunk_size
                if not last:
                    # double buffer: next slice downloads while this one
                    # is split and consumed
                    offset += chunk_size
                    inflight = ex.submit(fetch, offset)
                *lines, buf = buf.split(b"\n")
                for ln in lines:
                    if ln:
                        yield ln.decode()
                if last:
                    break
            if buf:
                yield buf.decode()
        finally:
            # an abandoned generator must not strand its worker thread
            # blocked on a queue forever
            ex.shutdown(wait=False)

    def _all_names(self) -> List[str]:
        status, body = self._request("GET", "/list",
                                     headers=self._accept_gzip())
        if status != 200:
            raise IOError(f"blob list failed: HTTP {status}")
        return [urllib.parse.unquote(n)
                for n in body.decode().split("\n") if n]

    def exists(self, name: str) -> bool:
        status, _ = self._request("HEAD", self._blob_path(name))
        return status == 200

    def remove(self, name: str) -> None:
        self._request("DELETE", self._blob_path(name))

    def close(self) -> None:
        self._client.close()
