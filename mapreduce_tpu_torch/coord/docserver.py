"""Networked control plane: the docstore served over HTTP (port of
``mapreduce_tpu/coord/docserver.py``).

The reference's whole deployment story is "point any worker on any
machine at one connstr" — mongod is reachable over TCP (cnn.lua:34-39,
worker.lua:20-27).  A :class:`DocServer` owns a single authoritative
:class:`~.docstore.MemoryDocStore` (or a durable ``dir://ROOT``
:class:`~.docstore.DirDocStore`) and speaks a tiny JSON-RPC over HTTP;
:class:`HttpDocStore` is the client-side :class:`~.docstore.DocStore`
behind the ``http://HOST:PORT`` connstr.  The wire is the JAX
package's byte for byte — RPC bodies, request ids, status codes,
headers, ``/metrics`` text — so either package's client talks to the
other's server.

Atomicity: every RPC executes under the backing store's lock on the
server, so ``find_and_modify`` claims and ``$inc`` retries keep exactly
the single-document atomicity the in-process backends give.

Retry safety: a broken socket mid-request leaves the client unsure
whether the server applied the op.  Mutating RPCs therefore carry a
client-generated request id (``SESSION:SEQ``); the server remembers
recently answered ids and replays the recorded response instead of
re-applying — exactly-once across any number of reconnect retries.  The
remembered-answer cache is bounded (``_DEDUPE_CAP``); a retry that
straggles in *after* its entry was evicted is refused with
:class:`DedupeEvictedError` rather than silently re-applied — the
monotonic per-session seq tells that straggler from a fresh request.

Left out for now: the replicated board (``--ha-*``, 421 answers, ROADMAP
A.4b-2), the scheduler's ``/tasks`` (A.4c), and ``/statusz``,
``/queryz`` and ``/alertz`` (A.8): those paths answer 404 naming the
item that brings them.
"""

from __future__ import annotations

import collections
import contextlib
import http.server
import itertools
import json
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs import metrics as _metrics
from ..obs.collector import Collector
from ..obs.statusz import update_board_gauges
from ..obs.trace import TRACE_HEADER, TRACER
from ..utils.httpclient import (
    NOT_PRIMARY_STATUS, FailoverClient, NotPrimaryError, RetryPolicy,
    check_auth, default_auth_token)
from .docstore import Doc, DocStore, MemoryDocStore, Query

_REQUESTS = _metrics.counter(
    "mrtpu_docserver_requests_total",
    "docserver RPCs served (labels: op, outcome=ok|error|replayed|"
    "evicted|unauthorized|bad_request)")
_RPC_SECONDS = _metrics.histogram(
    "mrtpu_docserver_rpc_seconds",
    "docserver RPC execution latency (labels: op)")
_DEDUPE_HITS = _metrics.counter(
    "mrtpu_docserver_dedupe_hits_total",
    "mutating RPC retries answered from the dedupe cache")
_DEDUPE_EVICTED = _metrics.counter(
    "mrtpu_docserver_dedupe_evicted_total",
    "straggler retries refused because their dedupe entry was evicted")
_SCRAPES = _metrics.counter(
    "mrtpu_docserver_scrapes_total",
    "GET requests to the exposition endpoints (labels: path)")

# ops whose second application would change state: answered once, replayed
# from the dedupe cache on retry.  Reads re-execute harmlessly.
_MUTATING_OPS = frozenset(
    {"insert", "insert_many", "update", "find_and_modify",
     "find_and_modify_many", "remove", "drop_collection"})

_DEDUPE_CAP = 4096   # answered-request ids remembered per server
_SESSION_CAP = 1024  # per-client eviction watermarks remembered

#: JAX docserver paths the port does not serve yet, each with the
#: ROADMAP item that brings it (answered 404, the body names it)
NOT_PORTED = {
    "/tasks": "the multi-tenant scheduler surface (ROADMAP A.4c)",
    "/statusz": "the cluster status snapshot (ROADMAP A.8)",
    "/queryz": "the durable telemetry history (ROADMAP A.8)",
    "/alertz": "the alerting plane (ROADMAP A.8)",
}


class DedupeEvictedError(IOError):
    """A mutating RPC's retry arrived after its dedupe entry was evicted:
    the server can no longer tell whether the original applied, so it
    refuses to re-apply and the client must surface the ambiguity instead
    of silently double-claiming / double-counting."""


def _rid_session_seq(rid: str) -> Tuple[Optional[str], Optional[int]]:
    """Split a ``SESSION:SEQ`` rid; (None, None) for legacy opaque rids
    (no eviction detection possible for those)."""
    session, sep, seq = rid.rpartition(":")
    if not sep:
        return None, None
    try:
        return session, int(seq)
    except ValueError:
        return None, None


class _RpcHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # status line / headers and body leave in separate writes on an
    # unbuffered socket; with Nagle on, the body write stalls ~40ms per
    # keep-alive request waiting for the client's delayed ACK
    disable_nagle_algorithm = True
    store: DocStore            # set by DocServer
    done: "collections.OrderedDict[str, bytes]"   # rid -> recorded response
    inflight: Dict[str, threading.Event]          # rid -> original executing
    evicted: "collections.OrderedDict[str, int]"  # session -> max evicted seq
    dedupe_lock: threading.Lock
    auth_token: Optional[str]  # None = open server
    collector: Collector       # cluster telemetry sink (obs/collector)

    def log_message(self, *a):  # quiet
        pass

    def _respond(self, code: int, body: bytes,
                 ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _not_ported(self, path: str) -> None:
        self._respond(404, json.dumps(
            {"ok": False, "type": "NotImplementedError",
             "error": f"{path}: {NOT_PORTED[path]} is not ported to "
                      "mapreduce_tpu_torch yet"}).encode())

    def do_POST(self) -> None:
        if self.path == "/telemetry":
            return self._do_telemetry()
        length = int(self.headers.get("Content-Length", 0))
        if self.path in NOT_PORTED:
            self.rfile.read(length)
            return self._not_ported(self.path)
        if self.path != "/rpc":
            self.rfile.read(length)
            return self._respond(404, b"{}")
        if not check_auth(self.auth_token, self.headers):
            # drain the body first so the keep-alive stream stays in sync
            self.rfile.read(length)
            _REQUESTS.inc(op="-", outcome="unauthorized")
            return self._respond(401, json.dumps(
                {"ok": False, "type": "PermissionError",
                 "error": "auth required (bad or missing bearer token)"}
            ).encode())
        try:
            req = json.loads(self.rfile.read(length))
            op = req["op"]
        except (json.JSONDecodeError, KeyError, UnicodeDecodeError,
                TypeError):  # TypeError: valid JSON that isn't an object
            _REQUESTS.inc(op="-", outcome="bad_request")
            return self._respond(400, b"{}")

        rid = req.get("rid") if op in _MUTATING_OPS else None
        if rid is not None:
            answered = self._claim_rid(rid, op)
            if answered is not None:
                return self._respond(200, answered)

        body = None
        t_exec = time.monotonic()
        try:
            try:
                # adopt the caller's span (TRACE_HEADER) so this RPC's
                # span nests under the client-side job/claim trace
                with TRACER.adopt(self.headers.get(TRACE_HEADER)), \
                        TRACER.span(f"rpc:{op}", coll=req.get("coll")):
                    result = self._execute(op, req)
                body = json.dumps({"ok": True, "result": result}).encode()
                _REQUESTS.inc(op=op, outcome="ok")
            except Exception as exc:
                # catch EVERYTHING: a reserved rid must always get a
                # recorded response, or the client's reconnect-retry
                # would re-execute a mutation whose first attempt
                # partially applied (e.g. ENOSPC mid-multi-update on a
                # dir:// board)
                body = json.dumps(
                    {"ok": False, "type": type(exc).__name__,
                     "error": str(exc)}).encode()
                _REQUESTS.inc(op=op, outcome="error")
        finally:
            _RPC_SECONDS.observe(time.monotonic() - t_exec, op=op)
            if rid is not None:
                self._record_rid(rid, body)
        self._respond(200, body)

    # -- rid dedupe ---------------------------------------------------------

    def _claim_rid(self, rid: str, op: str) -> Optional[bytes]:
        """Reserve *rid* for execution, or return the bytes to answer a
        duplicate with.  None means the caller executes and MUST call
        :meth:`_record_rid` (its finally block) so waiters resolve.

        A retry can arrive while the original is STILL executing (the
        server thread serving the broken socket may not have finished):
        reserving the rid before executing makes the duplicate wait for
        the recorded response instead of re-applying."""
        with self.dedupe_lock:
            replay = self.done.get(rid)
            waiter = None if replay is not None else self.inflight.get(rid)
            stale = False
            if replay is None and waiter is None:
                session, seq = _rid_session_seq(rid)
                if (session is not None and seq is not None
                        and seq <= self.evicted.get(session, -1)):
                    # straggling retry of an EVICTED entry: whether the
                    # original applied is unknowable — refuse loudly
                    stale = True
                else:
                    self.inflight[rid] = threading.Event()
        if stale:
            _DEDUPE_EVICTED.inc()
            _REQUESTS.inc(op=op, outcome="evicted")
            return json.dumps(
                {"ok": False, "type": "DedupeEvictedError",
                 "error": f"rid {rid}: retry arrived after its dedupe "
                          "entry was evicted; cannot guarantee "
                          "exactly-once"}).encode()
        if replay is not None:
            _DEDUPE_HITS.inc()
            _REQUESTS.inc(op=op, outcome="replayed")
            return replay
        if waiter is not None:
            waiter.wait(timeout=60)
            with self.dedupe_lock:
                replay = self.done.get(rid)
            if replay is None:  # original died without recording
                replay = json.dumps(
                    {"ok": False, "type": "IOError",
                     "error": "retried rpc: original did not complete"}
                ).encode()
                _REQUESTS.inc(op=op, outcome="error")
            else:
                _DEDUPE_HITS.inc()
                _REQUESTS.inc(op=op, outcome="replayed")
            return replay
        return None

    def _record_rid(self, rid: str, body: Optional[bytes]) -> None:
        with self.dedupe_lock:
            ev = self.inflight.pop(rid, None)
            if body is not None:  # BaseException: leave unrecorded
                self._remember_locked(rid, body)
        if ev is not None:
            ev.set()

    @classmethod
    def _remember_locked(cls, rid: str, body: bytes) -> None:
        """Insert one answered rid into the dedupe cache (dedupe_lock
        HELD), evicting the oldest past the cap into the per-session
        high-water marks — seqs are monotonic per session, so max ==
        newest evicted."""
        cls.done[rid] = body
        while len(cls.done) > _DEDUPE_CAP:
            old_rid, _ = cls.done.popitem(last=False)
            s, q = _rid_session_seq(old_rid)
            if s is not None and q is not None:
                cls.evicted[s] = max(q, cls.evicted.get(s, -1))
                cls.evicted.move_to_end(s)
                while len(cls.evicted) > _SESSION_CAP:
                    cls.evicted.popitem(last=False)

    # -- the telemetry sink -------------------------------------------------

    def _do_telemetry(self) -> None:
        """The collector's push sink: workers/servers POST span batches +
        metric snapshots here (obs/collector.TelemetryPusher).  Auth-
        gated like /rpc; ingestion failures answer 4xx/5xx and never
        kill the handler thread."""
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not check_auth(self.auth_token, self.headers):
            return self._respond(401, b"{}")
        try:
            payload = json.loads(body)
            if not isinstance(payload, dict):
                raise ValueError("telemetry payload is not an object")
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError):
            return self._respond(400, b"{}")
        try:
            ack = self.collector.push(payload, nbytes=len(body))
        except Exception as exc:
            return self._respond(500, json.dumps(
                {"error": f"{type(exc).__name__}: {exc}"}).encode())
        self._respond(200, json.dumps({"ok": True, **ack}).encode())

    def do_GET(self) -> None:
        """Exposition plane: ``/metrics`` (Prometheus text over the
        process-global registry, with the job-board depth gauges
        refreshed at scrape time), ``/tracez`` (this process's span ring
        as Chrome trace JSON), ``/clusterz`` (the MERGED cluster
        timeline: every pushed process's spans clock-aligned with this
        process's) and ``/healthz``.  Everything but /healthz is
        auth-gated like the RPC plane; /healthz is open — it returns a
        static liveness body, and orchestrator probes cannot send a
        bearer token."""
        path = self.path.partition("?")[0]
        if path == "/healthz":
            _SCRAPES.inc(path=path)
            return self._respond(200, b'{"ok": true}')
        if path in NOT_PORTED:
            return self._not_ported(path)
        if path not in ("/metrics", "/tracez", "/clusterz"):
            return self._respond(404, b"{}")
        if not check_auth(self.auth_token, self.headers):
            return self._respond(401, b"{}")
        _SCRAPES.inc(path=path)
        try:
            if path == "/metrics":
                update_board_gauges(self.store)
                body = _metrics.REGISTRY.render().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/tracez":
                body = json.dumps(TRACER.chrome_trace()).encode()
                ctype = "application/json"
            else:
                body = json.dumps(self.collector.cluster_doc(),
                                  default=float).encode()
                ctype = "application/json"
        except Exception as exc:
            # a scrape must never kill the handler thread; the scraper
            # sees the failure as a 500, not a hung socket
            return self._respond(500, json.dumps(
                {"error": f"{type(exc).__name__}: {exc}"}).encode())
        self._respond(200, body, ctype=ctype)

    def _execute(self, op: str, req: Dict[str, Any]) -> Any:
        store = self.store
        coll = req.get("coll")
        if op == "insert":
            return store.insert(coll, req["doc"])
        if op == "insert_many":
            return store.insert_many(coll, req["docs"])
        if op == "find":
            return store.find(coll, req.get("query"))
        if op == "count":
            return store.count(coll, req.get("query"))
        if op == "update":
            return store.update(coll, req["query"], req["update"],
                                multi=bool(req.get("multi")),
                                upsert=bool(req.get("upsert")))
        if op == "find_and_modify":
            return store.find_and_modify(coll, req["query"], req["update"])
        if op == "find_and_modify_many":
            # the batched claim: one rid-deduped round trip claims up to
            # `limit` jobs (Task.take_next_jobs)
            return store.find_and_modify_many(coll, req["query"],
                                              req["update"],
                                              int(req.get("limit", 1)))
        if op == "remove":
            return store.remove(coll, req.get("query"))
        if op == "drop_collection":
            store.drop_collection(coll)
            return None
        if op == "collections":
            return store.collections()
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown rpc op {op!r}")


class DocServer:
    """Serve a DocStore over HTTP (threaded, stdlib) — the mongod role.

    Wraps a :class:`MemoryDocStore` by default (authoritative state lives
    in this process; its lock makes each RPC atomic); pass a
    ``DirDocStore`` to make the board durable across server restarts the
    way mongod's disk was.  ``port=0`` binds a free port
    (:attr:`port` holds it).
    """

    def __init__(self, store: Optional[DocStore] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 auth_token: Optional[str] = None) -> None:
        handler = type("BoundRpcHandler", (_RpcHandler,), {
            "store": store if store is not None else MemoryDocStore(),
            "done": collections.OrderedDict(),
            "inflight": {},
            "evicted": collections.OrderedDict(),
            "dedupe_lock": threading.Lock(),
            "auth_token": default_auth_token(auth_token),
            "collector": Collector(local_role="server"),
        })
        self.store = handler.store
        self.collector = handler.collector
        self.httpd = http.server.ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def connstr(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start_background(self) -> "DocServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        """Stop serving and close the listening socket."""
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=10)
        self.httpd.server_close()


class HttpDocStore(DocStore):
    """Client DocStore over a :class:`DocServer` (``http://HOST:PORT``;
    several comma-separated endpoints make a :class:`FailoverClient`
    rotate between them).

    One keep-alive connection per endpoint, serialized by a lock (a
    worker's claim loop and its heartbeat thread share the handle);
    re-established on a broken socket under the client's
    :class:`RetryPolicy`, with the request id making every re-send
    exactly-once for mutating ops.  The rid is ``SESSION:SEQ`` — a
    per-handle session plus a monotonic sequence — so the server can
    tell a straggling retry of an *evicted* dedupe entry from a fresh
    request and fail it loudly instead of silently re-applying.
    """

    def __init__(self, address: str,
                 auth_token: Optional[str] = None,
                 retry: Optional[RetryPolicy] = None) -> None:
        self._client = FailoverClient(
            address, what="http docstore", auth_token=auth_token,
            retry=retry)
        self._rid_session = uuid.uuid4().hex
        self._rid_seq = itertools.count(1)
        # serializes rid allocation WITH the send: the eviction watermark
        # assumes this session's seqs arrive in order, so two threads
        # sharing the handle (claim loop + heartbeat) must not allocate
        # seqs in one order and win the client's send lock in the other
        self._mutate_lock = threading.Lock()

    # the ACTIVE endpoint's coordinates (rotates under failover)
    @property
    def host(self) -> str:
        return self._client.host

    @property
    def port(self) -> int:
        return self._client.port

    def _rpc(self, op: str, **fields: Any) -> Any:
        payload: Dict[str, Any] = {"op": op, **fields}
        mutating = op in _MUTATING_OPS
        with self._mutate_lock if mutating else contextlib.nullcontext():
            if mutating:
                payload["rid"] = (f"{self._rid_session}:"
                                  f"{next(self._rid_seq)}")
            status, raw = self._client.request(
                "POST", "/rpc", body=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
        if status == 401:
            raise PermissionError(
                f"docstore rpc {op!r}: auth rejected by "
                f"{self.host}:{self.port} (set $MAPREDUCE_TPU_AUTH or "
                "pass auth to Connection)")
        if status == NOT_PRIMARY_STATUS:
            # a standby replica of a replicated board
            raise NotPrimaryError(
                f"docstore rpc {op!r}: {self.host}:{self.port} is a "
                "standby board replica — pass every replica in the "
                "connstr (http://H1:P1,H2:P2) to fail over")
        if status != 200:
            raise IOError(f"docstore rpc {op!r}: HTTP {status}")
        reply = json.loads(raw)
        if not reply.get("ok"):
            exc_type = {"ValueError": ValueError, "KeyError": KeyError,
                        "TypeError": TypeError,
                        "PermissionError": PermissionError,
                        "DedupeEvictedError": DedupeEvictedError,
                        "NotPrimaryError": NotPrimaryError,
                        }.get(reply.get("type"), IOError)
            raise exc_type(reply.get("error", "rpc failed"))
        return reply["result"]

    # -- DocStore interface ------------------------------------------------

    def insert(self, coll: str, doc: Doc) -> str:
        return self._rpc("insert", coll=coll, doc=doc)

    def insert_many(self, coll: str, docs: List[Doc]) -> List[str]:
        return self._rpc("insert_many", coll=coll, docs=docs)

    def find(self, coll: str, query: Optional[Query] = None) -> List[Doc]:
        return self._rpc("find", coll=coll, query=query)

    def count(self, coll: str, query: Optional[Query] = None) -> int:
        return self._rpc("count", coll=coll, query=query)

    def update(self, coll: str, query: Query, update: Doc,
               multi: bool = False, upsert: bool = False) -> int:
        return self._rpc("update", coll=coll, query=query, update=update,
                         multi=multi, upsert=upsert)

    def find_and_modify(self, coll: str, query: Query, update: Doc,
                        sort_key: Optional[Callable[[Doc], Any]] = None,
                        ) -> Optional[Doc]:
        if sort_key is not None:
            # callables don't cross the wire; no framework caller passes one
            raise NotImplementedError(
                "HttpDocStore.find_and_modify does not support sort_key")
        return self._rpc("find_and_modify", coll=coll, query=query,
                         update=update)

    def find_and_modify_many(self, coll: str, query: Query, update: Doc,
                             limit: int = 1) -> List[Doc]:
        return self._rpc("find_and_modify_many", coll=coll, query=query,
                         update=update, limit=int(limit))

    def remove(self, coll: str, query: Optional[Query] = None) -> int:
        return self._rpc("remove", coll=coll, query=query)

    def drop_collection(self, coll: str) -> None:
        self._rpc("drop_collection", coll=coll)

    def collections(self) -> List[str]:
        return self._rpc("collections")

    def ping(self) -> bool:
        return self._rpc("ping") == "pong"

    # -- exposition plane ---------------------------------------------------

    def _get(self, path: str) -> bytes:
        status, raw = self._client.request("GET", path)
        if status == 401:
            raise PermissionError(f"{path[1:]}: auth rejected")
        if status != 200:
            raise IOError(f"{path[1:]}: HTTP {status}")
        return raw

    def metrics_text(self) -> str:
        """Fetch the server's /metrics Prometheus exposition."""
        return self._get("/metrics").decode()

    def tracez(self) -> Dict[str, Any]:
        """Fetch the server's /tracez Chrome trace snapshot."""
        return json.loads(self._get("/tracez"))

    def clusterz(self) -> Dict[str, Any]:
        """Fetch the server's /clusterz merged cluster timeline."""
        return json.loads(self._get("/clusterz"))

    def close(self) -> None:
        self._client.close()
