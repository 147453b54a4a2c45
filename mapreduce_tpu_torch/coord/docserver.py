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

High availability (``ha_dir=``, coord/ha.py): N replicas over one
shared directory; the lease holder serves, the rest answer HTTP 421 with
the JAX body and tail the mutation log.  Under HA a rid-carrying
mutation runs as a deferred-log transaction
(:meth:`~.ha.ReplicatedDocStore.deferred_rid`): its entries and its
recorded answer reach the log in one write, so a retry that fails over
replays the answer on the promoted standby.

Every docserver hosts the multi-tenant scheduler
(:mod:`..sched.scheduler`) on its board and speaks ``/tasks``: POST
submit, cancel and tick (rid-deduped and auth-gated like ``/rpc``), GET
the task list and the scheduler snapshot.

``/statusz`` serves the JSON cluster snapshot
(:func:`..obs.statusz.cluster_status`, plus the HA section on a
replicated board): the ``status`` and ``profile`` CLIs' feed.
``/queryz`` runs range queries over the durable telemetry history
(:mod:`..obs.history`, ``history_dir=``, on ``<ha_dir>/history`` by
default) and ``/alertz`` serves (GET) and mutates (POST ``silence`` /
``ack``) the alerting plane (:mod:`..obs.alerts`), whose evaluator
thread runs every ``alert_interval`` seconds on the primary; both GETs
are served by standbys too.
"""

from __future__ import annotations

import collections
import contextlib
import http.server
import itertools
import json
import logging
import os
import threading
import time
import urllib.parse
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs import metrics as _metrics
from ..obs.collector import Collector
from ..obs.statusz import cluster_status, update_board_gauges
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

#: the GET paths this docserver serves (``/healthz`` unauthenticated)
GET_PATHS = ("/metrics", "/statusz", "/tracez", "/clusterz", "/tasks",
             "/healthz", "/queryz", "/alertz")

#: the 404 body of ``/alertz`` on a board with no alert rules
_NO_ALERTS = json.dumps(
    {"ok": False, "type": "ValueError",
     "error": "no alert rules configured (start the docserver with "
              "--alert or --alert-rules)"}).encode()


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
    scheduler: Any             # sched.Scheduler hosted on self.store
    ha: Any = None             # coord/ha.HaController when HA-deployed

    def log_message(self, *a):  # quiet
        pass

    def _not_primary(self, length: int) -> None:
        """Answer a request that needs the primary from a replica that
        is not (standby, fenced, or mid-takeover): HTTP 421, which is
        NOT in the clients' retryable-status set — a FailoverClient
        rotates to the next endpoint immediately instead of burning
        its budget here."""
        self.rfile.read(length)
        _REQUESTS.inc(op="-", outcome="not_primary")
        self._respond(NOT_PRIMARY_STATUS, json.dumps(
            {"ok": False, "type": "NotPrimaryError",
             "error": f"this board replica is {self.ha.role}; dial "
                      "the lease-holding primary"}).encode())

    def _lapsed(self) -> None:
        """421 for a request whose primacy lapsed mid-execution."""
        self._respond(NOT_PRIMARY_STATUS, json.dumps(
            {"ok": False, "type": "NotPrimaryError",
             "error": "primacy lapsed mid-request; rotate"}).encode())

    def _txn(self, rid: Optional[str]):
        """On a replicated (HA) board, a rid-carrying request runs as a
        deferred-log transaction: its mutation entries and recorded
        response reach the shared log in ONE atomic append, so a
        standby replays mutation+answer together or sees neither."""
        defer = (getattr(self.store, "deferred_rid", None)
                 if rid is not None else None)
        return defer(rid) if defer is not None \
            else contextlib.nullcontext(None)

    def _respond(self, code: int, body: bytes,
                 ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self) -> None:
        length = int(self.headers.get("Content-Length", 0))
        if self.ha is not None and not self.ha.is_primary():
            # every POST surface mutates or feeds primary-local state;
            # a replica serves none of them
            return self._not_primary(length)
        if self.path == "/telemetry":
            return self._do_telemetry()
        if self.path == "/tasks":
            return self._do_tasks()
        if self.path == "/alertz":
            return self._do_alertz()
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
        not_primary = False
        try:
            with self._txn(rid) as txn:
                try:
                    # adopt the caller's span (TRACE_HEADER) so this
                    # RPC's span nests under the client-side trace
                    with TRACER.adopt(self.headers.get(TRACE_HEADER)), \
                            TRACER.span(f"rpc:{op}",
                                        coll=req.get("coll")):
                        result = self._execute(op, req)
                    body = json.dumps({"ok": True,
                                       "result": result}).encode()
                    _REQUESTS.inc(op=op, outcome="ok")
                except NotPrimaryError:
                    # the self-fence lapsed BETWEEN the door check and
                    # the write path: 421, and NOTHING recorded for the
                    # rid — no mutation applied (the fence precedes the
                    # apply), so the failed-over re-send runs fresh
                    not_primary = True
                    _REQUESTS.inc(op=op, outcome="not_primary")
                except Exception as exc:
                    # catch EVERYTHING else: a reserved rid must always
                    # get a recorded response, or the client's
                    # reconnect-retry would re-execute a mutation whose
                    # first attempt partially applied (e.g. ENOSPC
                    # mid-multi-update on a dir:// board)
                    body = json.dumps(
                        {"ok": False, "type": type(exc).__name__,
                         "error": str(exc)}).encode()
                    _REQUESTS.inc(op=op, outcome="error")
                if txn is not None:
                    txn.body = body
        finally:
            _RPC_SECONDS.observe(time.monotonic() - t_exec, op=op)
            if rid is not None:
                # body None (not-primary) leaves the rid unrecorded:
                # waiters wake, the re-send executes on the successor
                self._record_rid(rid, body)
        if not_primary:
            return self._lapsed()
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

    # -- the HA replayer's dedupe feed (coord/ha.py, duck-typed) -----------

    @classmethod
    def remember_answer(cls, rid: str, body: bytes) -> None:
        """Seed a REPLAYED rid->response pair (a mutation the old
        primary answered): a client retry that failed over here
        replays the recorded answer instead of re-applying."""
        with cls.dedupe_lock:
            cls._remember_locked(rid, body)

    @classmethod
    def refuse_rid(cls, rid: str) -> None:
        """Mark a rid whose mutations were logged WITHOUT a recorded
        response (the old primary died mid-request): its retry is
        refused with the loud dedupe ambiguity, never re-applied.
        Rides the eviction watermark — the client allocates seqs
        monotonically and serializes mutations per handle, so the
        watermark refuses exactly this rid."""
        s, q = _rid_session_seq(rid)
        if s is None or q is None:
            return
        with cls.dedupe_lock:
            cls.evicted[s] = max(q, cls.evicted.get(s, -1))
            cls.evicted.move_to_end(s)
            while len(cls.evicted) > _SESSION_CAP:
                cls.evicted.popitem(last=False)

    # -- /tasks: the scheduler surface --------------------------------------

    #: /tasks ops whose second application would change state (deduped);
    #: "tick" is idempotent admission work and re-executes harmlessly
    _TASKS_MUTATING = frozenset({"submit", "cancel"})
    #: serializes ALL /tasks scheduler calls on an HA board: a deferred
    #: submit/cancel holds the store lock for its whole transaction
    #: (wrapper -> scheduler lock order) while a concurrent tick takes
    #: scheduler -> wrapper — this outer lock keeps the two orders from
    #: ever interleaving (set per-server in DocServer.__init__)
    tasks_lock: threading.Lock

    def _do_alertz(self) -> None:
        """Operator mutations on the alerting plane: ``silence`` and
        ``ack``.  Both are durable appends to the generation-fenced
        alert log, so they run primary-only (the do_POST door already
        answered 421 for a standby) and auth-gated like /rpc."""
        length = int(self.headers.get("Content-Length", 0))
        if not check_auth(self.auth_token, self.headers):
            self.rfile.read(length)
            _REQUESTS.inc(op="alertz:-", outcome="unauthorized")
            return self._respond(401, b"{}")
        from ..obs import alerts as _alerts

        if not _alerts.PLANE.configured():
            self.rfile.read(length)
            return self._respond(404, _NO_ALERTS)
        try:
            req = json.loads(self.rfile.read(length))
            op = req["op"]
            if op not in ("silence", "ack"):
                raise KeyError(op)
        except (json.JSONDecodeError, KeyError, UnicodeDecodeError,
                TypeError):
            _REQUESTS.inc(op="alertz:-", outcome="bad_request")
            return self._respond(400, b"{}")
        try:
            if op == "silence":
                result = _alerts.PLANE.silence(
                    str(req["rule"]),
                    float(req.get("duration", 3600.0)))
            else:
                result = _alerts.PLANE.ack(str(req["rule"]))
        except (ValueError, KeyError, TypeError, OSError) as exc:
            _REQUESTS.inc(op=f"alertz:{op}", outcome="error")
            return self._respond(400, json.dumps(
                {"ok": False, "type": type(exc).__name__,
                 "error": str(exc)}).encode())
        _REQUESTS.inc(op=f"alertz:{op}", outcome="ok")
        self._respond(200, json.dumps(
            {"ok": True, "result": result}).encode())

    def _do_tasks(self) -> None:
        """The multi-tenant scheduler surface (sched/scheduler.py):
        ``submit`` / ``cancel`` (rid-deduped like every board mutation
        — a retried submit cannot enqueue a task twice) and ``tick``
        (idempotent admission).  Auth-gated like /rpc."""
        length = int(self.headers.get("Content-Length", 0))
        if not check_auth(self.auth_token, self.headers):
            self.rfile.read(length)
            _REQUESTS.inc(op="tasks:-", outcome="unauthorized")
            return self._respond(401, b"{}")
        try:
            req = json.loads(self.rfile.read(length))
            op = req["op"]
            if op not in ("submit", "cancel", "tick"):
                raise KeyError(op)
        except (json.JSONDecodeError, KeyError, UnicodeDecodeError,
                TypeError):
            _REQUESTS.inc(op="tasks:-", outcome="bad_request")
            return self._respond(400, b"{}")
        rid = req.get("rid") if op in self._TASKS_MUTATING else None
        if rid is not None:
            answered = self._claim_rid(rid, f"tasks:{op}")
            if answered is not None:
                return self._respond(200, answered)
        body = None
        code = 200
        t_exec = time.monotonic()
        not_primary = False
        # the tasks_lock guards a lock-order inversion that only exists
        # on an HA board (a deferred submit holds the store lock for
        # its whole transaction while a tick takes scheduler->store);
        # a plain board keeps its concurrent submit/cancel/tick
        lock_ctx = (self.tasks_lock if self.ha is not None
                    else contextlib.nullcontext())
        try:
            with lock_ctx, self._txn(rid) as txn:
                try:
                    if op == "submit":
                        result = self.scheduler.submit(
                            req["tenant"], db=req.get("db"),
                            params=req.get("params"),
                            priority=int(req.get("priority") or 0),
                            weight=float(req.get("weight") or 1.0),
                            est_jobs=int(req.get("est_jobs") or 0),
                            est_bytes=int(req.get("est_bytes") or 0),
                            kind=req.get("kind") or "server")
                    elif op == "cancel":
                        result = self.scheduler.cancel(
                            req["task_id"],
                            reason=req.get("reason") or "cancelled")
                    else:
                        result = self.scheduler.tick()
                    body = json.dumps({"ok": True,
                                       "result": result}).encode()
                    _REQUESTS.inc(op=f"tasks:{op}", outcome="ok")
                except NotPrimaryError:
                    # primacy lapsed mid-transaction: 421, rid left
                    # unrecorded — entries the transaction applied
                    # commit WITHOUT a response, so the successor
                    # refuses the re-send loudly, never double-applies
                    not_primary = True
                    _REQUESTS.inc(op=f"tasks:{op}",
                                  outcome="not_primary")
                except Exception as exc:
                    # same contract as /rpc: a reserved rid always gets
                    # a recorded response; admission rejections travel
                    # as typed errors (QuotaExceededError carries its
                    # reason) over HTTP 429, which the SchedulerClient
                    # deliberately does NOT retry
                    doc = {"ok": False, "type": type(exc).__name__,
                           "error": str(exc)}
                    reason = getattr(exc, "reason", None)
                    if reason is not None:
                        doc["reason"] = reason
                    body = json.dumps(doc).encode()
                    if type(exc).__name__ == "QuotaExceededError":
                        code = 429
                        _REQUESTS.inc(op=f"tasks:{op}",
                                      outcome="rejected")
                    else:
                        _REQUESTS.inc(op=f"tasks:{op}", outcome="error")
                if txn is not None:
                    txn.body = body
        finally:
            _RPC_SECONDS.observe(time.monotonic() - t_exec,
                                 op=f"tasks:{op}")
            if rid is not None:
                self._record_rid(rid, body)
        if not_primary:
            return self._lapsed()
        self._respond(code, body)

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
        refreshed at scrape time), ``/statusz`` (JSON cluster snapshot,
        including the collector's per-task roll-ups), ``/tracez`` (this
        process's span ring as Chrome trace JSON), ``/clusterz`` (the
        MERGED cluster timeline: every pushed process's spans
        clock-aligned with this process's), ``/tasks`` (every scheduler
        task doc plus the scheduler snapshot), ``/queryz`` (range
        queries over the durable history), ``/alertz`` (the alerting
        plane's state) and ``/healthz``.  Everything but /healthz is
        auth-gated like the RPC plane; /healthz is open — it returns
        liveness (and, on an HA board, the replica's role), and
        orchestrator probes cannot send a bearer token."""
        # /queryz carries its parameters in the query string; every
        # other endpoint ignores one (exact-path matching on the split)
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            _SCRAPES.inc(path=path)
            if self.ha is not None:
                # liveness plus ROLE: probes and the chaos tests tell
                # the primary from a standby without auth
                return self._respond(200, json.dumps(
                    {"ok": True, "role": self.ha.role,
                     "primary": self.ha.is_primary()}).encode())
            return self._respond(200, b'{"ok": true}')
        if path not in GET_PATHS:
            return self._respond(404, b"{}")
        if not check_auth(self.auth_token, self.headers):
            return self._respond(401, b"{}")
        _SCRAPES.inc(path=path)
        try:
            if path == "/metrics":
                update_board_gauges(self.store)
                # SLO gauges (percentile/burn/threshold) are published
                # by evaluation ticks; run one at scrape time so the
                # exposition is current and the burn windows sample at
                # scrape cadence
                from ..obs import slo as _slo

                _slo.evaluate(collector=self.collector)
                body = _metrics.REGISTRY.render().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/tracez":
                body = json.dumps(TRACER.chrome_trace()).encode()
                ctype = "application/json"
            elif path == "/queryz":
                # served by standbys too (history lives on the shared
                # dir and do_GET has no primary check by design), which
                # is what makes the series survive a board failover
                history = getattr(self.collector, "history", None)
                if history is None:
                    return self._respond(404, json.dumps(
                        {"error": "history not configured (start the "
                         "docserver with --history-dir or --ha-dir)"}
                    ).encode())
                try:
                    doc = self._queryz(history, query)
                except ValueError as exc:
                    # typed 400 body: bad step/range/op parameters are
                    # the CALLER's bug, distinguishable from a 500
                    return self._respond(400, json.dumps(
                        {"ok": False, "type": "ValueError",
                         "error": str(exc)}).encode())
                body = json.dumps(doc, default=float).encode()
                ctype = "application/json"
            elif path == "/alertz":
                # served from standbys too (the plane tails the shared
                # alert log on refresh), so `cli alerts` works against
                # whichever replica answers after a failover
                from ..obs import alerts as _alerts

                if not _alerts.PLANE.configured():
                    return self._respond(404, _NO_ALERTS)
                body = json.dumps(_alerts.alertz_doc(),
                                  default=float).encode()
                ctype = "application/json"
            elif path == "/tasks":
                body = json.dumps(
                    {"tasks": self.scheduler.list_tasks(),
                     "sched": self.scheduler.snapshot()},
                    default=float).encode()
                ctype = "application/json"
            elif path == "/clusterz":
                # evaluate HERE too: `cli diagnose` may be the first
                # scrape a board ever serves, and its SLO findings read
                # the derived percentile/burn/threshold gauges this tick
                # publishes
                from ..obs import slo as _slo

                _slo.evaluate(collector=self.collector)
                body = json.dumps(self.collector.cluster_doc(),
                                  default=float).encode()
                ctype = "application/json"
            else:
                snap = cluster_status(
                    self.store, collector=self.collector,
                    scheduler=self.scheduler)
                if self.ha is not None:
                    snap["ha"] = self.ha.snapshot()
                body = json.dumps(snap, default=float).encode()
                ctype = "application/json"
        except Exception as exc:
            # a scrape must never kill the handler thread; the scraper
            # sees the failure as a 500, not a hung socket
            return self._respond(500, json.dumps(
                {"error": f"{type(exc).__name__}: {exc}"}).encode())
        self._respond(200, body, ctype=ctype)

    @staticmethod
    def _queryz(history: Any, query: str) -> Dict[str, Any]:
        """Parse one /queryz query string and run it.

        ``op=query`` (default): ``metric=FAMILY`` plus repeated
        ``match=label=value`` matchers, ``start``/``end`` (wall
        seconds; <= 0 means relative to now), ``step`` and
        ``fn=raw|rate|increase|delta`` (``by_proc=1`` splits counters
        per pushing proc).  ``op=top``: top-K counter series by rate
        over ``window``.  ``op=trends``: the persisted trend summary
        diagnose consumes.  Raises ValueError on bad parameters (the
        caller answers 400)."""
        params = urllib.parse.parse_qs(query, keep_blank_values=True)

        def one(name: str, default: Optional[str] = None,
                ) -> Optional[str]:
            vals = params.get(name)
            return vals[-1] if vals else default

        op = one("op", "query")
        if op == "top":
            window = float(one("window", "300") or 300)
            return {"op": "top", "window_s": window,
                    "series": history.top_series(
                        k=int(one("k", "10") or 10), window_s=window)}
        if op == "trends":
            return {"op": "trends",
                    "trends": history.trends(
                        window_s=float(one("window", "300") or 300))}
        if op != "query":
            raise ValueError(f"unknown queryz op {op!r}")
        metric = one("metric")
        if not metric:
            raise ValueError("queryz needs metric=FAMILY")
        matchers: Dict[str, str] = {}
        for m in params.get("match", []):
            k, sep, v = m.partition("=")
            if not sep or not k:
                raise ValueError(f"bad matcher {m!r} (want label=value)")
            matchers[k] = v
        start = one("start")
        end = one("end")
        step = one("step")
        return history.query(
            metric, matchers=matchers or None,
            start=float(start) if start is not None else None,
            end=float(end) if end is not None else None,
            step=float(step) if step is not None else None,
            fn=one("fn", "raw") or "raw",
            by_proc=(one("by_proc", "0") or "0").lower()
            in ("1", "true", "yes"))

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
    way mongod's disk was, or *ha_dir* for a replicated board
    (coord/ha.py: the mutation log and the board-primary lease live
    there; *ha_lease* seconds, *ha_fsync* an fsync per append).  Every
    docserver hosts a :class:`~..sched.scheduler.Scheduler` on its board
    (*scheduler_config*).  ``port=0`` binds a free port (:attr:`port`
    holds it).

    *history_dir* (``<ha_dir>/history`` by default) arms the durable
    telemetry history behind ``/queryz``; *alert_rules* /
    *alert_rules_file* arm the alerting plane, whose log lives on
    ``<ha_dir>/alerts`` (or ``<history_dir>/alerts``) and whose
    evaluator thread sweeps every *alert_interval* seconds.
    """

    def __init__(self, store: Optional[DocStore] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 auth_token: Optional[str] = None,
                 scheduler_config=None,
                 ha_dir: Optional[str] = None,
                 ha_lease: Optional[float] = None,
                 ha_fsync: bool = False,
                 history_dir: Optional[str] = None,
                 history_keep: Optional[int] = None,
                 history_segment_bytes: Optional[int] = None,
                 history_max_age_s: Optional[float] = None,
                 alert_rules: Optional[List[str]] = None,
                 alert_rules_file: Optional[str] = None,
                 alert_webhooks: Optional[List[str]] = None,
                 alert_execs: Optional[List[str]] = None,
                 alert_interval: float = 5.0,
                 alert_damp: Optional[float] = None) -> None:
        # late import: sched builds on coord (no cycle at module load)
        from ..sched.scheduler import Scheduler, SchedulerConfig

        self.ha = None
        if ha_dir is not None:
            if store is not None:
                raise ValueError(
                    "ha_dir and an explicit store are mutually "
                    "exclusive: the HA board's authoritative state is "
                    "the mutation log under ha_dir")
            from .ha import DEFAULT_BOARD_LEASE, HaController

            self.ha = HaController(
                ha_dir,
                lease=(ha_lease if ha_lease is not None
                       else DEFAULT_BOARD_LEASE),
                fsync=ha_fsync)
            bound_store: DocStore = self.ha.store
        else:
            bound_store = store if store is not None else MemoryDocStore()
        # durable telemetry history: defaults onto the HA dir so the
        # standby tails the same segments and keeps serving /queryz
        # after failover; an explicit --history-dir works standalone
        if history_dir is None and ha_dir is not None:
            history_dir = os.path.join(ha_dir, "history")
        self.history = None
        if history_dir is not None:
            from ..obs.history import MetricHistory

            kwargs: Dict[str, Any] = {"fsync": ha_fsync}
            if history_keep is not None:
                kwargs["keep_segments"] = history_keep
            if history_segment_bytes is not None:
                kwargs["max_segment_bytes"] = history_segment_bytes
            if history_max_age_s is not None:
                kwargs["max_segment_age_s"] = history_max_age_s
            self.history = MetricHistory(history_dir, **kwargs)
            # a corrupt segment REFUSES to load (HistoryCorruptError
            # propagates) — better no history plane than a wrong one
            self.history.load()
            # restart-proof burn windows: rebuild the SLO plane's
            # in-memory deques from persisted bucket deltas so a
            # burn-rate alert survives the process that raised it
            from ..obs import slo as _slo

            _slo.PLANE.seed_from_history(self.history)
            # control-ledger outcomes read their before/after evidence
            # from history windows instead of racy in-memory snapshots
            from ..obs import control as _control

            _control.LEDGER.bind_history(self.history)
        # the alerting plane: rules evaluated on this board, every
        # transition appended to a generation-fenced log on the shared
        # dir so a promoted standby resumes pending timers and never
        # re-fires what the dead primary already fired
        self._alert_stop: Optional[threading.Event] = None
        self._alert_thread: Optional[threading.Thread] = None
        self._alert_interval = float(alert_interval)
        self.alerts = None
        rule_specs = list(alert_rules or [])
        if rule_specs or alert_rules_file:
            from ..obs import alerts as _alerts
            from ..obs import slo as _slo

            objective_names = [o.name for o in _slo.PLANE.objectives]
            rules = [_alerts.parse_alert(s, objectives=objective_names)
                     for s in rule_specs]
            if alert_rules_file:
                rules += _alerts.load_rules_file(
                    alert_rules_file, objectives=objective_names)
            sinks: List[Any] = [_alerts.parse_webhook_spec(s)
                                for s in (alert_webhooks or [])]
            sinks += [_alerts.parse_exec_spec(s)
                      for s in (alert_execs or [])]
            if ha_dir is not None:
                alert_dir: Optional[str] = os.path.join(ha_dir, "alerts")
            elif history_dir is not None:
                alert_dir = os.path.join(history_dir, "alerts")
            else:
                alert_dir = None  # burn-only rules, non-durable
            _alerts.PLANE.configure(
                rules, log_dir=alert_dir, fsync=ha_fsync,
                gen_fn=(self.ha.generation if self.ha is not None
                        else None),
                sinks=sinks, flap_damp_s=alert_damp)
            self.alerts = _alerts.PLANE
        handler = type("BoundRpcHandler", (_RpcHandler,), {
            "store": bound_store,
            "done": collections.OrderedDict(),
            "inflight": {},
            "evicted": collections.OrderedDict(),
            "dedupe_lock": threading.Lock(),
            "tasks_lock": threading.Lock(),
            "auth_token": default_auth_token(auth_token),
            "collector": Collector(local_role="server",
                                   history=self.history),
            "ha": self.ha,
            # every docserver hosts the multi-tenant scheduler surface;
            # admission (tick) stays lease-fenced, so a board whose
            # admission runs in a separate runner process simply never
            # wins the lease here
            "scheduler": Scheduler(
                bound_store,
                config=scheduler_config or SchedulerConfig()),
        })
        self.store = handler.store
        self.collector = handler.collector
        self.scheduler = handler.scheduler
        try:
            self.httpd = http.server.ThreadingHTTPServer((host, port),
                                                         handler)
        except OSError:
            if self.ha is not None:
                # a replica that cannot serve must not contend for —
                # let alone hold — the board-primary lease
                self.ha.log.close()
            raise
        self.host, self.port = self.httpd.server_address[:2]
        if self.ha is not None:
            # bind the HTTP port FIRST: only a replica that can serve
            # may contend for the lease.  The handler's class-level
            # dedupe maps are where replayed rid answers land.
            self.ha.bind_handler(handler)
            self.ha.start()
        self._thread: Optional[threading.Thread] = None
        if self.alerts is not None:
            self._alert_stop = threading.Event()
            self._alert_thread = threading.Thread(
                target=self._alert_loop, daemon=True,
                name="alert-evaluator")
            self._alert_thread.start()

    def _alert_loop(self) -> None:
        """Evaluate + pump on the primary; standbys only tail the
        shared alert log so their /alertz stays live.  A sweep failure
        is loud and non-fatal — the next tick retries."""
        from ..obs import alerts as _alerts

        while not self._alert_stop.wait(self._alert_interval):
            try:
                if self.ha is None or self.ha.is_primary():
                    _alerts.PLANE.evaluate(history=self.history,
                                           collector=self.collector)
                    _alerts.PLANE.pump()
                else:
                    _alerts.PLANE.refresh()
            except Exception as exc:
                logging.getLogger(__name__).warning(
                    "alert evaluator sweep failed: %s: %s",
                    type(exc).__name__, exc)

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
        """Stop serving and close the listening socket; an HA replica
        releases the board lease (a standby's next poll promotes at
        once, no expiry wait).  The alert evaluator stops first, and the
        history is unbound from the control ledger and closed last."""
        if self._alert_stop is not None:
            self._alert_stop.set()
            if self._alert_thread is not None:
                self._alert_thread.join(timeout=10)
        if self.alerts is not None:
            self.alerts.reset()
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=10)
        self.httpd.server_close()
        if self.ha is not None:
            self.ha.stop()
        if self.history is not None:
            from ..obs import control as _control

            _control.LEDGER.unbind_history(self.history)
            self.history.close()


class HttpDocStore(DocStore):
    """Client DocStore over a :class:`DocServer` (``http://HOST:PORT``,
    or the HA replica-set form ``HOST:PORT,HOST:PORT``: the
    :class:`FailoverClient` rotates on transport failures and on a
    standby's 421, under the one rid of the logical call, so the
    re-send replays from the new primary's replicated dedupe table).

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

    def statusz(self) -> Dict[str, Any]:
        """Fetch the server's /statusz cluster snapshot."""
        return json.loads(self._get("/statusz"))

    def metrics_text(self) -> str:
        """Fetch the server's /metrics Prometheus exposition."""
        return self._get("/metrics").decode()

    def tracez(self) -> Dict[str, Any]:
        """Fetch the server's /tracez Chrome trace snapshot."""
        return json.loads(self._get("/tracez"))

    def clusterz(self) -> Dict[str, Any]:
        """Fetch the server's /clusterz merged cluster timeline."""
        return json.loads(self._get("/clusterz"))

    def queryz(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Run one /queryz range query against the durable history
        plane (the ``history``/``top`` CLI feed).  *params* maps query
        parameter names to a value or a list of values (repeated
        ``match`` matchers)."""
        pairs: List[Tuple[str, str]] = []
        for k, v in params.items():
            for item in (v if isinstance(v, (list, tuple)) else (v,)):
                pairs.append((str(k), str(item)))
        qs = urllib.parse.urlencode(pairs)
        status, raw = self._client.request("GET", f"/queryz?{qs}")
        if status == 401:
            raise PermissionError("queryz: auth rejected")
        if status != 200:
            try:
                detail = json.loads(raw).get("error")
            except ValueError:
                detail = None
            raise IOError(f"queryz: HTTP {status}"
                          + (f" ({detail})" if detail else ""))
        return json.loads(raw)

    def alertz(self) -> Dict[str, Any]:
        """Fetch the alerting plane's lifecycle state (the ``alerts``
        CLI feed) — answered by standbys too, which is how an operator
        sees the same lifecycle after a failover."""
        status, raw = self._client.request("GET", "/alertz")
        if status == 401:
            raise PermissionError("alertz: auth rejected")
        if status != 200:
            try:
                detail = json.loads(raw).get("error")
            except ValueError:
                detail = None
            raise IOError(f"alertz: HTTP {status}"
                          + (f" ({detail})" if detail else ""))
        return json.loads(raw)

    def alert_op(self, op: str, rule: str,
                 duration: Optional[float] = None) -> Dict[str, Any]:
        """``silence`` / ``ack`` against the primary's alert plane."""
        req: Dict[str, Any] = {"op": op, "rule": rule}
        if duration is not None:
            req["duration"] = duration
        status, raw = self._client.request(
            "POST", "/alertz", body=json.dumps(req).encode())
        if status == 401:
            raise PermissionError("alertz: auth rejected")
        doc = json.loads(raw) if raw else {}
        if status != 200 or not doc.get("ok"):
            raise IOError(f"alertz {op}: HTTP {status}"
                          + (f" ({doc.get('error')})"
                             if doc.get("error") else ""))
        return doc.get("result") or {}

    def close(self) -> None:
        self._client.close()
