"""Board high availability: a replicated, lease-elected docserver (port
of ``mapreduce_tpu/coord/ha.py``).

The reference survives any single process dying because MongoDB *is*
the control plane — kill a worker, the board lives on.  One docserver
over one in-process :class:`~.docstore.MemoryDocStore` dies with every
lease, claim and dedupe entry it held.  This module gives the board the
mongod property back, from three pieces:

* **Durable mutation log** (:class:`~.persistent_table.MutationLog`):
  :class:`ReplicatedDocStore` wraps the authoritative MemoryDocStore
  and appends every mutation — with its rid and the writer's fencing
  generation — to one shared append-only JSONL file.  Application
  order IS log order (one critical section around apply + append), so
  a replay reproduces the primary's document state exactly; ``insert``
  ids are assigned BEFORE logging and id-less upserts decompose into a
  logged insert, so replay is deterministic.  The entries are the JAX
  package's, field for field: a log written by either package replays
  in the other.
* **Board-primary lease** (:class:`~.lease.BoardLease`): the
  coord/lease.py seed-iff-absent / free-or-expired / ``$inc``
  generation pattern, pointed at a tiny :class:`~.docstore.DirDocStore`
  inside the HA directory — the one store that must not live on the
  board it elects.  The holder self-fences on its own monotonic clock
  (writes refuse once ``last-renewal + lease`` passes without a
  successful heartbeat), the standby only claims after the persisted
  expiry, and every log entry carries the writer's generation so a
  deposed primary's straggling appends are skipped on replay.
* **Replicated dedupe**: each answered mutating RPC's ``SESSION:SEQ``
  rid and recorded response body land in the SAME atomic log write as
  its mutation entries (:meth:`ReplicatedDocStore.deferred_rid`), so a
  client retry that fails over to the new primary replays the recorded
  answer instead of re-applying.  A rid whose mutations were logged but
  whose response never was (the writer died mid-request) is refused
  with the dedupe plane's loud-ambiguity error, never silently
  re-applied.

Deployment: N ``docserver --ha-dir DIR`` replicas over one shared
directory.  Exactly one holds the lease and serves; the rest answer
HTTP 421 (NOT retryable — clients rotate instantly) and tail the log.
Kill the primary and a standby finishes the replay and takes over
within one lease period.  A single replica over an HA dir is simply a
DURABLE board: restart it and it replays itself back.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from ..obs import metrics as _metrics
from ..utils.httpclient import NotPrimaryError
from . import docstore as _ds
from .docstore import Doc, DocStore, MemoryDocStore, Query
from .lease import DEFAULT_BOARD_LEASE, BoardLease
from .persistent_table import BoardLogCorruptError, MutationLog

logger = logging.getLogger("mapreduce_tpu_torch.ha")

_LOG_ENTRIES = _metrics.counter(
    "mrtpu_board_log_entries_total",
    "board mutation-log entries (labels: dir=append|replay|"
    "skipped_stale — skipped_stale counts a deposed primary's "
    "straggling appends discarded by generation fencing)")
_PROMOTIONS = _metrics.counter(
    "mrtpu_board_promotions_total",
    "times this replica took the board-primary lease over")
_BOARD_FENCES = _metrics.counter(
    "mrtpu_board_fences_total",
    "times this replica definitively lost the board-primary lease "
    "and demoted itself (its replica is rebuilt from the log)")
_REFUSED_RIDS = _metrics.counter(
    "mrtpu_board_replayed_rid_refusals_total",
    "rids whose mutations were in the log without a recorded response "
    "at promotion (the old primary died mid-request): their retries "
    "are refused with the loud dedupe ambiguity, never re-applied")
_IS_PRIMARY = _metrics.gauge(
    "mrtpu_board_primary",
    "1 while this replica holds (and can still prove, on its own "
    "monotonic clock) the board-primary lease, else 0")
_GENERATION = _metrics.gauge(
    "mrtpu_board_generation",
    "fencing generation of this replica's current/last primacy")
_REPLAY_LAG = _metrics.gauge(
    "mrtpu_board_replay_lag_bytes",
    "bytes of the shared mutation log this replica has not applied "
    "yet (0 on the primary by construction)")


class _StoreCnn:
    """Connection shape (connect()/ns()) over the HA dir's lease store."""

    def __init__(self, store: DocStore) -> None:
        self._store = store

    def connect(self) -> DocStore:
        return self._store

    def ns(self, coll: str) -> str:
        return f"__board__.{coll}"


class _RidTxn:
    """One rid-carrying request's deferred log write: every mutation
    the request applies buffers here, and the committed response body
    joins them in ONE atomic append at scope exit."""

    __slots__ = ("rid", "entries", "body")

    def __init__(self, rid: str) -> None:
        self.rid = rid
        self.entries: List[Dict[str, Any]] = []
        self.body: Optional[bytes] = None


def apply_entry(store: DocStore, entry: Dict[str, Any]) -> None:
    """Replay ONE logged mutation onto *store* (the replica's inner
    MemoryDocStore).  ``resp`` entries are the caller's (dedupe plane),
    not ours."""
    op = entry["op"]
    coll = entry.get("coll")
    if op == "insert":
        store.insert(coll, entry["doc"])
    elif op == "insert_many":
        store.insert_many(coll, entry["docs"])
    elif op == "update":
        store.update(coll, entry["q"], entry["u"],
                     multi=bool(entry.get("m")),
                     upsert=bool(entry.get("up")))
    elif op == "fam":
        store.find_and_modify(coll, entry["q"], entry["u"])
    elif op == "fam_many":
        store.find_and_modify_many(coll, entry["q"], entry["u"],
                                   int(entry.get("lim", 1)))
    elif op == "remove":
        store.remove(coll, entry.get("q"))
    elif op == "drop":
        store.drop_collection(coll)
    elif op == "noop":
        pass  # promotion fence marker: raises the generation bar only
    else:
        raise BoardLogCorruptError(
            f"board log entry with unknown op {op!r}")


class ReplicatedDocStore(DocStore):
    """The primary's store: every mutation applies to the inner
    MemoryDocStore and lands in the shared mutation log inside ONE
    critical section, so log order is application order and a replay
    is exact.  Reads pass straight through.

    Mutations carry the holder's fencing generation and refuse with
    :class:`~..utils.httpclient.NotPrimaryError` once the controller
    can no longer prove primacy (standby, fenced, or the local
    monotonic lease-validity window lapsed) — the write path itself is
    fenced, not just the HTTP front door.
    """

    def __init__(self, inner: Optional[MemoryDocStore] = None,
                 log: Optional[MutationLog] = None,
                 gen_fn: Optional[Callable[[], int]] = None,
                 fence: Optional[Callable[[], None]] = None) -> None:
        self.inner = inner if inner is not None else MemoryDocStore()
        self.log = log
        self._gen_fn = gen_fn or (lambda: 0)
        self._fence = fence or (lambda: None)
        self._lock = threading.RLock()
        self._seq = 0
        self._tls = threading.local()

    # -- the deferred-rid transaction ------------------------------------

    @contextlib.contextmanager
    def deferred_rid(self, rid: str):
        """Scope one rid-carrying request: mutations inside buffer
        their log entries on the transaction instead of appending
        one-by-one; scope exit appends them PLUS the recorded response
        (``txn.body``, when the handler set one) as a single atomic
        log write.  The store lock is held for the whole scope, so no
        other writer's entries can interleave between this request's
        application and its log record."""
        with self._lock:
            prev = getattr(self._tls, "txn", None)
            txn = _RidTxn(rid)
            self._tls.txn = txn
            try:
                yield txn
            finally:
                self._tls.txn = prev
                entries = txn.entries
                if txn.body is not None:
                    entries.append(self._stamp(
                        {"op": "resp", "rid": rid,
                         "body": txn.body.decode("utf-8", "replace")}))
                if entries and self.log is not None:
                    self.log.append_many(entries)
                    _LOG_ENTRIES.inc(len(entries), dir="append")

    def _stamp(self, entry: Dict[str, Any]) -> Dict[str, Any]:
        self._seq += 1
        entry["g"] = int(self._gen_fn())
        entry["s"] = self._seq
        return entry

    def _record(self, entry: Dict[str, Any]) -> None:
        """Log one mutation: buffered on the open rid transaction, or
        appended immediately (server-side writers — the hosted
        scheduler — have no rid)."""
        entry = self._stamp(entry)
        txn = getattr(self._tls, "txn", None)
        if txn is not None:
            if txn.rid:
                entry.setdefault("rid", txn.rid)
            txn.entries.append(entry)
        elif self.log is not None:
            self.log.append_many([entry])
            _LOG_ENTRIES.inc(dir="append")

    # -- reads (passthrough) ---------------------------------------------

    def find(self, coll: str, query: Optional[Query] = None) -> List[Doc]:
        return self.inner.find(coll, query)

    def count(self, coll: str, query: Optional[Query] = None) -> int:
        return self.inner.count(coll, query)

    def collections(self) -> List[str]:
        return self.inner.collections()

    # -- mutations (fenced + logged) --------------------------------------

    def insert(self, coll: str, doc: Doc) -> str:
        with self._lock:
            self._fence()
            d = copy.deepcopy(doc)
            # assign the id HERE so the logged doc replays to the same
            # one (the inner store's uuid fallback would diverge)
            d["_id"] = str(d.get("_id") or uuid.uuid4().hex)
            _id = self.inner.insert(coll, d)
            self._record({"op": "insert", "coll": coll, "doc": d})
            return _id

    def insert_many(self, coll: str, docs: List[Doc]) -> List[str]:
        with self._lock:
            self._fence()
            ds = []
            for doc in docs:
                d = copy.deepcopy(doc)
                d["_id"] = str(d.get("_id") or uuid.uuid4().hex)
                ds.append(d)
            ids = self.inner.insert_many(coll, ds)
            self._record({"op": "insert_many", "coll": coll, "docs": ds})
            return ids

    def update(self, coll: str, query: Query, update: Doc,
               multi: bool = False, upsert: bool = False) -> int:
        with self._lock:
            self._fence()
            if upsert and "_id" not in query:
                # an id-less upsert's inserted doc would get a store-
                # generated uuid replay cannot reproduce: decompose
                # into update-miss + an explicitly-id'd logged insert
                # (same semantics as MemoryDocStore.update's upsert)
                n = self.inner.update(coll, query, update, multi=multi,
                                      upsert=False)
                if n:
                    self._record({"op": "update", "coll": coll,
                                  "q": query, "u": update,
                                  "m": bool(multi)})
                    return n
                base = {k: v for k, v in query.items()
                        if not isinstance(v, dict)
                        and not k.startswith("$")}
                doc = _ds.apply_update(base, copy.deepcopy(update))
                doc["_id"] = str(doc.get("_id") or uuid.uuid4().hex)
                self.inner.insert(coll, doc)
                self._record({"op": "insert", "coll": coll, "doc": doc})
                return 1
            n = self.inner.update(coll, query, update, multi=multi,
                                  upsert=upsert)
            if n:
                self._record({"op": "update", "coll": coll, "q": query,
                              "u": update, "m": bool(multi),
                              "up": bool(upsert)})
            return n

    def find_and_modify(self, coll: str, query: Query, update: Doc,
                        sort_key: Optional[Callable[[Doc], Any]] = None,
                        ) -> Optional[Doc]:
        if sort_key is not None:
            raise NotImplementedError(
                "a replicated board cannot log a sort_key callable; "
                "no framework caller passes one")
        with self._lock:
            self._fence()
            got = self.inner.find_and_modify(coll, query, update)
            if got is not None:
                self._record({"op": "fam", "coll": coll, "q": query,
                              "u": update})
            return got

    def find_and_modify_many(self, coll: str, query: Query, update: Doc,
                             limit: int = 1) -> List[Doc]:
        with self._lock:
            self._fence()
            out = self.inner.find_and_modify_many(coll, query, update,
                                                  limit)
            if out:
                self._record({"op": "fam_many", "coll": coll,
                              "q": query, "u": update,
                              "lim": int(limit)})
            return out

    def remove(self, coll: str, query: Optional[Query] = None) -> int:
        with self._lock:
            self._fence()
            n = self.inner.remove(coll, query)
            if n:
                self._record({"op": "remove", "coll": coll, "q": query})
            return n

    def drop_collection(self, coll: str) -> None:
        with self._lock:
            self._fence()
            self.inner.drop_collection(coll)
            self._record({"op": "drop", "coll": coll})

    def close(self) -> None:
        self.inner.close()


class HaController:
    """One replica's HA brain: log replay/tailing, lease contention,
    self-fencing primacy, promotion and demotion.

    Roles: ``replica`` (tailing the log, answering 421), ``primary``
    (serving, heartbeating, appending), ``broken`` (the shared log
    failed validation — refuses to serve rather than diverge).
    """

    def __init__(self, ha_dir: str,
                 lease: float = DEFAULT_BOARD_LEASE,
                 fsync: bool = False,
                 holder: Optional[str] = None,
                 tail_interval: float = 0.05) -> None:
        os.makedirs(ha_dir, exist_ok=True)
        self.ha_dir = ha_dir
        self.log = MutationLog(os.path.join(ha_dir, "board.log"),
                               fsync=fsync)
        from .docstore import DirDocStore

        self.lease = BoardLease(
            _StoreCnn(DirDocStore(os.path.join(ha_dir, "lease"))),
            holder=holder, lease=lease)
        self.store = ReplicatedDocStore(
            MemoryDocStore(), self.log,
            gen_fn=lambda: int(self.lease.generation or 0),
            fence=self._check_writable)
        self.role = "replica"
        self.promotions = 0
        self.failed: Optional[BaseException] = None
        self._valid_until = 0.0          # monotonic self-fence horizon
        self._offset = 0                 # log bytes applied
        self._max_gen = 0                # generation high-water mark
        self._replayed = 0
        #: rids whose mutations were replayed without a response entry
        #: (an old primary died mid-request): refused at promotion
        self._pending_rids: Dict[str, bool] = {}
        self._handler = None             # bound by DocServer
        self._tail_interval = float(tail_interval)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- wiring -----------------------------------------------------------

    def bind_handler(self, handler) -> None:
        """The docserver's handler class: its class-level dedupe maps
        are where replayed rid answers land (duck-typed —
        ``remember_answer(rid, body)`` / ``refuse_rid(rid)``)."""
        self._handler = handler

    def start(self) -> "HaController":
        # replay whatever the log already holds BEFORE contending: a
        # restarted replica (or a fresh standby joining a live pair)
        # must be current before it can ever win the lease
        self._apply_new()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mr-board-ha")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self.role == "primary":
            # clean handoff: a standby's next poll claims immediately
            try:
                self.lease.release()
            except OSError:
                pass
            self.role = "replica"
            _IS_PRIMARY.set(0)
        self.log.close()

    # -- primacy ----------------------------------------------------------

    def is_primary(self) -> bool:
        """Primacy this replica can PROVE right now: role primary AND
        the monotonic self-fence horizon (last successful renewal +
        lease period) has not passed.  A partitioned primary stops
        answering — and stops appending — before the standby's
        wait-out-the-expiry claim can succeed, so two generations
        never write concurrently (modulo clock-RATE skew; the
        generation stamps on every entry are the backstop)."""
        return (self.role == "primary"
                and time.monotonic() < self._valid_until)

    def _check_writable(self) -> None:
        if not self.is_primary():
            raise NotPrimaryError(
                f"this board replica is {self.role} "
                "(not the lease-holding primary)")

    def generation(self) -> int:
        return int(self.lease.generation or 0)

    # -- the contention / tail / heartbeat loop ---------------------------

    def _loop(self) -> None:
        beat = self.lease.lease / 4.0
        while not self._stop.is_set():
            try:
                self._loop_once(beat)
            except BoardLogCorruptError as exc:
                # from ANY replay site — tailing, a promotion drain, a
                # demote rebuild: the shared log is damaged, this
                # replica must refuse to serve rather than diverge,
                # and must say so (role + failed), never die silently
                logger.error("board log corrupt; refusing to serve: %s",
                             exc)
                self.failed = exc
                self.role = "broken"
                _IS_PRIMARY.set(0)

    def _loop_once(self, beat: float) -> None:
        if self.role == "primary":
            t0 = time.monotonic()
            try:
                owned = self.lease.heartbeat()
            except OSError:
                owned = None  # unknown: primacy decays at _valid_until
            if owned:
                self._valid_until = t0 + self.lease.lease
            elif owned is False:
                self._demote()
            self._stop.wait(beat)
        elif self.role == "replica":
            self._apply_new()
            t0 = time.monotonic()
            try:
                acquired = self.lease.try_acquire()
            except OSError:
                acquired = False  # lease store unreachable: stay replica
            if acquired:
                try:
                    self._promote(t0)
                except OSError as exc:
                    # the HA dir failed BETWEEN acquire and promote
                    # (fence-marker append / drain read — ENOSPC, NFS
                    # EIO): hand the lease back so a healthier replica
                    # (or this one, healed) claims promptly instead of
                    # the board sitting headless until expiry
                    logger.warning(
                        "promotion failed (%s); releasing the board "
                        "lease and staying replica", exc)
                    try:
                        self.lease.release()
                    except OSError:
                        pass  # expires on its own
                return
            self._stop.wait(self._tail_interval)
        else:  # broken
            self._stop.wait(1.0)

    def _promote(self, t0: float) -> None:
        # final drain: everything the dead primary managed to append is
        # ours before the first client sees us
        self._apply_new()
        # promotion FENCE MARKER: a no-op entry at our generation
        # closes the same-generation straggler window — a deposed
        # primary that passed its fence check but stalled before its
        # append either lands BEFORE this marker (the second drain
        # below applies it here, and every replay applies it — state
        # agrees) or AFTER it (generation-skipped by every replica and
        # every future replay, and never applied here — state agrees).
        # Without the marker, the bar only rises at our first real
        # mutation, and a straggler in that window would reach the
        # replicas but never this serving primary.
        self.log.append({"op": "noop", "g": self.generation(), "s": 0,
                         "holder": self.lease.holder})
        self._apply_new()
        for rid in list(self._pending_rids):
            # mutations logged, response never was: the old primary
            # died inside the request.  Whether its client saw an
            # answer is unknowable — refuse the retry loudly (the
            # dedupe plane's eviction semantics), never re-apply.
            if self._handler is not None:
                self._handler.refuse_rid(rid)
            _REFUSED_RIDS.inc()
        self._pending_rids.clear()
        self._valid_until = t0 + self.lease.lease
        self.role = "primary"
        self.promotions += 1
        _PROMOTIONS.inc()
        _IS_PRIMARY.set(1)
        _GENERATION.set(self.generation())
        _REPLAY_LAG.set(0)

    def _demote(self) -> None:
        """Definitive lease loss: fence, then REBUILD the replica from
        the log.  (If the self-fence held — it does, absent clock-rate
        pathology — we never appended a stale entry and the rebuild is
        a formality; if one slipped through, the successor skipped it
        by generation, and rebuilding from the log re-converges us to
        the successor's view.)"""
        _BOARD_FENCES.inc()
        _IS_PRIMARY.set(0)
        self.lease.generation = None
        self.role = "replica"
        with self.store._lock:
            self.store.inner = MemoryDocStore()
            self._offset = 0
            self._max_gen = 0
            self._pending_rids.clear()
        self._apply_new()

    # -- replay -----------------------------------------------------------

    def _apply_new(self) -> None:
        entries, new_offset = self.log.read_from(self._offset)
        applied = 0
        for e in entries:
            g = int(e.get("g", 0))
            if g < self._max_gen:
                # a deposed primary's straggling append: a successor
                # at a higher generation already owns the log's future
                _LOG_ENTRIES.inc(dir="skipped_stale")
                continue
            self._max_gen = g
            if e.get("op") == "resp":
                self._pending_rids.pop(e["rid"], None)
                if self._handler is not None:
                    self._handler.remember_answer(
                        e["rid"], e["body"].encode())
            else:
                apply_entry(self.store.inner, e)
                if e.get("rid"):
                    self._pending_rids[e["rid"]] = True
            self._replayed += 1
            applied += 1
        if applied:
            _LOG_ENTRIES.inc(applied, dir="replay")
        self._offset = new_offset
        if self.role != "primary":
            _REPLAY_LAG.set(max(0, self.log.size() - self._offset))

    # -- helpers ----------------------------------------------------------

    def wait_role(self, role: str, timeout: float = 30.0) -> bool:
        give_up = time.monotonic() + timeout
        while time.monotonic() < give_up:
            if self.role == role:
                return True
            time.sleep(0.02)
        return self.role == role

    def snapshot(self) -> Dict[str, Any]:
        """The /statusz ``ha`` section."""
        out: Dict[str, Any] = {
            "role": self.role,
            "generation": self.generation(),
            "holder": self.lease.holder,
            "log_bytes": self.log.size(),
            "log_appended": self.log.appended,
            "log_replayed": self._replayed,
            "promotions": self.promotions,
            # a primary appends without tailing, so its offset stops
            # moving — by definition it lags nothing
            "replay_lag_bytes": (0 if self.role == "primary" else
                                 max(0, self.log.size() - self._offset)),
        }
        try:
            doc = self.lease.peek()
        except OSError:
            doc = None
        if doc is not None:
            out["lease"] = {"holder": doc.get("holder"),
                            "generation": doc.get("generation", 0)}
        if self.failed is not None:
            out["failed"] = f"{type(self.failed).__name__}: {self.failed}"
        return out
