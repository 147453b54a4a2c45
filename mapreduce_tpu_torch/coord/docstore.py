"""Document store: the MongoDB-collection role of the reference's control
plane (cnn.lua + the ``task``/``map_jobs``/``red_jobs``/``errors``
collections, task.lua:349-352), without MongoDB (port of
``mapreduce_tpu/coord/docstore.py``).

Two local backends behind one interface (the networked third,
``HttpDocStore`` behind ``http://HOST:PORT``, is in
:mod:`.docserver`):

  * :class:`MemoryDocStore` — in-process dict + lock.  Unit tests and the
    single-process server+threads deployment use this; it is the "fake
    coordination backend so unit tests don't need a live service" the
    survey says the reference lacks (SURVEY.md §4).
  * :class:`DirDocStore` — one JSON file per document in a shared directory
    (local disk or NFS), cross-process atomicity from an ``fcntl`` lock
    file per collection and atomic tempfile+rename writes.  N OS-process
    workers on one host or a shared filesystem coordinate through it, the
    way the reference's workers coordinate through mongod.

The query/update language is the small Mongo subset the job plane uses
(equality, ``$in``/``$nin``/``$lt``/``$gte``/``$exists``, ``$or``;
``$set``/``$inc`` and whole-document replacement; multi-update and
upsert) — see e.g. the claim query task.lua:271-293 and
``mark_as_broken``'s ``$inc`` job.lua:322-342, and the trainer lease's
seed-iff-absent upsert (``$exists``); any other operator raises.  ``find_and_modify`` is
the one primitive the reference *wishes* it had for claims (it emulates it
with update-then-find_one, task.lua:294-309, with acknowledged races); here
it is genuinely atomic under the store lock.
"""

from __future__ import annotations

import copy
import fcntl
import json
import os
import threading
import time
import urllib.parse
import uuid
from typing import Any, Dict, List, Optional

Doc = Dict[str, Any]
Query = Dict[str, Any]


# --- query / update language ------------------------------------------------

def _match_value(cond: Any, value: Any, present: bool) -> bool:
    if isinstance(cond, dict) and any(k.startswith("$") for k in cond):
        for op, arg in cond.items():
            if op == "$in":
                if value not in arg:
                    return False
            elif op == "$nin":
                if value in arg:
                    return False
            elif op == "$lt":
                if not (present and value is not None and value < arg):
                    return False
            elif op == "$gte":
                if not (present and value is not None and value >= arg):
                    return False
            elif op == "$exists":
                if bool(present) != bool(arg):
                    return False
            else:
                raise ValueError(f"unsupported query operator {op!r}")
        return True
    return present and value == cond


def matches(doc: Doc, query: Query) -> bool:
    """True if *doc* satisfies *query* (Mongo-subset semantics)."""
    for field, cond in query.items():
        if field == "$or":
            if not any(matches(doc, q) for q in cond):
                return False
            continue
        present = field in doc
        if not _match_value(cond, doc.get(field), present):
            return False
    return True


def apply_update(doc: Doc, update: Doc) -> Doc:
    """Apply a Mongo-subset update spec to *doc* in place and return it.

    A spec with no ``$`` operators replaces the whole document except
    ``_id`` (Mongo replace semantics, used by task.lua:148-160 update).
    """
    if not any(k.startswith("$") for k in update):
        _id = doc.get("_id")
        doc.clear()
        doc.update(copy.deepcopy(update))
        if _id is not None and "_id" not in doc:
            doc["_id"] = _id
        return doc
    for op, fields in update.items():
        if op == "$set":
            for k, v in fields.items():
                doc[k] = copy.deepcopy(v)
        elif op == "$inc":
            for k, v in fields.items():
                doc[k] = doc.get(k, 0) + v
        else:
            raise ValueError(f"unsupported update operator {op!r}")
    return doc


# --- backends ---------------------------------------------------------------

class DocStore:
    """Abstract store of named collections of JSON-ish documents.

    Every mutating method takes the store-wide (Memory) or per-collection
    (Dir) lock, giving the single-document atomicity the reference leans on
    Mongo for (SURVEY.md §5 "Race detection": "safety relies on Mongo's
    single-document atomicity").
    """

    def insert(self, coll: str, doc: Doc) -> str:
        raise NotImplementedError

    def insert_many(self, coll: str, docs: List[Doc]) -> List[str]:
        return [self.insert(coll, d) for d in docs]

    def find(self, coll: str, query: Optional[Query] = None) -> List[Doc]:
        raise NotImplementedError

    def find_one(self, coll: str, query: Optional[Query] = None) -> Optional[Doc]:
        found = self.find(coll, query)
        return found[0] if found else None

    def update(self, coll: str, query: Query, update: Doc,
               multi: bool = False, upsert: bool = False) -> int:
        raise NotImplementedError

    def find_and_modify(self, coll: str, query: Query, update: Doc,
                        ) -> Optional[Doc]:
        """Atomically pick one matching doc, apply *update*, return the
        POST-update document (None if nothing matched)."""
        raise NotImplementedError

    def find_and_modify_many(self, coll: str, query: Query, update: Doc,
                             limit: int = 1) -> List[Doc]:
        """Claim up to *limit* matching docs in one call, applying
        *update* to each; returns the post-update documents (possibly
        empty).  The batched form of the worker claim
        (Task.take_next_jobs).  The base implementation
        loops :meth:`find_and_modify`, which is correct for any store
        whose claim update makes a doc stop matching (ours sets status
        RUNNING); backends override for one-lock atomicity."""
        out: List[Doc] = []
        for _ in range(max(int(limit), 0)):
            got = self.find_and_modify(coll, query, update)
            if got is None:
                break
            out.append(got)
        return out

    def remove(self, coll: str, query: Optional[Query] = None) -> int:
        raise NotImplementedError

    def count(self, coll: str, query: Optional[Query] = None) -> int:
        return len(self.find(coll, query))

    def drop_collection(self, coll: str) -> None:
        raise NotImplementedError

    def collections(self) -> List[str]:
        """Names of the collections that hold at least one document."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryDocStore(DocStore):
    """Dict-backed store; safe for many threads in one process.

    Instances are registered by name so that server and worker objects in
    one process can "connect" to the same store by connection string, the
    way reference processes all dial the same mongod (cnn.lua:34-39).
    """

    _registry: Dict[str, "MemoryDocStore"] = {}
    _registry_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._colls: Dict[str, Dict[str, Doc]] = {}

    @classmethod
    def named(cls, name: str) -> "MemoryDocStore":
        with cls._registry_lock:
            if name not in cls._registry:
                cls._registry[name] = cls()
            return cls._registry[name]

    def insert(self, coll: str, doc: Doc) -> str:
        with self._lock:
            d = copy.deepcopy(doc)
            _id = str(d.setdefault("_id", uuid.uuid4().hex))
            self._colls.setdefault(coll, {})[_id] = d
            return _id

    def find(self, coll: str, query: Optional[Query] = None) -> List[Doc]:
        with self._lock:
            docs = list(self._colls.get(coll, {}).values())
            if query:
                docs = [d for d in docs if matches(d, query)]
            return copy.deepcopy(docs)

    def update(self, coll: str, query: Query, update: Doc,
               multi: bool = False, upsert: bool = False) -> int:
        with self._lock:
            n = 0
            for d in self._colls.get(coll, {}).values():
                if matches(d, query):
                    apply_update(d, update)
                    n += 1
                    if not multi:
                        break
            if n == 0 and upsert:
                base = {k: v for k, v in query.items()
                        if not isinstance(v, dict) and not k.startswith("$")}
                # a doc with this _id existing but failing the query is a
                # conflict, not an upsert (Mongo raises duplicate-key);
                # overwriting would defeat optimistic-concurrency guards
                if "_id" in base and base["_id"] in self._colls.get(coll, {}):
                    return 0
                self.insert(coll, apply_update(base, update))
                n = 1
            return n

    def find_and_modify(self, coll, query, update):
        with self._lock:
            for d in self._colls.get(coll, {}).values():
                if matches(d, query):
                    return copy.deepcopy(apply_update(d, update))
            return None

    def find_and_modify_many(self, coll, query, update, limit=1):
        with self._lock:
            out = []
            for d in self._colls.get(coll, {}).values():
                if len(out) >= limit:
                    break
                if matches(d, query):
                    out.append(copy.deepcopy(apply_update(d, update)))
            return out

    def remove(self, coll: str, query: Optional[Query] = None) -> int:
        with self._lock:
            table = self._colls.get(coll, {})
            if not query:
                n = len(table)
                table.clear()
                return n
            doomed = [k for k, d in table.items() if matches(d, query)]
            for k in doomed:
                del table[k]
            return len(doomed)

    def drop_collection(self, coll: str) -> None:
        with self._lock:
            self._colls.pop(coll, None)

    def collections(self) -> List[str]:
        with self._lock:
            return [c for c, t in self._colls.items() if t]

class DirDocStore(DocStore):
    """Shared-directory store: ``<root>/<collection>/<_id>.json`` per doc.

    Cross-process atomicity: every operation on a collection holds an
    ``fcntl.flock`` on ``<root>/<collection>.lock`` (blocking, exclusive);
    document writes are tempfile + ``os.rename`` so readers in *other*
    collections never see torn JSON.  This is the multi-process analogue of
    the reference's mongod and works on local disk or NFS-with-working-locks.
    """

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._local_locks: Dict[str, threading.Lock] = {}
        self._llock = threading.Lock()
        self._fds: Dict[str, int] = {}
        self._closed = False

    def _coll_dir(self, coll: str) -> str:
        safe = coll.replace("/", "_")
        return os.path.join(self.root, safe)

    def _locked(self, coll: str) -> "_DirLock":
        with self._llock:
            tl = self._local_locks.setdefault(coll, threading.Lock())
        return _DirLock(self, coll, tl)

    def _read_all(self, coll: str) -> Dict[str, Doc]:
        d = self._coll_dir(coll)
        out: Dict[str, Doc] = {}
        if not os.path.isdir(d):
            return out
        for name in os.listdir(d):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, name), "r") as f:
                    doc = json.load(f)
                out[doc["_id"]] = doc
            except (json.JSONDecodeError, OSError, KeyError):
                continue  # torn/garbage file: skip (writer uses atomic rename)
        return out

    def _write_doc(self, coll: str, doc: Doc) -> None:
        d = self._coll_dir(coll)
        os.makedirs(d, exist_ok=True)
        # _ids are arbitrary user keys (str(taskfn key), task.make_job) —
        # quote so "/" or ".." can't escape the collection directory
        safe_id = urllib.parse.quote(str(doc["_id"]), safe="")
        path = os.path.join(d, f"{safe_id}.json")
        tmp = path + f".tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.rename(tmp, path)

    def _delete_doc(self, coll: str, _id: str) -> None:
        safe_id = urllib.parse.quote(str(_id), safe="")
        try:
            os.remove(os.path.join(self._coll_dir(coll), f"{safe_id}.json"))
        except FileNotFoundError:
            pass

    def insert(self, coll: str, doc: Doc) -> str:
        with self._locked(coll):
            d = copy.deepcopy(doc)
            _id = str(d.setdefault("_id", uuid.uuid4().hex))
            d["_id"] = _id
            self._write_doc(coll, d)
            return _id

    def find(self, coll: str, query: Optional[Query] = None) -> List[Doc]:
        with self._locked(coll):
            docs = list(self._read_all(coll).values())
        if query:
            docs = [d for d in docs if matches(d, query)]
        return docs

    def update(self, coll: str, query: Query, update: Doc,
               multi: bool = False, upsert: bool = False) -> int:
        with self._locked(coll):
            n = 0
            for d in self._read_all(coll).values():
                if matches(d, query):
                    apply_update(d, update)
                    self._write_doc(coll, d)
                    n += 1
                    if not multi:
                        break
            if n == 0 and upsert:
                base = {k: v for k, v in query.items()
                        if not isinstance(v, dict) and not k.startswith("$")}
                # same duplicate-_id conflict rule as MemoryDocStore
                if "_id" in base and base["_id"] in self._read_all(coll):
                    return 0
                doc = apply_update(base, update)
                doc.setdefault("_id", uuid.uuid4().hex)
                self._write_doc(coll, doc)
                n = 1
            return n

    def find_and_modify(self, coll, query, update):
        with self._locked(coll):
            for d in self._read_all(coll).values():
                if matches(d, query):
                    apply_update(d, update)
                    self._write_doc(coll, d)
                    return copy.deepcopy(d)
            return None

    def find_and_modify_many(self, coll, query, update, limit=1):
        with self._locked(coll):
            out = []
            for d in self._read_all(coll).values():
                if len(out) >= limit:
                    break
                if matches(d, query):
                    apply_update(d, update)
                    self._write_doc(coll, d)
                    out.append(copy.deepcopy(d))
            return out

    def remove(self, coll: str, query: Optional[Query] = None) -> int:
        with self._locked(coll):
            table = self._read_all(coll)
            doomed = [k for k, d in table.items()
                      if not query or matches(d, query)]
            for k in doomed:
                self._delete_doc(coll, k)
            return len(doomed)

    def drop_collection(self, coll: str) -> None:
        with self._locked(coll):
            d = self._coll_dir(coll)
            if os.path.isdir(d):
                for name in os.listdir(d):
                    try:
                        os.remove(os.path.join(d, name))
                    except FileNotFoundError:
                        pass
                try:
                    os.rmdir(d)
                except OSError:
                    pass

    def collections(self) -> List[str]:
        out = []
        for name in os.listdir(self.root):
            p = os.path.join(self.root, name)
            if os.path.isdir(p) and any(
                    f.endswith(".json") for f in os.listdir(p)):
                out.append(name)
        return out

    def close(self) -> None:
        # refuse new fd opens from this point on, then close every open fd
        # under ITS collection's thread lock — a _DirLock mid-critical-
        # section keeps its flock until __exit__, and a blocked one finds
        # the store closed instead of a stale/reused descriptor
        with self._llock:
            self._closed = True
        while True:
            with self._llock:
                coll = next(iter(self._fds), None)
                if coll is None:
                    return
                tlock = self._local_locks.setdefault(coll, threading.Lock())
            with tlock:
                with self._llock:
                    fd = self._fds.pop(coll, None)
                if fd is not None:
                    try:
                        os.close(fd)
                    except OSError:
                        pass


class _DirLock:
    """Thread lock + flock pair for one DirDocStore collection."""

    def __init__(self, store: DirDocStore, coll: str, tlock: threading.Lock):
        self.store, self.coll, self.tlock = store, coll, tlock

    def __enter__(self):
        self.tlock.acquire()
        try:
            path = os.path.join(self.store.root, f"{self.coll}.lock")
            fd = self.store._fds.get(self.coll)
            if fd is None:
                fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
                # the closed-check and the registration must be one
                # critical section: otherwise a close() racing between
                # them would scan _fds before this entry lands, return,
                # and leave the "closed" store operable with a leaked fd
                with self.store._llock:
                    if self.store._closed:
                        os.close(fd)
                        raise RuntimeError("DirDocStore is closed")
                    self.store._fds[self.coll] = fd
            fcntl.flock(fd, fcntl.LOCK_EX)
        except BaseException:
            # never leave the thread lock held on a failed acquire —
            # that would deadlock every later op on this collection
            self.tlock.release()
            raise
        self.fd = fd
        return self

    def __exit__(self, *exc):
        fcntl.flock(self.fd, fcntl.LOCK_UN)
        self.tlock.release()
        return False


def connect(connstr: str, auth: Optional[str] = None,
            retry=None) -> DocStore:
    """Open a store from a connection string (reference: a mongod host:port,
    utils.lua:62-69).  Forms:

      * ``mem://<name>``       — process-local named MemoryDocStore
      * ``dir:///path``        — DirDocStore rooted at /path
      * ``/abs/path``          — shorthand for dir://
      * ``http://[TOKEN@]HOST:PORT`` — HttpDocStore dialing a DocServer
        (either package's: the wire is the same).  ``auth`` is the
        bearer token of an auth-required server (reference: the
        ``auth_table`` arg of cnn.lua:106-113); it can also ride the
        connstr or $MAPREDUCE_TPU_AUTH (utils/httpclient.py).
        ``retry`` is an optional :class:`~..utils.httpclient.RetryPolicy`
        for the networked backend (the local ones have no wire to fail).
        An unreachable board raises once the policy is spent.
    """
    if connstr.startswith("mem://"):
        return MemoryDocStore.named(connstr[len("mem://"):])
    if connstr.startswith("dir://"):
        return DirDocStore(connstr[len("dir://"):])
    if connstr.startswith("http://"):
        from .docserver import HttpDocStore
        return HttpDocStore(connstr[len("http://"):], auth_token=auth,
                            retry=retry)
    if connstr.startswith("/"):
        return DirDocStore(connstr)
    raise ValueError(
        f"bad connection string {connstr!r} "
        "(want mem://NAME, dir:///PATH, or http://HOST:PORT)")


def now() -> float:
    """Wall-clock used for all lease / timing fields (reference uses
    mongo.time from the C module, utils.lua:78-84)."""
    return time.time()
