"""Durable shared state: the persistent-table singleton AND the board
mutation log (port of ``mapreduce_tpu/coord/persistent_table.py``).

Parity with mapreduce/persistent_table.lua: a named singleton doc usable as
shared runtime config across processes — ``set``/``update`` with a
timestamp-guarded optimistic write (persistent_table.lua:41-74), spin
``lock``/``unlock`` built on find-and-modify (persistent_table.lua:113-161),
``read_only`` mode, ``drop``.

:class:`MutationLog` is the durability layer UNDER the replicated board
(coord/ha.py): the docserver appends every board mutation to one shared
append-only JSONL file that a standby replica tails and a restarted
process replays.  Its bytes are the JAX package's: one
``json.dumps(entry, separators=(",", ":"), sort_keys=True)`` line an
entry, so a log written by either package replays in the other.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Tuple

from .connection import Connection
from . import docstore


class BoardLogCorruptError(RuntimeError):
    """A COMPLETE line of the board mutation log failed to parse: the
    log is damaged and a replica must refuse to serve from it rather
    than silently skip a mutation and diverge.  (A torn FINAL line
    without its newline is NOT corruption — it is an append the writer
    died inside, whose client never got a response; the reader simply
    stops before it.)"""


class MutationLog:
    """Append-only JSONL mutation log on a shared directory.

    * ``append(entry)`` — one ``os.write`` of one ``\\n``-terminated
      line on an ``O_APPEND`` fd: atomic interleaving between the
      primary and a (fenced, racing) stale writer, immediately visible
      to tailing readers, and durable across SIGKILL of the writer (the
      bytes are the kernel's once write() returns).  ``fsync=True``
      additionally survives host/power death at a per-append cost.
    * ``read_from(offset)`` — parse complete lines from *offset*; the
      tail primitive.  Returns ``(entries, new_offset)``; a trailing
      partial line is left for the next poll.

    Entry ordering IS application ordering: the appender must hold its
    store mutation and the append in one critical section
    (coord/ha.py's ReplicatedDocStore does), so a replay reproduces the
    primary's document state exactly.
    """

    def __init__(self, path: str, fsync: bool = False) -> None:
        self.path = path
        self.fsync = bool(fsync)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_APPEND,
                           0o644)
        self._lock = threading.Lock()
        self.appended = 0

    def append(self, entry: Dict[str, Any]) -> None:
        self.append_many([entry])

    def append_many(self, entries: List[Dict[str, Any]]) -> None:
        """Append *entries* as ONE ``os.write`` — the atomic unit the
        HA dedupe contract rides: a request's mutation entries and its
        recorded response either all reach the log or none do."""
        if not entries:
            return
        data = b"".join(
            (json.dumps(e, separators=(",", ":"), sort_keys=True)
             + "\n").encode()
            for e in entries)
        with self._lock:
            # finish a short write (ENOSPC-with-some-room, NFS): a
            # permanently torn line would read as a garbled COMPLETE
            # line once the next append lands, bricking every replica.
            # An os.write that RAISES propagates — the primary answers
            # an error and nothing was acknowledged.
            view = memoryview(data)
            while view:
                n = os.write(self._fd, view)
                view = view[n:]
            if self.fsync:
                os.fsync(self._fd)
            self.appended += len(entries)

    def size(self) -> int:
        try:
            return os.stat(self.path).st_size
        except FileNotFoundError:
            return 0

    def read_from(self, offset: int,
                  ) -> Tuple[List[Dict[str, Any]], int]:
        """Complete entries from byte *offset* on; ``new_offset`` is
        the position just past the last complete line.  A garbled
        COMPLETE line raises :class:`BoardLogCorruptError`."""
        try:
            with open(self.path, "rb") as f:
                f.seek(offset)
                data = f.read()
        except FileNotFoundError:
            return [], offset
        if not data:
            return [], offset
        end = data.rfind(b"\n")
        if end < 0:
            return [], offset  # only a torn tail so far
        out: List[Dict[str, Any]] = []
        pos = offset
        for line in data[:end + 1].splitlines():
            pos += len(line) + 1
            if not line.strip():
                continue
            try:
                doc = json.loads(line)
                if not isinstance(doc, dict):
                    raise ValueError("entry is not an object")
            except (json.JSONDecodeError, UnicodeDecodeError,
                    ValueError) as exc:
                raise BoardLogCorruptError(
                    f"board log {self.path}: complete line at "
                    f"~byte {pos} unparseable ({exc})") from exc
            out.append(doc)
        return out, offset + end + 1

    def replay(self, offset: int = 0) -> Iterator[Dict[str, Any]]:
        entries, _ = self.read_from(offset)
        return iter(entries)

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None  # type: ignore[assignment]


class PersistentTable:
    """Reference: ``persistent_table(name, {cnn_string, dbname, collection,
    read_only})`` (persistent_table.lua:210-250)."""

    SINGLETON_ID = "unique_key"  # reference pins _id (persistent_table.lua:44)

    def __init__(self, name: str, connection: Connection,
                 collection: str = "persistent_tables",
                 read_only: bool = False) -> None:
        self._name = name
        self._cnn = connection
        self._coll = connection.ns(collection)
        self._read_only = read_only
        self._dirty: Dict[str, Any] = {}
        self._content: Dict[str, Any] = {}
        self.update()

    def _id(self) -> str:
        return f"{self.SINGLETON_ID}.{self._name}"

    # -- sync -------------------------------------------------------------

    def update(self) -> None:
        """Push staged writes (if any) with an optimistic timestamp guard,
        then re-read (persistent_table.lua:41-74)."""
        store = self._cnn.connect()
        if self._dirty and not self._read_only:
            remote = store.find_one(self._coll, {"_id": self._id()})
            base_ts = (remote or {}).get("timestamp", 0)
            fields = {k: v for k, v in self._dirty.items()}
            n = store.update(
                self._coll,
                {"_id": self._id(),
                 "$or": [{"timestamp": base_ts},
                         {"timestamp": {"$exists": False}}]},
                {"$set": fields, "$inc": {"timestamp": 1}},
                upsert=(remote is None),
            )
            if n == 0:
                raise RuntimeError(
                    f"persistent_table {self._name!r}: concurrent update "
                    "conflict (timestamp moved)")
            self._dirty.clear()
        doc = store.find_one(self._coll, {"_id": self._id()})
        self._content = {k: v for k, v in (doc or {}).items()
                         if k not in ("_id", "_lock")}

    def set(self, key: str, value: Any) -> None:
        """Stage a write; visible locally at once, remotely at update()
        (persistent_table.lua:98-111)."""
        if self._read_only:
            raise RuntimeError(f"persistent_table {self._name!r} is read-only")
        self._dirty[key] = value
        self._content[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self._content.get(key, default)

    def __getitem__(self, key: str) -> Any:
        return self._content[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self.set(key, value)

    def __contains__(self, key: str) -> bool:
        return key in self._content

    def dirty(self) -> bool:
        return bool(self._dirty)

    # -- distributed lock -------------------------------------------------
    # Reference: spin-lock via findAndModify on a `_lock` field
    # (persistent_table.lua:113-161).

    def lock(self, timeout: float = 30.0, poll: float = 0.01) -> None:
        store = self._cnn.connect()
        deadline = docstore.now() + timeout
        # ensure the doc exists so find_and_modify has something to grab
        store.update(self._coll, {"_id": self._id()},
                     {"$set": {"_lock_init": True}}, upsert=True)
        while True:
            got = store.find_and_modify(
                self._coll,
                {"_id": self._id(),
                 "$or": [{"_lock": False}, {"_lock": {"$exists": False}}]},
                {"$set": {"_lock": True}})
            if got is not None:
                return
            if docstore.now() > deadline:
                raise TimeoutError(
                    f"persistent_table {self._name!r}: lock timeout")
            time.sleep(poll)

    def unlock(self) -> None:
        self._cnn.connect().update(self._coll, {"_id": self._id()},
                                   {"$set": {"_lock": False}})

    def drop(self) -> None:
        """persistent_table.lua drop: delete the doc; local view empties."""
        self._cnn.connect().remove(self._coll, {"_id": self._id()})
        self._content.clear()
        self._dirty.clear()
