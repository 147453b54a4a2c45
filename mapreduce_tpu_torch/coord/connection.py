"""Connection: docstore handle + errors channel + batched inserts (port of
``mapreduce_tpu/coord/connection.py``, without the token embedded in an
``http://`` connstr: the networked board is not ported yet, ROADMAP
A.4b).

Parity with the reference's ``cnn`` class (mapreduce/cnn.lua): connect
(cnn.lua:34-39), the ``errors`` collection as a remote log channel
(cnn.lua:55-71), and buffered batch inserts flushed at
``MAX_PENDING_INSERTS`` (cnn.lua:73-104, 50k in the reference).
"""

from __future__ import annotations

import socket
import traceback
from typing import Any, Dict, List, Optional

from ..utils.constants import MAX_PENDING_INSERTS
from . import docstore
from .docstore import DocStore


class Connection:
    """A named database (collection-name prefix) over a :class:`DocStore`.

    Reference: ``cnn(connstr, dbname, auth)`` (cnn.lua:106-113).  In the
    JAX package ``auth`` is the bearer token of the networked board; the
    in-process and directory boards ported here have no wire to guard,
    so an ``auth`` raises until that board is ported (ROADMAP A.4b).
    """

    def __init__(self, connstr: str, dbname: str,
                 auth: Optional[Any] = None) -> None:
        if auth is not None:
            raise ValueError("auth guards the networked board, which is "
                             "not ported yet (ROADMAP A.4b); pass "
                             "auth=None")
        self.connstr = connstr
        self.dbname = dbname
        self._store: Optional[DocStore] = None
        # pending batched inserts: coll -> docs
        self._pending: Dict[str, List[Dict[str, Any]]] = {}

    # -- connection -----------------------------------------------------

    def connect(self) -> DocStore:
        """Reference: cnn.lua:34-39 (cached connection)."""
        if self._store is None:
            self._store = docstore.connect(self.connstr)
        return self._store

    def ns(self, coll: str) -> str:
        """Namespace a collection under this db (Mongo's ``db.coll``)."""
        return f"{self.dbname}.{coll}"

    # -- errors channel ---------------------------------------------------
    # Reference: cnn.lua:55-71; workers insert, the server drains and
    # prints mid-poll (server.lua:219-228).

    def insert_error(self, worker_name: str, msg: str) -> None:
        self.connect().insert(self.ns("errors"),
                              {"worker": worker_name, "msg": msg,
                               "time": docstore.now()})

    def insert_exception(self, worker_name: str, exc: BaseException) -> None:
        msg = "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__))
        self.insert_error(worker_name, msg)

    def get_errors(self) -> List[Dict[str, Any]]:
        return self.connect().find(self.ns("errors"))

    def remove_errors(self, ids: List[str]) -> None:
        if ids:
            self.connect().remove(self.ns("errors"), {"_id": {"$in": ids}})

    # -- batched inserts --------------------------------------------------
    # Reference: cnn.lua:73-104 `annotate_insert`/`flush_pending_inserts`;
    # the server uses it to bulk-create 50k job docs at a time
    # (server.lua:316-325).

    def annotate_insert(self, coll: str, doc: Dict[str, Any]) -> None:
        self._pending.setdefault(coll, []).append(doc)
        total = sum(len(v) for v in self._pending.values())
        if total >= MAX_PENDING_INSERTS:
            self.flush_pending_inserts(0)

    def flush_pending_inserts(self, min_pending: int = 0) -> None:
        total = sum(len(v) for v in self._pending.values())
        if total <= min_pending:
            return
        store = self.connect()
        for coll, docs in self._pending.items():
            if docs:
                store.insert_many(coll, docs)
        self._pending.clear()

    # -- misc -------------------------------------------------------------

    @staticmethod
    def hostname() -> str:
        """Reference: utils.get_hostname via ``hostname`` (utils.lua:72)."""
        return socket.gethostname()
