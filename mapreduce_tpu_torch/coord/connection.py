"""Connection: docstore handle + errors channel + batched inserts (port of
``mapreduce_tpu/coord/connection.py``).

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

    Reference: ``cnn(connstr, dbname, auth)`` (cnn.lua:106-113); there
    ``auth`` is a ``{user=..., password=...}`` table re-applied on every
    reconnect (cnn.lua:34-39).  Here it is the shared-secret bearer token
    for the networked backends (docserver/blobserver) — pass a plain
    token string, or a reference-shaped dict whose ``password`` (or
    ``token``) field is used.  Ignored by the in-process/dir backends,
    which have no wire to guard.
    """

    def __init__(self, connstr: str, dbname: str,
                 auth: Optional[Any] = None,
                 retry: Optional[Any] = None) -> None:
        self.connstr = connstr
        self.dbname = dbname
        self.auth = auth
        #: RetryPolicy for the networked planes; threaded through to the
        #: board client (connect) AND to any storage handle opened for a
        #: job of this connection (job.py), so one CLI flag set governs
        #: both sockets.  None = httpclient.DEFAULT_RETRY_POLICY.
        self.retry_policy = retry
        self._store: Optional[DocStore] = None
        # pending batched inserts: coll -> docs
        self._pending: Dict[str, List[Dict[str, Any]]] = {}

    def auth_token(self) -> Optional[str]:
        """The bearer token in whatever shape it arrived: the ``auth``
        param (str, or a reference-shaped dict), else embedded in the
        connstr (``http://TOKEN@HOST:PORT``) — so a connstr-carried token
        reaches the storage plane too, not just the board socket."""
        from ..utils.httpclient import split_embedded_token

        if isinstance(self.auth, dict):
            return self.auth.get("password") or self.auth.get("token")
        if self.auth:
            return self.auth
        if self.connstr.startswith("http://"):
            # parse per replica endpoint: a token embedded in ANY
            # member of a multi-endpoint (HA) connstr authenticates
            # the whole replica set
            for member in self.connstr[len("http://"):].split(","):
                token = split_embedded_token(member)[0]
                if token:
                    return token
        return None

    def board_hostports(self) -> List[str]:
        """Every ``HOST:PORT`` of an http:// board connstr — one entry
        per replica of a multi-endpoint (HA) board,
        ``http://[TOKEN@]H1:P1,H2:P2``.  The ambient-auth scope must
        cover ALL of them: a client that failed over mid-job still
        speaks to its own cluster."""
        from ..utils.httpclient import split_embedded_token

        if not self.connstr.startswith("http://"):
            return []
        # split members FIRST, token per member second (the auth_token
        # / FailoverClient parse order): a token embedded in a NON-
        # first member must not eat the earlier members' addresses
        return [split_embedded_token(m)[1]
                for m in self.connstr[len("http://"):].split(",") if m]

    def board_hostport(self) -> Optional[str]:
        """The board address for single-handle consumers (the
        telemetry pushers): every replica of a multi-endpoint board,
        comma-joined — the form FailoverClient/acquire_pusher accept —
        so a pusher follows the primary across a failover."""
        hps = self.board_hostports()
        return ",".join(hps) if hps else None

    # -- connection -----------------------------------------------------

    def connect(self) -> DocStore:
        """Reference: cnn.lua:34-39 (cached connection, auth on connect)."""
        if self._store is None:
            self._store = docstore.connect(self.connstr,
                                           auth=self.auth_token(),
                                           retry=self.retry_policy)
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
