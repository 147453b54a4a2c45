"""Trainer lease: fenced single-writer election through the job board
(port of ``mapreduce_tpu/coord/lease.py``).

ONE writer may advance the optimizer state at a time, a preempted or
partitioned trainer must FENCE at its next step boundary (never
committing a checkpoint a successor could race), and a successor takes
over the moment the lease is free — at once on a clean release, after
expiry on silent death.

The lease is a singleton document in ``<db>.trainer_lease`` on the
board the job plane rides (``mem://`` or ``dir://``; the JAX package's
lease and this one contend on one ``dir://`` board and exclude each
other), mutated only through atomic guarded updates:

  * :meth:`TrainerLease.try_acquire` — ``find_and_modify`` guarded by
    "free or expired"; every successful acquire increments
    ``generation``, the fencing token;
  * :meth:`TrainerLease.heartbeat` — guarded lease extension: False is
    KNOWLEDGE of loss, a transport error proves nothing either way;
  * :meth:`TrainerLease.ensure_owned` — the step-boundary gate ``fit``
    calls: retries transport errors until a definitive answer, raises
    :class:`TrainerFencedError` on loss;
  * :meth:`TrainerLease.release` — clean handoff: holder cleared, expiry
    zeroed, so the successor's acquire succeeds on its next poll.

The board-primary election (:class:`BoardLease`) is the same guarded
singleton, pointed at the HA directory's own ``DirDocStore``
(coord/ha.py).
"""

from __future__ import annotations

import os
import socket
import time
import uuid
from typing import Any, Dict, Optional

from ..obs import metrics as _metrics
from . import docstore
from .connection import Connection
from .task import LeaseLostError

#: default trainer lease (seconds) — epochs are the beat cadence, so
#: this must comfortably exceed one epoch + one checkpoint write.
DEFAULT_TRAINER_LEASE = 15.0

_ACQUIRES = _metrics.counter(
    "mrtpu_trainer_lease_acquires_total",
    "trainer-lease acquisition attempts (labels: outcome=acquired|busy)")
_BEATS = _metrics.counter(
    "mrtpu_trainer_lease_beats_total",
    "trainer-lease heartbeats (labels: outcome=owned|lost|error)")
_FENCES = _metrics.counter(
    "mrtpu_trainer_lease_fences_total",
    "times a trainer fenced itself after losing its lease")
_GENERATION = _metrics.gauge(
    "mrtpu_trainer_lease_generation",
    "fencing token of the lease this process last held")


class TrainerFencedError(LeaseLostError):
    """This trainer's lease is definitively gone (expired and reaped by
    a successor's acquire, or superseded).  Raised at the next step
    boundary; the holder must stop committing state — the successor's
    restored lineage is now authoritative."""


class TrainerLease:
    """Client handle on the singleton trainer-lease document."""

    SINGLETON_ID = "trainer"
    COLL = "trainer_lease"

    def __init__(self, connection: Connection,
                 holder: Optional[str] = None,
                 lease: float = DEFAULT_TRAINER_LEASE) -> None:
        self._cnn = connection
        self.holder = holder or (
            f"trainer-{socket.gethostname()}-{uuid.uuid4().hex[:6]}")
        self.lease = float(lease)
        self.tmpname = uuid.uuid4().hex[:12]
        #: fencing token of OUR current tenure (None = not holding)
        self.generation: Optional[int] = None
        self._seeded = False

    @property
    def ns(self) -> str:
        return self._cnn.ns(self.COLL)

    def _guard(self) -> Dict[str, Any]:
        return {"_id": self.SINGLETON_ID, "holder": self.holder,
                "tmpname": self.tmpname, "generation": self.generation}

    def _seed(self) -> None:
        """Create the singleton iff absent.  The upsert query matches
        only a doc WITHOUT a holder field, and the store's duplicate-_id
        upsert rule refuses to overwrite an existing doc — so two racing
        seeds (or a seed racing an acquire) can never clobber a held
        lease."""
        self._cnn.connect().update(
            self.ns,
            {"_id": self.SINGLETON_ID, "holder": {"$exists": False}},
            {"$set": {"holder": None, "lease_expires": 0.0,
                      "generation": 0}},
            upsert=True)

    def try_acquire(self) -> bool:
        """One atomic claim attempt: succeeds when the lease is free
        (released) or expired (holder presumed dead).  On success this
        handle owns the lease and carries a fresh, strictly increasing
        ``generation``."""
        if not self._seeded:
            # once per handle: a standby polling acquire() pays ONE board
            # round-trip per poll, not a redundant seed upsert beside it
            self._seed()
            self._seeded = True
        doc = self._cnn.connect().find_and_modify(
            self.ns,
            {"_id": self.SINGLETON_ID,
             "$or": [{"holder": None},
                     {"lease_expires": {"$lt": docstore.now()}}]},
            {"$set": {"holder": self.holder, "tmpname": self.tmpname,
                      "lease_expires": docstore.now() + self.lease},
             "$inc": {"generation": 1}})
        if doc is None:
            _ACQUIRES.inc(outcome="busy")
            return False
        self.generation = int(doc["generation"])
        _ACQUIRES.inc(outcome="acquired")
        _GENERATION.set(self.generation)
        return True

    def acquire(self, timeout: Optional[float] = None,
                poll: float = 0.2) -> int:
        """Block until acquired (a successor waiting out a dead holder's
        lease); returns the generation.  *timeout* None waits forever;
        past it, ``TimeoutError``."""
        give_up = (time.monotonic() + timeout) if timeout is not None \
            else None
        while True:
            if self.try_acquire():
                return self.generation
            if give_up is not None and time.monotonic() >= give_up:
                raise TimeoutError(
                    f"trainer lease {self.ns} not acquired within "
                    f"{timeout}s (held by another trainer)")
            time.sleep(poll)

    def heartbeat(self) -> bool:
        """Extend our lease; returns whether we still own it.  False is
        definitive (guarded update matched nothing on a working board);
        a transport failure raises and proves NOTHING — callers that
        need certainty use :meth:`ensure_owned`."""
        if self.generation is None:
            return False
        n = self._cnn.connect().update(
            self.ns, self._guard(),
            {"$set": {"lease_expires": docstore.now() + self.lease}})
        _BEATS.inc(outcome="owned" if n else "lost")
        return n > 0

    def ensure_owned(self, max_wait: Optional[float] = None,
                     poll: float = 0.1) -> None:
        """The step-boundary fence gate: returns only with PROOF of
        ownership; raises :class:`TrainerFencedError` on definitive
        loss.  Transport errors (``OSError``) mean ownership is UNKNOWN:
        retried up to *max_wait* (default: 4 lease periods), after which
        we fence conservatively — we cannot have extended the lease all
        this time, so a successor is free to hold it."""
        if max_wait is None:
            max_wait = 4.0 * self.lease
        give_up = time.monotonic() + max_wait
        while True:
            try:
                owned = self.heartbeat()
            except OSError as exc:
                _BEATS.inc(outcome="error")
                if time.monotonic() >= give_up:
                    _FENCES.inc()
                    raise TrainerFencedError(
                        f"trainer lease unverifiable for {max_wait:.1f}s "
                        f"({exc}); fencing conservatively") from exc
                time.sleep(poll)
                continue
            if owned:
                return
            _FENCES.inc()
            raise TrainerFencedError(
                f"trainer lease lost (holder {self.holder}, "
                f"generation {self.generation}): a successor may hold "
                "it — fencing at this step boundary")

    def release(self) -> bool:
        """Clean handoff: clear the holder so a successor's acquire
        succeeds IMMEDIATELY (no expiry wait).  Guarded — releasing a
        lease we no longer hold is a no-op, never a theft."""
        if self.generation is None:
            return False
        n = self._cnn.connect().update(
            self.ns, self._guard(),
            {"$set": {"holder": None, "lease_expires": 0.0}})
        self.generation = None
        return n > 0

    def peek(self) -> Optional[Dict[str, Any]]:
        """The current lease document."""
        return self._cnn.connect().find_one(
            self.ns, {"_id": self.SINGLETON_ID})


#: default board-primary lease (seconds) — the failover detection
#: window: a SIGKILLed primary's standby takes over within one of
#: these.  Must be comfortably under the board clients' retry deadline
#: (httpclient.BOARD_DEADLINE, 12s) so a mutation in flight at the kill
#: survives the takeover inside its own budget.
DEFAULT_BOARD_LEASE = 2.0


class BoardLease(TrainerLease):
    """The board-primary election: the same guarded singleton
    (seed-iff-absent, free-or-expired claim, ``$inc`` generation
    fencing token) pointed at the HA directory's own little
    :class:`~.docstore.DirDocStore` — the one store that must NOT live
    on the board it elects.  The generation is stamped into every
    mutation-log entry the holder appends, so a deposed primary's
    straggling appends are identifiable (and skipped) on replay
    (coord/ha.py)."""

    SINGLETON_ID = "board"
    COLL = "board_lease"

    def __init__(self, cnn, holder: Optional[str] = None,
                 lease: float = DEFAULT_BOARD_LEASE) -> None:
        super().__init__(
            cnn,
            holder=holder or (f"board-{socket.gethostname()}-"
                              f"{os.getpid()}-{uuid.uuid4().hex[:6]}"),
            lease=lease)
