"""Engine-host fleet membership: leases, mesh facts and task routes
(port of ``mapreduce_tpu/coord/fleet.py``).

The board survives its own death and the spill plane makes any single
stream durable; this module makes the serving tier more than ONE engine
host:

  * :class:`HostLease`: one generation-fenced lease document PER HOST
    in ``__fleet__.hosts`` (coord/lease.py's guarded singleton with the
    host id as the document id): a host that stops heartbeating is
    *expired*, and a returning zombie's guarded writes match nothing
    once a sweep reaps it.
  * :class:`FleetMember`: the session host's handle: join (acquire),
    heartbeat liveness PLUS ``local_mesh_facts`` (compile-ledger
    warmth, the card's memory fraction) in one guarded write whose
    post-image answers the board's requests back (the ``drain`` flag),
    leave (clean release).
  * :class:`FleetRegistry`: the board and scheduler view: live and
    expired hosts, the ``__fleet__.routes`` task->host table mutated
    only by guarded updates (a raced re-route resolves to one winner),
    advisor sync (every live host's facts registered under its host
    id, dead hosts unregistered), and the guarded :meth:`~FleetRegistry.
    reap` that makes a failed-host sweep fire exactly once.
  * :func:`rehome_routes`: the shared move planner: score live hosts
    as the AdmissionAdvisor scores placements (warmth beats cold,
    headroom breaks ties, pressure penalised), re-route every stream of
    a dead or draining host, count each move and record it in the
    control ledger.  The recovery sweep (sched/scheduler.py) and
    ``cli drain`` are each one call to it.

The collections, the documents, the constants and the four metric
families are the JAX package's, so either package's registry reads the
fleet the other's members wrote.

Durability contract: routes and host docs live on the SAME board the
job collections ride (mem/dir/http), so fleet state survives any
process death the board survives; the streams themselves are durable in
the spill store, and restore is lazy: a re-homed stream costs nothing
until its next touch.

Monotonic-only module: lease waits are durations; every persisted stamp
(lease expiry, facts age, route moves) is minted through
coord/docstore.now like the rest of the board.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Dict, List, Optional, Tuple

from ..obs import metrics as _metrics
from . import docstore
from .lease import TrainerLease
from .task import LeaseLostError

#: reserved database prefix for fleet state on the board
FLEET_DB = "__fleet__"
HOSTS_COLL = f"{FLEET_DB}.hosts"
ROUTES_COLL = f"{FLEET_DB}.routes"

#: default host lease (seconds) — the failed-host detection window: a
#: SIGKILLed engine host's streams are re-homeable one of these after
#: its last beat.  Hosts beat every serve-loop turn (~1s), so this
#: tolerates a few missed beats without flapping.
DEFAULT_HOST_LEASE = 5.0

#: a host at or above this device-memory fraction is pressure-penalized
#: as a re-home destination (the AdmissionAdvisor.PRESSURE_FRAC policy,
#: restated here so coord/ stays free of engine imports)
PRESSURE_FRAC = 0.8

_HOSTS = _metrics.gauge(
    "mrtpu_fleet_hosts",
    "registered engine hosts by membership state (labels: state="
    "live|draining|expired|left) — whole-family swap at every "
    "fleet snapshot and registry sweep")
_BEATS = _metrics.counter(
    "mrtpu_fleet_heartbeats_total",
    "engine-host fleet heartbeats (labels: host, outcome=owned|lost) "
    "— 'lost' is DEFINITIVE (the guarded write matched nothing over a "
    "working RPC): the host has been reaped or superseded and must "
    "stop serving")
_RECOVERIES = _metrics.counter(
    "mrtpu_fleet_recoveries_total",
    "failed-host recovery sweeps that re-homed an expired host's "
    "streams (labels: host) — one increment per reaped host, however "
    "many streams moved")
_MIGRATIONS = _metrics.counter(
    "mrtpu_session_migrations_total",
    "live session migrations between engine hosts (labels: task, "
    "reason=explicit|rebalance|drain|recovery) — every migration is "
    "spill-on-src + guarded route flip + lazy restore-on-dst, and "
    "every one lands in the control ledger (controller=fleet)")


class HostFencedError(LeaseLostError):
    """This engine host's fleet lease is definitively gone (expired and
    reaped by a recovery sweep, or superseded): its streams may already
    be re-homed — the host must stop serving them and rejoin as a
    fresh member."""


def default_host_id() -> str:
    """The unique per-process host id (``hostname:pid``) — two runners
    on one board must not clobber each other's membership or
    ``register_mesh`` facts."""
    return f"{socket.gethostname()}:{os.getpid()}"


class _FleetCnn:
    """Minimal Connection shape over a raw DocStore (connect() + ns())
    so fleet leases ride any board the caller already holds."""

    def __init__(self, store: docstore.DocStore) -> None:
        self._store = store

    def connect(self) -> docstore.DocStore:
        return self._store

    def ns(self, coll: str) -> str:
        return f"{FLEET_DB}.{coll}"


class HostLease(TrainerLease):
    """One engine host's membership lease: coord/lease.py's guarded
    document (seed-iff-absent, free-or-expired claim, ``$inc``
    generation fencing token) with the HOST ID as the document id —
    N hosts, N independent lease docs in ``__fleet__.hosts``.  Beats
    and fences count in the shared trainer-lease metric family."""

    COLL = "hosts"

    def __init__(self, cnn, host_id: str,
                 holder: Optional[str] = None,
                 lease: float = DEFAULT_HOST_LEASE) -> None:
        super().__init__(
            cnn,
            holder=holder or f"host-{host_id}",
            lease=lease)
        #: instance-level shadow of the class attribute: every guarded
        #: query in TrainerLease goes through self.SINGLETON_ID, so
        #: this one assignment points the whole machinery at our doc
        self.SINGLETON_ID = str(host_id)


class FleetMember:
    """The session-host side of the fleet: join, beat facts, leave.

    The heartbeat is ONE guarded ``find_and_modify`` that extends the
    lease and refreshes the host's placement facts, and whose returned
    post-image carries the board's requests back (today: the ``drain``
    flag ``cli drain`` sets) — membership, telemetry and control ride
    a single board round-trip per beat."""

    def __init__(self, store: docstore.DocStore,
                 host_id: Optional[str] = None,
                 lease: float = DEFAULT_HOST_LEASE,
                 holder: Optional[str] = None) -> None:
        self.store = store
        self.host_id = str(host_id or default_host_id())
        self.lease = HostLease(_FleetCnn(store), self.host_id,
                               holder=holder, lease=lease)

    @property
    def generation(self) -> Optional[int]:
        return self.lease.generation

    def join(self, timeout: Optional[float] = None,
             warm_programs=(), hbm_frac: Optional[float] = None) -> int:
        """Acquire this host's lease (blocking up to *timeout*; a dead
        predecessor under the same id is waited out) and publish the
        first facts; returns the fencing generation."""
        gen = self.lease.acquire(timeout=timeout)
        self.heartbeat(warm_programs=warm_programs, hbm_frac=hbm_frac)
        return gen

    def heartbeat(self, warm_programs=None,
                  hbm_frac: Optional[float] = None,
                  ) -> Optional[Dict[str, Any]]:
        """Extend the lease and (when given) refresh the host's mesh
        facts; returns the post-image host doc — ``doc["drain"]`` is
        the board asking this host to migrate off and leave — or None
        on DEFINITIVE loss (reaped/superseded; the host must fence)."""
        if self.lease.generation is None:
            return None
        sets: Dict[str, Any] = {
            "lease_expires": docstore.now() + self.lease.lease}
        if warm_programs is not None or hbm_frac is not None:
            sets["facts"] = {
                "warm": sorted(str(p) for p in (warm_programs or ())),
                "hbm_frac": None if hbm_frac is None
                else float(hbm_frac),
            }
            sets["facts_time"] = docstore.now()
        doc = self.store.find_and_modify(
            self.lease.ns, self.lease._guard(), {"$set": sets})
        _BEATS.inc(host=self.host_id,
                   outcome="owned" if doc is not None else "lost")
        if doc is None:
            self.lease.generation = None
        return doc

    def ensure_member(self) -> Dict[str, Any]:
        """Heartbeat that raises :class:`HostFencedError` on definitive
        loss — the serve-loop gate (the ``ensure_owned`` shape)."""
        doc = self.heartbeat()
        if doc is None:
            raise HostFencedError(
                f"host {self.host_id!r} lost its fleet lease: a "
                "recovery sweep may have re-homed its streams — stop "
                "serving and rejoin")
        return doc

    def leave(self) -> bool:
        """Clean departure: clear the holder so the host shows as left
        (not expired) and a successor under the same id joins with no
        reap wait."""
        return self.lease.release()


def host_state(doc: Dict[str, Any], now: float) -> str:
    """Classify one host doc against the board clock *now* (a wall
    stamp minted by docstore.now — the /statusz lease-view license)."""
    if doc.get("holder") is None:
        return "left"
    if float(doc.get("lease_expires") or 0.0) <= now:
        return "expired"
    return "draining" if doc.get("drain") else "live"


class FleetRegistry:
    """The board-side fleet view: membership, routes, advisor sync."""

    def __init__(self, store: docstore.DocStore) -> None:
        self.store = store

    # -- membership --------------------------------------------------------

    def hosts(self) -> List[Dict[str, Any]]:
        return self.store.find(HOSTS_COLL)

    def _by_state(self, state: str,
                  now: Optional[float] = None) -> List[Dict[str, Any]]:
        now = docstore.now() if now is None else now
        return [d for d in self.hosts() if host_state(d, now) == state]

    def live_hosts(self, now: Optional[float] = None,
                   ) -> List[Dict[str, Any]]:
        """Hosts holding an unexpired lease (draining hosts count:
        they still serve until their drain completes, they are only
        excluded as re-home DESTINATIONS)."""
        now = docstore.now() if now is None else now
        return [d for d in self.hosts()
                if host_state(d, now) in ("live", "draining")]

    def expired_hosts(self, now: Optional[float] = None,
                      ) -> List[Dict[str, Any]]:
        """Hosts whose lease lapsed without a release — the recovery
        sweep's input (a cleanly-left host is NOT here: its streams
        were drained before release)."""
        return self._by_state("expired", now)

    def request_drain(self, host_id: str) -> bool:
        """Ask *host_id* to migrate everything off and leave: the flag
        rides back on its next heartbeat's post-image."""
        return self.store.update(
            HOSTS_COLL, {"_id": str(host_id)},
            {"$set": {"drain": True,
                      "drain_time": docstore.now()}}) > 0

    def reap(self, doc: Dict[str, Any]) -> bool:
        """Guarded burial of an expired host: clears the holder ONLY if
        the doc still matches the (holder, generation) the sweep saw —
        two racing sweeps reap once, and a zombie host's next guarded
        heartbeat matches nothing (it fences instead of resurrecting a
        re-homed fleet slice)."""
        return self.store.update(
            HOSTS_COLL,
            {"_id": doc["_id"], "holder": doc.get("holder"),
             "generation": doc.get("generation")},
            {"$set": {"holder": None, "lease_expires": 0.0,
                      "drain": False,
                      "reaped_time": docstore.now()}}) > 0

    # -- task -> host routes -----------------------------------------------

    def route(self, task: str) -> Optional[Dict[str, Any]]:
        return self.store.find_one(ROUTES_COLL, {"_id": str(task)})

    def routes_for(self, host_id: str) -> List[Dict[str, Any]]:
        return self.store.find(ROUTES_COLL, {"host": str(host_id)})

    def assign(self, task: str, host_id: str,
               program: Optional[str] = None,
               reason: str = "place") -> None:
        """Place *task* on *host_id* (fresh streams; an existing route
        is re-pointed — placement is the scheduler's call to make).
        *program* is remembered so later re-homes can score warmth."""
        sets: Dict[str, Any] = {"host": str(host_id),
                                "moved_time": docstore.now(),
                                "reason": str(reason)}
        if program is not None:
            sets["program"] = str(program)
        self.store.update(ROUTES_COLL, {"_id": str(task)},
                          {"$set": sets}, upsert=True)

    def reroute(self, task: str, dst_host: str,
                expect_src: Optional[str] = None) -> bool:
        """Guarded route flip: wins only while the route still points
        at *expect_src* (when given) — a migration racing a recovery
        sweep resolves to exactly one move."""
        guard: Dict[str, Any] = {"_id": str(task)}
        if expect_src is not None:
            guard["host"] = str(expect_src)
        return self.store.find_and_modify(
            ROUTES_COLL, guard,
            {"$set": {"host": str(dst_host),
                      "moved_time": docstore.now()}}) is not None

    def drop_route(self, task: str) -> None:
        self.store.remove(ROUTES_COLL, {"_id": str(task)})

    # -- advisor sync ------------------------------------------------------

    def sync_advisor(self, advisor,
                     now: Optional[float] = None) -> None:
        """Mirror the fleet into an AdmissionAdvisor: every live host's
        heartbeat facts registered under its host id, every dead/left
        host unregistered — the scheduler's placement is then over the
        REAL fleet, not one advisory mesh.  Entries the advisor holds
        that never were fleet hosts (an embedder's own register_mesh)
        are left alone."""
        if advisor is None:
            return
        now = docstore.now() if now is None else now
        docs = {str(d["_id"]): d for d in self.hosts()}
        for host_id, doc in sorted(docs.items()):
            facts = doc.get("facts") or {}
            if host_state(doc, now) in ("live", "draining"):
                advisor.register_mesh(
                    host_id, warm_programs=facts.get("warm") or (),
                    hbm_frac=facts.get("hbm_frac"))
            else:
                advisor.unregister_mesh(host_id)


def _score_host(doc: Dict[str, Any],
                program: Optional[str]) -> Tuple[float, Dict[str, Any]]:
    """AdmissionAdvisor's mesh score over a host doc's heartbeat facts:
    warm beats cold, headroom breaks ties, pressure penalized."""
    facts = doc.get("facts") or {}
    warm = (program is not None
            and str(program) in set(facts.get("warm") or ()))
    frac = facts.get("hbm_frac")
    frac = None if frac is None else float(frac)
    headroom = 1.0 - (0.5 if frac is None
                      else min(max(frac, 0.0), 1.0))
    score = (2.0 if warm else 0.0) + headroom
    if frac is not None and frac >= PRESSURE_FRAC:
        score -= 2.0
    return score, {"warm": warm, "hbm_frac": frac,
                   "score": round(score, 4)}


def rehome_routes(registry: FleetRegistry, src_host: str,
                  reason: str, ledger=None,
                  now: Optional[float] = None,
                  ) -> List[Tuple[str, str]]:
    """Move every stream routed at *src_host* to the best live host
    (excluding *src_host* and draining hosts): the route flips are
    guarded (a stream someone else already moved is skipped, not
    stolen), each move is counted in ``mrtpu_session_migrations_total``
    and recorded as a control-ledger ``fleet`` decision.  Returns the
    ``(task, dst_host)`` moves made.  The streams themselves need no
    touch — they are durable in the spill store and restore lazily on
    the destination's next feed/snapshot."""
    now = docstore.now() if now is None else now
    candidates = [d for d in registry.live_hosts(now)
                  if str(d["_id"]) != str(src_host)
                  and host_state(d, now) == "live"]
    routes = registry.routes_for(src_host)
    if not routes:
        return []
    if not candidates:
        # nowhere to go: the streams stay routed at the dead host and
        # the NEXT sweep (with a live host back) moves them — durable
        # state means deferral, never loss.  Loud, because a fleet
        # with zero live hosts is an operator page, not a detail.
        if ledger is not None:
            ledger.record(
                "fleet", "-",
                {"src": str(src_host), "streams": len(routes),
                 "live_candidates": 0},
                {"reason": str(reason), "deferred": True},
                outcome="refused",
                note=f"cannot re-home {len(routes)} stream(s) off "
                     f"{src_host}: no live destination host")
        return []
    moves: List[Tuple[str, str]] = []
    for rt in sorted(routes, key=lambda r: str(r["_id"])):
        task = str(rt["_id"])
        program = rt.get("program")
        scored = {str(d["_id"]): _score_host(d, program)
                  for d in candidates}
        dst = max(scored, key=lambda h: (scored[h][0], h))
        if not registry.reroute(task, dst, expect_src=src_host):
            continue  # raced another mover: its flip stands
        _MIGRATIONS.inc(task=task, reason=str(reason))
        moves.append((task, dst))
        if ledger is not None:
            ledger.record(
                "fleet", task,
                {"src": str(src_host), "program": program,
                 "candidates": {h: s[1] for h, s in scored.items()}},
                {"dst": dst, "reason": str(reason)},
                outcome="applied",
                note=f"re-homed {task} off {src_host} to {dst} "
                     f"({reason}, "
                     + ("warm" if scored[dst][1]["warm"] else "cold")
                     + ")")
    return moves


def fleet_snapshot(store: docstore.DocStore,
                   now: Optional[float] = None) -> Dict[str, Any]:
    """The /statusz fleet section: per-host membership state, lease
    headroom, heartbeat facts and resident-route counts, plus the
    route total.  Empty when no host ever joined (the section stays
    off the page).  Refreshes the ``mrtpu_fleet_hosts`` gauge family
    as a side effect, so a /metrics scrape is always current."""
    docs = store.find(HOSTS_COLL)
    routes = store.find(ROUTES_COLL)
    if not docs and not routes:
        return {}
    now = docstore.now() if now is None else now
    hosts: Dict[str, Dict[str, Any]] = {}
    counts: Dict[str, int] = {}
    for d in docs:
        state = host_state(d, now)
        counts[state] = counts.get(state, 0) + 1
        facts = d.get("facts") or {}
        hosts[str(d["_id"])] = {
            "state": state,
            "generation": int(d.get("generation") or 0),
            "lease_expires_in": round(
                float(d.get("lease_expires") or 0.0) - now, 3),
            "warm_programs": len(facts.get("warm") or ()),
            "hbm_frac": facts.get("hbm_frac"),
            "streams": 0,
        }
    unrouted = 0
    for rt in routes:
        h = hosts.get(str(rt.get("host")))
        if h is None:
            unrouted += 1
        else:
            h["streams"] += 1
    _HOSTS.replace([({"state": s}, n)
                    for s, n in sorted(counts.items())])
    out: Dict[str, Any] = {"hosts": hosts, "routes": len(routes)}
    if unrouted:
        out["routes_unhosted"] = unrouted
    return out
