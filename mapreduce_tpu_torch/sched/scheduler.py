"""Board-resident multi-tenant task scheduler (port of
``mapreduce_tpu/sched/scheduler.py``).

Every piece of scheduler state is a DOCUMENT on the job board (the same
DocStore the task/job collections ride — mem/dir/http all work), so the
scheduler is crash-safe by construction: a restarted scheduler process
re-acquires the singleton lease and continues from the documents, the
way a restarted server resumes a crashed task (server.lua:468-491).

Collections (reserved ``__sched__`` database prefix, invisible to the
per-task board views):

  * ``__sched__.tasks`` — one doc per submitted task: tenant, target
    db, server params, priority/weight, state machine
    ``QUEUED -> ADMITTED -> RUNNING -> DONE`` (with ``CANCELLED`` /
    ``FAILED`` exits from any non-terminal state);
  * ``__sched__.tenants`` — per-tenant fair-share accounting (served
    cost, served records), ``$inc``-maintained so it survives crashes;
  * ``__sched__.state`` — the submit-sequence singleton;
  * ``__sched__.scheduler_lease`` — the fenced single-admitter
    election (:class:`SchedulerLease`, the coord/lease.py pattern at
    scheduler granularity): only the lease holder promotes QUEUED
    tasks, and a deposed scheduler's next :meth:`Scheduler.tick`
    learns it definitively and stops admitting.

Admission control on submit: per-tenant quotas on queued tasks / total
queued ``est_jobs`` / total queued ``est_bytes``, plus the two-Servers-
one-db guard — a submit naming a database that is already active
(queued/admitted/running) is REJECTED, because two Servers driving ONE
db would interleave their stats-gauge publish/read-back cycles and
persist each other's numbers (the hazard server.py's db-label comment
warns about; db labels keep *distinct* dbs apart, nothing before this
guard kept two tasks off the SAME db).

Dequeue: weighted-fair across tenants (pick the tenant with the lowest
``served_cost / weight``, charging ``max(est_jobs, 1)`` at admission),
priority + submit order within a tenant.  The global ``max_inflight``
bound is the card's concurrency budget.

The task docs, the tenant docs and each :class:`QuotaExceededError`
reason are the JAX package's field for field, so either package's
scheduler continues from the other's documents.  ``advisor=`` (an
:class:`~..engine.autotune.AdmissionAdvisor`) routes each admitted task
to a registered placement and sets ``mesh`` on its doc.  ``fleet=`` (a
:class:`~..coord.fleet.FleetRegistry`) mirrors the live engine hosts
into the advisor at every tick, records each placement as a fleet route,
and runs the failed-host :meth:`Scheduler.recovery_sweep`.
"""

from __future__ import annotations

import itertools
import json
import threading
import uuid
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional

from ..coord import docstore
from ..coord.lease import TrainerLease
from ..coord.task import LeaseLostError
from ..obs import metrics as _metrics
from ..obs import slo as _slo
from ..utils.constants import STATUS

#: reserved database prefix for scheduler state on the board
SCHED_DB = "__sched__"
TASKS_COLL = f"{SCHED_DB}.tasks"
TENANTS_COLL = f"{SCHED_DB}.tenants"
STATE_COLL = f"{SCHED_DB}.state"
#: one reservation doc per ACTIVE task db — the cross-process form of
#: the one-Server-per-db guard (see Scheduler._reserve_db)
DBS_COLL = f"{SCHED_DB}.dbs"

#: a db reservation whose owning task doc is ABSENT is presumed to be a
#: submit caught between reserve and insert until this many seconds
#: old; past it the reservation is a crashed submit's leak, reclaimable
#: by a guarded steal
DB_RESERVE_GRACE = 30.0

#: the task state machine
QUEUED = "QUEUED"
ADMITTED = "ADMITTED"
RUNNING = "RUNNING"
DONE = "DONE"
CANCELLED = "CANCELLED"
FAILED = "FAILED"

#: states that hold a db active (the one-Server-per-db guard) and that
#: :meth:`Scheduler.cancel` can still reach
ACTIVE_STATES = (QUEUED, ADMITTED, RUNNING)
#: states counted against the global ``max_inflight`` bound
INFLIGHT_STATES = (ADMITTED, RUNNING)

_QUEUE_DEPTH = _metrics.gauge(
    "mrtpu_sched_queue_depth",
    "scheduler tasks by tenant and state (labels: tenant, state) — "
    "refreshed on every scheduler mutation and at /statusz scrape")
_QUEUED_WORK = _metrics.gauge(
    "mrtpu_sched_queued_work",
    "declared work waiting in a tenant's queue (labels: tenant, "
    "unit=jobs|bytes) — the quantities the per-tenant admission "
    "quotas bound")
_ADMISSION = _metrics.counter(
    "mrtpu_sched_admission_total",
    "submit admission decisions (labels: tenant, outcome=accepted|"
    "rejected, reason=-|queued_tasks|queued_jobs|queued_bytes|"
    "db_active)")
_TASK_EVENTS = _metrics.counter(
    "mrtpu_sched_tasks_total",
    "scheduler task state transitions (labels: tenant, event="
    "submitted|admitted|running|done|cancelled|failed)")
_SERVED_RECORDS = _metrics.counter(
    "mrtpu_sched_served_records_total",
    "records served per tenant, as reported by runners and engine "
    "sessions via Scheduler.note_served (labels: tenant)")
_FENCES = _metrics.counter(
    "mrtpu_sched_fences_total",
    "ticks a scheduler refused to admit because its lease was "
    "definitively lost (a successor owns admission now)")
_OLDEST_AGE = _metrics.gauge(
    "mrtpu_sched_oldest_queued_age_seconds",
    "age of each tenant's oldest QUEUED task, from the task docs' "
    "persisted submit stamps (labels: tenant) — queue DEPTH says how "
    "many wait, this says how LONG: backpressure is visible before it "
    "bites; whole-family swap on every scheduler mutation and at "
    "snapshot scrape")


class QuotaExceededError(RuntimeError):
    """A submit was refused by admission control.  ``reason`` is the
    quota that tripped (``queued_tasks`` / ``queued_jobs`` /
    ``queued_bytes`` / ``db_active``)."""

    def __init__(self, msg: str, reason: str) -> None:
        super().__init__(msg)
        self.reason = reason


class SchedulerFencedError(LeaseLostError):
    """This scheduler's admission lease is definitively gone — a
    successor scheduler owns dequeue now (strict tick() only; the
    docserver-hosted scheduler fences quietly and re-contends)."""


class _SchedCnn:
    """Minimal Connection shape over a raw DocStore for the lease
    (connect() + ns()), so the docserver can run a scheduler on the
    store it already owns with no loopback socket."""

    def __init__(self, store: docstore.DocStore) -> None:
        self._store = store

    def connect(self) -> docstore.DocStore:
        return self._store

    def ns(self, coll: str) -> str:
        return f"{SCHED_DB}.{coll}"


class SchedulerLease(TrainerLease):
    """The fenced single-admitter election: coord/lease.py's guarded
    singleton (seed-iff-absent, free-or-expired claim, ``$inc``
    generation fencing token) pointed at ``__sched__.scheduler_lease``.
    Beats/fences count in the shared trainer-lease metric family."""

    SINGLETON_ID = "scheduler"
    COLL = "scheduler_lease"

    #: schedulers tick at sub-second cadence; the lease only needs to
    #: outlive a few ticks, not an epoch + checkpoint
    DEFAULT_LEASE = 10.0

    def __init__(self, cnn, holder: Optional[str] = None,
                 lease: float = DEFAULT_LEASE) -> None:
        import socket

        super().__init__(
            cnn,
            holder=holder or (f"sched-{socket.gethostname()}-"
                              f"{uuid.uuid4().hex[:6]}"),
            lease=lease)


@dataclass(frozen=True)
class SchedulerConfig:
    """Admission-control knobs."""

    #: tasks allowed ADMITTED+RUNNING at once (the card/worker-pool
    #: concurrency budget)
    max_inflight: int = 2
    #: per-tenant quota: tasks waiting in the queue
    tenant_max_queued_tasks: int = 16
    #: per-tenant quota: sum of queued tasks' declared ``est_jobs``
    tenant_max_queued_jobs: int = 100_000
    #: per-tenant quota: sum of queued tasks' declared ``est_bytes``
    tenant_max_queued_bytes: int = 1 << 30
    #: retention: terminal (DONE/CANCELLED/FAILED) task docs kept on
    #: the board for the list/snapshot history; the oldest beyond this
    #: are pruned at each terminal transition — an always-on service
    #: must not grow its board (and every full-collection scan) with
    #: every task it ever served
    keep_terminal_tasks: int = 200


class Scheduler:
    """The scheduler over a DocStore (direct) — host it next to the
    store (the docserver does) or build one over any connected board.

    Thread-safety and scope: every state TRANSITION is a guarded
    ``find_and_modify`` (a raced cancel always wins over a promote),
    admission is serialized by the lease (one admitter cluster-wide),
    and the one-Server-per-db guard is a board-atomic reservation
    (:meth:`_reserve_db`) — those three hold across processes.  The
    per-tenant QUOTA sums, by contrast, are read-sum-insert under a
    process-local lock: they are resource POLICY, enforced exactly
    within one scheduler frontend; N frontends submitting for one
    tenant concurrently can transiently overshoot a quota by up to
    N-1 submits.  Route submissions through one frontend (the
    docserver's ``/tasks``) where exact quotas matter.
    """

    def __init__(self, store: docstore.DocStore,
                 config: SchedulerConfig = SchedulerConfig(),
                 lease: Optional[SchedulerLease] = None,
                 use_lease: bool = True,
                 holder: Optional[str] = None,
                 advisor: Optional[Any] = None,
                 fleet: Optional[Any] = None) -> None:
        self.store = store
        self.config = config
        self.lease = lease if lease is not None else (
            SchedulerLease(_SchedCnn(store), holder=holder)
            if use_lease else None)
        #: telemetry-informed admission (engine/autotune.
        #: AdmissionAdvisor): an admitted task is ROUTED to the
        #: registered placement warm for its program with the most
        #: memory headroom (the pick lands in the control ledger).
        #: None, the default, admits exactly as before.
        self.advisor = advisor
        #: the engine-host fleet (coord/fleet.FleetRegistry): when
        #: attached, every tick (lease-gated, so ONE sweeper
        #: cluster-wide) mirrors live hosts' heartbeat facts into the
        #: advisor, runs the failed-host recovery sweep (an expired
        #: host's streams re-home to live hosts; lazy restore makes
        #: them servable after one sweep), and an admitted task's
        #: placement lands in the fleet's task->host route table.  None,
        #: the default, is the single-host scheduler.
        self.fleet = fleet
        self._lock = threading.Lock()

    # -- submit (admission control) ---------------------------------------

    def _seq(self) -> int:
        self.store.update(
            STATE_COLL, {"_id": "sched", "seq": {"$exists": False}},
            {"$set": {"seq": 0}}, upsert=True)
        doc = self.store.find_and_modify(
            STATE_COLL, {"_id": "sched"}, {"$inc": {"seq": 1}})
        return int(doc["seq"])

    def _reserve_db(self, db: str, task_id: str) -> bool:
        """Atomically reserve *db* for *task_id* on the BOARD — the
        cross-process one-Server-per-db guard (a process-local lock
        cannot stop two schedulers over one shared store from both
        passing a count check).  The acquire is a guarded upsert (the
        store's duplicate-_id conflict rule refuses to overwrite an
        existing reservation, mem/dir/http alike); a reservation whose
        owning task is terminal — or absent past the grace window (a
        crashed submit) — is reclaimed by a guarded steal."""
        for _ in range(3):
            n = self.store.update(
                DBS_COLL, {"_id": db, "task": {"$exists": False}},
                {"$set": {"task": task_id,
                          "reserved_time": docstore.now()}},
                upsert=True)
            if n:
                return True
            doc = self.store.find_one(DBS_COLL, {"_id": db})
            if doc is None:
                continue  # raced a release; try the upsert again
            holder = doc.get("task")
            held = self.store.find_one(TASKS_COLL, {"_id": holder})
            if held is not None and held.get("state") in ACTIVE_STATES:
                return False  # genuinely active: refuse
            if held is None and (docstore.now()
                                 - float(doc.get("reserved_time") or 0)
                                 < DB_RESERVE_GRACE):
                # another submit is between reserve and insert: its
                # claim is valid, ours loses
                return False
            if held is not None and (docstore.now()
                                     - float(held.get("done_time") or 0)
                                     < DB_RESERVE_GRACE):
                # terminal holder whose reservation was deliberately
                # left for its task thread to release (cancel of a RUNNING
                # task): that thread is still draining — stealing now
                # would put two Servers on one db.  Past the grace the
                # thread is presumed dead and the leak reclaimable.
                return False
            # stale (terminal task, or a crashed submit past grace):
            # guarded steal — only wins if nobody else stole first
            if self.store.update(
                    DBS_COLL, {"_id": db, "task": holder},
                    {"$set": {"task": task_id,
                              "reserved_time": docstore.now()}}):
                return True
        return False

    def _release_db(self, doc: Dict[str, Any]) -> None:
        """Free a terminal task's db reservation (guarded: only the
        owning task's reservation is removed, never a successor's)."""
        db = doc.get("db")
        if db:
            self.store.remove(DBS_COLL,
                              {"_id": db, "task": doc["_id"]})

    def submit(self, tenant: str, db: Optional[str] = None,
               params: Optional[Dict[str, Any]] = None,
               priority: int = 0, weight: float = 1.0,
               est_jobs: int = 0, est_bytes: int = 0,
               kind: str = "server") -> Dict[str, Any]:
        """Queue one task for *tenant*; raises
        :class:`QuotaExceededError` when admission control refuses it.

        *db* is the task's database on the board (auto-generated when
        omitted); *params* the ``Server.configure`` table a runner will
        drive it with (``kind="session"`` tasks carry none — a resident
        :class:`~..engine.session.EngineSession` serves them).
        *est_jobs* / *est_bytes* are the tenant's declared cost, the
        quantities its queue quotas bound and the weighted-fair charge.
        """
        tenant = str(tenant)
        cfg = self.config
        with self._lock:
            queued = self.store.find(TASKS_COLL,
                                     {"tenant": tenant, "state": QUEUED})
            reason = None
            if len(queued) >= cfg.tenant_max_queued_tasks:
                reason = "queued_tasks"
            elif (sum(int(q.get("est_jobs") or 0) for q in queued)
                    + int(est_jobs) > cfg.tenant_max_queued_jobs):
                reason = "queued_jobs"
            elif (sum(int(q.get("est_bytes") or 0) for q in queued)
                    + int(est_bytes) > cfg.tenant_max_queued_bytes):
                reason = "queued_bytes"
            if reason is not None:
                _ADMISSION.inc(tenant=tenant, outcome="rejected",
                               reason=reason)
                raise QuotaExceededError(
                    f"submit refused for tenant {tenant!r}: {reason} "
                    f"(config {asdict(cfg)})", reason)
            seq = self._seq()
            task_id = f"{tenant}-{seq:06d}"
            db = db or f"t_{task_id}"
            # the two-Servers-one-db fix: a second task on an ACTIVE db
            # would interleave stats publish/read-back cycles and
            # persist the other task's numbers (server.py's db-label
            # comment).  The guard is an atomic BOARD-level reservation
            # (not a count check): two schedulers over one shared store
            # racing the same db resolve through the store's guarded
            # upsert, and exactly one wins.  Refused submits resubmit
            # once the holder reaches a terminal state.
            if not self._reserve_db(db, task_id):
                _ADMISSION.inc(tenant=tenant, outcome="rejected",
                               reason="db_active")
                raise QuotaExceededError(
                    f"submit refused for tenant {tenant!r}: db_active "
                    f"({db!r} is already queued/admitted/running)",
                    "db_active")
            doc = {
                "_id": task_id,
                "tenant": tenant,
                "db": db,
                "kind": kind,
                "params": params,
                "priority": int(priority),
                "weight": float(weight) if weight > 0 else 1.0,
                "est_jobs": int(est_jobs),
                "est_bytes": int(est_bytes),
                "state": QUEUED,
                "seq": seq,
                "submit_time": docstore.now(),
            }
            self.store.insert(TASKS_COLL, doc)
            # the SLO plane's monotonic submit stamp: this process can
            # now report EXACT queue-wait/first-result durations for
            # transitions it also observes (obs/slo; cross-process
            # observers fall back to the persisted submit_time)
            _slo.stamp_submit(task_id, tenant)
            _ADMISSION.inc(tenant=tenant, outcome="accepted", reason="-")
            _TASK_EVENTS.inc(tenant=tenant, event="submitted")
            self._refresh_gauges()
        return doc

    # -- dequeue (weighted-fair, priority, lease-fenced) -------------------

    def _tenant_served(self) -> Dict[str, float]:
        return {d["_id"]: float(d.get("served_cost", 0.0))
                for d in self.store.find(TENANTS_COLL)}

    def _owns_admission(self, strict: bool) -> bool:
        """Lease gate for tick(): True only with PROOF of ownership
        (acquired now, or a beat that answered owned).  A definitive
        loss fences — quietly (count + False) by default so a hosted
        scheduler just stops admitting, loudly with *strict*."""
        if self.lease is None:
            return True
        if self.lease.generation is None:
            return self.lease.try_acquire()
        try:
            owned = self.lease.heartbeat()
        except PermissionError:
            raise  # auth misconfig: retrying is no fix
        except OSError:
            return False  # ownership UNKNOWN: skip this tick, never admit
        if owned:
            return True
        self.lease.generation = None
        _FENCES.inc()
        if strict:
            raise SchedulerFencedError(
                "scheduler admission lease lost: a successor owns "
                "dequeue — this scheduler stops admitting")
        return False

    def tick(self, strict: bool = False) -> List[Dict[str, Any]]:
        """Promote QUEUED tasks into the ``max_inflight`` budget:
        weighted-fair across tenants (lowest ``served_cost/weight``
        first), priority then submit order within a tenant.  Returns
        the newly admitted task docs; empty when not the lease holder.
        """
        if not self._owns_admission(strict):
            return []
        if self.fleet is not None:
            # the fleet plane rides the SAME lease gate as admission:
            # one scheduler cluster-wide mirrors host facts into the
            # advisor and sweeps for failed hosts, so each move is one
            # auditable decision, not one plus a raced no-op
            try:
                self.fleet.sync_advisor(self.advisor)
                self.recovery_sweep()
            except OSError:
                pass  # board hiccup: the next tick retries the sweep
        admitted: List[Dict[str, Any]] = []
        with self._lock:
            while True:
                inflight = self.store.count(
                    TASKS_COLL,
                    {"state": {"$in": list(INFLIGHT_STATES)}})
                if inflight >= self.config.max_inflight:
                    break
                queued = self.store.find(TASKS_COLL, {"state": QUEUED})
                if not queued:
                    break
                by_tenant: Dict[str, List[Dict[str, Any]]] = {}
                for q in queued:
                    by_tenant.setdefault(q["tenant"], []).append(q)
                served = self._tenant_served()

                def fair_key(t: str):
                    w = max(float(q.get("weight") or 1.0)
                            for q in by_tenant[t])
                    return (served.get(t, 0.0) / max(w, 1e-9), t)

                tenant = min(by_tenant, key=fair_key)
                cand = min(by_tenant[tenant],
                           key=lambda q: (-int(q.get("priority") or 0),
                                          int(q.get("seq") or 0)))
                gen = self.lease.generation if self.lease else 0
                doc = self.store.find_and_modify(
                    TASKS_COLL, {"_id": cand["_id"], "state": QUEUED},
                    {"$set": {"state": ADMITTED,
                              "admitted_time": docstore.now(),
                              "generation": gen}})
                if doc is None:
                    continue  # cancelled in the race; re-read the queue
                if self.advisor is not None:
                    # the program is the task's declared one, else its
                    # kind; with nothing registered the task routes as
                    # before
                    program = str((cand.get("params") or {})
                                  .get("program")
                                  or cand.get("kind") or "-")
                    mesh = self.advisor.choose(program, tenant=tenant,
                                               task=doc["_id"])
                    if mesh is not None:
                        self.store.update(TASKS_COLL,
                                          {"_id": doc["_id"]},
                                          {"$set": {"mesh": mesh}})
                        doc["mesh"] = mesh
                        if self.fleet is not None:
                            # the pick is also a fleet ROUTE: what drain
                            # and the recovery sweep re-home, with the
                            # program kept to score warmth later
                            self.fleet.assign(doc["_id"], mesh,
                                              program=program)
                # queue wait (submit->admitted): exact monotonic when
                # this process saw the submit, else the board's
                # persisted stamps (cross-process degradation)
                wait = _slo.note_admitted(doc["_id"], tenant=tenant)
                if wait is None:
                    wait = (float(doc.get("admitted_time") or 0.0)
                            - float(doc.get("submit_time") or 0.0))
                _slo.observe_queue_wait(tenant, wait)
                cost = max(float(cand.get("est_jobs") or 0), 1.0)
                self.store.update(
                    TENANTS_COLL,
                    {"_id": tenant, "served_cost": {"$exists": False}},
                    {"$set": {"served_cost": 0.0, "served_records": 0}},
                    upsert=True)
                self.store.update(TENANTS_COLL, {"_id": tenant},
                                  {"$inc": {"served_cost": cost}})
                _TASK_EVENTS.inc(tenant=tenant, event="admitted")
                admitted.append(doc)
            if admitted:
                self._refresh_gauges()
        return admitted

    # -- failed-host recovery (the fleet plane) ----------------------------

    def recovery_sweep(self) -> List[tuple]:
        """Notice expired host leases and re-home their streams: for
        every host whose lease lapsed WITHOUT a clean release, move
        each of its routed streams to the best live host (guarded
        route flips, one control-ledger ``fleet`` decision per move:
        :func:`~..coord.fleet.rehome_routes`), then reap the host doc
        under a (holder, generation) guard so the sweep fires once and
        a returning zombie fences instead of resurrecting re-homed
        streams.  The streams are durable in the spill store and
        restore LAZILY on their new host's next touch, so a dead host's
        whole tenancy is servable again after this one sweep.  Returns
        the ``(task, dst_host)`` moves made."""
        if self.fleet is None:
            return []
        from ..coord import fleet as _fleet
        from ..obs import control as _control

        moves: List[tuple] = []
        now = docstore.now()
        for doc in self.fleet.expired_hosts(now):
            host_id = str(doc["_id"])
            moves.extend(_fleet.rehome_routes(
                self.fleet, host_id, reason="recovery",
                ledger=_control.LEDGER, now=now))
            if self.fleet.routes_for(host_id):
                # no live destination took them (rehome recorded the
                # refusal): leave the host EXPIRED so the next sweep
                # retries; reaping now would orphan the routes
                continue
            if self.fleet.reap(doc):
                _fleet._RECOVERIES.inc(host=host_id)
        return moves

    # -- lifecycle transitions (runner-facing) -----------------------------

    def mark_running(self, task_id: str) -> Optional[Dict[str, Any]]:
        doc = self.store.find_and_modify(
            TASKS_COLL, {"_id": task_id, "state": ADMITTED},
            {"$set": {"state": RUNNING, "started_time": docstore.now()}})
        if doc is not None:
            dt = _slo.admitted_age(task_id)
            if dt is None:
                dt = (float(doc.get("started_time") or 0.0)
                      - float(doc.get("admitted_time") or 0.0))
            _slo.observe_admit_to_running(doc["tenant"], dt)
            _TASK_EVENTS.inc(tenant=doc["tenant"], event="running")
            self._refresh_gauges()
        return doc

    def mark_done(self, task_id: str,
                  records: int = 0) -> Optional[Dict[str, Any]]:
        """RUNNING -> DONE, guarded so a raced cancel wins; *records*
        roll into the tenant's served-records accounting."""
        doc = self.store.find_and_modify(
            TASKS_COLL, {"_id": task_id, "state": RUNNING},
            {"$set": {"state": DONE, "done_time": docstore.now()}})
        if doc is not None:
            _TASK_EVENTS.inc(tenant=doc["tenant"], event="done")
            self._release_db(doc)
            _slo.drop_stamp(task_id)
            if records:
                self.note_served(doc["tenant"], records)
            self._gc_terminal()
            self._refresh_gauges()
        return doc

    def mark_failed(self, task_id: str,
                    reason: str = "") -> Optional[Dict[str, Any]]:
        doc = self.store.find_and_modify(
            TASKS_COLL,
            {"_id": task_id, "state": {"$in": [ADMITTED, RUNNING]}},
            {"$set": {"state": FAILED, "done_time": docstore.now(),
                      "reason": str(reason)[:2000]}})
        if doc is not None:
            _TASK_EVENTS.inc(tenant=doc["tenant"], event="failed")
            self._release_db(doc)
            _slo.drop_stamp(task_id)
            self._gc_terminal()
            self._refresh_gauges()
        return doc

    def _gc_terminal(self) -> None:
        """Prune the oldest terminal task docs beyond the retention cap
        (the CheckpointManager keep-N pattern for the board): tenant
        accounting survives in ``__sched__.tenants``, only the per-task
        history rows age out."""
        keep = self.config.keep_terminal_tasks
        terminal = self.store.find(
            TASKS_COLL, {"state": {"$in": [DONE, CANCELLED, FAILED]}})
        if len(terminal) <= keep:
            return
        # never prune a terminal doc that still HOLDS its db
        # reservation (a cancelled-while-RUNNING task whose Server thread is
        # draining): with the doc gone, _reserve_db's absent-holder
        # branch would compare against the ancient reserved_time and
        # steal the db out from under the live Server
        holding = {d.get("task") for d in self.store.find(DBS_COLL)}
        terminal.sort(key=lambda d: int(d.get("seq") or 0))
        doomed = [d["_id"] for d in terminal[:len(terminal) - keep]
                  if d["_id"] not in holding]
        if doomed:
            self.store.remove(TASKS_COLL, {"_id": {"$in": doomed}})

    def note_served(self, tenant: str, records: int) -> None:
        """Roll *records* into *tenant*'s served accounting: the live
        counter (collector/diagnose roll-ups ride it) AND the board's
        tenant doc (crash-safe, visible to every process)."""
        records = int(records)
        if records <= 0:
            return
        _SERVED_RECORDS.inc(records, tenant=str(tenant))
        self.store.update(
            TENANTS_COLL,
            {"_id": str(tenant), "served_records": {"$exists": False}},
            {"$set": {"served_cost": 0.0, "served_records": 0}},
            upsert=True)
        self.store.update(TENANTS_COLL, {"_id": str(tenant)},
                          {"$inc": {"served_records": records}})

    # -- cancel ------------------------------------------------------------

    def cancel(self, task_id: str,
               reason: str = "cancelled") -> Optional[Dict[str, Any]]:
        """Cancel a task in any non-terminal state.  A cancelled task's
        queued jobs NEVER run: its task-db singleton is forced to
        FINISHED (``Task.take_next_jobs`` answers every worker ``[]``
        from then on) and its claimable job docs are removed, so
        neither a fresh claim nor a lease-reaped BROKEN retry can
        resurrect them.

        The db reservation is released here only for QUEUED/ADMITTED
        tasks (no Server ever started).  A RUNNING task's Server is
        still inside ``Server.loop`` draining toward the FINISHED it
        just observed — releasing now would let a resubmit start a
        second Server on the same db while the first is live (the
        hazard the reservation exists for), so the runner's exit path
        releases instead (TaskRunner._run_task), with the stale-
        reclaim grace as the backstop for an orphan no thread drives."""
        update = {"$set": {"state": CANCELLED,
                           "done_time": docstore.now(),
                           "reason": str(reason)[:2000]}}
        doc = self.store.find_and_modify(
            TASKS_COLL,
            {"_id": task_id, "state": {"$in": [QUEUED, ADMITTED]}},
            update)
        unstarted = doc is not None
        if doc is None:
            doc = self.store.find_and_modify(
                TASKS_COLL, {"_id": task_id, "state": RUNNING}, update)
            if doc is None:
                return None
        _TASK_EVENTS.inc(tenant=doc["tenant"], event="cancelled")
        db = doc.get("db")
        if db:
            from ..utils.constants import TASK_STATUS

            self.store.update(
                f"{db}.task", {"_id": "unique"},
                {"$set": {"status": TASK_STATUS.FINISHED.value}})
            for coll in (f"{db}.map_jobs", f"{db}.red_jobs"):
                self.store.remove(
                    coll, {"status": {"$in": [int(STATUS.WAITING),
                                              int(STATUS.BROKEN)]}})
        if unstarted:
            # released LAST (after the task-db stomp above): freeing
            # the db first would let a cancel-then-resubmit successor
            # reserve it and then eat these late FINISHED/remove writes
            self._release_db(doc)
        _slo.drop_stamp(task_id)
        self._gc_terminal()
        self._refresh_gauges()
        return doc

    # -- views -------------------------------------------------------------

    def list_tasks(self, tenant: Optional[str] = None,
                   state: Optional[str] = None) -> List[Dict[str, Any]]:
        q: Dict[str, Any] = {}
        if tenant is not None:
            q["tenant"] = str(tenant)
        if state is not None:
            q["state"] = state
        docs = self.store.find(TASKS_COLL, q or None)
        docs.sort(key=lambda d: int(d.get("seq") or 0))
        return docs

    def get(self, task_id: str) -> Optional[Dict[str, Any]]:
        return self.store.find_one(TASKS_COLL, {"_id": task_id})

    def snapshot(self) -> Dict[str, Any]:
        """The scheduler section of GET /tasks: per-tenant queue depths and
        declared queued work, the in-flight count, fair-share and
        served-records accounting, and the admission-lease doc.  Empty
        when no task was ever submitted (the section stays off the
        page).  Refreshes the queue-depth gauges as a side effect, so
        a /tasks or /metrics scrape is always current."""
        tasks = self.store.find(TASKS_COLL)
        if not tasks:
            return {}
        tenants: Dict[str, Dict[str, Any]] = {}

        def _t(name: str) -> Dict[str, Any]:
            return tenants.setdefault(name, {
                "queued": 0, "admitted": 0, "running": 0, "done": 0,
                "cancelled": 0, "failed": 0, "queued_jobs": 0,
                "queued_bytes": 0, "served_cost": 0.0,
                "served_records": 0})

        for d in tasks:
            t = _t(d.get("tenant", "-"))
            state = str(d.get("state", QUEUED)).lower()
            if state in t:
                t[state] += 1
            if d.get("state") == QUEUED:
                t["queued_jobs"] += int(d.get("est_jobs") or 0)
                t["queued_bytes"] += int(d.get("est_bytes") or 0)
        for d in self.store.find(TENANTS_COLL):
            t = _t(d["_id"])
            t["served_cost"] = float(d.get("served_cost", 0.0))
            t["served_records"] = int(d.get("served_records", 0))
        out: Dict[str, Any] = {
            "config": asdict(self.config),
            "inflight": self.store.count(
                TASKS_COLL, {"state": {"$in": list(INFLIGHT_STATES)}}),
            "tenants": tenants,
        }
        lease_doc = self.store.find_one(
            f"{SCHED_DB}.{SchedulerLease.COLL}",
            {"_id": SchedulerLease.SINGLETON_ID})
        if lease_doc is not None:
            out["lease"] = {"holder": lease_doc.get("holder"),
                            "generation": lease_doc.get("generation", 0)}
        oldest = self._refresh_gauges(tasks=tasks)
        for t, age in oldest.items():
            if t in tenants:
                tenants[t]["oldest_queued_age_s"] = round(age, 3)
        return out

    def _refresh_gauges(self, tasks: Optional[List[Dict[str, Any]]] = None,
                        ) -> Dict[str, float]:
        """Swap the whole queue-depth / queued-work / oldest-queued-age
        families atomically (the update_board_gauges pattern): stale
        series from drained queues must not linger as lies.  Returns
        the per-tenant oldest-queued ages (the snapshot rides them)."""
        if tasks is None:
            tasks = self.store.find(TASKS_COLL)
        depth: Dict[tuple, int] = {}
        work: Dict[tuple, int] = {}
        # queue AGE alongside queue depth: oldest QUEUED submit stamp
        # per tenant, compared against the board's wall clock (persisted
        # timestamps minted through docstore.now — the same timestamp-
        # comparison license the lease views hold)
        now_wall = docstore.now()
        oldest: Dict[str, float] = {}
        for d in tasks:
            tenant = str(d.get("tenant", "-"))
            state = str(d.get("state", QUEUED))
            depth[(tenant, state)] = depth.get((tenant, state), 0) + 1
            if state == QUEUED:
                work[(tenant, "jobs")] = (work.get((tenant, "jobs"), 0)
                                          + int(d.get("est_jobs") or 0))
                work[(tenant, "bytes")] = (work.get((tenant, "bytes"), 0)
                                           + int(d.get("est_bytes") or 0))
                age = max(0.0, now_wall
                          - float(d.get("submit_time") or now_wall))
                oldest[tenant] = max(oldest.get(tenant, 0.0), age)
        _QUEUE_DEPTH.replace(
            [({"tenant": t, "state": s}, n)
             for (t, s), n in sorted(depth.items())])
        _QUEUED_WORK.replace(
            [({"tenant": t, "unit": u}, n)
             for (t, u), n in sorted(work.items())])
        _OLDEST_AGE.replace(
            [({"tenant": t}, round(a, 3))
             for t, a in sorted(oldest.items())])
        return oldest

    def release(self) -> None:
        """Clean handoff of the admission lease (a successor's
        try_acquire succeeds immediately)."""
        if self.lease is not None and self.lease.generation is not None:
            try:
                self.lease.release()
            except OSError:
                pass  # board unreachable: the lease expires on its own


# -- the /tasks HTTP client ---------------------------------------------------


class SchedulerClient:
    """Client for the docserver's ``/tasks`` surface (the submit/list/
    cancel CLI rides it).  Mutations carry ``SESSION:SEQ`` request ids
    and are deduped server-side exactly like board RPCs — a retried
    submit cannot enqueue twice.  Accepts the multi-endpoint HA board
    form (``HOST:PORT,HOST:PORT``): a dead or standby replica rotates
    under the one rid, and the replicated dedupe table keeps the
    failed-over re-send exactly-once.

    Backpressure contract: the server answers quota rejections with
    HTTP 429 + the typed body.  This client strips 429 from its retry
    statuses ON PURPOSE — an admission rejection is an ANSWER
    (:class:`QuotaExceededError` with its reason), not a transient to
    hammer through."""

    def __init__(self, address: str, auth_token: Optional[str] = None,
                 retry=None) -> None:
        import dataclasses

        from ..utils.httpclient import (
            DEFAULT_RETRY_POLICY, FailoverClient)

        policy = retry if retry is not None else DEFAULT_RETRY_POLICY
        policy = dataclasses.replace(
            policy,
            retry_statuses=frozenset(policy.retry_statuses) - {429})
        self._client = FailoverClient(
            address, what="scheduler", auth_token=auth_token,
            retry=policy)
        self._rid_session = uuid.uuid4().hex
        self._rid_seq = itertools.count(1)
        self._lock = threading.Lock()

    def _call(self, op: str, **fields: Any) -> Any:
        payload: Dict[str, Any] = {"op": op, **fields}
        with self._lock:
            payload["rid"] = (f"{self._rid_session}:"
                              f"{next(self._rid_seq)}")
            status, raw = self._client.request(
                "POST", "/tasks", body=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
        if status == 401:
            raise PermissionError(
                f"/tasks {op!r}: auth rejected (set $MAPREDUCE_TPU_AUTH "
                "or pass auth)")
        if status == 404:
            raise IOError(
                "/tasks: this docserver predates the scheduler surface")
        if status not in (200, 429):
            # 429 carries the typed quota rejection in its body — fall
            # through to the typed-error dispatch below
            raise IOError(f"/tasks {op!r}: HTTP {status}")
        reply = json.loads(raw)
        if not reply.get("ok"):
            exc_type = {"QuotaExceededError": None,
                        "ValueError": ValueError,
                        "KeyError": KeyError,
                        "PermissionError": PermissionError,
                        }.get(reply.get("type"), IOError)
            if exc_type is None:
                raise QuotaExceededError(reply.get("error", "rejected"),
                                         reply.get("reason", "-"))
            raise exc_type(reply.get("error", "/tasks call failed"))
        return reply.get("result")

    def submit(self, tenant: str, **kw: Any) -> Dict[str, Any]:
        return self._call("submit", tenant=tenant, **kw)

    def cancel(self, task_id: str,
               reason: str = "cancelled") -> Optional[Dict[str, Any]]:
        return self._call("cancel", task_id=task_id, reason=reason)

    def tick(self) -> List[Dict[str, Any]]:
        return self._call("tick")

    def list(self) -> Dict[str, Any]:
        """GET /tasks: every task doc plus the scheduler snapshot."""
        status, raw = self._client.request("GET", "/tasks")
        if status == 401:
            raise PermissionError("/tasks: auth rejected")
        if status != 200:
            raise IOError(f"/tasks: HTTP {status}")
        return json.loads(raw)

    def close(self) -> None:
        self._client.close()
