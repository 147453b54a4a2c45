"""Task state machine: the singleton task document and job claiming
(port of ``mapreduce_tpu/coord/task.py``).

Parity with mapreduce/task.lua: one task document (``_id="unique"``) per
database holding the phase (WAIT/MAP/REDUCE/FINISHED), the user module
names, storage spec, iteration counter and stats (task.lua:96-116, example
doc task.lua:26-56); job documents in ``map_jobs``/``red_jobs`` claimed
atomically by workers (task.lua:258-343).

Strengthened vs the reference (SURVEY.md §5 gaps):

  * claims use a real atomic ``find_and_modify`` instead of the racy
    update-then-find_one claim-by-stamp (task.lua:294-309, FIXME'd there);
  * RUNNING jobs carry a ``lease_expires`` wall-clock field; the server
    reaps expired leases back to BROKEN (the reference has no heartbeat or
    lease — dead workers' jobs hang until a server restart);
  * the map-job locality cache (task.lua:249-254, 279-293) is instance
    state, not a module global (quirk list, SURVEY.md §7).
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Tuple

from ..utils.constants import (
    STATUS, TASK_STATUS, DEFAULT_JOB_LEASE, MAX_IDLE_COUNT)
from . import docstore
from .connection import Connection

TaskDoc = Dict[str, Any]
JobDoc = Dict[str, Any]


class LeaseLostError(RuntimeError):
    """This worker's claim on the running job is gone (lease reaped after
    a partition outlasted it, or the job re-issued to another worker).
    Raised inside the job's execution path to abort it — the re-issued
    copy is now the authoritative run, and finishing here would race it
    (duplicate user-fn side effects, the window Dean & Ghemawat close by
    committing map output atomically; we close it at the source)."""


def make_job(key: Any, value: Any) -> JobDoc:
    """Build a claimable job document (reference utils.make_job:87-98)."""
    return {
        "_id": str(key),
        "key": key,
        "value": value,
        "worker": None,
        "status": int(STATUS.WAITING),
        "creation_time": docstore.now(),
        "repetitions": 0,
    }


class Task:
    """Reference: ``task(cnn)`` (task.lua:345-359)."""

    SINGLETON_ID = "unique"  # task.lua pins the doc id

    def __init__(self, connection: Connection,
                 job_lease: float = DEFAULT_JOB_LEASE) -> None:
        self._cnn = connection
        self.tbl: TaskDoc = {}
        self.job_lease = job_lease
        # locality cache: map-job ids this process wrote in a previous
        # iteration, preferred when re-claiming (task.lua:249-254)
        self._cached_map_ids: List[str] = []
        self._idle_count = 0

    # -- namespaces (task.lua:195-245) ------------------------------------

    def task_ns(self) -> str:
        return self._cnn.ns("task")

    def map_jobs_ns(self) -> str:
        return self._cnn.ns("map_jobs")

    def red_jobs_ns(self) -> str:
        return self._cnn.ns("red_jobs")

    def red_results_ns(self) -> str:
        return self.tbl.get("result_ns", self._cnn.ns("result"))

    def jobs_ns(self) -> str:
        """Collection for the *current* phase's jobs (task.lua:213-221)."""
        st = self.status()
        if st == TASK_STATUS.MAP:
            return self.map_jobs_ns()
        if st == TASK_STATUS.REDUCE:
            return self.red_jobs_ns()
        raise RuntimeError(f"no jobs collection in task status {st}")

    # -- task document lifecycle ------------------------------------------

    def create_collection(self, status: TASK_STATUS, params: Dict[str, Any],
                          iteration: int) -> None:
        """Write the task singleton (reference task.lua:96-116)."""
        doc = {
            "_id": self.SINGLETON_ID,
            "status": status.value,
            "iteration": iteration,
            "taskfn": params["taskfn"],
            "mapfn": params["mapfn"],
            "partitionfn": params["partitionfn"],
            "reducefn": params["reducefn"],
            "combinerfn": params.get("combinerfn"),
            "finalfn": params["finalfn"],
            "init_args": params.get("init_args"),
            "storage": params["storage"],
            "path": params["path"],
            "result_ns": params.get("result_ns", self._cnn.ns("result")),
            "device": bool(params.get("device", False)),
        }
        store = self._cnn.connect()
        store.update(self.task_ns(), {"_id": self.SINGLETON_ID}, doc,
                     upsert=True)
        self.tbl = dict(doc)

    def update(self) -> bool:
        """Re-read the singleton (task.lua:148-160); False if absent."""
        doc = self._cnn.connect().find_one(self.task_ns(),
                                           {"_id": self.SINGLETON_ID})
        if doc is None:
            return False
        self.tbl = doc
        return True

    def status(self) -> TASK_STATUS:
        return TASK_STATUS(self.tbl.get("status", "WAIT"))

    def iteration(self) -> int:
        return int(self.tbl.get("iteration", 0))

    def finished(self) -> bool:
        return self.status() == TASK_STATUS.FINISHED

    def set_task_status(self, status: TASK_STATUS) -> None:
        """task.lua:182-193."""
        self._cnn.connect().update(
            self.task_ns(), {"_id": self.SINGLETON_ID},
            {"$set": {"status": status.value}})
        self.tbl["status"] = status.value

    def set_fields(self, fields: Dict[str, Any]) -> None:
        self._cnn.connect().update(
            self.task_ns(), {"_id": self.SINGLETON_ID}, {"$set": fields})
        self.tbl.update(fields)

    # -- job claiming (the scheduler heart) -------------------------------

    def insert_jobs(self, coll: str, jobs: List[JobDoc]) -> None:
        """Bulk job creation through the batched-insert path
        (server.lua:316-325 via cnn.annotate_insert)."""
        for j in jobs:
            self._cnn.annotate_insert(coll, j)
        self._cnn.flush_pending_inserts(0)

    def note_written_map_job(self, job_id: str) -> None:
        """Record a map-job id this process produced, for locality
        preference on later iterations (task.lua:313-318)."""
        self._cached_map_ids.append(job_id)

    def take_next_jobs(self, worker_name: str, tmpname: str, n: int = 1,
                       ) -> Tuple[List[JobDoc], TASK_STATUS]:
        """Atomically claim up to *n* jobs for *worker_name* in ONE board
        call (find_and_modify_many).

        Every claimed doc carries the same ``(worker, tmpname)`` claim
        stamp; claim identity stays per-job because ``_id`` is part of
        the guard (job.Job._claim_query), so each claim in the batch is
        leased, heartbeated and FENCED independently of its batch-mates.
        Reference: task.lua:258-343 — including the iteration>1 locality
        preference (claim own cached map jobs first, then fall back to
        BROKEN-only for MAX_IDLE_COUNT polls, then anything).
        """
        n = max(int(n), 1)  # 0 would turn every poll into an idle poll
        if not self.update():
            return [], TASK_STATUS.WAIT
        st = self.status()
        if st in (TASK_STATUS.WAIT, TASK_STATUS.FINISHED):
            return [], st
        coll = self.jobs_ns()
        claimable = {"status": {"$in": [int(STATUS.WAITING),
                                        int(STATUS.BROKEN)]}}
        queries: List[Dict[str, Any]] = []
        if (st == TASK_STATUS.MAP and self.iteration() > 1
                and self._cached_map_ids):
            if self._idle_count < MAX_IDLE_COUNT:
                # prefer jobs whose output this host already has locally
                queries.append({**claimable,
                                "_id": {"$in": self._cached_map_ids}})
                queries.append({"status": int(STATUS.BROKEN)})
            else:
                queries.append(claimable)
        else:
            queries.append(claimable)

        now = docstore.now()
        claim = {"$set": {
            "worker": worker_name,
            "tmpname": tmpname,
            "started_time": now,
            "lease_expires": now + self.job_lease,
            "status": int(STATUS.RUNNING),
        }}
        store = self._cnn.connect()
        got: List[JobDoc] = []
        for q in queries:
            want = n - len(got)
            if want <= 0:
                break
            got.extend(store.find_and_modify_many(coll, q, claim, want))
        if got:
            self._idle_count = 0
        else:
            self._idle_count += 1
        return got, st

    def release_jobs(self, coll: str, job_tbls: List[JobDoc]) -> int:
        """Hand claimed-but-never-started jobs straight back to WAITING
        (claim-guarded, RUNNING only) so an exiting worker's claim-ahead
        queue is reclaimable immediately instead of after a lease reap —
        and without the spurious ``repetitions`` increment a reap charges.
        Best-effort: if this RPC fails the lease reaper covers it."""
        if not job_tbls:
            return 0
        guards = [{"_id": j["_id"], "worker": j.get("worker"),
                   "tmpname": j.get("tmpname"),
                   "status": int(STATUS.RUNNING)} for j in job_tbls]
        return self._cnn.connect().update(
            coll, {"$or": guards},
            {"$set": {"status": int(STATUS.WAITING), "worker": None}},
            multi=True)

    @staticmethod
    def _beat_guard(job_tbl: JobDoc) -> Dict[str, Any]:
        return {"_id": job_tbl["_id"],
                "worker": job_tbl.get("worker"),
                "tmpname": job_tbl.get("tmpname"),
                "status": {"$in": [int(STATUS.RUNNING),
                                   int(STATUS.FINISHED),
                                   int(STATUS.WRITTEN)]}}

    def heartbeat_many(self, coll: str, job_tbls: List[JobDoc],
                       ) -> List[bool]:
        """Extend EVERY lease this worker holds (the running job plus its
        claim-ahead queue) in one ``$or``-guarded multi-update, and return
        per-claim ownership (no reference equivalent — fixes the missing
        dead-worker detection, SURVEY.md §5).

        Each ``$or`` arm is a full claim guard (:meth:`_beat_guard`), so
        a stale worker can't extend a lease that now belongs to another
        worker's claim.  The guard matches RUNNING and FINISHED (a map
        job is FINISHED while its worker still writes its output files,
        and that write must keep the lease alive) and WRITTEN (a beat
        racing this claim's own just-completed write must report
        ownership; the reaper only looks at RUNNING/FINISHED).

        False for a claim means its lease was lost for certain — reaped to
        BROKEN or reclaimed by another worker — and the caller must fence:
        abort the running job instead of racing the re-issued copy (the
        answer came over a working call, so False is knowledge; a failure
        of the board raises instead and proves nothing).  When the matched
        count says every claim is owned (the steady state) one update is
        the whole answer; a shortfall means at least one lease is LOST,
        and each claim is then probed individually so exactly the lost
        ones get fenced.  *coll* is the jobs collection the batch was
        claimed from (the task's phase may have moved on while these
        claims are still held)."""
        if not job_tbls:
            return []
        n = self._cnn.connect().update(
            coll, {"$or": [self._beat_guard(j) for j in job_tbls]},
            {"$set": {"lease_expires": docstore.now() + self.job_lease}},
            multi=True)
        if n >= len(job_tbls):
            return [True] * len(job_tbls)
        out = []
        for j in job_tbls:
            m = self._cnn.connect().update(
                coll, self._beat_guard(j),
                {"$set": {"lease_expires":
                          docstore.now() + self.job_lease}})
            out.append(m > 0)
        return out

    def reap_expired(self, coll: str) -> int:
        """Server-side: in-flight jobs (RUNNING, or FINISHED — user fn done
        but output files not yet written) with an expired lease become
        BROKEN (+1 repetition), making them claimable again.  FINISHED is
        non-terminal: a worker dying between mark_as_finished and
        mark_as_written would otherwise leave an unreapable job and hang
        the server's poll loop forever."""
        store = self._cnn.connect()
        n = 0
        while True:
            got = store.find_and_modify(
                coll,
                {"status": {"$in": [int(STATUS.RUNNING),
                                    int(STATUS.FINISHED)]},
                 "lease_expires": {"$lt": docstore.now()}},
                {"$set": {"status": int(STATUS.BROKEN)},
                 "$inc": {"repetitions": 1}})
            if got is None:
                return n
            n += 1

    @staticmethod
    def tmpname() -> str:
        """Per-claim scratch token (reference uses os.tmpname)."""
        return uuid.uuid4().hex[:12]
