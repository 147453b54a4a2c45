"""The serving processes of the always-on service (port of
``mapreduce_tpu/sched/service.py``).

Two loops close the submit -> result path over the scheduler's board
state (sched/scheduler.py):

  * :class:`TaskRunner` — the task-thread pool: ticks the scheduler
    (admission, lease-fenced) and drives every ADMITTED ``server``-kind
    task through the UNCHANGED ``Server`` machinery, one thread per
    in-flight task.  Phases, stats, crash recovery and ``"loop"``
    iteration are all the existing Server.loop — the runner only maps
    scheduler states onto it (ADMITTED -> RUNNING -> DONE/FAILED,
    guarded so a raced cancel wins).
  * :class:`ScheduledWorker` — ONE worker loop serving N tenants: it
    polls the scheduler's admitted/running set and claims each active
    task's jobs through the existing per-db ``Task`` machinery
    (batched claims, heartbeats, per-claim fencing — worker.py
    unchanged), cycling across tasks so no tenant starves while
    another has claimable jobs.  A cancelled task vanishes from the
    active set AND its task doc reads FINISHED, so its queued jobs are
    unclaimable from either direction.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from ..coord import docstore
from ..obs import slo as _slo
from ..obs.metrics import REGISTRY
from ..utils.constants import STATUS
from ..worker import Worker
from .scheduler import ADMITTED, INFLIGHT_STATES, RUNNING, Scheduler
from .scheduler import TASKS_COLL

logger = logging.getLogger("mapreduce_tpu_torch.sched")


class TaskRunner:
    """Drive admitted tasks to completion through ``Server``.

    The runner owns admission: its poll loop calls
    :meth:`Scheduler.tick` (a no-op unless this process holds — or can
    take — the scheduler lease) and then starts one task thread per
    newly admitted ``server`` task, up to the scheduler's own
    ``max_inflight`` bound.  Session-kind tasks are left to whatever
    :class:`~..engine.session.EngineSession` host claimed them.

    *partitions* are this process's :class:`~..parallel.mesh.Partitions`
    (the JAX runner's process mesh): every task's ``configure`` gets
    them as ``params["partitions"]``, as ``cli wordcount --device``
    passes them.  The default is ``Partitions(1)`` on the card, which
    raises without CUDA: the runner never falls back to the CPU.
    """

    def __init__(self, connstr: str, scheduler: Scheduler,
                 auth: Optional[Any] = None, retry: Optional[Any] = None,
                 job_lease: Optional[float] = None,
                 poll: float = 0.05,
                 partitions: Optional[Any] = None) -> None:
        if partitions is None:
            from ..parallel.mesh import Partitions

            partitions = Partitions(1)
        self.partitions = partitions
        self.connstr = connstr
        self.scheduler = scheduler
        self.auth = auth
        self.retry = retry
        self.job_lease = job_lease
        self.poll = poll
        self._threads: Dict[str, threading.Thread] = {}
        self._stop = threading.Event()
        self._main: Optional[threading.Thread] = None
        #: terminal failure (auth misconfig) that stopped the loop —
        #: embedders/cmd_runner surface it instead of spinning forever
        self.failed: Optional[BaseException] = None

    def start(self) -> "TaskRunner":
        self._main = threading.Thread(target=self._loop, daemon=True,
                                      name="mr-sched-runner")
        self._main.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._main is not None:
            self._main.join(timeout=timeout)
        for t in list(self._threads.values()):
            t.join(timeout=timeout)
        self.scheduler.release()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.scheduler.tick()
                for doc in self.scheduler.list_tasks(state=ADMITTED):
                    if doc.get("kind") != "server":
                        continue  # session tasks are served in-place
                    tid = doc["_id"]
                    if tid in self._threads:
                        continue
                    t = threading.Thread(target=self._run_task,
                                         args=(doc,), daemon=True,
                                         name=f"mr-sched-{tid}")
                    self._threads[tid] = t
                    t.start()
                # reap finished task threads so re-submits of a freed
                # db get a fresh slot
                for tid in [k for k, t in self._threads.items()
                            if not t.is_alive()]:
                    self._threads.pop(tid, None)
            except PermissionError as exc:
                # auth misconfig never heals on its own: stop the loop
                # loudly instead of retrying at poll cadence forever
                logger.error("runner auth rejected by the board (%s); "
                             "stopping", exc)
                self.failed = exc
                self._stop.set()
                return
            except OSError as exc:
                logger.warning("scheduler poll failed (%s); backing off",
                               exc)
            self._stop.wait(self.poll)

    def _served_records(self, db: str) -> int:
        """Records this task's jobs wrote, from the per-task accounting
        counters (coord/job.py increments them at write time) — the
        local-process view; cross-process rows roll up on /clusterz."""
        n = REGISTRY.sum("mrtpu_task_records_total", task=db,
                         phase="map")
        if not n:
            n = REGISTRY.sum("mrtpu_task_records_total", task=db)
        return int(n)

    def _watch_first_result(self, doc: Dict[str, Any]) -> None:
        """The SLO plane's running→first-job-written stamp: poll the
        task db for its first WRITTEN job (one cheap count per poll
        tick, bounded by the task's lifetime) and observe the tenant's
        submit→first-result latency — exact monotonic when this process
        saw the submit, else the board's persisted submit stamp."""
        tid, db, tenant = doc["_id"], doc["db"], doc["tenant"]
        store = self.scheduler.store
        written_q = {"status": int(STATUS.WRITTEN)}
        # a REUSED db (prior run DONE, resubmitted) still carries the
        # previous run's WRITTEN job docs until the new Server's loop
        # drops the collections: those must not read as an instant
        # first result.  The first poll's count is the stale baseline;
        # only a count that MOVED (the drop zeroes it, a fresh write
        # raises it) is this run's first result.
        baseline = None
        while not self._stop.is_set():
            try:
                done = 0
                for coll in (f"{db}.map_jobs", f"{db}.red_jobs"):
                    done += store.count(coll, written_q)
                if baseline is None:
                    baseline = done
                elif done == 0:
                    baseline = 0  # the new run dropped the stale docs
                if done and done != baseline:
                    _slo.observe_first_result(
                        tid, tenant,
                        fallback_s=(docstore.now()
                                    - float(doc.get("submit_time")
                                            or docstore.now())))
                    return
                task = self.scheduler.get(tid)
                if task is None or task.get("state") != RUNNING:
                    return  # terminal before any job was written
            except PermissionError:
                # auth misconfig never heals on its own (the _loop
                # carve-out): exit rather than spin at poll cadence
                # forever — the SLO observation is telemetry, the
                # runner's own loop surfaces the failure
                logger.debug("first-result watcher for %s: auth "
                             "rejected; giving up", tid)
                return
            except OSError:
                pass  # board blip: telemetry degrades, never raises
            self._stop.wait(max(self.poll, 0.02))

    def _run_task(self, doc: Dict[str, Any]) -> None:
        from ..server import Server  # late: the device phase imports torch

        tid = doc["_id"]
        if self.scheduler.mark_running(tid) is None:
            return  # a cancel won the race: never start the Server
        threading.Thread(target=self._watch_first_result, args=(doc,),
                         daemon=True,
                         name=f"mr-slo-watch-{tid}").start()
        try:
            kw: Dict[str, Any] = {}
            if self.job_lease is not None:
                kw["job_lease"] = self.job_lease
            server = Server(self.connstr, doc["db"], auth=self.auth,
                            retry=self.retry, **kw)
            server.configure(dict(doc.get("params") or {},
                                  partitions=self.partitions))
            server.loop()
        except Exception as exc:
            # the shield: one tenant's broken task must not take the
            # runner (or any other tenant) down with it
            logger.exception("task %s failed", tid)
            if self.scheduler.mark_failed(
                    tid, reason=f"{type(exc).__name__}: {exc}") is None:
                # a cancel won while the Server ran: the db reservation
                # was deliberately left for THIS exit path to release
                self.scheduler._release_db(doc)
            return
        if self.scheduler.mark_done(
                tid, records=self._served_records(doc["db"])) is None:
            self.scheduler._release_db(doc)


class ScheduledWorker:
    """One worker loop claiming across every admitted tenant's task.

    Wraps the existing :class:`~..worker.Worker` per task db (claims,
    heartbeats, lease fencing, batched claim-ahead all unchanged) and
    cycles over the scheduler's active set in submit order, giving each
    task a bounded slice (``Worker._execute_task`` with a small
    ``max_iter`` returns once the task goes idle), so one pool drains N
    tenants' boards without any tenant monopolising it.
    """

    def __init__(self, connstr: str, auth: Optional[Any] = None,
                 name: Optional[str] = None, retry: Optional[Any] = None,
                 conf: Optional[Dict[str, Any]] = None,
                 job_lease: Optional[float] = None,
                 poll: float = 0.05,
                 idle_backoff: float = 0.5) -> None:
        self.connstr = connstr
        self.auth = auth
        self.retry = retry
        self.name = name or f"sw-{id(self):x}"
        self.job_lease = job_lease
        self.poll = poll
        #: a task whose last slice found no work is skipped for this
        #: long: an always-on pool over N mostly-idle tasks must not
        #: burn a claim RPC + a heartbeat-thread spawn per task per
        #: poll tick forever
        self.idle_backoff = idle_backoff
        self._idle_until: Dict[str, float] = {}
        #: per-slice worker knobs: a small max_iter bounds how long an
        #: idle task holds the loop before the next tenant's turn
        self.conf = {"max_iter": 2, "max_sleep": 0.1, **(conf or {})}
        self._workers: Dict[str, Worker] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._store: Optional[docstore.DocStore] = None
        #: terminal failure (auth misconfig) that stopped this worker —
        #: observable (cmd_runner watches it); the loop still runs its
        #: held-claim release on the way out
        self.failed: Optional[BaseException] = None

    def start(self) -> "ScheduledWorker":
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name=f"mr-{self.name}")
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def _active_tasks(self) -> List[Dict[str, Any]]:
        if self._store is None:
            self._store = docstore.connect(self.connstr, auth=self.auth,
                                           retry=self.retry)
        docs = self._store.find(
            TASKS_COLL, {"state": {"$in": list(INFLIGHT_STATES)},
                         "kind": "server"})
        docs.sort(key=lambda d: int(d.get("seq") or 0))
        return docs

    def _worker_for(self, db: str) -> Worker:
        w = self._workers.get(db)
        if w is None:
            w = Worker(self.connstr, db, auth=self.auth,
                       name=f"{self.name}:{db}", retry=self.retry)
            w.configure(self.conf)
            if self.job_lease is not None:
                w.task.job_lease = self.job_lease
            self._workers[db] = w
        return w

    def run(self) -> None:
        """The pool loop: serve every active task a slice, sleep when
        the whole service is idle.  Board unreachability is an idle
        cycle, not a death — the claim loop inside Worker already
        shields per-RPC faults, this shields the scheduler poll."""
        while not self._stop.is_set():
            try:
                active = self._active_tasks()
            except PermissionError as exc:
                # auth misconfig: retrying is no fix.  Stop OBSERVABLY
                # (failed flag, not a raise that dies silently in a
                # daemon thread) and fall through to the held-claim
                # release below so another worker picks the jobs up now
                logger.error("%s: board auth rejected (%s); stopping",
                             self.name, exc)
                self.failed = exc
                self._stop.set()
                break
            except OSError as exc:
                logger.warning("%s: scheduler board unreachable (%s)",
                               self.name, exc)
                self._stop.wait(max(self.poll, 0.2))
                continue
            # forget workers whose task left the active set, EVERY
            # cycle: a continuously busy service must not accumulate
            # one handle (socket + claim state) per tenant db ever seen
            active_dbs = {d["db"] for d in active}
            for db in [d for d in self._workers if d not in active_dbs]:
                self._workers.pop(db, None)
                self._idle_until.pop(db, None)
            if not active:
                self._stop.wait(self.poll)
                continue
            sliced = False
            for doc in active:
                if self._stop.is_set():
                    break
                db = doc["db"]
                if time.monotonic() < self._idle_until.get(db, 0.0):
                    continue  # idle backoff: nothing claimable last time
                sliced = True
                try:
                    worked = self._worker_for(db)._execute_task()
                    self._idle_until[db] = (
                        0.0 if worked
                        else time.monotonic() + self.idle_backoff)
                except PermissionError as exc:
                    logger.error("%s: auth rejected mid-slice (%s); "
                                 "stopping", self.name, exc)
                    self.failed = exc
                    self._stop.set()
                    break
                except Exception:
                    logger.exception("%s: slice on task %s failed",
                                     self.name, doc["_id"])
            if not sliced:
                # every active task is in idle backoff: pace the poll
                # instead of spinning the active-set query hot
                self._stop.wait(self.poll)
        # release anything still held so the next worker claims it now
        for w in self._workers.values():
            try:
                with w._held_lock:
                    held = list(w._held.values())
                for coll, job_tbl, _fence in held:
                    w.task.release_jobs(coll, [job_tbl])
            except Exception:
                logger.debug("%s: exit release failed", self.name,
                             exc_info=True)


def spawn_scheduled_workers(connstr: str, n: int,
                            auth: Optional[Any] = None,
                            retry: Optional[Any] = None,
                            conf: Optional[Dict[str, Any]] = None,
                            job_lease: Optional[float] = None,
                            name_prefix: str = "sw",
                            ) -> List[ScheduledWorker]:
    """Start *n* cross-tenant workers as daemon threads (the scheduled
    analogue of :func:`~..worker.spawn_worker_threads`)."""
    pool = []
    for i in range(n):
        w = ScheduledWorker(connstr, auth=auth, retry=retry, conf=conf,
                            job_lease=job_lease,
                            name=f"{name_prefix}-{i}")
        w.start()
        pool.append(w)
    return pool


def wait_for_state(scheduler: Scheduler, task_id: str, states,
                   timeout: float = 60.0, poll: float = 0.05,
                   ) -> Dict[str, Any]:
    """Block until *task_id* reaches one of *states*; the submit-and-
    wait convenience the CLI and tests use."""
    states = {states} if isinstance(states, str) else set(states)
    give_up = time.monotonic() + timeout
    while True:
        doc = scheduler.get(task_id)
        if doc is not None and doc.get("state") in states:
            return doc
        if time.monotonic() >= give_up:
            raise TimeoutError(
                f"task {task_id} not in {sorted(states)} within "
                f"{timeout}s (currently "
                f"{doc.get('state') if doc else 'absent'})")
        time.sleep(poll)
