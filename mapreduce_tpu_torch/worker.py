"""Worker: the polling executor loop (reference mapreduce/worker.lua; port
of ``mapreduce_tpu/worker.py``).

Claims jobs from the task's job board, runs them under an exception shield
that marks the job BROKEN and reports to the errors channel, backs off
exponentially when idle, and self-terminates after too many CONSECUTIVE
failures (worker.lua:42-138, call stack SURVEY.md §3.2).  New vs the
reference:

* a heartbeat thread extends held-job leases so the server can tell slow
  workers from dead ones (SURVEY.md §5 gap) — and doubles as the fencing
  probe: when it learns a lease is LOST (reaped after a partition
  outlasted ``job_lease``, or re-issued to another worker) it fences
  that job, which aborts at its next emit/output step instead of racing
  the re-issued copy (coord/task.LeaseLostError);
* the claim path is PIPELINED: one batched claim RPC takes up to
  ``claim_batch`` jobs (Task.take_next_jobs — one board round trip
  instead of one per job), and when the worker starts its last queued
  job it claims the next batch in the background, so the claim's
  network latency overlaps the current job's execution instead of
  serializing with it.  Every held claim is leased and fenced
  INDIVIDUALLY — one heartbeat RPC covers them all (heartbeat_many),
  but a lost lease fences exactly the job that lost it;
* with an ``http://`` board the worker leases the process-shared
  telemetry pusher (obs/collector), so its spans and metrics reach the
  docserver's ``/clusterz`` and ``/metrics``.

Worker threads of one process share its CUDA context; separate worker
processes (``python -m mapreduce_tpu_torch.cli worker``) each build or
load the kernel libraries on their first device call.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .coord.connection import Connection
from .coord.job import Job
from .coord.task import LeaseLostError, Task
from .obs import metrics as _metrics
from .obs.trace import TRACER
from .utils.constants import (
    TASK_STATUS, DEFAULT_SLEEP, DEFAULT_MAX_SLEEP, DEFAULT_MAX_ITER,
    DEFAULT_MAX_TASKS, DEFAULT_HEARTBEAT, DEFAULT_CLAIM_BATCH,
    MAX_WORKER_RETRIES)

logger = logging.getLogger("mapreduce_tpu_torch.worker")

_CLAIMS = _metrics.counter(
    "mrtpu_worker_claims_total",
    "claim-poll outcomes (labels: worker, task, outcome=claimed|idle|"
    "unreachable)")
_CLAIM_BATCH = _metrics.histogram(
    "mrtpu_worker_claim_batch_jobs",
    "jobs claimed per successful claim RPC (labels: worker, task) — the "
    "claim pipelining win is this histogram's mean being > 1",
    buckets=(1, 2, 4, 8, 16, 32))
_CLAIMED_JOBS = _metrics.counter(
    "mrtpu_worker_claimed_jobs_total",
    "jobs claimed, summed over batches (labels: worker, task)")
_RELEASED_JOBS = _metrics.counter(
    "mrtpu_worker_released_jobs_total",
    "claim-ahead jobs handed back to WAITING unrun at worker exit "
    "(labels: worker, task)")
_HEARTBEATS = _metrics.counter(
    "mrtpu_worker_heartbeats_total",
    "per-claim heartbeat outcomes (labels: worker, task, outcome=ok|"
    "error|lost); one batched RPC may account several claims")
_LEASE_LOST = _metrics.counter(
    "mrtpu_worker_lease_lost_total",
    "jobs fenced after a confirmed lease loss (labels: worker, task)")
_JOBS = _metrics.counter(
    "mrtpu_worker_jobs_total",
    "jobs this worker finished, by outcome (labels: worker, task, "
    "phase, outcome=written|broken|fenced)")
_JOB_SECONDS = _metrics.histogram(
    "mrtpu_worker_job_seconds",
    "wall seconds from claim to job outcome (labels: worker, task, "
    "phase)")
_CONSEC_FAILURES = _metrics.gauge(
    "mrtpu_worker_consecutive_failures",
    "current unbroken run of job failures (labels: worker, task); "
    "MAX_WORKER_RETRIES ends the worker")


class _AsyncClaim:
    """One batched claim RPC in flight on its own thread — the worker's
    claim-ahead slot.  Started when the worker begins its last queued
    job; joined when that job finishes, by which time the next batch is
    (usually) already claimed.  The claims are registered into the
    worker's held-lease set FROM THIS THREAD, the moment the RPC
    answers — a prefetched claim's lease starts ticking at the claim,
    so its heartbeats must too, not only once the current job finishes
    and the batch is dequeued (a long job would otherwise let every
    prefetched lease expire and be reaped, charging spurious
    repetitions)."""

    def __init__(self, worker: "Worker", sync: bool = False) -> None:
        self.t0 = time.monotonic()
        self.t1 = self.t0
        self.jobs: List[Dict[str, Any]] = []
        self.fences: Dict[str, threading.Event] = {}
        self.status: Optional[TASK_STATUS] = None
        self.task_tbl: Dict[str, Any] = {}
        self.error: Optional[BaseException] = None
        self._worker = worker
        if sync:
            # the blocking-claim path: same result shape, no thread
            # churn (an idle worker polls this many times per second)
            self._t = None
            self._run()
        else:
            self._t = threading.Thread(target=self._run, daemon=True)
            self._t.start()

    def _run(self) -> None:
        w = self._worker
        try:
            self.jobs, self.status = w.task.take_next_jobs(
                w.name, Task.tmpname(), w.claim_batch)
            self.task_tbl = dict(w.task.tbl)
        except BaseException as exc:
            self.error = exc
        else:
            if self.jobs:  # under heartbeat from this instant
                self.fences = w._register_claims(self.status, self.jobs)
        self.t1 = time.monotonic()

    def join(self) -> "_AsyncClaim":
        if self._t is not None:
            self._t.join()
        return self


class Worker:
    """Reference: ``worker.new(connstr, dbname, auth)`` (worker.lua:154-167)."""

    def __init__(self, connstr: str, dbname: str,
                 auth: Optional[Any] = None,
                 name: Optional[str] = None,
                 retry: Optional[Any] = None) -> None:
        self.cnn = Connection(connstr, dbname, auth, retry=retry)
        self.task = Task(self.cnn)
        self.name = name or f"{Connection.hostname()}-{id(self):x}"
        #: the per-task accounting label on every metric this worker
        #: emits (the task database name — low cardinality)
        self._task = dbname
        self.max_iter = DEFAULT_MAX_ITER
        self.max_sleep = DEFAULT_MAX_SLEEP
        self.max_tasks = DEFAULT_MAX_TASKS
        self.sleep = DEFAULT_SLEEP
        self.heartbeat_period = DEFAULT_HEARTBEAT
        #: claim pipelining knobs: jobs per claim RPC, and whether the
        #: next batch's claim overlaps the current job's execution
        self.claim_batch = DEFAULT_CLAIM_BATCH
        self.claim_ahead = True
        #: telemetry push knobs: spans + metric snapshots go to the
        #: docserver's collector every ``telemetry_interval`` seconds
        #: over a DEDICATED socket (obs/collector.TelemetryPusher —
        #: lossy-but-counted, can never block a heartbeat or job).
        #: ``telemetry_address`` defaults to the board itself for
        #: http:// connstrs.  The LIBRARY default is off (embedders —
        #: and tests that put a fault proxy in front of the board —
        #: must not grow surprise background traffic); the worker CLI
        #: turns it on at 1.0s.
        self.telemetry_interval = 0.0
        self.telemetry_address: Optional[str] = None
        self.telemetry_backlog = 20_000
        self.jobs_done = 0
        # claims this worker currently holds: _id -> (coll, job_tbl,
        # fence); shared between the executor loop and the heartbeat
        # thread under _held_lock
        self._held: Dict[str, Tuple[str, Dict[str, Any],
                                    threading.Event]] = {}
        self._held_lock = threading.Lock()

    def configure(self, conf: Dict[str, Any]) -> None:
        """worker.lua:142-148: max_iter / max_sleep / max_tasks knobs,
        plus the claim-pipelining pair and the telemetry-push knobs."""
        for k in ("max_iter", "max_sleep", "max_tasks", "claim_batch",
                  "claim_ahead", "telemetry_interval",
                  "telemetry_address", "telemetry_backlog"):
            if k in conf:
                setattr(self, k, conf[k])
        # claim_batch=0 would make every poll an idle poll forever — a
        # silent no-op worker; 1 is the meaningful minimum (serial path)
        self.claim_batch = max(int(self.claim_batch), 1)

    def _register_claims(self, status: TASK_STATUS,
                         jobs: List[Dict[str, Any]],
                         ) -> Dict[str, threading.Event]:
        """Put freshly claimed jobs under heartbeat coverage (called by
        whichever thread completed the claim RPC); returns each job's
        fence."""
        coll = self._jobs_coll(status)
        fences: Dict[str, threading.Event] = {}
        with self._held_lock:
            for j in jobs:
                fence = threading.Event()
                self._held[j["_id"]] = (coll, j, fence)
                fences[j["_id"]] = fence
        return fences

    # -- heartbeat: one thread, one RPC, every held lease -----------------

    def _beat_all(self, stop: threading.Event) -> None:
        while not stop.wait(self.heartbeat_period):
            with self._held_lock:
                groups: Dict[str, List[Tuple[Dict[str, Any],
                                             threading.Event]]] = {}
                for coll, job_tbl, fence in self._held.values():
                    groups.setdefault(coll, []).append((job_tbl, fence))
            for coll, pairs in groups.items():
                try:
                    owned = self.task.heartbeat_many(
                        coll, [j for j, _ in pairs])
                except Exception:
                    # network failure: ownership is UNKNOWN (the lease may
                    # still be live server-side), so keep beating — fencing
                    # on a guess would abort healthy jobs during a blip
                    _HEARTBEATS.inc(worker=self.name, task=self._task,
                                    outcome="error")
                    logger.exception("heartbeat failed")
                    continue
                for (job_tbl, fence), ok in zip(pairs, owned):
                    _HEARTBEATS.inc(worker=self.name, task=self._task,
                                    outcome="ok" if ok else "lost")
                    if not ok and not stop.is_set():
                        # the server answered and this claim no longer
                        # matches: lease reaped (partition outlasted
                        # job_lease, task.reap_expired) or the job was
                        # re-issued.  Fence THIS job only — its batch-
                        # mates' claims answered for themselves.
                        logger.warning(
                            "%s: lease lost on job %s — fencing",
                            self.name, job_tbl["_id"])
                        _LEASE_LOST.inc(worker=self.name, task=self._task)
                        fence.set()
                        with self._held_lock:
                            self._held.pop(job_tbl["_id"], None)

    # -- one job under the shield (worker.lua:112-138) --------------------

    def _run_one(self, job_tbl: Dict[str, Any], status: TASK_STATUS,
                 task_tbl: Dict[str, Any], coll: str,
                 fence: threading.Event,
                 t_claim0: float, t_claim1: float) -> str:
        """Execute one claimed job; returns its outcome
        (written|broken|fenced)."""
        job = Job(self.cnn, job_tbl, status, task_tbl, coll, fence=fence)
        logger.info("%s: running %s job %s", self.name, status.value,
                    job.get_id())
        outcome = "written"
        # the root span is backdated to the claim RPC so the trace shows
        # claim -> run -> write nested under one per-job trace id (the
        # batch's claim interval is recorded under EACH of its jobs)
        with TRACER.span("job", start=t_claim0, job=job.get_id(),
                         phase=status.value, worker=self.name) as root:
            TRACER.record("claim", t_claim0, t_claim1,
                          worker=self.name, job=job.get_id())
            try:
                job.execute()
                if status == TASK_STATUS.MAP:
                    self.task.note_written_map_job(job.get_id())
                self.jobs_done += 1
            except LeaseLostError:
                # fenced, not failed: the job was reaped/re-issued (e.g. a
                # partition outlasted job_lease) and its new owner runs it
                # now.  This worker is healthy — don't mark BROKEN (the
                # claim guard wouldn't match anyway), don't count it
                # toward giving up.
                outcome = "fenced"
                logger.warning("%s: job %s fenced after lease loss",
                               self.name, job.get_id())
            except Exception as exc:
                # xpcall shield: mark BROKEN, report, maybe give up
                # (worker.lua:112-138)
                outcome = "broken"
                logger.exception("%s: job %s failed", self.name,
                                 job.get_id())
                try:
                    job.mark_as_broken()
                    self.cnn.insert_exception(self.name, exc)
                except Exception:
                    # the BROKEN mark and the errors channel ride the same
                    # network as the board; when the job failed BECAUSE of
                    # a partition these fail too.  Keep the shield: the
                    # lease reaper re-issues the job either way, a dead
                    # worker thread helps nobody.
                    logger.exception("%s: could not report job failure",
                                     self.name)
            finally:
                root.args["outcome"] = outcome
                _JOBS.inc(worker=self.name, task=self._task,
                          phase=status.value, outcome=outcome)
                _JOB_SECONDS.observe(time.monotonic() - t_claim0,
                                     worker=self.name, task=self._task,
                                     phase=status.value)
        return outcome

    def _release(self, coll: str,
                 leftovers: List[Dict[str, Any]]) -> None:
        """Hand claimed-but-unrun jobs back to WAITING on exit paths so
        another worker picks them up now, not after a lease reap."""
        if not leftovers:
            return
        with self._held_lock:
            for j in leftovers:
                self._held.pop(j["_id"], None)
        try:
            n = self.task.release_jobs(coll, leftovers)
        except Exception:
            logger.warning("%s: could not release %d unrun claims; the "
                           "lease reaper will reclaim them", self.name,
                           len(leftovers), exc_info=True)
            return
        if n:
            _RELEASED_JOBS.inc(n, worker=self.name, task=self._task)

    def _jobs_coll(self, status: TASK_STATUS) -> str:
        return (self.task.map_jobs_ns() if status == TASK_STATUS.MAP
                else self.task.red_jobs_ns())

    # -- the executor loop (worker.lua:42-105) ----------------------------

    def _execute_task(self) -> bool:
        """Work one task to completion; True if any job was executed."""
        iter_count = 0
        sleep = self.sleep
        worked = False
        failures = 0  # CONSECUTIVE failures; reset by every success
        prefetch: Optional[_AsyncClaim] = None
        with self._held_lock:
            self._held.clear()
        stop_beat = threading.Event()
        beat_t = threading.Thread(target=self._beat_all,
                                  args=(stop_beat,), daemon=True)
        beat_t.start()
        try:
            while iter_count < self.max_iter:
                # -- obtain a batch: the claim-ahead slot if one is in
                #    flight, else a fresh (blocking) claim RPC
                if prefetch is not None:
                    claim, prefetch = prefetch.join(), None
                else:
                    claim = _AsyncClaim(self, sync=True)
                if claim.error is not None:
                    if isinstance(claim.error, PermissionError):
                        raise claim.error  # auth misconfig: retrying is no fix
                    if not isinstance(claim.error, OSError):
                        raise claim.error
                    # board unreachable (RetryError / CircuitOpenError /
                    # reset): an idle poll, not a death sentence — back off
                    # like any idle iteration; a board that never comes
                    # back exhausts max_iter and the worker exits normally
                    _CLAIMS.inc(worker=self.name, task=self._task,
                                outcome="unreachable")
                    logger.warning("%s: job board unreachable (%s); "
                                   "backing off", self.name, claim.error)
                    iter_count += 1
                    time.sleep(sleep)
                    sleep = min(sleep * 1.5, self.max_sleep)
                    continue
                if not claim.jobs:
                    _CLAIMS.inc(worker=self.name, task=self._task,
                                outcome="idle")
                    if claim.status == TASK_STATUS.FINISHED:
                        return worked
                    # idle: exponential backoff (worker.lua:97-103)
                    iter_count += 1
                    time.sleep(sleep)
                    sleep = min(sleep * 1.5, self.max_sleep)
                    continue

                status, task_tbl = claim.status, claim.task_tbl
                coll = self._jobs_coll(status)
                _CLAIMS.inc(worker=self.name, task=self._task,
                            outcome="claimed")
                _CLAIM_BATCH.observe(len(claim.jobs), worker=self.name,
                                     task=self._task)
                _CLAIMED_JOBS.inc(len(claim.jobs), worker=self.name,
                                  task=self._task)
                # fences were minted at registration time (inside the
                # claim RPC's thread) — the batch has been heartbeated
                # since the moment it was claimed
                pending = collections.deque(
                    (j, claim.fences[j["_id"]]) for j in claim.jobs)

                try:
                    while pending:
                        job_tbl, fence = pending.popleft()
                        if fence.is_set():
                            # lease lost while queued (already out of
                            # _held): the re-issued copy owns it — never
                            # start the stale run
                            logger.warning(
                                "%s: skipping job %s — lease lost before "
                                "it started", self.name, job_tbl["_id"])
                            continue
                        if not pending and self.claim_ahead:
                            # claim-ahead: the next batch's round trip
                            # overlaps this (last queued) job's execution
                            prefetch = _AsyncClaim(self)
                        outcome = self._run_one(
                            job_tbl, status, task_tbl, coll, fence,
                            claim.t0, claim.t1)
                        with self._held_lock:
                            self._held.pop(job_tbl["_id"], None)
                        if outcome == "written":
                            worked = True
                            # a success proves this worker is healthy:
                            # only an unbroken run of failures should end
                            # it, or a long-lived worker's occasional
                            # transient faults accumulate into a lifetime
                            # death sentence
                            failures = 0
                        elif outcome == "broken":
                            failures += 1
                        _CONSEC_FAILURES.set(failures, worker=self.name,
                                             task=self._task)
                        if failures >= MAX_WORKER_RETRIES:
                            logger.error(
                                "%s: %d consecutive failures, giving up "
                                "on task (worker.lua:133-137)", self.name,
                                failures)
                            return worked
                        if outcome == "broken":
                            # shed the rest of the batch (finally below
                            # releases it) and re-claim fresh: the serial
                            # path interleaves a failed job's RETRY with
                            # the next claims, so N distinct first-attempt
                            # failures never read as N consecutive ones —
                            # ploughing on through a claimed batch would.
                            # A failing worker also shouldn't sit on
                            # queued work another worker could run.
                            break
                finally:
                    # leftover claims on ANY exit (give-up, exception):
                    # back to WAITING for the next worker
                    self._release(coll, [j for j, f in pending
                                         if not f.is_set()])
                iter_count = 0
                sleep = self.sleep
            return worked
        finally:
            if prefetch is not None:
                c = prefetch.join()
                if c.error is None and c.jobs:
                    self._release(self._jobs_coll(c.status), c.jobs)
            stop_beat.set()
            beat_t.join()

    def _start_telemetry(self):
        """Lease the process-shared telemetry pusher when the board is a
        networked docserver (the collector lives there) — shared, not
        per-worker: N workers in one process drain ONE span ring, so one
        pusher delivers it once.  Any failure means 'no telemetry',
        never 'no worker'."""
        from .obs.collector import acquire_pusher

        address = self.telemetry_address
        if not address:
            try:
                address = self.cnn.board_hostport()
            except Exception:
                address = None
        return acquire_pusher(address, self.cnn.auth_token(),
                              role=f"worker:{self.name}",
                              interval=self.telemetry_interval,
                              max_backlog=self.telemetry_backlog)

    def execute(self) -> None:
        """Top-level entry (worker.lua:112-138): serve up to max_tasks
        tasks, waiting for each to appear."""
        from .obs.collector import release_pusher

        logger.info("worker %s starting", self.name)
        lease = self._start_telemetry()
        try:
            self._execute_tasks()
        finally:
            # the LAST worker out stops the shared pusher with a final
            # flush, so the process's closing spans reach the merged
            # timeline; anything undeliverable is counted dropped
            release_pusher(lease)

    def _execute_tasks(self) -> None:
        for _ in range(self.max_tasks):
            # wait for a task document to exist and leave WAIT
            iter_count = 0
            sleep = self.sleep
            while iter_count < self.max_iter:
                try:
                    has_task = self.task.update()
                except PermissionError:
                    raise
                except OSError as exc:  # same shield as the claim loop
                    logger.warning("%s: job board unreachable (%s); "
                                   "backing off", self.name, exc)
                    has_task = False
                if has_task and not self.task.finished():
                    if self.task.status() != TASK_STATUS.WAIT:
                        break
                iter_count += 1
                time.sleep(sleep)
                sleep = min(sleep * 1.5, self.max_sleep)
            else:
                logger.info("worker %s: no task appeared, exiting", self.name)
                return
            self._execute_task()
        logger.info("worker %s done (%d jobs)", self.name, self.jobs_done)


def spawn_worker_threads(connstr: str, dbname: str, n: int,
                         conf: Optional[Dict[str, Any]] = None,
                         auth: Optional[Any] = None,
                         retry: Optional[Any] = None,
                         name_prefix: Optional[str] = None,
                         ) -> List[threading.Thread]:
    """Run *n* workers as daemon threads in this process — the rebuild's
    'fake cluster' for tests and the single-host deployment (the reference
    uses N OS processes under ``screen``, test.sh:10).  *name_prefix*
    overrides the default ``w<i>`` naming (``<prefix>-<i>``) so
    multi-process deployments keep worker metric/trace labels distinct."""
    threads = []
    for i in range(n):
        name = f"{name_prefix}-{i}" if name_prefix else f"w{i}"
        w = Worker(connstr, dbname, auth=auth, name=name, retry=retry)
        if conf:
            w.configure(conf)
        t = threading.Thread(target=w.execute, daemon=True,
                             name=f"mr-worker-{i}")
        t.start()
        threads.append(t)
    return threads
