"""Server: the planning and polling loop (reference mapreduce/server.lua;
port of ``mapreduce_tpu/server.py``).

Configures a task, plans map jobs from ``taskfn``, polls workers'
completion, plans reduce jobs from the map output files, aggregates
per-phase statistics, runs ``finalfn`` and drives the iterative ``"loop"``
cycle with crash recovery (server.lua:417-622, call stack SURVEY.md §3.1).

Differences by design: stats are computed host-side in Python (the
reference ships server-side JavaScript into mongod, server.lua:155-183);
expired RUNNING-job leases are reaped each poll (the reference only clears
stale jobs on restart, server.lua:237-245).

Differences from the JAX package: the device phase runs the port's
:class:`~.engine.DeviceEngine` over :class:`~.parallel.mesh.Partitions`
(``configure`` pops ``"partitions"`` where the JAX server pops
``"mesh"``; the default ``Partitions(1)`` is the card and raises without
CUDA); there is no capacity autotuner or speculative re-claim yet
(ROADMAP A.7).  PyTorch is imported only by the device phase.  On an
``http://`` board with ``http:`` storage every byte the loop moves —
the device phase's ``result.P00000`` included — is a blob PUT or GET,
and the loop's spans and metrics reach the docserver through the
process-shared telemetry pusher.
"""

from __future__ import annotations

import logging
import re
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from . import spec
from . import storage as storage_mod
from .coord import docstore
from .coord.connection import Connection
from .coord.job import map_results_prefix
from .coord.task import Task, make_job
from .obs import metrics as _metrics
from .obs.metrics import REGISTRY
from .obs.trace import TRACER
from .utils.constants import (
    STATUS, TASK_STATUS, DEFAULT_SLEEP, MAX_JOB_RETRIES,
    MAX_TASKFN_VALUE_SIZE)
from .utils.serialization import (
    check_serializable, serialize_record, sort_key)
from .utils.iterators import merge_iterator

logger = logging.getLogger("mapreduce_tpu_torch.server")

TERMINAL = [int(STATUS.WRITTEN), int(STATUS.FAILED)]

# -- stats gauges: the ONE source both the persisted stats doc and the
#    /metrics exposition read, so they cannot drift apart.  Every series
#    carries the task's db label: two Server instances in one process
#    (the library supports several tasks per board) must not overwrite
#    each other's stats between publish and read-back -----------------------
_STATS_JOBS = _metrics.gauge(
    "mrtpu_stats_jobs",
    "terminal jobs in the last computed stats (labels: db, phase, "
    "state=all|failed)")
_STATS_SECONDS = _metrics.gauge(
    "mrtpu_stats_seconds",
    "per-phase timing sums from the last computed stats (labels: db, "
    "phase, field=cpu|real|cluster)")
_STATS_ITERATION = _metrics.gauge(
    "mrtpu_stats_iteration",
    "iteration the last stats doc covers (labels: db)")
_STATS_DEVICE = _metrics.gauge(
    "mrtpu_stats_device",
    "device-phase engine timings from the last run (labels: db, field)")
_PHASE_SECONDS = _metrics.histogram(
    "mrtpu_server_phase_seconds",
    "wall seconds the server spent driving one phase (labels: phase)")


def _publish_phase_stats(db: str, phase: str, d: Dict[str, Any]) -> None:
    _STATS_JOBS.set(d["count"], db=db, phase=phase, state="all")
    _STATS_JOBS.set(d["failed"], db=db, phase=phase, state="failed")
    _STATS_SECONDS.set(d["sum_cpu_time"], db=db, phase=phase, field="cpu")
    _STATS_SECONDS.set(d["sum_real_time"], db=db, phase=phase,
                       field="real")
    _STATS_SECONDS.set(d["cluster_time"], db=db, phase=phase,
                       field="cluster")


def _phase_stats_from_registry(db: str, phase: str) -> Dict[str, Any]:
    """Read one phase's stats BACK from the registry — the persisted doc
    is built from these reads, so doc and /metrics agree by construction."""
    return {
        "count": int(REGISTRY.value("mrtpu_stats_jobs", db=db,
                                    phase=phase, state="all")),
        "failed": int(REGISTRY.value("mrtpu_stats_jobs", db=db,
                                     phase=phase, state="failed")),
        "sum_cpu_time": REGISTRY.value("mrtpu_stats_seconds", db=db,
                                       phase=phase, field="cpu"),
        "sum_real_time": REGISTRY.value("mrtpu_stats_seconds", db=db,
                                        phase=phase, field="real"),
        "cluster_time": REGISTRY.value("mrtpu_stats_seconds", db=db,
                                       phase=phase, field="cluster"),
    }


class Server:
    """Reference: ``server.new(connstr, dbname, auth)`` (server.lua:614-622)."""

    def __init__(self, connstr: str, dbname: str,
                 auth: Optional[Any] = None,
                 reclaim: Optional[Any] = None,
                 retry: Optional[Any] = None) -> None:
        if reclaim is not None:
            raise ValueError("speculative re-claim is not ported yet "
                             "(ROADMAP A.7); pass reclaim=None")
        self.cnn = Connection(connstr, dbname, auth, retry=retry)
        self.task = Task(self.cnn)
        self.params: Dict[str, Any] = {}
        self.configured = False
        self.finished = False
        self.poll_sleep = DEFAULT_SLEEP
        #: telemetry push cadence to the board's collector (seconds) —
        #: the server's spans join the merged cluster timeline the same
        #: way the workers' do.  Off by default in the library (no
        #: surprise background traffic for embedders); the server CLI
        #: turns it on at 1.0s.
        self.telemetry_interval = 0.0
        # device fast path state (configure(device=True)): the partitions
        # and the engine live on the server instance and never enter the
        # task document
        self._parts = None
        self._device_engine = None
        self._last_device_timings: Optional[Dict[str, Any]] = None

    # -- configuration (server.lua:417-460) --------------------------------

    def configure(self, params: Dict[str, Any]) -> None:
        params = dict(params)
        # live Partitions are config for THIS process, not task state;
        # a device task without them gets the card now, so a missing
        # CUDA device fails here rather than mid-run
        self._parts = params.pop("partitions", None)
        if params.get("device") and self._parts is None:
            self._parts = self._device_parts()
        backend, path = storage_mod.get_storage_from(params.get("storage"))
        params["storage"] = f"{backend}:{path}"
        params["path"] = path
        spec.validate_spec(params)
        # run task/final init once, dedup by module identity
        # (server.lua:452-456)
        init_args = params.get("init_args")
        for role in ("taskfn", "finalfn"):
            spec.load_role(params[role], role).ensure_init(init_args)
        self.params = params
        self.configured = True

    # -- map planning (server.lua:249-276) ---------------------------------

    def _remove_pending_jobs(self, coll: str) -> None:
        """Clear non-terminal jobs (stale RUNNING/WAITING from a crashed
        run), keeping WRITTEN/FAILED (server.lua:237-245)."""
        self.cnn.connect().remove(
            coll, {"status": {"$nin": TERMINAL}})

    def _collect_task_pairs(self) -> List[Tuple[Any, Any]]:
        """Run taskfn and return its validated (key, value) emits
        (dup-key check + value-size cap, server.lua:256-272)."""
        taskfn = spec.load_role(self.params["taskfn"], "taskfn")
        seen: Dict[str, Any] = {}
        pairs: List[Tuple[Any, Any]] = []

        def emit(key: Any, value: Any) -> None:
            check_serializable(key)
            check_serializable(value)
            kid = str(key)
            if kid in seen:
                raise ValueError(
                    f"taskfn emitted duplicate key {key!r} "
                    "(reference dup check server.lua:256-268)")
            seen[kid] = True
            if len(repr(value)) > MAX_TASKFN_VALUE_SIZE:
                raise ValueError(
                    f"taskfn value for key {key!r} exceeds "
                    f"{MAX_TASKFN_VALUE_SIZE} bytes (utils.lua:54)")
            pairs.append((key, value))

        taskfn.fn(emit)
        return pairs

    def _prepare_map(self) -> int:
        coll = self.task.map_jobs_ns()
        self._remove_pending_jobs(coll)
        existing = {d["_id"] for d in self.cnn.connect().find(coll)}
        jobs = [make_job(k, v) for k, v in self._collect_task_pairs()
                if str(k) not in existing]  # resume: keep finished jobs
        self.task.insert_jobs(coll, jobs)
        self.task.set_task_status(TASK_STATUS.MAP)
        logger.info("map phase: %d jobs planned", len(jobs))
        return len(jobs)

    # -- completion polling (server.lua:186-234) ---------------------------

    def _poll_phase(self, coll: str, phase: str) -> None:
        """Block until every job in *coll* is WRITTEN or FAILED: reap
        expired leases, promote over-retried BROKEN jobs to FAILED, drain
        the errors channel, log progress."""
        store = self.cnn.connect()
        last_pct = -1.0
        while True:
            reaped = self.task.reap_expired(coll)
            if reaped:
                logger.warning("%s: reaped %d expired job leases", phase,
                               reaped)
            # BROKEN with repetitions >= cap -> FAILED (server.lua:192-206)
            store.update(
                coll,
                {"status": int(STATUS.BROKEN),
                 "repetitions": {"$gte": MAX_JOB_RETRIES}},
                {"$set": {"status": int(STATUS.FAILED)}}, multi=True)
            total = store.count(coll)
            done = store.count(coll, {"status": {"$in": TERMINAL}})
            errors = self.cnn.get_errors()
            if errors:
                for e in errors:
                    logger.error("worker %s error: %s", e.get("worker"),
                                 e.get("msg"))
                self.cnn.remove_errors([e["_id"] for e in errors])
            pct = 100.0 * done / max(total, 1)
            if pct != last_pct:
                logger.info("%s %.1f%% (%d/%d)", phase, pct, done, total)
                last_pct = pct
            if done >= total:
                return
            time.sleep(self.poll_sleep)

    # -- reduce planning (server.lua:279-329) ------------------------------

    def _prepare_reduce(self) -> int:
        storage = self._storage()
        ns = map_results_prefix(self.params["path"])
        # group map result files by partition token P<nnnnn>
        # (server.lua:291-312)
        rx = re.compile(re.escape(ns) + r"\.(P\d+)\.M")
        parts: Dict[str, List[str]] = {}
        for name in storage.list("^" + re.escape(ns) + r"\.P\d+\.M"):
            m = rx.match(name)
            if m:
                parts.setdefault(m.group(1), []).append(name)
        coll = self.task.red_jobs_ns()
        self._remove_pending_jobs(coll)
        existing = {d["_id"] for d in self.cnn.connect().find(coll)}
        result_ns = self.task.red_results_ns()
        jobs = []
        # NOTE: no per-job "mappers" hostname list, unlike server.lua:316-323
        # — that existed for the scp pull; the reduce executor re-lists the
        # shared storage by prefix instead
        for pkey in sorted(parts):
            if pkey in existing:
                continue
            value = {"file": f"{ns}.{pkey}",
                     "result": f"{result_ns}.{pkey}"}
            jobs.append(make_job(pkey, value))
        self.task.insert_jobs(coll, jobs)
        self.task.set_task_status(TASK_STATUS.REDUCE)
        logger.info("reduce phase: %d partitions", len(jobs))
        return len(jobs)

    def _storage(self):
        """The task's storage, opened with the connection's token and
        retry policy (one flag set governs both sockets)."""
        return storage_mod.router(self.params["storage"],
                                  auth=self.cnn.auth_token(),
                                  retry=self.cnn.retry_policy)

    # -- device fast path (the unified framework, SURVEY.md §7 steps 4-5) --

    def _device_parts(self):
        if self._parts is None:
            from .parallel.mesh import Partitions
            self._parts = Partitions(1)
        return self._parts

    def _get_device_engine(self, ds: spec.DeviceSpec, parts):
        if self._device_engine is None:
            from .engine import DeviceEngine, EngineConfig
            cfg = ds.config() if ds.config else EngineConfig()
            self._device_engine = DeviceEngine(parts, ds.map_fn, cfg)
        return self._device_engine

    def _run_device_phase(self) -> None:
        """Fused map+shuffle+reduce on the device: taskfn plans splits
        host-side exactly as the general path does, the module's device
        hooks turn them into one engine run, and the reduced uniques
        land in the SAME result-file contract the host reduce writes — so
        finalfn, stats, ``"loop"`` iteration and crash recovery are
        shared, not duplicated.  One job document (``__device__``) records
        the fused phase for the stats machinery; per-stage device timings
        go into it and into ``task.stats.device``
        (parity with the reference's per-phase report, server.lua:555-600).
        """
        coll = self.task.map_jobs_ns()
        # device re-runs are idempotent whole-phase: forget prior jobs
        self.cnn.connect().remove(coll, {})
        pairs = self._collect_task_pairs()
        # claim-equivalent: the server stakes the __device__ job on the
        # board.  Backdating the root span to here gives the device
        # plane the same claim -> run -> write trace the worker path
        # records.
        t_claim0 = time.monotonic()
        job = make_job("__device__", {"pairs": len(pairs)})
        now = docstore.now()
        job.update({"worker": "server",
                    "status": int(STATUS.RUNNING),
                    "started_time": now,
                    "lease_expires": now + self.task.job_lease})
        self.task.insert_jobs(coll, [job])
        self.task.set_task_status(TASK_STATUS.MAP)
        t_claim1 = time.monotonic()

        with TRACER.span("job", start=t_claim0, job="__device__",
                         phase="device", worker="server") as root:
            TRACER.record("claim", t_claim0, t_claim1,
                          worker="server", job="__device__")
            ds = spec.load_device(self.params["mapfn"])
            spec.load_role(self.params["mapfn"], "mapfn").ensure_init(
                self.params.get("init_args"))
            parts = self._device_parts()
            # monotonic for the duration fields; wall clock (docstore.now)
            # only for the started_time/written_time timestamps
            t_cpu, t_real = time.process_time(), time.monotonic()
            timings: Dict[str, Any] = {}
            with TRACER.span("run", phase="device", job="__device__"):
                t0 = time.monotonic()
                chunks = ds.prepare(pairs, parts)
                t1 = time.monotonic()
                engine = self._get_device_engine(ds, parts)
                # on_overflow="return" so the error names the MODULE
                # knob (the engine's own raise points at EngineConfig
                # generically)
                res = engine.run(chunks, timings=timings,
                                 on_overflow="return")
                if res.overflow:
                    raise RuntimeError(
                        f"device phase overflowed capacities by "
                        f"{res.overflow} rows even after retries; raise "
                        "the module's EngineConfig")
                t2 = time.monotonic()
                out_pairs = list(ds.result(chunks, res))
                t3 = time.monotonic()

            self.task.set_task_status(TASK_STATUS.REDUCE)
            # one key-sorted result partition file in the shared record
            # format: finalfn cannot tell which plane produced it.  Stale
            # result partitions from a crashed (possibly host-plane) run
            # are cleared first — _result_pairs merges every result.P*
            # file, so a leftover P00001 would silently blend into the
            # device output
            with TRACER.span("write", phase="device", job="__device__"):
                storage = self._storage()
                storage.remove_many(self._result_partitions(storage))
                b = storage.builder()
                for key, values in sorted(out_pairs,
                                          key=lambda kv: sort_key(kv[0])):
                    check_serializable(key)
                    values = list(values)
                    check_serializable(values)
                    b.write_record_line(serialize_record(key, values))
                b.build(f"{self.task.red_results_ns()}.P00000")
                # the phase's host split beside the engine's own keys
                # (every value a JSON type: a dir: board json.dumps it)
                timings["prepare_s"] = t1 - t0
                timings["engine_s"] = t2 - t1
                timings["result_s"] = t3 - t2
                timings["write_s"] = time.monotonic() - t3
                self.cnn.connect().update(
                    coll, {"_id": "__device__"},
                    {"$set": {"status": int(STATUS.WRITTEN),
                              "written_time": docstore.now(),
                              "cpu_time": time.process_time() - t_cpu,
                              "real_time": time.monotonic() - t_real,
                              "device_timings": timings}})
            root.args["outcome"] = "written"
        self._last_device_timings = timings
        logger.info("device phase: %d splits -> %d uniques, %d waves, "
                    "%d retries, timings %s", len(pairs), len(out_pairs),
                    timings.get("waves", 0), timings.get("retries", 0),
                    timings)

    # -- statistics (server.lua:155-183, 538-600) --------------------------

    def _phase_stats(self, coll: str) -> Dict[str, Any]:
        """Aggregate one phase's terminal job docs.

        Clock caveat: ``cpu_time``/``real_time`` are per-job durations
        measured on each worker's own monotonic clock (NTP-safe), but
        ``cluster_time`` spans DIFFERENT workers — it subtracts one
        worker's wall-clock ``started_time`` from another's
        ``written_time`` (both stamped via docstore.now), so clock skew
        between hosts leaks into it.  That is inherent to a cross-host
        makespan; treat cluster_time as approximate at skew scale.
        """
        docs = self.cnn.connect().find(coll,
                                       {"status": {"$in": TERMINAL}})
        cpu = sum(d.get("cpu_time", 0.0) for d in docs)
        real = sum(d.get("real_time", 0.0) for d in docs)
        started = [d["started_time"] for d in docs if "started_time" in d]
        written = [d["written_time"] for d in docs if "written_time" in d]
        failed = sum(1 for d in docs if d["status"] == int(STATUS.FAILED))
        return {
            "count": len(docs),
            "failed": failed,
            "sum_cpu_time": cpu,
            "sum_real_time": real,
            "cluster_time": (max(written) - min(started)
                             if started and written else 0.0),
        }

    def _compute_stats(self) -> Dict[str, Any]:
        """Aggregate job docs -> registry gauges -> persisted stats doc.

        The registry sits in the middle on purpose: the doc is built by
        READING the gauges back (_phase_stats_from_registry), so the
        registry and the stats doc the reference persisted
        (server.lua:555-600) are the same numbers by construction.
        """
        db = self.cnn.dbname
        _publish_phase_stats(db, "map",
                             self._phase_stats(self.task.map_jobs_ns()))
        _publish_phase_stats(db, "reduce",
                             self._phase_stats(self.task.red_jobs_ns()))
        _STATS_ITERATION.set(self.task.iteration(), db=db)
        m = _phase_stats_from_registry(db, "map")
        r = _phase_stats_from_registry(db, "reduce")
        _STATS_SECONDS.set(m["cluster_time"] + r["cluster_time"],
                           db=db, phase="total", field="cluster")
        stats = {"map": m, "reduce": r,
                 "cluster_time": REGISTRY.value(
                     "mrtpu_stats_seconds", db=db, phase="total",
                     field="cluster"),
                 "iteration": int(REGISTRY.value("mrtpu_stats_iteration",
                                                 db=db))}
        if self._last_device_timings is not None:
            # per-stage device timings (upload/compute/readback/waves)
            # into the persisted stats doc — the device-path form of the
            # reference's per-phase report (server.lua:555-600) — and
            # into gauges
            for field, v in self._last_device_timings.items():
                if isinstance(v, (int, float)):
                    _STATS_DEVICE.set(v, db=db, field=field)
            stats["device"] = dict(self._last_device_timings)
        self.task.set_fields({"stats": stats})
        logger.info(
            "stats: map %d jobs (%d failed) cpu %.3fs cluster %.3fs | "
            "reduce %d jobs (%d failed) cpu %.3fs cluster %.3fs",
            m["count"], m["failed"], m["sum_cpu_time"], m["cluster_time"],
            r["count"], r["failed"], r["sum_cpu_time"], r["cluster_time"])
        return stats

    # -- final (server.lua:346-411) ----------------------------------------

    def _result_partitions(self, storage) -> List[str]:
        """Every result partition file for this task — the single source
        of truth for the result-file naming pattern (written by host
        reduce jobs and the device phase alike)."""
        result_ns = self.task.red_results_ns()
        return storage.list("^" + re.escape(result_ns) + r"\.P\d+$")

    def _result_pairs(self, storage) -> Iterator[Tuple[Any, List[Any]]]:
        """Merged iterator over all result partition files, globally key-
        sorted (server.lua:352-383 iterates files in sorted order; we merge
        so finalfn sees one ordered stream)."""
        names = self._result_partitions(storage)

        def records(name):
            from .utils.serialization import parse_record
            def it():
                for line in storage.open_lines(name):
                    yield parse_record(line)
            return it

        return merge_iterator([records(n) for n in names])

    def _final(self) -> Any:
        storage = self._storage()
        finalfn = spec.load_role(self.params["finalfn"], "finalfn")
        reply = finalfn.fn(self._result_pairs(storage))
        if reply not in (True, False, None, "loop"):
            logger.warning("finalfn returned %r; expected "
                           "True/False/None/'loop' (server.lua:387-390)",
                           reply)
        result_ns = self.task.red_results_ns()
        if reply == "loop":
            # iterate: forget job boards, keep task doc (server.lua:395-398)
            logger.info("finalfn requested loop; iteration %d done",
                        self.task.iteration())
            self.cnn.connect().drop_collection(self.task.map_jobs_ns())
            self.cnn.connect().drop_collection(self.task.red_jobs_ns())
        else:
            self.task.set_task_status(TASK_STATUS.FINISHED)
            self.finished = True
        # result files are deleted unless the user asked to keep them by
        # returning False/None (server.lua:403-410)
        if reply in (True, "loop"):
            storage.remove_many(self._result_partitions(storage))
        return reply

    # -- the main loop (server.lua:464-609) --------------------------------

    def loop(self) -> Dict[str, Any]:
        assert self.configured, "call configure() before loop()"
        # ambient token for user fns run server-side (taskfn/finalfn may
        # build their own storage handle, like worker-side map fns do);
        # scoped to this task's own endpoints and restored after — a
        # later open server on this thread must not inherit it
        from .coord.job import ambient_scope
        from .obs.collector import acquire_pusher, release_pusher
        from .utils.httpclient import push_ambient_auth, restore_ambient_auth

        prev_auth = push_ambient_auth(
            self.cnn.auth_token(),
            ambient_scope(self.cnn, self.params.get("storage")))
        # push the server's spans/metrics to the board's collector (when
        # the board is a networked docserver); telemetry failures can
        # never fail the run.  The pusher is process-shared — a server
        # colocated with worker threads must not deliver the ring twice.
        lease = acquire_pusher(self.cnn.board_hostport(),
                               self.cnn.auth_token(),
                               role=f"server:{self.cnn.dbname}",
                               interval=self.telemetry_interval)
        try:
            return self._loop_impl()
        finally:
            restore_ambient_auth(prev_auth)
            release_pusher(lease)

    def _loop_impl(self) -> Dict[str, Any]:
        it = 0
        skip_map = False
        # the execution plane is decided ONCE: params, falling back to the
        # persisted task doc on resume — so a crashed device-mode task
        # resumed by a server configured without device=True (or vice
        # versa) stays on the plane the original run recorded instead of
        # silently switching mid-task (ADVICE r3)
        device = bool(self.params.get("device"))
        # crash recovery (server.lua:468-491)
        if self.task.update():
            st = self.task.status()
            if st != TASK_STATUS.FINISHED:
                # resuming: the PERSISTED plane wins in both directions —
                # a device-configured server must not hijack a host-plane
                # task mid-run (abandoning its stored map output) any more
                # than the reverse
                doc_device = self.task.tbl.get("device")
                if doc_device is not None:
                    device = bool(doc_device)
            if st == TASK_STATUS.FINISHED:
                self.drop_collections()
            elif st == TASK_STATUS.REDUCE:
                logger.warning("resuming crashed task at REDUCE "
                               "(server.lua:475-481)")
                # restore storage decisions from the surviving task doc
                self.params["storage"] = self.task.tbl["storage"]
                self.params["path"] = self.task.tbl["path"]
                if device:
                    # the device phase is fused: re-run it whole (its
                    # map output never hits storage, so a REDUCE-state
                    # resume has nothing to reduce from)
                    it = max(self.task.iteration() - 1, 0)
                else:
                    it = self.task.iteration()
                    skip_map = True
            elif st in (TASK_STATUS.WAIT, TASK_STATUS.MAP):
                logger.warning("resuming crashed task at %s", st.value)
                self.params["storage"] = self.task.tbl["storage"]
                self.params["path"] = self.task.tbl["path"]
                it = max(self.task.iteration() - 1, 0)

        while not self.finished:
            if device:
                # unified device fast path: ONE fused device phase replaces
                # map + shuffle + reduce; taskfn/finalfn/stats/loop stay
                # exactly the host machinery
                it += 1
                self.task.create_collection(TASK_STATUS.WAIT, self.params,
                                            it)
                t0 = time.monotonic()
                self._run_device_phase()
                dt = time.monotonic() - t0
                _PHASE_SECONDS.observe(dt, phase="device")
                logger.info("device map+reduce done in %.3fs", dt)
            else:
                if not skip_map:
                    it += 1
                    self.task.create_collection(TASK_STATUS.WAIT,
                                                self.params, it)
                    t0 = time.monotonic()
                    self._prepare_map()
                    self._poll_phase(self.task.map_jobs_ns(), "map")
                    dt = time.monotonic() - t0
                    _PHASE_SECONDS.observe(dt, phase="map")
                    logger.info("map done in %.3fs", dt)
                else:
                    skip_map = False
                t0 = time.monotonic()
                self._prepare_reduce()
                self._poll_phase(self.task.red_jobs_ns(), "reduce")
                dt = time.monotonic() - t0
                _PHASE_SECONDS.observe(dt, phase="reduce")
                logger.info("reduce done in %.3fs", dt)
            stats = self._compute_stats()
            self._final()
        return stats

    def drop_collections(self) -> None:
        """server_drop_collections (server.lua:331-343)."""
        store = self.cnn.connect()
        for coll in (self.task.task_ns(), self.task.map_jobs_ns(),
                     self.task.red_jobs_ns(), self.cnn.ns("errors")):
            store.drop_collection(coll)
        self.task.tbl = {}
