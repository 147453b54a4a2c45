"""Job executor: one claimed map or reduce job (port of
``mapreduce_tpu/coord/job.py``).

Parity with mapreduce/job.lua: load the user module (process-cached), build
the ``emit`` closure, run the user fn, then for map — sort + combine +
partition + write per-partition record files (job_prepare_map,
job.lua:154-228); for reduce — k-way merge all mappers' files for one
partition and fold each key (job_prepare_reduce, job.lua:230-296) — writing
status transitions and cpu/real timings back into the job document
(job.lua:117-152).

Intended-behavior decisions where the reference is quirky (SURVEY.md §7):

  * worker-side ``init`` receives the real ``init_args`` (the reference
    passes an undefined global — job.lua:369);
  * the combiner is the explicitly-configured ``combinerfn`` param; when
    absent and the reduce module declares itself associative + commutative
    + idempotent, ``reducefn`` doubles as the combiner (what the reference
    examples do by hand, reducefn.lua:10-14) — a non-ACI reducefn is never
    silently used as a combiner (the reference would, task.lua:322-327).
"""

from __future__ import annotations

import logging
import re
import time
import urllib.parse
from typing import Any, Callable, Dict, List, Optional

from .. import spec
from ..obs import metrics as _metrics
from ..obs.trace import TRACER
from ..utils.constants import (
    STATUS, TASK_STATUS, MAX_MAP_RESULT, MAP_RESULT_TEMPLATE)
from ..utils.iterators import merge_iterator
from ..utils.serialization import (
    serialize_record, sort_key, check_serializable)
from .. import storage as storage_mod
from . import docstore
from .connection import Connection

logger = logging.getLogger("mapreduce_tpu_torch.coord.job")

# -- per-task accounting: the collector's roll-up substrate (task = the
#    task database name — low cardinality by construction).  Map-side
#    partition increments measure the shuffle volume INTO each
#    partition. -----------------------------------------------------------
_TASK_RECORDS = _metrics.counter(
    "mrtpu_task_records_total",
    "record lines written by jobs, per task (labels: task, phase)")
_TASK_BYTES = _metrics.counter(
    "mrtpu_task_bytes_total",
    "record bytes written by jobs, per task (labels: task, phase)")
_PARTITION_RECORDS = _metrics.counter(
    "mrtpu_partition_records_total",
    "records routed into each reduce partition at map write time plus "
    "records reduced out of it (labels: task, phase, partition)")
_PARTITION_BYTES = _metrics.counter(
    "mrtpu_partition_bytes_total",
    "record bytes per reduce partition (labels: task, phase, partition)")


def sanitize_token(s: str) -> str:
    """Make an arbitrary key string safe inside a blob name."""
    return urllib.parse.quote(str(s), safe="")


def map_file_name(ns: str, part: int, mapkey: Any) -> str:
    """``<ns>.P<part>.M<mapkey>`` (reference job.lua:196-215), partition
    zero-padded so lexicographic listing groups deterministically."""
    return MAP_RESULT_TEMPLATE.format(
        ns=ns, part=f"{part:05d}", mapkey=sanitize_token(mapkey))


def map_results_prefix(path: str) -> str:
    """The shared map-output namespace for a task (single source of truth
    for job writers and the server's reduce planner)."""
    return f"{path}/map_results"


def ambient_scope(connection: Connection, storage_dsl) -> set:
    """The ``HOST:PORT`` endpoints a job's ambient auth token is valid
    for: its own board and its own http storage — nothing else, so user
    fns dialing third-party HTTP hosts cannot leak the cluster secret."""
    from ..utils.httpclient import split_embedded_token

    hosts = set(connection.board_hostports())
    # parse the DSL prefix directly: get_storage_from would mkdtemp as a
    # side effect for a bare "shared" string
    if isinstance(storage_dsl, str) and storage_dsl.startswith("http:"):
        hosts.add(split_embedded_token(storage_dsl.partition(":")[2])[1])
    return hosts


class Job:
    """Reference: ``job(cnn, job_tbl, task_status, fname, init_args, ...)``
    (job.lua:300-381); instances are built by the worker from a claimed
    job document plus the task singleton's fields."""

    def __init__(self, connection: Connection, job_tbl: Dict[str, Any],
                 task_status: TASK_STATUS, task_tbl: Dict[str, Any],
                 jobs_ns: str, fence: Optional[Any] = None) -> None:
        self._cnn = connection
        self.tbl = job_tbl
        self.task_status = task_status
        self.task_tbl = task_tbl
        self.jobs_ns = jobs_ns
        #: threading.Event set by the worker's heartbeat thread when this
        #: claim's lease is confirmed lost; checked at every emit and
        #: before each output-publish / write-back step, so a fenced run
        #: aborts instead of racing the re-issued copy.  A publish
        #: already in flight when the fence drops may still land (benign:
        #: per-job-named atomic whole-content files); the hard guarantee
        #: is the claim-guarded job-document write-back.
        self._fence = fence
        self._storage = storage_mod.router(
            task_tbl["storage"], auth=connection.auth_token(),
            retry=connection.retry_policy)
        self.path = task_tbl["path"]
        #: files consumed by a reduce run, deleted only once WRITTEN is
        #: durable (a re-run of a crashed reduce must still find them)
        self._consumed: List[str] = []

    # -- status transitions (job.lua:117-152, 322-342) --------------------

    def get_id(self) -> str:
        return self.tbl["_id"]

    def _claim_query(self) -> Dict[str, Any]:
        """Match the job only while THIS claim still owns it.  A worker
        whose lease was reaped and whose job was reclaimed by someone else
        must not clobber the new owner's state (the reference has exactly
        this hazard and shrugs, task.lua:307-309)."""
        return {"_id": self.get_id(),
                "worker": self.tbl.get("worker"),
                "tmpname": self.tbl.get("tmpname")}

    def _set_status(self, status: STATUS,
                    extra: Optional[Dict] = None) -> bool:
        fields = {"status": int(status)}
        if extra:
            fields.update(extra)
        n = self._cnn.connect().update(self.jobs_ns, self._claim_query(),
                                       {"$set": fields})
        return n > 0

    def mark_as_finished(self) -> bool:
        return self._set_status(STATUS.FINISHED,
                                {"finished_time": docstore.now()})

    def mark_as_written(self, cpu_time: float, real_time: float) -> bool:
        return self._set_status(STATUS.WRITTEN,
                                {"written_time": docstore.now(),
                                 "cpu_time": cpu_time,
                                 "real_time": real_time})

    def mark_as_broken(self) -> None:
        """BROKEN + $inc repetitions; claimable again (job.lua:322-342).
        Guarded by the claim so a stale worker can't re-break a job another
        worker has since reclaimed, and by status so a post-completion
        failure (e.g. cleanup I/O) can never demote a durably WRITTEN job
        back to claimable."""
        self._cnn.connect().update(
            self.jobs_ns,
            {**self._claim_query(),
             "status": {"$nin": [int(STATUS.WRITTEN),
                                 int(STATUS.FAILED)]}},
            {"$set": {"status": int(STATUS.BROKEN)},
             "$inc": {"repetitions": 1}})

    def _check_fence(self) -> None:
        """Abort if the heartbeat thread has confirmed lease loss; called
        from emit (so a long user fn dies at its next emission) and before
        each output-visibility step."""
        if self._fence is not None and self._fence.is_set():
            from .task import LeaseLostError
            raise LeaseLostError(
                f"job {self.get_id()}: lease lost (reaped or reclaimed); "
                "aborting this run — the re-issued copy owns the job now")

    # -- user-fn plumbing --------------------------------------------------

    def _role(self, role: str) -> spec.RoleModule:
        rm = spec.load_role(self.task_tbl[role], role)
        rm.ensure_init(self.task_tbl.get("init_args"))
        return rm

    def _effective_combiner(self) -> Optional[Callable]:
        name = self.task_tbl.get("combinerfn")
        if name:
            return self._role("combinerfn").fn
        red = self._role("reducefn")
        if spec.is_aci(red):
            return lambda k, vs: red.fn(k, vs)
        return None

    # -- execution ---------------------------------------------------------

    def execute(self) -> None:
        """job:__call dispatch (job.lua:345-381).  Runs under the ambient
        auth token — scoped to this job's own board + storage endpoints —
        so user map/reduce fns that build their own storage handle
        (router(DSL) in module code, e.g. examples/train_digits) inherit
        the worker's token without env/DSL plumbing."""
        from ..utils.httpclient import push_ambient_auth, restore_ambient_auth

        # durations on the monotonic clock: an NTP step mid-job must not
        # corrupt the persisted real_time (started_time/written_time stay
        # wall-clock by contract — they are timestamps, not durations)
        t_cpu, t_real = time.process_time(), time.monotonic()
        prev_auth = push_ambient_auth(
            self._cnn.auth_token(),
            ambient_scope(self._cnn, self.task_tbl.get("storage")))
        try:
            if self.task_status == TASK_STATUS.MAP:
                self._execute_map()
            elif self.task_status == TASK_STATUS.REDUCE:
                self._execute_reduce()
            else:
                raise RuntimeError(
                    f"job in task status {self.task_status}")
        finally:
            restore_ambient_auth(prev_auth)
        self._check_fence()
        owned = self.mark_as_written(time.process_time() - t_cpu,
                                     time.monotonic() - t_real)
        # delete consumed map files only once WRITTEN is durable AND this
        # claim still owned the job (a reaped+reclaimed job's files belong
        # to the new owner's re-run); reference deletes pre-write,
        # job.lua:293, which loses the partition if the worker dies between
        # build and write-back.  A cleanup failure must NOT escape: the job
        # is already durably WRITTEN, and letting a storage blip bubble to
        # the worker's shield would demote a completed job to BROKEN — a
        # forced duplicate execution whose inputs may be partially deleted.
        if owned and self._consumed:
            try:
                self._storage.remove_many(self._consumed)
            except OSError:
                logger.warning(
                    "job %s: WRITTEN but consumed-input cleanup failed; "
                    "leaving orphan map files behind", self.get_id(),
                    exc_info=True)
        self._consumed = []

    def _execute_map(self) -> None:
        """job_prepare_map (job.lua:154-228)."""
        mapfn = self._role("mapfn").fn
        partfn = self._role("partitionfn").fn
        combiner = self._effective_combiner()

        result: Dict[Any, List[Any]] = {}
        keyorder: Dict[Any, Any] = {}
        # sort_key memo for the scalar keys real workloads emit: emit is
        # THE map hot loop and sort_key allocates a rank tuple per call.
        # Two type-split caches, because dict keys compare by value across
        # types (True == 1 == 1.0) while sort_key ranks them differently —
        # and only exact str/int (not bool, not float) are cached, so a
        # float key can never alias an int cache entry.
        _sk_str: Dict[str, Any] = {}
        _sk_int: Dict[int, Any] = {}

        def emit(key: Any, value: Any) -> None:
            self._check_fence()
            tk = type(key)
            if tk is str:
                sk = _sk_str.get(key)
                if sk is None:
                    sk = _sk_str[key] = sort_key(key)
            elif tk is int:
                sk = _sk_int.get(key)
                if sk is None:
                    sk = _sk_int[key] = sort_key(key)
            else:
                sk = sort_key(key)
            bucket = result.setdefault(sk, [])
            keyorder.setdefault(sk, key)
            bucket.append(value)
            # streaming combine: collapse a hot key's pending values
            # (job.lua:92-96, threshold utils.lua:53)
            if combiner is not None and len(bucket) >= MAX_MAP_RESULT:
                result[sk] = [combiner(key, bucket)]

        with TRACER.span("run", phase="map", job=self.get_id()):
            mapfn(self.tbl["key"], self.tbl["value"], emit)
            self.mark_as_finished()

            # sort keys, write-time combine, partition (job.lua:194-215)
            per_part: Dict[int, List[str]] = {}
            for sk in sorted(result.keys()):
                key = keyorder[sk]
                values = result[sk]
                if combiner is not None and len(values) > 1:
                    values = [combiner(key, values)]
                part = partfn(key)
                if not isinstance(part, int):
                    raise TypeError(
                        f"partitionfn must return int, got "
                        f"{type(part).__name__}"
                        " (reference job.lua:203-207)")
                per_part.setdefault(part, []).append(
                    serialize_record(key, values))
            db = self._cnn.dbname
            for part, lines in per_part.items():
                nb = sum(len(ln) for ln in lines)
                part_lbl = f"P{part:05d}"
                _PARTITION_RECORDS.inc(len(lines), task=db, phase="map",
                                       partition=part_lbl)
                _PARTITION_BYTES.inc(nb, task=db, phase="map",
                                     partition=part_lbl)
                _TASK_RECORDS.inc(len(lines), task=db, phase="map")
                _TASK_BYTES.inc(nb, task=db, phase="map")

        with TRACER.span("write", phase="map", job=self.get_id(),
                         partitions=len(per_part)):
            ns = map_results_prefix(self.path)

            def put_one(part: int, lines: List[str]) -> None:
                self._check_fence()
                b = self._storage.builder()
                for line in lines:
                    b.write_record_line(line)
                b.build(map_file_name(ns, part, self.get_id()))

            for part, lines in per_part.items():
                put_one(part, lines)

    def _execute_reduce(self) -> None:
        """job_prepare_reduce (job.lua:230-296): merge all mappers' files
        for one partition, fold keys, write one result file."""
        red = self._role("reducefn")
        reducefn, aci = red.fn, spec.is_aci(red)
        value = self.tbl["value"]
        file_prefix, result_name = value["file"], value["result"]

        files = self._storage.list(
            "^" + re.escape(file_prefix) + r"\.M")
        sources = [
            (lambda name: lambda: _records(self._storage, name))(n)
            for n in files
        ]
        b = self._storage.builder()
        n_out = 0
        out_bytes = 0
        with TRACER.span("run", phase="reduce", job=self.get_id(),
                         inputs=len(files)):
            for key, values in merge_iterator(sources):
                self._check_fence()
                # ACI fast path: a single value needs no reduce call
                # (job.lua:264-284)
                if aci and len(values) == 1:
                    out = values[0]
                else:
                    out = reducefn(key, values)
                check_serializable(out)
                line = serialize_record(key, [out])
                n_out += 1
                out_bytes += len(line)
                b.write_record_line(line)
        with TRACER.span("write", phase="reduce", job=self.get_id()):
            b.build(result_name)
        db = self._cnn.dbname
        # the reduce job id IS the partition token (P<nnnnn>)
        _PARTITION_RECORDS.inc(n_out, task=db, phase="reduce",
                               partition=str(self.get_id()))
        _PARTITION_BYTES.inc(out_bytes, task=db, phase="reduce",
                             partition=str(self.get_id()))
        _TASK_RECORDS.inc(n_out, task=db, phase="reduce")
        _TASK_BYTES.inc(out_bytes, task=db, phase="reduce")
        # deletion of consumed inputs is deferred to execute(), post-WRITTEN
        self._consumed = files


def _records(storage, name):
    from ..utils.serialization import parse_record
    for line in storage.open_lines(name):
        yield parse_record(line)


def run_map_inline(task_tbl: Dict[str, Any], key: Any, value: Any,
                   emit: Callable[[Any, Any], None]) -> None:
    """Run a mapfn outside the job machinery (used by tests/tools)."""
    rm = spec.load_role(task_tbl["mapfn"], "mapfn")
    rm.ensure_init(task_tbl.get("init_args"))
    rm.fn(key, value, emit)
