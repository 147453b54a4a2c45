"""Framework-wide constants and status enums.

Port of ``mapreduce_tpu/utils/constants.py``: the reference's constant
block (reference: mapreduce/utils.lua:24-56).  The job / task state
machines are kept bit-compatible in *meaning* with the reference so the
scheduler semantics (SURVEY.md §2, task.lua / job.lua) carry over:

  job:   WAITING -> RUNNING -> FINISHED -> WRITTEN   (happy path)
         WAITING/RUNNING -> BROKEN -> (retry) -> ... -> FAILED
  task:  WAIT -> MAP -> REDUCE -> FINISHED

Numeric values follow mapreduce/utils.lua:33-46.
"""

from __future__ import annotations

import enum


class STATUS(enum.IntEnum):
    """Per-job status (reference: mapreduce/utils.lua:33-40)."""

    WAITING = 0   # claimable
    RUNNING = 1   # claimed by a worker (lease-protected here, unlike reference)
    BROKEN = 2    # worker died / user fn raised; claimable again
    FINISHED = 3  # user fn ran; output not yet durable
    WRITTEN = 4   # output durable in storage; terminal success
    FAILED = 5    # exceeded MAX_JOB_RETRIES; terminal failure


class TASK_STATUS(str, enum.Enum):
    """Task-singleton phase (reference: mapreduce/utils.lua:42-46)."""

    WAIT = "WAIT"
    MAP = "MAP"
    REDUCE = "REDUCE"
    FINISHED = "FINISHED"


# --- tunables (reference: mapreduce/utils.lua:27-55) -----------------------

#: seconds between control-plane polls.  The reference hardcodes 1s
#: (utils.lua:28); our in-process / shared-dir backends are cheap so the
#: default is much tighter, and callers may override.
DEFAULT_SLEEP = 0.05

#: worker idle backoff multiplier and cap (reference: worker.lua:100-102).
IDLE_BACKOFF = 1.5
DEFAULT_MAX_SLEEP = 2.0

#: give up after this many idle polls (reference: worker.lua default
#: max_iter=20, worker.lua:160-163).
DEFAULT_MAX_ITER = 20

#: how many tasks a worker executes before exiting (reference default 1).
DEFAULT_MAX_TASKS = 1

#: a job is FAILED after this many BROKEN retries (utils.lua MAX_JOB_RETRIES,
#: enforced server-side at server.lua:192-206).
MAX_JOB_RETRIES = 3

#: a worker self-terminates after this many distinct failed jobs
#: (worker.lua:133-137).
MAX_WORKER_RETRIES = 3

#: streaming-combiner threshold: combine a key's pending values once this
#: many accumulate during map (job.lua:92-96, utils.lua:53 MAX_MAP_RESULT).
MAX_MAP_RESULT = 5000

#: taskfn value size cap, bytes (utils.lua:54, enforced server.lua:256-272).
MAX_TASKFN_VALUE_SIZE = 16 * 1024

#: control-plane insert batching (cnn.lua:73-104 flushes at 50k).
MAX_PENDING_INSERTS = 50000

#: NEW (no reference equivalent -- fixes the missing dead-worker reaping
#: called out in SURVEY.md §5): RUNNING jobs whose lease is older than this
#: are reaped back to BROKEN by the server.  The JAX package sizes it for
#: a slow networked board (one beat period + 4 board deadlines < 60 s);
#: the value is kept so both packages lease alike.
DEFAULT_JOB_LEASE = 60.0

#: worker heartbeat period; must be well under DEFAULT_JOB_LEASE.
DEFAULT_HEARTBEAT = 5.0

#: locality preference: after this many idle polls a worker stops holding
#: out for its own cached map jobs and claims anything
#: (task.lua:249-254 MAX_IDLE_COUNT).
MAX_IDLE_COUNT = 5

#: NEW (no reference equivalent): jobs a worker claims per board round
#: trip (claim pipelining, Task.take_next_jobs).  1 restores the
#: reference's serial claim-per-job traffic; higher amortizes the claim
#: RPC across the batch and lets the next jobs' claims overlap the
#: current job's execution.  Kept small so a slow worker doesn't hoard
#: jobs a free worker could run — each held claim is still individually
#: lease-fenced, so the failure cost of hoarding is bounded by job_lease.
DEFAULT_CLAIM_BATCH = 4

#: grid/file-name layout for intermediate files, mirroring the reference's
#: "<results_ns>.P<part>.M<map_key>" convention (job.lua:196-215).
MAP_RESULT_TEMPLATE = "{ns}.P{part}.M{mapkey}"
RED_RESULT_TEMPLATE = "{ns}.P{part:04d}"

#: default number of reduce partitions when a task does not specify one
#: (the reference examples use 10-15; partitionfn.lua:2-15).
DEFAULT_NUM_PARTITIONS = 10
