"""Multi-tenant scheduler: the service layer over the job board (port
of ``mapreduce_tpu/sched``).

  * :mod:`.scheduler` — the board-resident task queue: per-tenant
    queues with priority + weighted-fair dequeue, admission control
    (global in-flight bound, per-tenant quotas on queued tasks, jobs
    and bytes), crash-safe state (every decision is a document
    mutation) and lease-fenced scheduler ownership.  The docserver
    hosts one and speaks ``/tasks`` (submit/list/cancel/tick,
    rid-deduped like every other board mutation).
  * :mod:`.service` — the serving processes: a :class:`TaskRunner`
    that drives admitted tasks through the unchanged ``Server``
    machinery, and :class:`ScheduledWorker` — ONE worker loop serving
    every admitted tenant's job board through the existing ``Task``
    claim machinery.
"""

from .scheduler import (  # noqa: F401
    QuotaExceededError, Scheduler, SchedulerClient, SchedulerConfig,
    SchedulerFencedError, SchedulerLease)
from .service import (  # noqa: F401
    ScheduledWorker, TaskRunner, spawn_scheduled_workers, wait_for_state)
