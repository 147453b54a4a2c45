"""Serving SLO plane, the lifecycle half (port of
``mapreduce_tpu/obs/slo.py``).

Per-tenant request timestamps threaded through the serving path:

* ``sched/scheduler.py`` stamps submit→admitted (**queue wait**) and
  admitted→running on task transitions;
* ``sched/service.py`` stamps running→first-job-written (the
  **submit→first-result** latency of a server-kind task);
* a resident session's snapshot reports **staleness** (age of the newest
  record a ``snapshot()`` reflects) through :func:`observe_staleness`,
  and every feed and snapshot its own latency through
  :func:`observe_session_op`.

All of it lands in per-tenant Histograms on the sub-second-resolution
:data:`~.metrics.SLO_BUCKETS` ladder; :func:`merged_counts` reads them
back for percentile estimation (:func:`~.metrics.estimate_percentile`).

Cross-process stamps: the exact duration needs ONE process to see both
ends, so the scheduler keeps an in-memory monotonic stamp per submit
(:func:`stamp_submit`) and the observers fall back to the board's
persisted wall timestamps (minted through ``coord/docstore.now``) when
the transitions happened in different processes.

Left out (ROADMAP A.8): the objectives and their evaluation
(``SLOObjective``, ``parse_objective``, ``SloPlane``, ``evaluate``,
``slo_snapshot``, ``validate_slo``) and the ``--slo`` flag.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .metrics import REGISTRY, Registry, SLO_BUCKETS, histogram

# -- the per-tenant lifecycle histograms -------------------------------------

QUEUE_WAIT_FAMILY = "mrtpu_slo_queue_wait_seconds"
FIRST_RESULT_FAMILY = "mrtpu_slo_submit_first_result_seconds"
STALENESS_FAMILY = "mrtpu_slo_snapshot_staleness_seconds"

_QUEUE_WAIT = histogram(
    QUEUE_WAIT_FAMILY,
    "submit -> admitted wait per tenant task (labels: tenant) — "
    "monotonic when one scheduler saw both transitions, else the "
    "board's persisted timestamps", buckets=SLO_BUCKETS)
_ADMIT_TO_RUNNING = histogram(
    "mrtpu_slo_admit_to_running_seconds",
    "admitted -> running latency per tenant task (labels: tenant) — "
    "how long an admitted task waited for its Server thread", buckets=SLO_BUCKETS)
_FIRST_RESULT = histogram(
    FIRST_RESULT_FAMILY,
    "submit -> first result visible per tenant (labels: tenant): first "
    "job written for a server task, first snapshot for a session "
    "stream", buckets=SLO_BUCKETS)
_STALENESS = histogram(
    STALENESS_FAMILY,
    "snapshot staleness per tenant stream (labels: tenant): age of the "
    "newest record the snapshot reflects, monotonic at feed time vs "
    "monotonic at snapshot time", buckets=SLO_BUCKETS)
_SESSION_OP = histogram(
    "mrtpu_slo_session_op_seconds",
    "per-call latency of the resident session surface (labels: tenant, "
    "op=feed|snapshot)", buckets=SLO_BUCKETS)


# -- in-memory submit stamps (the exact-duration path) -----------------------

#: bounded monotonic stamp registry keyed by scheduler task id; evicted
#: FIFO past the cap (a stamp is only an accuracy upgrade — observers
#: fall back to persisted board timestamps without one)
_STAMP_CAP = 4096
_stamp_lock = threading.Lock()
_stamps: "collections.OrderedDict[str, Dict[str, Any]]" = \
    collections.OrderedDict()


def stamp_submit(task_id: str, tenant: str) -> None:
    """Record the monotonic submit instant of *task_id* (called by
    ``Scheduler.submit`` in the frontend process)."""
    with _stamp_lock:
        _stamps[str(task_id)] = {"t": time.monotonic(),
                                 "tenant": str(tenant),
                                 "admitted_t": None,
                                 "first_done": False}
        while len(_stamps) > _STAMP_CAP:
            _stamps.popitem(last=False)


def note_admitted(task_id: str,
                  tenant: Optional[str] = None) -> Optional[float]:
    """Stamp the admission instant (creating an admitted-only entry
    when the submit happened in another process, so admit→running can
    still be exact here); returns the queue wait (monotonic) when this
    process also saw the submit."""
    with _stamp_lock:
        st = _stamps.get(str(task_id))
        now = time.monotonic()
        if st is None:
            _stamps[str(task_id)] = {"t": None,
                                     "tenant": str(tenant or "-"),
                                     "admitted_t": now,
                                     "first_done": False}
            while len(_stamps) > _STAMP_CAP:
                _stamps.popitem(last=False)
            return None
        st["admitted_t"] = now
        return None if st["t"] is None else now - st["t"]


def admitted_age(task_id: str) -> Optional[float]:
    with _stamp_lock:
        st = _stamps.get(str(task_id))
        if st is None or st.get("admitted_t") is None:
            return None
        return time.monotonic() - st["admitted_t"]


def drop_stamp(task_id: str) -> None:
    with _stamp_lock:
        _stamps.pop(str(task_id), None)


def observe_queue_wait(tenant: str, seconds: float) -> None:
    _QUEUE_WAIT.observe(max(0.0, float(seconds)), tenant=str(tenant))


def observe_admit_to_running(tenant: str, seconds: float) -> None:
    _ADMIT_TO_RUNNING.observe(max(0.0, float(seconds)),
                              tenant=str(tenant))


def observe_first_result(task_id: str, tenant: str,
                         fallback_s: Optional[float] = None,
                         ) -> Optional[float]:
    """Observe submit→first-result ONCE per task: the monotonic stamp
    when this process saw the submit, else *fallback_s* (a wall-clock
    difference of persisted board timestamps, the cross-process
    degradation).  Returns the observed seconds, or None when neither
    source is available or the task already reported."""
    with _stamp_lock:
        st = _stamps.get(str(task_id))
        if st is not None and st["first_done"]:
            return None
        seconds = (time.monotonic() - st["t"]
                   if st is not None and st["t"] is not None
                   else fallback_s)
        if st is not None:
            st["first_done"] = True
    if seconds is None:
        return None
    seconds = max(0.0, float(seconds))
    _FIRST_RESULT.observe(seconds, tenant=str(tenant))
    return seconds


def observe_staleness(tenant: str, seconds: float) -> None:
    _STALENESS.observe(max(0.0, float(seconds)), tenant=str(tenant))


def observe_session_op(op: str, tenant: str, seconds: float) -> None:
    _SESSION_OP.observe(max(0.0, float(seconds)), tenant=str(tenant),
                        op=str(op))


# -- histogram read paths ----------------------------------------------------


def merged_counts(family: str, tenants: Optional[Iterable[str]] = None,
                  registry: Registry = REGISTRY,
                  ) -> Tuple[List[float], List[int]]:
    """(bounds, per-bucket counts) of *family* summed over *tenants*
    (every tenant when None) from the LOCAL registry — the bench's
    baseline/delta read path."""
    h = registry.histogram(family, buckets=SLO_BUCKETS)
    bounds = list(h.buckets)
    if tenants is None:
        return bounds, h.merged_counts()
    out = [0] * len(bounds)
    for t in tenants:
        for i, n in enumerate(h.merged_counts(tenant=str(t))):
            out[i] += n
    return bounds, out
