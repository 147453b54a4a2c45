"""Board gauges for ``/metrics`` (port of ``update_board_gauges`` and its
helpers from ``mapreduce_tpu/obs/statusz.py``).

The docserver calls :func:`update_board_gauges` right before it renders
``/metrics``, so the job board's queue depth by phase and status is
scrape-time truth computed from the authoritative DocStore, not a stale
event count.  The rest of the JAX module — the ``/statusz`` cluster
snapshot and its sections — waits for device observability (ROADMAP
A.8); the port's docserver answers ``/statusz`` with 404.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..utils.constants import STATUS
from .metrics import REGISTRY, Registry

#: job-board collection suffixes that make up one task's database; the
#: trainer-lease suffix is appended from its source of truth at scrape
#: time (late import: coord pulls obs in at package load)
_BOARD_SUFFIXES = ("task", "map_jobs", "red_jobs", "errors")


def _board_suffixes():
    from ..coord.lease import TrainerLease

    return _BOARD_SUFFIXES + (TrainerLease.COLL,)


def _status_name(code: Any) -> str:
    try:
        return STATUS(int(code)).name
    except (ValueError, TypeError):
        return str(code)


def _dbnames(store) -> Dict[str, Dict[str, str]]:
    """Group board collections by database prefix: ``{db: {suffix: coll}}``
    (collections are named ``<db>.<suffix>``, coord/connection.ns)."""
    dbs: Dict[str, Dict[str, str]] = {}
    suffixes = _board_suffixes()
    for coll in store.collections():
        db, sep, suffix = coll.rpartition(".")
        if sep and suffix in suffixes:
            dbs.setdefault(db, {})[suffix] = coll
    return dbs


def _phase_counts(store, coll: Optional[str]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    if coll is None:
        return counts
    for doc in store.find(coll):
        name = _status_name(doc.get("status"))
        counts[name] = counts.get(name, 0) + 1
    return counts


def update_board_gauges(store, registry: Registry = REGISTRY) -> None:
    """Refresh ``mrtpu_board_jobs`` from the board — called by the
    docserver right before rendering /metrics so queue depth by
    phase/status is scrape-time truth, not a stale event count."""
    g = registry.gauge(
        "mrtpu_board_jobs",
        "job-board queue depth (labels: db, phase, status)")
    # build the whole snapshot first, then swap atomically: a concurrent
    # scrape must never render a cleared-but-not-yet-repopulated family,
    # and stale series from drained boards must not linger as lies
    fresh = []
    for db, colls in _dbnames(store).items():
        for phase, suffix in (("map", "map_jobs"), ("reduce", "red_jobs")):
            for status, n in _phase_counts(
                    store, colls.get(suffix)).items():
                fresh.append(
                    ({"db": db, "phase": phase, "status": status}, n))
    g.replace(fresh)
