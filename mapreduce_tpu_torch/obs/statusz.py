"""/statusz: a JSON cluster snapshot built from the job board (port of
``mapreduce_tpu/obs/statusz.py``).

The live counterpart of Dean & Ghemawat's master status page: per-phase
job counts, worker liveness derived from heartbeat lease ages, the
iteration counter, and the last persisted stats doc — everything an
operator (or the ``status`` CLI) needs to see a run at a glance,
computed fresh from the authoritative DocStore at scrape time.

Wall-clock use here is TIMESTAMP comparison (``lease_expires`` fields
are wall-clock by contract, coord/docstore.now), not duration
arithmetic.

The engine-host ``fleet`` section (:func:`..coord.fleet.fleet_snapshot`:
membership states, lease headroom, heartbeat facts and routed streams
per host), the ``alerts`` section (:mod:`.alerts`) and the ``history``
row (:mod:`.history`, when the collector has one) are the JAX
package's.

Added in the port: a serving process that ran no engine (the docserver
of a docserver/runner topology) takes the engine sections it lacks —
``device``, ``compile``, ``memory``, ``comms`` — from the freshest
process that pushed them with its telemetry
(:func:`process_sections`), marked ``from_proc``; the JAX page shows
only the serving process's own.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from ..utils.constants import STATUS
from .metrics import Registry, REGISTRY, parse_prometheus

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


def _workers(store, colls, now: float) -> Dict[str, Dict[str, Any]]:
    """Worker liveness from heartbeat-maintained leases: a worker whose
    freshest lease is still in the future is alive (its heartbeat thread
    extended it within the last period)."""
    workers: Dict[str, Dict[str, Any]] = {}
    for coll in colls:
        if coll is None:
            continue
        for doc in store.find(coll):
            name = doc.get("worker")
            lease = doc.get("lease_expires")
            if not name or name == "server" or lease is None:
                continue
            w = workers.setdefault(
                name, {"jobs": 0, "running": 0, "lease_expires_in": None})
            w["jobs"] += 1
            if doc.get("status") in (int(STATUS.RUNNING),
                                     int(STATUS.FINISHED)):
                w["running"] += 1
                remain = round(lease - now, 3)
                prev = w["lease_expires_in"]
                if prev is None or remain > prev:
                    w["lease_expires_in"] = remain
    for w in workers.values():
        w["alive"] = (w["lease_expires_in"] is not None
                      and w["lease_expires_in"] > 0)
    return workers


def _trainer_lease(store, coll: Optional[str], now: float,
                   ) -> Optional[Dict[str, Any]]:
    """The training plane's lease doc (coord/lease.py singleton), with
    the same timestamp-comparison liveness the worker view uses."""
    from ..coord.lease import TrainerLease

    if coll is None:
        return None
    doc = store.find_one(coll, {"_id": TrainerLease.SINGLETON_ID})
    if doc is None:
        return None
    expires = doc.get("lease_expires") or 0.0
    return {"holder": doc.get("holder"),
            "generation": doc.get("generation", 0),
            "lease_expires_in": round(expires - now, 3),
            "held": bool(doc.get("holder")) and expires > now}


def checkpoint_snapshot(registry: Registry = REGISTRY,
                        collector=None) -> Dict[str, Any]:
    """Checkpoint/lease counters (mrtpu_ckpt_* / mrtpu_trainer_*) for
    the /statusz training section — summed over THIS process and every
    process that pushed telemetry to the hosted *collector*, so a
    docserver scrape sees a separate trainer process's saves/restores/
    corruptions/fences (the `cli train` against `cli server` deployment
    shape, where the counters live only in the trainer).  Gauges (last
    saved step, recovery seconds) take the max across processes."""
    snaps = [parse_prometheus(registry.render())]
    if collector is not None:
        snaps += collector.metric_snapshots()

    def _agg(name, combine, **labels):
        vals = [v for parsed in snaps for (n, lk), v in parsed.items()
                if n == name and all(dict(lk).get(k) == w
                                     for k, w in labels.items())]
        return combine(vals) if vals else 0.0

    snap = {
        "saves": _agg("mrtpu_ckpt_saves_total", sum),
        "restores_ok": _agg("mrtpu_ckpt_restores_total", sum,
                            outcome="ok"),
        "restores_corrupt": _agg("mrtpu_ckpt_restores_total", sum,
                                 outcome="corrupt"),
        "corrupt_shards": _agg("mrtpu_ckpt_corrupt_shards_total", sum),
        "fallbacks": _agg("mrtpu_ckpt_fallbacks_total", sum),
        "gc": _agg("mrtpu_ckpt_gc_total", sum),
        "last_saved_step": _agg("mrtpu_ckpt_last_step", max, op="save"),
        "lease_fences": _agg("mrtpu_trainer_lease_fences_total", sum),
        "recovery_s": _agg("mrtpu_trainer_recovery_seconds", max),
    }
    return snap if any(snap.values()) else {}


def compile_snapshot() -> Dict[str, Any]:
    """The compile section of /statusz: the process's compile-ledger
    summary (per-program outcomes + compile seconds + shape-bucket
    counts and the registry/cache locations).  Empty when nothing was
    ever compiled here — the section then stays off the page."""
    from .compile import LEDGER  # late: statusz loads in torch-free procs

    snap = LEDGER.snapshot()
    return snap if snap.get("programs") else {}


def memory_snapshot_section() -> Dict[str, Any]:
    """The memory section of /statusz (obs/memory last-sample mirror:
    per-device live bytes, per-program footprints, donation savings)."""
    from .memory import memory_snapshot

    return memory_snapshot()


def comms_snapshot_section() -> Dict[str, Any]:
    """The comms section of /statusz (obs/comms last-sample mirror:
    exchange traffic matrix roll-ups, link-class bytes, upload/compute
    overlap fraction)."""
    from .comms import comms_snapshot

    return comms_snapshot()


def control_snapshot_section() -> Dict[str, Any]:
    """The control section of /statusz (obs/control): the process's
    control-ledger decisions — evidence, action, measured outcome —
    and per-controller outcome counts.  Empty when no controller ever
    decided anything, so a controllers-disabled run provably shows
    nothing."""
    from .control import control_snapshot

    return control_snapshot()


def alerts_snapshot_section() -> Dict[str, Any]:
    """The alerts section of /statusz (obs/alerts): configured rules,
    live instance lifecycle states and active silences.  Empty when no
    rules are configured, so a plane that was never armed provably
    shows nothing."""
    from .alerts import alerts_snapshot

    return alerts_snapshot()


def slo_snapshot_section(collector=None) -> Dict[str, Any]:
    """The SLO section of /statusz (obs/slo): per-tenant objective
    percentiles, error budget and burn rates, evaluated at scrape time
    over this process's histograms plus every collector-pushed
    process's.  Empty when no tenant ever produced an SLO observation
    — the section then stays off the page."""
    from .slo import slo_snapshot

    return slo_snapshot(collector=collector)


def history_snapshot_section(collector=None) -> Dict[str, Any]:
    """The ``history`` row of /statusz: segment/byte/series counts of
    the durable telemetry history plane (obs/history) when the serving
    process's collector has one attached; empty — and off the page —
    otherwise."""
    history = getattr(collector, "history", None)
    if history is None:
        return {}
    try:
        return history.snapshot()
    except OSError:
        # a stat-level failure must not take /statusz down with it
        return {"error": "history directory unreadable"}


#: the /statusz sections that describe the engine of the process that
#: ran it — a runner's, in the docserver/runner topology
ENGINE_SECTIONS = ("device", "compile", "memory", "comms")


def process_sections(registry: Registry = REGISTRY) -> Dict[str, Any]:
    """This process's engine-side sections of /statusz, those that hold
    anything (a process that never ran the engine pushes ``{}``)."""
    from .profile import device_snapshot  # late: profile pulls trace

    out: Dict[str, Any] = {}
    dev = device_snapshot(registry)
    if dev.get("waves") or dev.get("flops_total"):
        out["device"] = dev
    for key, section in (("compile", compile_snapshot),
                         ("memory", memory_snapshot_section),
                         ("comms", comms_snapshot_section)):
        sec = section()
        if sec:
            out[key] = sec
    return out


def cluster_status(store, now: Optional[float] = None,
                   collector=None, scheduler=None) -> Dict[str, Any]:
    """The /statusz document: one entry per task database on the board,
    plus the serving process's device-plane section (engine FLOPs/MFU —
    nonzero only where the engine actually ran; per-task device numbers
    travel in the persisted ``stats.device`` doc either way), the build
    identity, the multi-tenant *scheduler*'s queue/quota snapshot (when
    the serving process hosts one — sched/scheduler.py), and — when the
    serving process hosts a telemetry *collector* (obs/collector) — the
    cluster's per-task roll-ups and per-process push health."""
    from ..coord.lease import TrainerLease  # late: coord pulls obs
    from .buildinfo import build_info
    from .profile import device_snapshot  # late: profile pulls trace

    now = time.time() if now is None else now
    out: Dict[str, Any] = {"now": now, "tasks": {},
                           "device": device_snapshot(),
                           "build": build_info()}
    ckpt = checkpoint_snapshot(collector=collector)
    if ckpt:
        out["checkpoint"] = ckpt
    comp = compile_snapshot()
    if comp:
        out["compile"] = comp
    mem = memory_snapshot_section()
    if mem:
        out["memory"] = mem
    comms = comms_snapshot_section()
    if comms:
        out["comms"] = comms
    slo_sec = slo_snapshot_section(collector=collector)
    if slo_sec:
        out["slo"] = slo_sec
    ctrl = control_snapshot_section()
    if ctrl:
        out["control"] = ctrl
    alerts_sec = alerts_snapshot_section()
    if alerts_sec:
        out["alerts"] = alerts_sec
    if scheduler is not None:
        sched = scheduler.snapshot()
        if sched:
            out["sched"] = sched
    # the engine-host fleet (coord/fleet): membership states, lease
    # headroom, heartbeat facts and per-host stream routes, read from
    # the board like every other section, so ANY process over the
    # store renders it; empty (no host ever joined) stays off the page
    from ..coord.fleet import fleet_snapshot  # late: coord pulls obs

    fleet = fleet_snapshot(store, now=now)
    if fleet:
        out["fleet"] = fleet
    if collector is not None:
        # the docserver of a docserver/runner topology runs no engine:
        # each engine section it lacks comes from the freshest process
        # that pushed one, marked with that process's id
        for key in ENGINE_SECTIONS:
            mine = out.get(key)
            if mine and (key != "device" or mine.get("waves")
                         or mine.get("flops_total")):
                continue
            for proc, sections in collector.pushed_sections():
                if sections.get(key):
                    out[key] = dict(sections[key], from_proc=proc)
                    break
        out["telemetry"] = collector.summary()
        hist = history_snapshot_section(collector)
        if hist:
            out["history"] = hist
    for db, colls in sorted(_dbnames(store).items()):
        task_doc = None
        if "task" in colls:
            found = store.find(colls["task"], {"_id": "unique"})
            task_doc = found[0] if found else None
        entry: Dict[str, Any] = {
            "status": (task_doc or {}).get("status"),
            "iteration": (task_doc or {}).get("iteration"),
            "device": (task_doc or {}).get("device"),
            "stats": (task_doc or {}).get("stats"),
            "phases": {
                "map": _phase_counts(store, colls.get("map_jobs")),
                "reduce": _phase_counts(store, colls.get("red_jobs")),
            },
            "workers": _workers(
                store, [colls.get("map_jobs"), colls.get("red_jobs")], now),
            "errors": (store.count(colls["errors"])
                       if "errors" in colls else 0),
        }
        trainer = _trainer_lease(store, colls.get(TrainerLease.COLL), now)
        if trainer is not None:
            entry["trainer"] = trainer
        out["tasks"][db] = entry
    return out


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
