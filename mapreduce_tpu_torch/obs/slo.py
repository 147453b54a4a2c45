"""Serving SLO plane: per-tenant latency/staleness objectives, error
budget and multi-window burn rate (port of ``mapreduce_tpu/obs/slo.py``).

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
:data:`~.metrics.SLO_BUCKETS` ladder, and this module evaluates **SLO
objectives** against them: a target percentile + threshold + window per
objective (``--slo`` on the docserver and runner CLIs), percentiles
estimated from histogram bucket counts
(:func:`~.metrics.estimate_percentile`), error budget and multi-window
(short/long) **burn rate** per tenant — burn rate 1.0 means the tenant
is consuming its error budget exactly at the rate that exhausts it over
the long window; a breach is counted
(``mrtpu_slo_breach_total{tenant,objective}``) whenever the LONG-window
percentile estimate exceeds the objective's threshold.

Cross-process stamps: the exact duration needs ONE process to see both
ends, so the scheduler keeps an in-memory monotonic stamp per submit
(:func:`stamp_submit`) and the observers fall back to the board's
persisted wall timestamps (minted through ``coord/docstore.now``) when
the transitions happened in different processes.

Evaluation is scrape-driven: the docserver's /statusz, /metrics and
/clusterz handlers call :func:`evaluate`, which samples the cumulative
bucket counts, appends them to per-(objective, tenant) monotonic
windows, publishes the derived gauges (``mrtpu_slo_percentile_seconds``
/ ``mrtpu_slo_burn_rate`` / ``mrtpu_slo_threshold_seconds``) with
whole-family swaps, and returns the /statusz ``slo`` section.  With a
*collector*, histogram counts merge across every process that pushed
telemetry, so the board's scrape sees cluster-wide SLO truth.

:meth:`SloPlane.seed_from_history` re-seeds the burn windows from the
durable history's persisted bucket deltas after a restart.
"""

from __future__ import annotations

import collections
import math
import sys
import threading
import time
from dataclasses import asdict, dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .metrics import (
    REGISTRY, Registry, SLO_BUCKETS, counter, estimate_percentile,
    fraction_le, gauge, histogram)

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


# -- the evaluation-plane instruments ----------------------------------------

_BREACH = counter(
    "mrtpu_slo_breach_total",
    "SLO evaluations that observed a tenant's long-window percentile "
    "over its objective threshold (labels: tenant, objective) — counts "
    "scrape-cadence evaluation ticks in breach, not distinct incidents")
_PCTL = gauge(
    "mrtpu_slo_percentile_seconds",
    "estimated objective percentile per tenant over the long window "
    "(labels: tenant, objective, pct) — from histogram bucket counts, "
    "whole-family swap at each evaluation")
_BURN = gauge(
    "mrtpu_slo_burn_rate",
    "error-budget burn rate per tenant and window (labels: tenant, "
    "objective, window=short|long): over-threshold fraction over the "
    "window divided by the objective's budget (1 - target percentile); "
    "1.0 = burning exactly the budget the long window allows")
_THRESHOLD = gauge(
    "mrtpu_slo_threshold_seconds",
    "configured objective thresholds (labels: objective, pct) — "
    "config-as-metric so offline diagnosis can compare the percentile "
    "gauges against the objective that was actually in force")


@dataclass(frozen=True)
class SLOObjective:
    """One serving objective: '<percentile> of <family> observations
    stay under <threshold_s>, judged over <long_window_s>'."""

    name: str
    family: str
    percentile: float = 0.99
    threshold_s: float = 1.0
    long_window_s: float = 600.0
    short_window_s: float = 60.0

    @property
    def budget(self) -> float:
        """Error budget: the fraction of observations ALLOWED over the
        threshold (p99 -> 1%)."""
        return max(1.0 - self.percentile, 1e-9)

    @property
    def pct_label(self) -> str:
        p = self.percentile * 100.0
        return f"p{p:g}"


#: objective name -> family, for the CLI parser and diagnose fallback
OBJECTIVE_FAMILIES: Dict[str, str] = {
    "submit_first_result": FIRST_RESULT_FAMILY,
    "snapshot_staleness": STALENESS_FAMILY,
    "queue_wait": QUEUE_WAIT_FAMILY,
}

DEFAULT_OBJECTIVES: Tuple[SLOObjective, ...] = (
    SLOObjective("submit_first_result", FIRST_RESULT_FAMILY,
                 percentile=0.99, threshold_s=5.0),
    SLOObjective("snapshot_staleness", STALENESS_FAMILY,
                 percentile=0.99, threshold_s=1.0),
    SLOObjective("queue_wait", QUEUE_WAIT_FAMILY,
                 percentile=0.99, threshold_s=10.0),
)


def parse_objective(spec: str) -> SLOObjective:
    """Parse a ``--slo`` flag value:
    ``NAME:pPCT:THRESHOLD[:LONG_S[:SHORT_S]]`` — e.g.
    ``snapshot_staleness:p99:1.0:600:60``.  NAME must be one of
    :data:`OBJECTIVE_FAMILIES` (the instrumented lifecycle stages)."""
    parts = str(spec).split(":")
    if len(parts) < 3:
        raise ValueError(
            f"bad --slo spec {spec!r}: want "
            "NAME:pPCT:THRESHOLD[:LONG_S[:SHORT_S]]")
    name = parts[0].strip()
    family = OBJECTIVE_FAMILIES.get(name)
    if family is None:
        raise ValueError(
            f"unknown SLO objective {name!r} (known: "
            f"{sorted(OBJECTIVE_FAMILIES)})")
    pct = parts[1].strip().lstrip("pP")
    percentile = float(pct) / 100.0
    if not 0.0 < percentile < 1.0:
        raise ValueError(f"bad --slo percentile {parts[1]!r}")
    threshold = float(parts[2])
    if threshold <= 0:
        raise ValueError(f"bad --slo threshold {parts[2]!r}")
    long_w = float(parts[3]) if len(parts) > 3 else 600.0
    short_w = float(parts[4]) if len(parts) > 4 else min(60.0, long_w)
    if not 0 < short_w <= long_w:
        raise ValueError(f"bad --slo windows in {spec!r} "
                         "(need 0 < SHORT <= LONG)")
    return SLOObjective(name, family, percentile=percentile,
                        threshold_s=threshold, long_window_s=long_w,
                        short_window_s=short_w)


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


def _tenant_counts(family: str, registry: Registry,
                   snapshots: Optional[List[Dict[Any, float]]],
                   ) -> Dict[str, Tuple[List[float], List[int]]]:
    """Per-tenant (bounds, per-bucket counts) of *family*, merged over
    the local registry plus every collector-pushed process snapshot
    (cumulative ``_bucket`` samples summed per ``le`` across sources —
    counters are per-process monotonic totals, so the sum IS the
    cluster total, the collector roll-up rule)."""
    # {tenant: {le_bound: cumulative}}
    cums: Dict[str, Dict[float, float]] = {}
    h = registry.histogram(family, buckets=SLO_BUCKETS)
    for labels, counts in h.bucket_series():
        tenant = labels.get("tenant", "-")
        dst = cums.setdefault(tenant, {})
        cum = 0
        for bound, n in zip(h.buckets, counts):
            cum += n
            dst[bound] = dst.get(bound, 0.0) + cum
    bucket_name = family + "_bucket"
    for parsed in snapshots or []:
        for (name, labelkey), value in parsed.items():
            if name != bucket_name:
                continue
            labels = dict(labelkey)
            le = labels.get("le")
            if le is None:
                continue
            bound = math.inf if le == "+Inf" else float(le)
            tenant = labels.get("tenant", "-")
            dst = cums.setdefault(tenant, {})
            dst[bound] = dst.get(bound, 0.0) + value
    out: Dict[str, Tuple[List[float], List[int]]] = {}
    for tenant, by_le in cums.items():
        bounds, counts, total = _cum_to_counts(by_le)
        if total:
            out[tenant] = (bounds, counts)
    return out


def _cum_to_counts(cum: Dict[float, float],
                   ) -> Tuple[List[float], List[int], int]:
    """Cumulative ``{le_bound: count}`` -> sorted bounds + per-bucket
    counts + total.  The ONE conversion both the cluster merge and the
    window math ride: clips locally non-monotone merged cumulatives (a
    source with a sparser ladder can produce them) so a fix to the
    clipping/rounding rule cannot drift between the two surfaces."""
    bounds = sorted(cum)
    counts: List[int] = []
    prev = 0.0
    for b in bounds:
        cur = max(cum[b], prev)
        counts.append(int(round(cur - prev)))
        prev = cur
    return bounds, counts, sum(counts)


# -- the evaluator -----------------------------------------------------------

#: window samples kept per (objective, tenant) — bounds memory at one
#: sample per scrape; old samples also age out by the long window
_MAX_SAMPLES = 720


class SloPlane:
    """Objectives + per-(objective, tenant) sample windows.  One
    process-global instance (:data:`PLANE`) serves the docserver; tests
    build their own over the same registry."""

    def __init__(self, objectives: Optional[Sequence[SLOObjective]] = None,
                 ) -> None:
        self._lock = threading.Lock()
        self.objectives: List[SLOObjective] = list(
            objectives if objectives is not None else DEFAULT_OBJECTIVES)
        # (objective, tenant) -> deque[(mono_t, {le: cum_count})]
        self._windows: Dict[Tuple[str, str], Any] = {}

    def configure(self, objectives: Sequence[SLOObjective]) -> None:
        with self._lock:
            self.objectives = list(objectives)
            self._windows.clear()

    def seed_from_history(self, history: Any,
                          now: Optional[float] = None,
                          wall_now: Optional[float] = None) -> int:
        """Rebuild EMPTY sample windows from the durable history plane
        (obs/history.MetricHistory) — the restart-proof half of the
        burn-rate alerts: a docserver that restarts mid-incident seeds
        its windows from persisted bucket deltas instead of forgetting
        the burn.  History samples carry wall stamps (minted at the
        collector); they are mapped onto this process's monotonic
        timebase by age (``mono = now - (wall_now - t_wall)``).
        Returns the number of (objective, tenant) windows seeded;
        already-live windows are never touched."""
        if wall_now is None:
            from ..coord import docstore  # the one wall-clock mint
            wall_now = docstore.now()
        if now is None:
            now = time.monotonic()
        seeded = 0
        with self._lock:
            for obj in self.objectives:
                try:
                    per_tenant = history.bucket_windows(obj.family)
                except (OSError, RuntimeError):
                    # corrupt/unreadable history must not block serving
                    # — the windows just start cold
                    break
                for tenant, snaps in per_tenant.items():
                    key = (obj.name, tenant)
                    if self._windows.get(key):
                        continue
                    dq = collections.deque()
                    for (t_wall, cums) in snaps[-_MAX_SAMPLES:]:
                        age = wall_now - t_wall
                        if age < 0 or age > obj.long_window_s:
                            continue
                        dq.append((now - age, dict(cums)))
                    if dq:
                        self._windows[key] = dq
                        seeded += 1
        return seeded

    @staticmethod
    def _delta(samples, now: float, window: float,
               current: Dict[float, float]) -> Dict[float, float]:
        """Cumulative-count delta over the trailing *window*: baseline
        is the newest sample at or before ``now - window`` (zero when
        the whole history is younger — the window then covers
        everything seen so far)."""
        cut = now - window
        base: Dict[float, float] = {}
        for t, cum in samples:
            if t <= cut:
                base = cum
            else:
                break
        return {b: max(0.0, c - base.get(b, 0.0))
                for b, c in current.items()}

    @staticmethod
    def _windowed(cum: Dict[float, float],
                  ) -> Tuple[List[float], List[int], int]:
        return _cum_to_counts(cum)

    def evaluate(self, registry: Registry = REGISTRY, collector=None,
                 now: Optional[float] = None) -> Dict[str, Any]:
        """One evaluation tick: sample every objective family, update
        the windows, publish the derived gauges, count breaches, and
        return the /statusz ``slo`` section."""
        now = time.monotonic() if now is None else float(now)
        snapshots = (collector.metric_snapshots()
                     if collector is not None else None)
        # refresh the session stream-age gauges on the same tick so a
        # stalled stream is visible even when nobody snapshots it —
        # only when the (torch-bound) session module is already loaded
        sess_mod = sys.modules.get(
            "mapreduce_tpu_torch.engine.session")
        if sess_mod is not None:
            sess_mod.refresh_stream_age_gauges()
        tenants_out: Dict[str, Dict[str, Any]] = {}
        pctl_rows: List[Tuple[Dict[str, Any], float]] = []
        burn_rows: List[Tuple[Dict[str, Any], float]] = []
        thr_rows: List[Tuple[Dict[str, Any], float]] = []
        with self._lock:
            objectives = list(self.objectives)
            for obj in objectives:
                thr_rows.append(({"objective": obj.name,
                                  "pct": obj.pct_label}, obj.threshold_s))
                per_tenant = _tenant_counts(obj.family, registry,
                                            snapshots)
                for tenant, (bounds, counts) in sorted(
                        per_tenant.items()):
                    cum: Dict[float, float] = {}
                    running = 0.0
                    for b, n in zip(bounds, counts):
                        running += n
                        cum[b] = running
                    dq = self._windows.setdefault(
                        (obj.name, tenant), collections.deque())
                    # append only on CHANGE: an idle tenant's window
                    # collapses to its last-change sample instead of
                    # growing one identical sample per scrape forever —
                    # the always-on-board bound (tenant labels persist
                    # in the histograms, so every tenant ever seen is
                    # re-evaluated each tick; its WINDOW must not also
                    # retain per-scrape state while nothing changes)
                    if not dq or dq[-1][1] != cum:
                        dq.append((now, cum))
                    cut = now - obj.long_window_s
                    # keep ONE sample at/before the boundary as the
                    # long-window baseline
                    while (len(dq) > 1 and dq[1][0] <= cut) \
                            or len(dq) > _MAX_SAMPLES:
                        dq.popleft()
                    entry = self._evaluate_one(obj, tenant, dq, now,
                                               cum)
                    tenants_out.setdefault(tenant, {})[obj.name] = entry
                    if entry["p"] is not None:
                        pctl_rows.append(
                            ({"tenant": tenant, "objective": obj.name,
                              "pct": obj.pct_label}, entry["p"]))
                    for window in ("short", "long"):
                        burn_rows.append(
                            ({"tenant": tenant, "objective": obj.name,
                              "window": window},
                             entry[f"burn_{window}"]))
                    if entry["breaching"]:
                        _BREACH.inc(tenant=tenant, objective=obj.name)
        _PCTL.replace(pctl_rows)
        _BURN.replace(burn_rows)
        _THRESHOLD.replace(thr_rows)
        out = {
            "objectives": [dict(asdict(o), pct=o.pct_label)
                           for o in objectives],
            "tenants": tenants_out,
        }
        return out

    def _evaluate_one(self, obj: SLOObjective, tenant: str, dq,
                      now: float, cum: Dict[float, float],
                      ) -> Dict[str, Any]:
        bounds, counts, n_total = self._windowed(cum)
        long_cum = self._delta(dq, now, obj.long_window_s, cum)
        short_cum = self._delta(dq, now, obj.short_window_s, cum)
        lb, lc, ln = self._windowed(long_cum)
        sb, sc, sn = self._windowed(short_cum)
        p_long = estimate_percentile(lb, lc, obj.percentile)
        p50_long = estimate_percentile(lb, lc, 0.50)

        def _burn(b, c, n) -> float:
            if n <= 0:
                return 0.0
            good = fraction_le(b, c, obj.threshold_s)
            bad = 1.0 - (good if good is not None else 1.0)
            return bad / obj.budget

        burn_long = _burn(lb, lc, ln)
        burn_short = _burn(sb, sc, sn)
        # breach = the long window's percentile estimate over the
        # threshold, OR its over-threshold fraction over the budget
        # (the same criterion modulo in-bucket interpolation) — the OR
        # keeps detection live when the estimate's +Inf clamp tops out
        # at the largest finite bucket bound below a very large
        # configured threshold, where the percentile comparison alone
        # would be permanently blind (fraction_le never counts +Inf
        # mass under any finite threshold, so burn still sees it)
        breaching = bool(ln > 0 and (
            (p_long is not None and p_long > obj.threshold_s)
            or burn_long > 1.0))
        return {
            "n": n_total,
            "window_n": ln,
            "p": None if p_long is None else round(p_long, 6),
            "p50": None if p50_long is None else round(p50_long, 6),
            "threshold_s": obj.threshold_s,
            "burn_short": round(burn_short, 4),
            "burn_long": round(burn_long, 4),
            "budget_remaining": round(
                max(0.0, 1.0 - burn_long), 4),
            "breaching": breaching,
        }


#: the process-global plane the docserver scrapes evaluate
PLANE = SloPlane()


def configure(objectives: Sequence[SLOObjective]) -> None:
    """Replace the global plane's objectives (the ``--slo`` CLI path)."""
    PLANE.configure(objectives)


def evaluate(registry: Registry = REGISTRY, collector=None,
             now: Optional[float] = None) -> Dict[str, Any]:
    return PLANE.evaluate(registry=registry, collector=collector,
                          now=now)


def slo_snapshot(collector=None,
                 registry: Registry = REGISTRY) -> Dict[str, Any]:
    """The /statusz ``slo`` section: evaluate the global plane now
    (scrape-driven sampling) — empty when no tenant ever produced an
    SLO observation, so the section stays off the page."""
    snap = evaluate(registry=registry, collector=collector)
    return snap if snap.get("tenants") else {}


# -- the bundle artifact -----------------------------------------------------


def validate_slo(doc: Any) -> None:
    """Strict structural check of a bundle's ``slo.json`` — enforced on
    write AND reload (the comms.json/compile-ledger pattern), so a
    bundle that loads is a bundle the analysis tools accept."""
    if not isinstance(doc, dict) or doc.get("kind") != "mrtpu-slo":
        raise ValueError("slo: not a mrtpu-slo document")
    snap = doc.get("snapshot")
    if not isinstance(snap, dict):
        raise ValueError("slo: snapshot is not an object")
    objectives = snap.get("objectives")
    if not isinstance(objectives, list) or not objectives:
        raise ValueError("slo: objectives is not a non-empty list")
    for i, o in enumerate(objectives):
        if not isinstance(o, dict) or not o.get("name"):
            raise ValueError(f"slo: objective {i} has no name")
        for field in ("percentile", "threshold_s", "long_window_s",
                      "short_window_s"):
            if not isinstance(o.get(field), (int, float)):
                raise ValueError(
                    f"slo: objective {i} missing numeric {field!r}")
    tenants = snap.get("tenants")
    if not isinstance(tenants, dict) or not tenants:
        raise ValueError("slo: tenants is not a non-empty object")
    for tenant, objs in tenants.items():
        if not isinstance(objs, dict):
            raise ValueError(f"slo: tenant {tenant!r} is not an object")
        for oname, e in objs.items():
            if not isinstance(e, dict):
                raise ValueError(
                    f"slo: tenant {tenant!r} objective {oname!r} is "
                    "not an object")
            for field in ("n", "burn_short", "burn_long"):
                if not isinstance(e.get(field), (int, float)):
                    raise ValueError(
                        f"slo: tenant {tenant!r} objective {oname!r} "
                        f"missing numeric {field!r}")
            if "breaching" not in e:
                raise ValueError(
                    f"slo: tenant {tenant!r} objective {oname!r} "
                    "missing 'breaching'")
