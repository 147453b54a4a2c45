"""Cluster diagnosis over the merged timeline: stragglers, skew, faults
(port of ``mapreduce_tpu/obs/analysis.py``).

Consumes the ``/clusterz`` document (merged aligned spans +
cluster-aggregated metrics, obs/collector.cluster_doc) and emits a
structured report — the MapReduce-operator questions Dean & Ghemawat's
backup-task machinery was built on top of, answered from telemetry
instead of folklore:

* **stragglers** — per-worker claim→write latency (the backdated
  ``job`` spans) put through a robust LEAVE-ONE-OUT outlier test: a
  worker is flagged when its median job latency exceeds the median of
  every OTHER worker's jobs by more than ``STRAGGLER_MAD_K`` scaled
  MADs (1.4826·MAD ≈ σ for normal data) AND by an absolute floor (so
  µs-scale jitter on an idle cluster never flags anyone) AND by a
  minimum ratio.  Leave-one-out, not pooled: a straggler that ran half
  the cluster's jobs drags a pooled median toward itself and hides —
  against everyone else's jobs it cannot.  Falls back to the
  cluster-aggregated ``mrtpu_worker_job_seconds`` histogram sums when a
  run's job spans were lost to telemetry drops — degraded telemetry
  degrades the diagnosis, it does not blank it.

* **skewed partitions** — per-partition record/byte counts from BOTH
  planes (host: ``mrtpu_partition_records_total`` incremented at map
  write time, i.e. shuffle volume into each partition; device:
  ``mrtpu_device_partition_records`` from the engine's exchange
  readback), flagged when a partition's share exceeds ``skew_ratio``
  times the uniform share over the observed partitions.

* **retry/fault hotspots** — the nonzero fault-path counters
  (HTTP retries/exhaustions, lease losses, broken jobs, docserver
  errors, telemetry drops), largest first.

* **phase breakdown** — wall seconds by span name: claim vs run
  (compute) vs write (blob), plus the device plane's
  wave/upload/compute/readback, total and per worker.

Everything here is pure arithmetic over an already-captured document —
no clocks are read — so a report is the JAX package's for the same
document, but for the port's words for a build: a compile hotspot
"spent Ns building" (``nvcc`` or ``g++`` and the library load, two
``mrtpu_compile_seconds`` observations a fresh build, as lowering and
backend compile are two in the JAX package) where the JAX text says
"in XLA".  The trend and alert findings read the sections the
collector embeds from the durable history and the alerting plane
(``mrtpuCluster["history"]`` and ``["alerts"]``); the fleet findings
read the families the engine-host fleet (``coord/fleet``,
``engine/migrate``) counts: hosts by state, migrations by reason and
recovered hosts.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

#: a worker is a straggler when its median job latency exceeds the
#: pooled median by K scaled MADs ...
STRAGGLER_MAD_K = 3.0
#: ... and by this ratio (a 5% slowdown is noise, not a straggler) ...
STRAGGLER_MIN_RATIO = 1.5
#: ... and by this many absolute seconds (an idle cluster's µs jitter
#: must never flag anyone)
STRAGGLER_MIN_GAP_S = 0.05

#: a partition is skewed when its share of the task's records exceeds
#: skew_ratio × the uniform share over observed partitions
SKEW_RATIO = 2.0

#: rows reported per section, largest offender first
TOP_K = 5

#: a tenant whose oldest QUEUED task is older than this gets an
#: admission-backpressure note (obs/slo's queue-age gauge feeds it)
QUEUE_AGE_NOTE_S = 60.0

#: fault-path families (and the label subsets that make them faults)
#: surfaced as hotspots when nonzero
_HOTSPOT_FAMILIES: Tuple[Tuple[str, Optional[Dict[str, Any]]], ...] = (
    ("mrtpu_http_retries_total", None),
    ("mrtpu_http_retryable_status_total", None),
    ("mrtpu_http_exhausted_total", None),
    ("mrtpu_worker_lease_lost_total", None),
    ("mrtpu_worker_jobs_total", {"outcome": "broken"}),
    ("mrtpu_worker_jobs_total", {"outcome": "fenced"}),
    ("mrtpu_worker_released_jobs_total", None),
    ("mrtpu_docserver_requests_total", {"outcome": "error"}),
    ("mrtpu_docserver_requests_total", {"outcome": "evicted"}),
    ("mrtpu_device_retries_total", None),
    ("mrtpu_telemetry_dropped_total", None),
)


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if not n:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def _mad(xs: List[float], med: float) -> float:
    return _median([abs(x - med) for x in xs])


def _metric_rows(doc: Dict[str, Any]) -> List[Tuple[str, Dict[str, str],
                                                    float]]:
    rows = []
    for row in (doc.get("mrtpuCluster") or {}).get("metrics") or []:
        try:
            name, labels, value = row
            rows.append((str(name), dict(labels), float(value)))
        except (TypeError, ValueError):
            continue
    return rows


def _events(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [e for e in doc.get("traceEvents") or []
            if isinstance(e, dict) and e.get("ph") == "X"]


# -- stragglers --------------------------------------------------------------


def _worker_latencies(doc: Dict[str, Any]) -> Tuple[Dict[str, List[float]],
                                                    str]:
    """Per-worker claim→write latencies in seconds, preferring the
    merged ``job`` spans; falling back to the aggregated
    job-seconds histogram when spans were lost."""
    per: Dict[str, List[float]] = {}
    for e in _events(doc):
        if e.get("name") != "job":
            continue
        worker = (e.get("args") or {}).get("worker")
        if not worker or worker == "server":
            continue
        try:
            per.setdefault(str(worker), []).append(float(e["dur"]) / 1e6)
        except (KeyError, TypeError, ValueError):
            continue
    if per:
        return per, "spans"
    sums: Dict[str, float] = {}
    counts: Dict[str, float] = {}
    for name, labels, value in _metric_rows(doc):
        w = labels.get("worker")
        if not w:
            continue
        if name == "mrtpu_worker_job_seconds_sum":
            sums[w] = sums.get(w, 0.0) + value
        elif name == "mrtpu_worker_job_seconds_count":
            counts[w] = counts.get(w, 0.0) + value
    for w, n in counts.items():
        if n > 0:
            # the histogram only survives as mean latency; report it as
            # one synthetic sample per worker (the outlier test is on
            # per-worker medians either way)
            per[w] = [sums.get(w, 0.0) / n]
    return per, "metrics"


def _find_stragglers(doc: Dict[str, Any]) -> Tuple[List[Dict[str, Any]],
                                                   Dict[str, Any], str]:
    per, source = _worker_latencies(doc)
    workers: Dict[str, Any] = {}
    for w, xs in per.items():
        workers[w] = {
            "jobs": len(xs),
            "median_s": round(_median(xs), 4),
            "mean_s": round(sum(xs) / len(xs), 4),
            "total_s": round(sum(xs), 4),
            "max_s": round(max(xs), 4),
        }
    stragglers: List[Dict[str, Any]] = []
    if len(workers) >= 2:
        for w, stats in workers.items():
            others = [x for v, xs in per.items() if v != w for x in xs]
            if not others:
                continue
            med = _median(others)
            mad = _mad(others, med)
            threshold = med + max(STRAGGLER_MAD_K * 1.4826 * mad,
                                  STRAGGLER_MIN_GAP_S)
            m = stats["median_s"]
            if m > threshold and m > STRAGGLER_MIN_RATIO * max(med, 1e-9):
                stragglers.append({
                    "worker": w, "median_s": m, "jobs": stats["jobs"],
                    "baseline_median_s": round(med, 4),
                    "ratio": round(m / max(med, 1e-9), 2),
                })
        stragglers.sort(key=lambda s: -s["median_s"])
    return stragglers, workers, source


# -- partition skew ----------------------------------------------------------


def _matrix_part(label: Optional[str]) -> Optional[str]:
    """An exchange-matrix ``dst`` label (``D00005``) as the partition
    spelling the counters use (``P00005``) — partition p IS device p on
    the device plane."""
    if not label or not label.startswith("D"):
        return label
    try:
        return f"P{int(label[1:]):05d}"
    except ValueError:
        return label


def _find_skew(doc: Dict[str, Any], skew_ratio: float,
               top_k: int) -> List[Dict[str, Any]]:
    # plane -> task -> partition -> records
    counts: Dict[Tuple[str, str], Dict[str, float]] = {}
    nbytes: Dict[Tuple[str, str], Dict[str, float]] = {}
    for name, labels, value in _metric_rows(doc):
        if name in ("mrtpu_partition_records_total",
                    "mrtpu_device_partition_records"):
            dst = counts
        elif name in ("mrtpu_partition_bytes_total",
                      "mrtpu_device_partition_bytes"):
            dst = nbytes
        else:
            continue
        plane = "device" if name.startswith("mrtpu_device") else "host"
        task = labels.get("task") or "-"
        part = labels.get("partition")
        if part is None:
            continue
        d = dst.setdefault((plane, task), {})
        d[part] = d.get(part, 0.0) + value
    source: Dict[Tuple[str, str], str] = {
        key: ("partition_gauges" if key[0] == "device"
              else "partition_counters")
        for key in counts}
    if not any(plane == "device" for plane, _t in counts):
        # fallback: no device partition gauges survived (the engine
        # process's push was lost, or an older engine) — the exchange
        # traffic matrix's recv totals (column sums: records routed TO
        # each partition) carry the same skew signal.  Entries say so.
        for name, labels, value in _metric_rows(doc):
            if name not in ("mrtpu_exchange_records_total",
                            "mrtpu_exchange_bytes_total"):
                continue
            dst = (counts if name.endswith("records_total") else nbytes)
            task = labels.get("task") or "-"
            part = _matrix_part(labels.get("dst"))
            if part is None:
                continue
            d = dst.setdefault(("device", task), {})
            d[part] = d.get(part, 0.0) + value
            source[("device", task)] = "exchange_matrix"
    skewed: List[Dict[str, Any]] = []
    for (plane, task), parts in counts.items():
        total = sum(parts.values())
        n = len(parts)
        if n < 2 or total <= 0:
            continue
        uniform = 1.0 / n
        for part, v in parts.items():
            share = v / total
            if share > skew_ratio * uniform:
                skewed.append({
                    "plane": plane, "task": task, "partition": part,
                    "records": int(v),
                    "bytes": int(nbytes.get((plane, task), {})
                                 .get(part, 0)),
                    "share": round(share, 4),
                    "uniform_share": round(uniform, 4),
                    "ratio_vs_uniform": round(share / uniform, 2),
                    "partitions_observed": n,
                    "source": source.get((plane, task), "?"),
                })
    skewed.sort(key=lambda s: -s["share"])
    return skewed[:top_k]


# -- hotspots ----------------------------------------------------------------


def _find_hotspots(doc: Dict[str, Any], top_k: int) -> List[Dict[str, Any]]:
    hits: List[Dict[str, Any]] = []
    for name, labels, value in _metric_rows(doc):
        if value <= 0:
            continue
        for family, want in _HOTSPOT_FAMILIES:
            if name != family:
                continue
            if want is not None and any(labels.get(k) != v
                                        for k, v in want.items()):
                continue
            hits.append({"metric": name, "labels": labels,
                         "value": value})
    hits.sort(key=lambda h: -h["value"])
    return hits[:top_k]


# -- compile hotspots --------------------------------------------------------


def _compile_hotspots(doc: Dict[str, Any],
                      top_k: int) -> List[Dict[str, Any]]:
    """Programs ranked by compile seconds: cluster-aggregated
    ``mrtpu_compile_seconds`` sums when the collector carried them,
    merged with the merged timeline's ``compile`` spans (which also
    survive in offline bundles that predate the metrics)."""
    per: Dict[str, Dict[str, float]] = {}
    for name, labels, value in _metric_rows(doc):
        if name != "mrtpu_compile_seconds_sum":
            continue
        prog = labels.get("program") or "?"
        p = per.setdefault(prog, {"total_s": 0.0, "compiles": 0.0,
                                  "max_s": 0.0})
        p["total_s"] += value
    for name, labels, value in _metric_rows(doc):
        if name != "mrtpu_compile_seconds_count":
            continue
        prog = labels.get("program") or "?"
        if prog in per:
            # a fresh build is two observations (nvcc or g++, then the
            # load); halve so "compiles" means programs built
            per[prog]["compiles"] += value / 2.0
    spans: Dict[str, Dict[str, float]] = {}
    for e in _events(doc):
        if e.get("name") != "compile":
            continue
        args = e.get("args") or {}
        prog = str(args.get("program") or "?")
        try:
            dur = float(e.get("dur", 0.0)) / 1e6
        except (TypeError, ValueError):
            continue
        s = spans.setdefault(prog, {"total_s": 0.0, "n": 0.0,
                                    "max_s": 0.0})
        s["total_s"] += dur
        s["n"] += 1
        s["max_s"] = max(s["max_s"], dur)
    for prog, s in spans.items():
        p = per.setdefault(prog, {"total_s": 0.0, "compiles": 0.0,
                                  "max_s": 0.0})
        # spans double the metrics when both are present: the metrics
        # sums stay authoritative, the FULL span aggregate fills in
        # for span-only docs (offline bundles predating the metrics)
        p["max_s"] = max(p["max_s"], s["max_s"])
        if p["total_s"] <= 0.0:
            p["total_s"] = s["total_s"]
            p["compiles"] = s["n"]
    out = [{"program": prog,
            "total_s": round(v["total_s"], 4),
            "compiles": int(v["compiles"]) or None,
            "max_s": round(v["max_s"], 4) or None}
           for prog, v in per.items() if v["total_s"] > 0]
    out.sort(key=lambda h: -h["total_s"])
    return out[:top_k]


# -- memory pressure ---------------------------------------------------------

#: bytes_in_use / bytes_limit above this reads as memory pressure in
#: the diagnosis notes (matches obs/memory.HBM_PRESSURE_RATIO)
MEMORY_PRESSURE_RATIO = 0.8


def _memory_findings(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Capacity-retry forensics events (the engine's structured
    ``capacity_retry`` spans) plus live device-memory pressure from the
    cluster-aggregated gauges."""
    retries: List[Dict[str, Any]] = []
    for e in _events(doc):
        if e.get("name") != "capacity_retry":
            continue
        args = e.get("args") or {}
        retries.append({
            "task": args.get("task"),
            "attempt": args.get("attempt"),
            "overflow_rows": args.get("overflow_rows"),
            "bound": args.get("bound"),
            "program_memory": args.get("program_memory"),
            "device_memory": args.get("device_memory"),
            "new_capacities": args.get("new_capacities"),
        })
    pressure: List[Dict[str, Any]] = []
    in_use: Dict[str, float] = {}
    limits: Dict[str, float] = {}
    for name, labels, value in _metric_rows(doc):
        if name != "mrtpu_device_memory_bytes":
            continue
        dev = labels.get("device") or "?"
        if labels.get("stat") == "bytes_in_use":
            in_use[dev] = max(in_use.get(dev, 0.0), value)
        elif labels.get("stat") == "bytes_limit":
            limits[dev] = max(limits.get(dev, 0.0), value)
    for dev, limit in limits.items():
        used = in_use.get(dev, 0.0)
        if limit > 0 and used >= MEMORY_PRESSURE_RATIO * limit:
            pressure.append({"device": dev, "bytes_in_use": int(used),
                             "bytes_limit": int(limit),
                             "ratio": round(used / limit, 3)})
    pressure.sort(key=lambda p: -p["ratio"])
    out: Dict[str, Any] = {}
    if retries:
        out["capacity_retries"] = retries
    if pressure:
        out["device_pressure"] = pressure
    return out


# -- the control plane: decisions, cross-referenced into findings ------------


#: human surfaces (diagnose notes + rendered control section) show only
#: the newest N decisions — the cli statusz cap; the full ledger stays
#: machine-readable in report["control"] / --json
MAX_NOTE_DECISIONS = 8


def _control_findings(doc: Dict[str, Any]) -> Dict[str, Any]:
    """The observe->act loop's decisions, from the merged timeline's
    ``control_decision`` events (obs/control emits one per record AND
    one per resolve; the resolve carries the final outcome, so the
    LAST event per decision id wins) plus the cluster-aggregated
    decision counters."""
    decisions: Dict[Any, Dict[str, Any]] = {}
    for e in _events(doc):
        if e.get("name") != "control_decision":
            continue
        args = e.get("args") or {}
        # the pid is part of the identity: decision ids are PER-PROCESS
        # ledger sequences, so two hosts' decision #1 must not clobber
        # each other in the merged /clusterz doc
        did = (e.get("pid"), args.get("controller"),
               args.get("decision_id"))
        decisions[did] = {
            "controller": args.get("controller"),
            "task": args.get("task"),
            "id": args.get("decision_id"),
            "outcome": args.get("outcome"),
            "evidence": args.get("evidence"),
            "action": args.get("action"),
            "outcome_evidence": args.get("outcome_evidence"),
            "note": args.get("note"),
            # the merged-timeline event stamp: RECENCY across
            # processes, where raw ids (per-process sequences) cannot
            # order anything
            "ts": e.get("ts"),
        }
    counts: Dict[str, Dict[str, float]] = {}
    for name, labels, value in _metric_rows(doc):
        if name != "mrtpu_control_decisions_total":
            continue
        c = counts.setdefault(labels.get("controller", "?"), {})
        o = labels.get("outcome", "?")
        c[o] = c.get(o, 0.0) + value
    out: Dict[str, Any] = {}
    if decisions:
        # TIMELINE order, newest last: the human surfaces cap to the
        # list tail, and a (controller, id) sort would put the
        # alphabetically-last controller's stale decisions there
        out["decisions"] = sorted(
            decisions.values(),
            key=lambda d: (d.get("ts") or 0, str(d["controller"]),
                           d["id"] or 0))
    if counts:
        out["counts"] = counts
    return out


def _acted_on(control: Dict[str, Any], controller: str,
              **match: Any) -> Optional[Dict[str, Any]]:
    """The newest decision of *controller* whose fields match —
    findings cross-reference this so a skew/straggler that was already
    acted on says so instead of re-alarming."""
    best = None
    for d in control.get("decisions") or []:
        if d.get("controller") != controller:
            continue
        if d.get("outcome") in ("refused", "error"):
            continue  # a refused decision did not act on anything
        ok = True
        for field, want in match.items():
            have = d.get(field)
            if field == "worker":
                have = (d.get("evidence") or {}).get("worker")
            if str(have) != str(want):
                ok = False
                break
        # recency by the merged-timeline stamp, not the raw id: ids
        # are per-process sequences, so process A's #50 must not beat
        # process B's newer #3
        if ok and (best is None or (d.get("ts") or 0)
                   >= (best.get("ts") or 0)):
            best = d
    return best


def _acted_summary(dec: Dict[str, Any]) -> str:
    """One-line "already acted on" rendering of a decision."""
    oe = dec.get("outcome_evidence") or {}
    ev = dec.get("evidence") or {}
    if (dec.get("controller") == "repartition"
            and oe.get("imbalance_recv_after") is not None):
        return ("rebalanced: imbalance {:.1f}x -> {:.1f}x ({})".format(
            float(ev.get("imbalance_recv") or 0.0),
            float(oe["imbalance_recv_after"]), dec.get("outcome")))
    note = dec.get("note") or ""
    return "{} ({})".format(note or "decision applied",
                            dec.get("outcome"))


# -- comms: exchange imbalance + upload/compute overlap ----------------------

#: recv-side imbalance (max over mean) at or above this reads as an
#: exchange-imbalance note in the diagnosis
EXCHANGE_IMBALANCE_NOTE_RATIO = 2.0

#: a run whose upload waiting overlapped device execution less than
#: this — while upload was a nontrivial share of the busy time — reads
#: as feeder-bound
OVERLAP_FEEDER_BOUND_FRAC = 0.5


def _comms_findings(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Exchange traffic roll-ups from the cluster-aggregated matrix
    counters: per-task totals, send/recv imbalance, the hottest
    destination device, per-link-class bytes, and the modeled exchange
    seconds (obs/comms gauges)."""
    sent: Dict[str, Dict[str, float]] = {}
    recv: Dict[str, Dict[str, float]] = {}
    by_link: Dict[str, float] = {}
    for name, labels, value in _metric_rows(doc):
        if name == "mrtpu_exchange_records_total":
            task = labels.get("task") or "-"
            s = labels.get("src") or "?"
            d = labels.get("dst") or "?"
            srow = sent.setdefault(task, {})
            srow[s] = srow.get(s, 0.0) + value
            drow = recv.setdefault(task, {})
            drow[d] = drow.get(d, 0.0) + value
        elif name == "mrtpu_comms_bytes_total":
            link = labels.get("link") or "?"
            by_link[link] = by_link.get(link, 0.0) + value
    tasks: Dict[str, Any] = {}
    for task, drow in recv.items():
        total = sum(drow.values())
        if total <= 0 or not drow:
            continue
        hot = max(drow, key=drow.get)
        srow = sent.get(task, {})
        # zero cells never become counter rows, so the destination list
        # alone under-counts the device universe (and under-reports
        # imbalance); the union with the senders recovers every device
        # that touched the exchange at all
        n = len(set(drow) | set(srow))
        mean = total / n
        tasks[task] = {
            "records": int(total),
            "devices_observed": n,
            "imbalance_recv": round(max(drow.values()) / mean, 2),
            "imbalance_send": (round(max(srow.values()) * n / total, 2)
                               if srow else None),
            "hot_dst": hot,
            "hot_dst_records": int(drow[hot]),
            "hot_dst_share": round(drow[hot] / total, 4),
        }
    out: Dict[str, Any] = {}
    if tasks:
        out["exchange"] = tasks
    if by_link:
        out["bytes_by_link"] = {k: int(v)
                                for k, v in sorted(by_link.items())}
    for gauge_name, field in (
            ("mrtpu_comms_modeled_exchange_seconds",
             "modeled_exchange_s"),
            ("mrtpu_comms_exchange_frac_of_compute",
             "exchange_frac_of_compute")):
        vals = [v for name, _l, v in _metric_rows(doc)
                if name == gauge_name]
        if vals:
            out[field] = round(max(vals), 6)
    return out


def _union_ivals(events: List[Dict[str, Any]],
                 name: str) -> List[Tuple[float, float]]:
    """``(t0, t1)`` second-intervals of every complete span named
    *name* in the merged doc."""
    out: List[Tuple[float, float]] = []
    for e in events:
        if e.get("name") != name:
            continue
        try:
            t0 = float(e["ts"]) / 1e6
            out.append((t0, t0 + float(e.get("dur", 0.0)) / 1e6))
        except (KeyError, TypeError, ValueError):
            continue
    return out


def _busy_ivals(events: List[Dict[str, Any]],
                ) -> List[Tuple[float, float]]:
    """Device-busy proxies: for each ``wave`` span, dispatch (its
    ``compute`` child's start) to the wave's end (the readback that
    proved its device work finished); waves without a matched compute
    child contribute their whole interval."""
    waves: Dict[str, Tuple[float, float]] = {}
    for e in events:
        if e.get("name") != "wave":
            continue
        sid = (e.get("args") or {}).get("span_id")
        try:
            t0 = float(e["ts"]) / 1e6
            waves[str(sid)] = (t0, t0 + float(e.get("dur", 0.0)) / 1e6)
        except (KeyError, TypeError, ValueError):
            continue
    starts: Dict[str, float] = {}
    for e in events:
        if e.get("name") != "compute":
            continue
        parent = str((e.get("args") or {}).get("parent_id"))
        if parent not in waves:
            continue
        try:
            t0 = float(e["ts"]) / 1e6
        except (TypeError, ValueError):
            continue
        starts[parent] = min(starts.get(parent, t0), t0)
    return [(max(t0, starts.get(sid, t0)), t1)
            for sid, (t0, t1) in waves.items()]


def _overlap_and_critical_path(doc: Dict[str, Any],
                               comms: Dict[str, Any]) -> Dict[str, Any]:
    """Feeder effectiveness + critical path over the merged timeline:
    which stage — upload, compute (device-busy), exchange (modeled),
    readback, claim, blob write — accounts for the most wall time.
    Pure interval arithmetic over an already-captured document
    (obs/comms.overlap_fraction; no clocks are read).

    Overlap is computed PER PROCESS TRACK and the worst fraction
    reported: one process's busy device must not hide another
    process's feeder-bound run — the span-plane twin of the
    collector's MIN-merge rule for the overlap gauge."""
    from .comms import _union_length, overlap_fraction

    events = _events(doc)
    uploads = _union_ivals(events, "upload")
    busy = _busy_ivals(events)
    stages: Dict[str, float] = {}
    for stage, ivals in (("upload", uploads), ("compute", busy),
                         ("readback", _union_ivals(events, "readback")),
                         ("claim", _union_ivals(events, "claim")),
                         ("write", _union_ivals(events, "write"))):
        secs = _union_length(ivals)
        if secs > 0:
            stages[stage] = round(secs, 4)
    modeled = comms.get("modeled_exchange_s")
    if modeled:
        stages["exchange_modeled"] = round(float(modeled), 4)
    out: Dict[str, Any] = {"stages": stages}
    window = _union_ivals(events, "device_run") or \
        _union_ivals(events, "job")
    if window:
        out["window_s"] = round(_union_length(window), 4)
    if stages:
        out["bound"] = max(stages, key=stages.get)
    if uploads or busy:
        up_s = _union_length(uploads)
        busy_s = _union_length(busy)
        # per-process overlap: intersect each track's uploads with ITS
        # OWN busy windows, then take the worst fraction among tracks
        # that actually waited on uploads
        pids = {e.get("pid") for e in events
                if e.get("name") in ("upload", "wave")}
        per_proc: Dict[Any, float] = {}
        for pid in pids:
            pe = [e for e in events if e.get("pid") == pid]
            pup = _union_ivals(pe, "upload")
            if _union_length(pup) <= 0.0:
                continue
            per_proc[pid] = overlap_fraction(pup, _busy_ivals(pe))
        frac = min(per_proc.values()) if per_proc \
            else overlap_fraction(uploads, busy)
        out["upload_overlap_frac"] = round(frac, 4)
        if len(per_proc) > 1:
            out["upload_overlap_frac_by_proc"] = {
                str(pid): round(f, 4)
                for pid, f in sorted(per_proc.items())}
        out["upload_s"] = round(up_s, 4)
        out["device_busy_s"] = round(busy_s, 4)
        # the same intersection seen from the compute side: how much of
        # device execution had an upload hiding under it
        out["overlap_of_compute_frac"] = (
            round(frac * up_s / busy_s, 4) if busy_s > 0 else 0.0)
        out["feeder_bound"] = bool(
            frac < OVERLAP_FEEDER_BOUND_FRAC and uploads and busy
            and up_s > 0.1 * max(busy_s, 1e-9))
    return out


# -- phase breakdown ---------------------------------------------------------

_HOST_PHASES = ("claim", "run", "write")
_DEVICE_PHASES = ("wave", "upload", "compute", "readback")


def _phase_breakdown(doc: Dict[str, Any]) -> Dict[str, Any]:
    totals: Dict[str, float] = {}
    per_worker: Dict[str, Dict[str, float]] = {}
    for e in _events(doc):
        name = e.get("name")
        if name not in _HOST_PHASES and name not in _DEVICE_PHASES:
            continue
        try:
            dur = float(e.get("dur", 0.0)) / 1e6
        except (TypeError, ValueError):
            continue
        totals[name] = totals.get(name, 0.0) + dur
        worker = (e.get("args") or {}).get("worker")
        if worker and name in _HOST_PHASES:
            w = per_worker.setdefault(str(worker), {})
            w[name] = w.get(name, 0.0) + dur
    out: Dict[str, Any] = {
        f"{p}_s": round(totals.get(p, 0.0), 4)
        for p in _HOST_PHASES}
    dev = {f"{p}_s": round(totals.get(p, 0.0), 4)
           for p in _DEVICE_PHASES if totals.get(p)}
    if dev:
        out["device"] = dev
    if per_worker:
        out["per_worker"] = {
            w: {f"{p}_s": round(v, 4) for p, v in d.items()}
            for w, d in sorted(per_worker.items())}
    return out


# -- multi-tenant service findings (sched/ + engine/session) -----------------


def _sched_findings(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Tenancy health from the cluster-aggregated scheduler/session
    families: queue depth per tenant/state, admission rejections by
    reason, served records, and streaming-session overflow."""
    depth: Dict[str, Dict[str, int]] = {}
    rejections: Dict[str, Dict[str, int]] = {}
    served: Dict[str, int] = {}
    overflow: Dict[str, int] = {}
    for name, labels, value in _metric_rows(doc):
        if name == "mrtpu_sched_queue_depth" and value:
            depth.setdefault(labels.get("tenant", "-"), {})[
                labels.get("state", "?")] = int(value)
        elif (name == "mrtpu_sched_admission_total"
                and labels.get("outcome") == "rejected" and value):
            rejections.setdefault(labels.get("tenant", "-"), {})[
                labels.get("reason", "-")] = int(value)
        elif name == "mrtpu_sched_served_records_total" and value:
            t = labels.get("tenant", "-")
            served[t] = served.get(t, 0) + int(value)
        elif name == "mrtpu_session_overflow_rows_total" and value:
            t = labels.get("task", "-")
            overflow[t] = overflow.get(t, 0) + int(value)
    out: Dict[str, Any] = {}
    if depth:
        out["queue_depth"] = depth
    if rejections:
        out["rejections"] = rejections
    if served:
        out["served_records"] = served
    if overflow:
        out["session_overflow"] = overflow
    return out


def _durability_findings(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Service-durability health from the cluster-aggregated HA/spill
    families (coord/ha + engine/spill): board promotions/fences and
    client failover rotations, session spill/restore traffic, and
    feed-queue backpressure rejections."""
    out: Dict[str, Any] = {}
    failovers: Dict[str, int] = {}
    backpressure: Dict[str, int] = {}
    spills: Dict[str, int] = {}
    restores: Dict[str, int] = {}
    for name, labels, value in _metric_rows(doc):
        if not value:
            continue
        if name == "mrtpu_board_promotions_total":
            out["board_promotions"] = (out.get("board_promotions", 0)
                                       + int(value))
        elif name == "mrtpu_board_fences_total":
            out["board_fences"] = out.get("board_fences", 0) + int(value)
        elif name == "mrtpu_board_replayed_rid_refusals_total":
            out["refused_rids"] = (out.get("refused_rids", 0)
                                   + int(value))
        elif name == "mrtpu_client_failovers_total":
            ep = labels.get("endpoint", "-")
            failovers[ep] = failovers.get(ep, 0) + int(value)
        elif name == "mrtpu_session_backpressure_total":
            t = labels.get("task", "-")
            backpressure[t] = backpressure.get(t, 0) + int(value)
        elif name == "mrtpu_session_spills_total":
            t = labels.get("task", "-")
            spills[t] = spills.get(t, 0) + int(value)
        elif name == "mrtpu_session_restores_total":
            t = labels.get("task", "-")
            restores[t] = restores.get(t, 0) + int(value)
    if failovers:
        out["client_failovers"] = failovers
    if backpressure:
        out["session_backpressure"] = backpressure
    if spills:
        out["session_spills"] = spills
    if restores:
        out["session_restores"] = restores
    return out


# -- engine-fleet findings (coord/fleet + engine/migrate) --------------------


def _fleet_findings(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Engine-fleet health from the cluster-aggregated fleet families
    (coord/fleet + engine/migrate): membership states, stream
    migrations by reason, failed-host recoveries, and definitive
    heartbeat losses (a host that was fenced off its own lease).
    Per-migration evidence rides the control ledger (controller
    ``fleet``) and surfaces through the control findings; this section
    is the counter-level roll-up."""
    out: Dict[str, Any] = {}
    hosts: Dict[str, int] = {}
    migrations: Dict[str, int] = {}
    migrated_tasks: Dict[str, int] = {}
    recovered: Dict[str, int] = {}
    lost_beats: Dict[str, int] = {}
    for name, labels, value in _metric_rows(doc):
        if name == "mrtpu_fleet_hosts":
            if value:
                state = labels.get("state", "-")
                # gauge: each serving process renders the same board
                # truth, so MAX (not sum) avoids double counting
                hosts[state] = max(hosts.get(state, 0), int(value))
        elif not value:
            continue
        elif name == "mrtpu_session_migrations_total":
            r = labels.get("reason", "-")
            migrations[r] = migrations.get(r, 0) + int(value)
            t = labels.get("task", "-")
            migrated_tasks[t] = migrated_tasks.get(t, 0) + int(value)
        elif name == "mrtpu_fleet_recoveries_total":
            h = labels.get("host", "-")
            recovered[h] = recovered.get(h, 0) + int(value)
        elif name == "mrtpu_fleet_heartbeats_total":
            if labels.get("outcome") == "lost":
                h = labels.get("host", "-")
                lost_beats[h] = lost_beats.get(h, 0) + int(value)
    if hosts:
        out["hosts"] = hosts
    if migrations:
        out["migrations"] = migrations
    if migrated_tasks:
        out["migrated_tasks"] = migrated_tasks
    if recovered:
        out["recovered_hosts"] = recovered
    if lost_beats:
        out["heartbeat_losses"] = lost_beats
    return out


# -- serving-SLO findings (obs/slo) ------------------------------------------


def _slo_findings(doc: Dict[str, Any]) -> Dict[str, Any]:
    """SLO health from the cluster-aggregated serving-SLO gauges
    (obs/slo publishes them at every evaluation tick; the collector
    merges them by MAX — worst process wins): per-(tenant, objective)
    percentile estimates vs the threshold that was in force, short/long
    burn rates, breach-tick counts, plus per-tenant oldest-queued-age
    and per-stream staleness-age (the silent-staleness gauges)."""
    pct: Dict[tuple, Dict[str, Any]] = {}
    thresholds: Dict[str, float] = {}
    burn: Dict[tuple, Dict[str, float]] = {}
    breaches: Dict[tuple, int] = {}
    queue_age: Dict[str, float] = {}
    stream_age: Dict[str, Dict[str, float]] = {}
    for name, labels, value in _metric_rows(doc):
        if name == "mrtpu_slo_percentile_seconds":
            key = (labels.get("tenant", "-"),
                   labels.get("objective", "-"))
            pct[key] = {"p": value, "pct": labels.get("pct", "p99")}
        elif name == "mrtpu_slo_threshold_seconds":
            thresholds[labels.get("objective", "-")] = value
        elif name == "mrtpu_slo_burn_rate":
            key = (labels.get("tenant", "-"),
                   labels.get("objective", "-"))
            burn.setdefault(key, {})[
                labels.get("window", "?")] = value
        elif name == "mrtpu_slo_breach_total" and value:
            key = (labels.get("tenant", "-"),
                   labels.get("objective", "-"))
            breaches[key] = breaches.get(key, 0) + int(value)
        elif name == "mrtpu_sched_oldest_queued_age_seconds" and value:
            queue_age[labels.get("tenant", "-")] = value
        elif name == "mrtpu_session_stream_age_seconds":
            stream_age.setdefault(labels.get("task", "-"), {})[
                labels.get("stamp", "?")] = value
    entries: List[Dict[str, Any]] = []
    for (tenant, objective), row in sorted(pct.items()):
        thr = thresholds.get(objective)
        b = burn.get((tenant, objective), {})
        entries.append({
            "tenant": tenant,
            "objective": objective,
            "pct": row["pct"],
            "p_s": round(row["p"], 6),
            "threshold_s": thr,
            "burn_short": b.get("short"),
            "burn_long": b.get("long"),
            "breach_ticks": breaches.get((tenant, objective), 0),
            "breaching": bool(thr is not None and row["p"] > thr),
        })
    out: Dict[str, Any] = {}
    if entries:
        out["objectives"] = entries
    if queue_age:
        out["oldest_queued_age_s"] = {
            t: round(v, 3) for t, v in sorted(queue_age.items())}
    if stream_age:
        out["stream_age_s"] = {
            t: {k: round(v, 3) for k, v in sorted(s.items())}
            for t, s in sorted(stream_age.items())}
    return out


#: a per-wave compute cost (or a retry-family rate) whose new trend
#: window is this many times its old window is called a regression
TREND_DRIFT_RATIO = 1.5


def _history_findings(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Trend regressions computed over the durable history plane's
    persisted windows (``mrtpuCluster["history"]``, embedded by the
    collector when a MetricHistory is attached) — the findings survive
    restarts and work offline on a saved cluster trace because the
    math already ran against segments, not process memory."""
    cluster = doc.get("mrtpuCluster") or {}
    hist = cluster.get("history")
    if not isinstance(hist, dict) or not hist:
        return {}
    if hist.get("error"):
        return {"error": str(hist["error"])}
    findings: List[Dict[str, Any]] = []
    spw = hist.get("compute_s_per_wave") or {}
    ratio = spw.get("ratio")
    if ratio is not None and ratio >= TREND_DRIFT_RATIO:
        findings.append({"kind": "compute_drift",
                         "old_s_per_wave": spw.get("old"),
                         "new_s_per_wave": spw.get("new"),
                         "ratio": ratio})
    for r in hist.get("rates") or []:
        # ratio None = the family was silent in the old window and
        # fired in the new one — trending up from zero, the loudest
        # kind (this is what a failover's retry/rotation burst is)
        if r.get("rate_new", 0.0) > 0.0 and (
                r.get("ratio") is None
                or r["ratio"] >= TREND_DRIFT_RATIO):
            findings.append(dict(r, kind="rate_trend"))
    for b in hist.get("burn") or []:
        if b.get("burn", 0.0) > 1.0:
            findings.append(dict(b, kind="persisted_burn"))
    for proc, j in sorted((hist.get("offset_jumps") or {}).items()):
        findings.append(dict(j, kind="offset_jump", proc=proc))
    return {
        "window_s": hist.get("window_s"),
        "span_s": hist.get("span_s"),
        "entries": hist.get("entries"),
        "procs": hist.get("procs"),
        "findings": findings,
    }


def _alert_findings(doc: Dict[str, Any]) -> Dict[str, Any]:
    """The alerting plane's lifecycle state from the cluster doc
    (``mrtpuCluster["alerts"]``, embedded by the collector when rules
    are configured) plus cluster-wide transition/delivery counts from
    the metric roll-up — works offline on a saved trace like every
    other findings section."""
    cluster = doc.get("mrtpuCluster") or {}
    snap = cluster.get("alerts")
    if not isinstance(snap, dict) or not snap:
        return {}
    out: Dict[str, Any] = {
        "rules": len(snap.get("rules") or []),
        "counts": snap.get("counts") or {},
        "firing": [i for i in snap.get("instances") or []
                   if i.get("state") == "firing"],
        "pending": [i for i in snap.get("instances") or []
                    if i.get("state") == "pending"],
        "silences": snap.get("silences") or [],
    }
    transitions: Dict[str, float] = {}
    deliveries: Dict[str, float] = {}
    for name, labels, v in _metric_rows(doc):
        if name == "mrtpu_alert_transitions_total":
            to = labels.get("to") or "?"
            transitions[to] = transitions.get(to, 0.0) + v
        elif (name == "mrtpu_alert_notifications_total"
              and labels.get("outcome") == "delivered"):
            sink = labels.get("sink") or "?"
            deliveries[sink] = deliveries.get(sink, 0.0) + v
    if transitions:
        out["transitions"] = transitions
    if deliveries:
        out["deliveries"] = deliveries
    return out


def _firing_alert(alerts: Dict[str, Any], **match: Any,
                  ) -> Optional[Dict[str, Any]]:
    """The firing instance whose labels carry every *match* pair, or
    None — the alert-plane analogue of :func:`_acted_on`: a finding
    the plane is already paging on says so instead of re-alarming."""
    for inst in alerts.get("firing") or []:
        labels = inst.get("labels") or {}
        if all(str(labels.get(k)) == str(v) for k, v in match.items()):
            return inst
    return None


# -- the report --------------------------------------------------------------


def diagnose(doc: Dict[str, Any], skew_ratio: float = SKEW_RATIO,
             top_k: int = TOP_K) -> Dict[str, Any]:
    """Structured diagnosis of a ``/clusterz`` document (also accepts a
    bundle's ``cluster_trace.json``).  Pure function — safe to run
    offline on a captured file."""
    cluster = doc.get("mrtpuCluster") or {}
    stragglers, workers, latency_source = _find_stragglers(doc)
    comms = _comms_findings(doc)
    control = _control_findings(doc)
    alerts = _alert_findings(doc)
    report: Dict[str, Any] = {
        "aligned_to": cluster.get("aligned_to"),
        "n_procs": len(cluster.get("procs") or {}) or None,
        "procs": cluster.get("procs") or {},
        "tasks": cluster.get("tasks") or {},
        "workers": workers,
        "latency_source": latency_source,
        "stragglers": stragglers,
        "skew": _find_skew(doc, skew_ratio, top_k),
        "hotspots": _find_hotspots(doc, top_k),
        "compile_hotspots": _compile_hotspots(doc, top_k),
        "memory": _memory_findings(doc),
        "comms": comms,
        "sched": _sched_findings(doc),
        "slo": _slo_findings(doc),
        "durability": _durability_findings(doc),
        "fleet": _fleet_findings(doc),
        "trends": _history_findings(doc),
        "control": control,
        "alerts": alerts,
        "critical_path": _overlap_and_critical_path(doc, comms),
        "phases": _phase_breakdown(doc),
        "trace_events": len(doc.get("traceEvents") or []),
    }
    # decision-aware findings: a skew/straggler the control plane
    # already acted on is annotated instead of re-alarming — the
    # "what changed since" cli diagnose previously could not answer
    for s in report["skew"]:
        dec = _acted_on(control, "repartition", task=s.get("task"))
        if dec is not None:
            s["acted"] = _acted_summary(dec)
    for s in report["stragglers"]:
        dec = _acted_on(control, "reclaim", worker=s.get("worker"))
        if dec is not None:
            s["acted"] = _acted_summary(dec)
    # alert-aware findings (the control-decision pattern, one plane
    # up): an SLO breach the alerting plane is already paging on is
    # annotated with its firing rule instead of re-alarming cold
    for e in (report["slo"].get("objectives") or []):
        if not e.get("breaching"):
            continue
        inst = _firing_alert(alerts, tenant=e.get("tenant"),
                             objective=e.get("objective"))
        if inst is not None:
            e["alerted"] = inst.get("rule")
    notes: List[str] = []
    for inst in (alerts.get("firing") or [])[-MAX_NOTE_DECISIONS:]:
        lbl = ",".join(f"{k}={v}" for k, v in
                       sorted((inst.get("labels") or {}).items()))
        note = "alert: {} firing".format(
            inst.get("rule") + (f"{{{lbl}}}" if lbl else ""))
        if inst.get("age_s") is not None:
            note += " for {:.0f}s".format(inst["age_s"])
        if inst.get("value") is not None:
            note += " (value {:.4g})".format(float(inst["value"]))
        if inst.get("suppressed"):
            note += " [silenced]"
        if inst.get("acked"):
            note += " [acked]"
        notes.append(note)
    for inst in (alerts.get("pending") or [])[-MAX_NOTE_DECISIONS:]:
        notes.append(
            "alert: {} pending ({}s into its for-duration)".format(
                inst.get("rule"),
                int(inst.get("pending_for_s") or 0)))
    # newest MAX_NOTE_DECISIONS only (the cli statusz cap): an active
    # reclaimer/advisor writes one ledger row per decision, and
    # hundreds of "control:" lines would drown the skew/straggler
    # findings the report exists to surface — the full list stays in
    # report["control"] (--json / the render's control section)
    all_decisions = control.get("decisions") or []
    for d in all_decisions[-MAX_NOTE_DECISIONS:]:
        note = d.get("note") or (
            f"{d.get('controller')} decision on task {d.get('task')}")
        oe = d.get("outcome_evidence") or {}
        if (d.get("controller") == "repartition"
                and oe.get("imbalance_recv_after") is not None):
            note += ": imbalance {:.1f}x -> {:.1f}x".format(
                float((d.get("evidence") or {})
                      .get("imbalance_recv") or 0.0),
                float(oe["imbalance_recv_after"]))
        elif d.get("outcome") in ("improved", "neutral", "regressed"):
            note += f" [{d['outcome']}]"
        notes.append("control: " + note)
    if len(all_decisions) > MAX_NOTE_DECISIONS:
        notes.append("control: (+{} earlier decisions in the control "
                     "section)".format(
                         len(all_decisions) - MAX_NOTE_DECISIONS))
    for task, ex in sorted((comms.get("exchange") or {}).items()):
        if ex["imbalance_recv"] >= EXCHANGE_IMBALANCE_NOTE_RATIO:
            hot = ex["hot_dst"]
            try:
                hot = int(str(hot).lstrip("DP"))
            except ValueError:
                pass
            dec = _acted_on(control, "repartition", task=task)
            if dec is not None:
                # acted on: the cumulative matrix still carries the
                # pre-rebalance history — say what changed instead of
                # re-alarming on stale totals
                notes.append(
                    "exchange imbalance {:.1f}x on task {} (cumulative) "
                    "— already acted on: {}".format(
                        ex["imbalance_recv"], task,
                        _acted_summary(dec)))
                continue
            notes.append(
                "exchange imbalance {:.1f}x on task {}: device {} "
                "receives {:.0%} of records".format(
                    ex["imbalance_recv"], task, hot,
                    ex["hot_dst_share"]))
    cp = report["critical_path"]
    if cp.get("feeder_bound"):
        notes.append(
            "upload overlapped {:.0%} of device compute — feeder-bound "
            "(only {:.0%} of {:.3g}s upload waiting hid under "
            "execution)".format(cp.get("overlap_of_compute_frac", 0.0),
                                cp.get("upload_overlap_frac", 0.0),
                                cp.get("upload_s", 0.0)))
    if cp.get("bound"):
        notes.append(
            "critical path: {} dominates the timeline ({:.3g}s)".format(
                cp["bound"], cp["stages"].get(cp["bound"], 0.0)))
    skew_sources = {s.get("source") for s in report["skew"]
                    if s.get("plane") == "device"}
    if "exchange_matrix" in skew_sources:
        notes.append(
            "device skew derived from the exchange traffic matrix "
            "(recv totals); partition gauges were absent from the "
            "document")
    for r in report["memory"].get("capacity_retries") or []:
        pm = r.get("program_memory") or {}
        footprint = pm.get("total")
        limit = None
        for entry in ((r.get("device_memory") or {}).get("devices")
                      or {}).values():
            if entry.get("bytes_limit"):
                limit = max(limit or 0, entry["bytes_limit"])
        if r.get("bound") == "hbm":
            # the engine classified this retry HBM-bound from live
            # device stats; never contradict that just because the
            # program footprint or limit went unrecorded
            if footprint and limit:
                notes.append(
                    "capacity retry on task {} was HBM-bound: program "
                    "footprint {:.3g} of {:.3g} device bytes".format(
                        r.get("task"), float(footprint), float(limit)))
            else:
                notes.append(
                    "capacity retry on task {} was HBM-bound "
                    "(bytes_in_use at >={:.0%} of device capacity; "
                    "program footprint unrecorded)".format(
                        r.get("task"), MEMORY_PRESSURE_RATIO))
        else:
            notes.append(
                "capacity retry on task {}: static capacities "
                "overflowed ({} rows); HBM {} (footprint {})".format(
                    r.get("task"), r.get("overflow_rows"),
                    "headroom unknown" if not limit
                    else "had headroom", footprint))
    for p in report["memory"].get("device_pressure") or []:
        notes.append(
            "device {} memory pressure: {:.3g} of {:.3g} bytes in use "
            "({:.0%})".format(p["device"], float(p["bytes_in_use"]),
                              float(p["bytes_limit"]), p["ratio"]))
    for e in report["slo"].get("objectives") or []:
        if not e["breaching"]:
            continue
        burn_s = ""
        if e.get("burn_long") is not None:
            burn_s = ", burn {:.0f}x".format(e["burn_long"])
            if (e.get("burn_short") is not None
                    and round(e["burn_short"]) != round(e["burn_long"])):
                burn_s += " (short-window {:.0f}x)".format(
                    e["burn_short"])
        notes.append(
            "tenant {} {} {} {:.3g}s against {:g}s objective{}".format(
                e["tenant"], e["pct"], e["objective"], e["p_s"],
                e["threshold_s"], burn_s))
    for tenant, age in sorted(
            (report["slo"].get("oldest_queued_age_s") or {}).items()):
        if age >= QUEUE_AGE_NOTE_S:
            notes.append(
                "tenant {} has a task queued for {:.0f}s — admission "
                "backpressure (raise max_inflight or the tenant's "
                "share)".format(tenant, age))
    for tenant, reasons in sorted(
            (report["sched"].get("rejections") or {}).items()):
        total = sum(reasons.values())
        worst = max(reasons, key=reasons.get)
        notes.append(
            f"tenant {tenant}: {total} admission rejection(s), mostly "
            f"{worst} — raise its quota or drain its queue")
    for task, rows in sorted(
            (report["sched"].get("session_overflow") or {}).items()):
        notes.append(
            f"session stream {task} dropped {rows} rows for capacity — "
            "its resident aggregate is truncated; raise EngineConfig "
            "capacities and restart the stream")
    dur = report["durability"]
    if dur.get("board_promotions"):
        notes.append(
            "board failover: {} standby promotion(s){} — the primary "
            "died or was fenced; exactly-once held through the "
            "replicated dedupe table{}".format(
                dur["board_promotions"],
                (", {} writer fence(s)".format(dur["board_fences"])
                 if dur.get("board_fences") else ""),
                (" ({} ambiguous in-flight rid(s) refused loudly)"
                 .format(dur["refused_rids"])
                 if dur.get("refused_rids") else "")))
    if dur.get("client_failovers"):
        total = sum(dur["client_failovers"].values())
        notes.append(
            f"clients rotated board endpoints {total} time(s) — "
            "expected during a failover; sustained rotation means a "
            "replica is flapping")
    for task, n in sorted((dur.get("session_backpressure") or {})
                          .items()):
        notes.append(
            f"session stream {task} refused {n} feed(s) at its "
            "bounded pending queue — the mesh is behind this stream's "
            "arrival rate (shed load or grow the mesh)")
    fleet = report["fleet"]
    if fleet.get("migrations"):
        total = sum(fleet["migrations"].values())
        notes.append(
            "fleet: {} stream migration(s) ({}) — each one's evidence "
            "is a control-ledger decision above".format(
                total, ", ".join(f"{r}={n}" for r, n in
                                 sorted(fleet["migrations"].items()))))
    for host, n in sorted((fleet.get("recovered_hosts") or {}).items()):
        notes.append(
            "fleet: host {} died (lease expired) and was reaped by the "
            "recovery sweep{} — its streams were re-homed to live "
            "hosts and are servable again via lazy restore".format(
                host, f" {n} time(s)" if n > 1 else ""))
    if fleet.get("hosts", {}).get("expired"):
        notes.append(
            "fleet: {} host(s) currently hold an expired lease — the "
            "next scheduler sweep will re-home their streams".format(
                fleet["hosts"]["expired"]))
    hot_compile = report["compile_hotspots"]
    if hot_compile and hot_compile[0]["total_s"] >= 5.0:
        h = hot_compile[0]
        notes.append(
            "compile hotspot: program {} spent {:.1f}s building — prime "
            "it with `cli warmup --replay` so restarts and capacity "
            "retries hit the persistent cache".format(
                h["program"], h["total_s"]))
    trends = report["trends"]
    for f in trends.get("findings") or []:
        kind = f.get("kind")
        if kind == "compute_drift":
            notes.append(
                "trend: compute seconds per wave drifted {:.4g}s -> "
                "{:.4g}s ({:.1f}x) across persisted {:.0f}s "
                "windows".format(
                    f.get("old_s_per_wave") or 0.0,
                    f.get("new_s_per_wave") or 0.0,
                    f.get("ratio") or 0.0,
                    trends.get("window_s") or 0.0))
        elif kind == "rate_trend":
            notes.append(
                "trend: {} rate {} -> {:.4g}/s over persisted {:.0f}s "
                "windows{}".format(
                    f.get("name"),
                    ("silent" if not f.get("rate_old")
                     else "{:.4g}/s".format(f["rate_old"])),
                    f.get("rate_new") or 0.0,
                    trends.get("window_s") or 0.0,
                    (" — appeared from zero" if f.get("ratio") is None
                     else " ({:.1f}x)".format(f["ratio"]))))
        elif kind == "persisted_burn":
            notes.append(
                "trend: tenant {} {} burning {:.1f}x its error budget "
                "over the PERSISTED window ({} observations) — this "
                "alert survives a docserver restart".format(
                    f.get("tenant"), f.get("objective"),
                    f.get("burn") or 0.0, f.get("window_n")))
        elif kind == "offset_jump":
            notes.append(
                "trend: proc {} clock offset jumped {:+.3f}s between "
                "trend windows — its pusher restarted or its clock "
                "moved; compare history stamps across the jump with "
                "care".format(f.get("proc"), f.get("jump_s") or 0.0))
    if trends.get("error"):
        notes.append("trend analysis unavailable: history plane "
                     "error ({})".format(trends["error"]))
    if not workers:
        notes.append("no worker job latencies found (no job spans and "
                     "no job-seconds metrics in the document)")
    if latency_source == "metrics" and workers:
        notes.append("job spans were lost to telemetry drops; straggler "
                     "test ran on per-worker mean job seconds instead")
    dropped = sum(v for name, _l, v in _metric_rows(doc)
                  if name == "mrtpu_telemetry_dropped_total")
    if dropped:
        notes.append(f"{int(dropped)} span events were lost to the "
                     "telemetry plane; the timeline is incomplete "
                     "(jobs themselves were unaffected by design)")
    report["notes"] = notes
    return report


def render_diagnosis(report: Dict[str, Any]) -> str:
    """One-screen text rendering of a :func:`diagnose` report."""
    lines: List[str] = []
    n_procs = report.get("n_procs")
    lines.append("cluster diagnosis ({} process{}, {} trace events)".format(
        n_procs if n_procs is not None else "?",
        "" if n_procs == 1 else "es", report.get("trace_events", 0)))

    stragglers = report.get("stragglers") or []
    if stragglers:
        lines.append("STRAGGLERS:")
        for s in stragglers:
            lines.append(
                "  worker {worker}: median job {median_s:.3f}s over "
                "{jobs} job(s) — {ratio}x everyone else's median "
                "({baseline_median_s:.3f}s)".format(**s)
                + ("  [acted: {}]".format(s["acted"])
                   if s.get("acted") else ""))
    else:
        lines.append("stragglers: none detected")

    skew = report.get("skew") or []
    if skew:
        lines.append("SKEWED PARTITIONS:")
        for s in skew:
            lines.append(
                "  [{plane}] task {task} partition {partition}: "
                "{records} records = {share:.1%} of the task "
                "({ratio_vs_uniform}x uniform over "
                "{partitions_observed} partitions)".format(**s)
                + (" [via exchange matrix]"
                   if s.get("source") == "exchange_matrix" else "")
                + ("  [acted: {}]".format(s["acted"])
                   if s.get("acted") else ""))
    else:
        lines.append("partition skew: none detected")

    hot = report.get("hotspots") or []
    if hot:
        lines.append("fault/retry hotspots:")
        for h in hot:
            lbl = ",".join(f"{k}={v}" for k, v in
                           sorted(h["labels"].items()))
            lines.append(f"  {h['metric']}{{{lbl}}} = {h['value']:g}")
    else:
        lines.append("fault/retry hotspots: none")

    comms = report.get("comms") or {}
    ex_tasks = comms.get("exchange") or {}
    if ex_tasks:
        lines.append("exchange traffic:")
        for t, ex in sorted(ex_tasks.items()):
            lines.append(
                "  task {}: {} records over {} device(s), recv "
                "imbalance {:.2f}x (hot {} at {:.1%})".format(
                    t, ex["records"], ex["devices_observed"],
                    ex["imbalance_recv"], ex["hot_dst"],
                    ex["hot_dst_share"]))
        link = comms.get("bytes_by_link") or {}
        if link:
            lines.append("  bytes by link: " + "  ".join(
                f"{cls} {v:,}" for cls, v in link.items()))
        if comms.get("modeled_exchange_s") is not None:
            lines.append(
                "  modeled exchange {:.4g}s{} [analytic]".format(
                    comms["modeled_exchange_s"],
                    "" if comms.get("exchange_frac_of_compute") is None
                    else " = {:.1%} of measured compute".format(
                        comms["exchange_frac_of_compute"])))
    cp = report.get("critical_path") or {}
    if cp.get("stages"):
        parts = "  ".join(f"{k} {v:.3g}s"
                          for k, v in sorted(cp["stages"].items()))
        lines.append(f"critical path: {parts} -> bound: "
                     f"{cp.get('bound')}")
        if cp.get("upload_overlap_frac") is not None:
            lines.append(
                "  upload overlap: {:.0%} of {:.3g}s upload hid under "
                "device execution{}".format(
                    cp["upload_overlap_frac"], cp.get("upload_s", 0.0),
                    " (FEEDER-BOUND)" if cp.get("feeder_bound") else ""))

    slo = report.get("slo") or {}
    if slo.get("objectives"):
        lines.append("serving SLOs:")
        for e in slo["objectives"]:
            thr = ("" if e.get("threshold_s") is None
                   else " / {:g}s objective".format(e["threshold_s"]))
            burns = ""
            if e.get("burn_long") is not None:
                burns = "  burn {:.1f}x long".format(e["burn_long"])
                if e.get("burn_short") is not None:
                    burns += " / {:.1f}x short".format(e["burn_short"])
            lines.append(
                "  tenant {} {} {}: {:.3g}s{}{}{}{}".format(
                    e["tenant"], e["pct"], e["objective"], e["p_s"],
                    thr, burns,
                    "  BREACHING" if e["breaching"] else "",
                    ("  [alerting: {}]".format(e["alerted"])
                     if e.get("alerted") else "")))
        for t, age in sorted(
                (slo.get("oldest_queued_age_s") or {}).items()):
            lines.append(
                "  tenant {}: oldest queued task {:.1f}s old".format(
                    t, age))

    sched = report.get("sched") or {}
    if sched.get("queue_depth") or sched.get("served_records"):
        lines.append("scheduler (multi-tenant service):")
        for t, states in sorted((sched.get("queue_depth") or {}).items()):
            parts = " ".join(f"{s}={n}"
                             for s, n in sorted(states.items()))
            lines.append(f"  tenant {t}: {parts}")
        for t, n in sorted((sched.get("served_records") or {}).items()):
            lines.append(f"  tenant {t}: {n} records served")

    fleet = report.get("fleet") or {}
    if fleet:
        lines.append("engine fleet:")
        if fleet.get("hosts"):
            lines.append("  hosts: " + "  ".join(
                f"{s}={n}" for s, n in sorted(fleet["hosts"].items())))
        if fleet.get("migrations"):
            lines.append("  migrations: " + "  ".join(
                f"{r}={n}" for r, n in
                sorted(fleet["migrations"].items())))
        for host, n in sorted((fleet.get("recovered_hosts")
                               or {}).items()):
            lines.append(f"  recovered host {host}: streams re-homed "
                         f"({n} sweep hit(s))")

    trends = report.get("trends") or {}
    if trends and not trends.get("error"):
        tf = trends.get("findings") or []
        header = ("history trends ({:.0f}s windows over {} persisted "
                  "entries, {:.0f}s span):".format(
                      trends.get("window_s") or 0.0,
                      trends.get("entries"),
                      trends.get("span_s") or 0.0))
        if tf:
            lines.append(header.upper())
            for f in tf:
                kind = f.get("kind")
                if kind == "compute_drift":
                    lines.append(
                        "  compute s/wave {:.4g} -> {:.4g} "
                        "({:.1f}x)".format(f.get("old_s_per_wave")
                                           or 0.0,
                                           f.get("new_s_per_wave")
                                           or 0.0,
                                           f.get("ratio") or 0.0))
                elif kind == "rate_trend":
                    lines.append(
                        "  {} {:.4g}/s -> {:.4g}/s{}".format(
                            f.get("name"), f.get("rate_old") or 0.0,
                            f.get("rate_new") or 0.0,
                            (" (from zero)" if f.get("ratio") is None
                             else "")))
                elif kind == "persisted_burn":
                    lines.append(
                        "  tenant {} {}: {:.1f}x budget over the "
                        "persisted window".format(
                            f.get("tenant"), f.get("objective"),
                            f.get("burn") or 0.0))
                elif kind == "offset_jump":
                    lines.append(
                        "  proc {} offset jumped {:+.3f}s".format(
                            f.get("proc"), f.get("jump_s") or 0.0))
        else:
            lines.append(header + " no regressions")

    ctrl = report.get("control") or {}
    if ctrl.get("decisions") or ctrl.get("counts"):
        lines.append("control plane (observe->act):")
        for c, by_o in sorted((ctrl.get("counts") or {}).items()):
            lines.append("  {}: {}".format(c, "  ".join(
                f"{o}={int(n)}" for o, n in sorted(by_o.items()))))
        decs = ctrl.get("decisions") or []
        for d in decs[-MAX_NOTE_DECISIONS:]:
            lines.append(
                "  [{}] task {} #{}: {} -> {}".format(
                    d.get("controller"), d.get("task"), d.get("id"),
                    d.get("note") or "decision", d.get("outcome")))
        if len(decs) > MAX_NOTE_DECISIONS:
            lines.append("  (+{} earlier decisions; --json for the "
                         "full ledger)".format(
                             len(decs) - MAX_NOTE_DECISIONS))

    al = report.get("alerts") or {}
    if al:
        counts = al.get("counts") or {}
        lines.append("alerts ({} rule(s)): ".format(al.get("rules"))
                     + ("  ".join(f"{s}={n}" for s, n in
                                  sorted(counts.items()))
                        or "all inactive"))
        for inst in al.get("firing") or []:
            lbl = ",".join(f"{k}={v}" for k, v in
                           sorted((inst.get("labels") or {}).items()))
            lines.append("  FIRING {}{}{}".format(
                inst.get("rule"), f"{{{lbl}}}" if lbl else "",
                " [silenced]" if inst.get("suppressed") else ""))
        for to, n in sorted((al.get("transitions") or {}).items()):
            lines.append(f"  transitions to {to}: {int(n)}")
        for sink, n in sorted((al.get("deliveries") or {}).items()):
            lines.append(f"  sink {sink}: {int(n)} delivered")

    comp = report.get("compile_hotspots") or []
    if comp:
        lines.append("compile hotspots:")
        for h in comp:
            extra = ("" if not h.get("compiles")
                     else f" over {h['compiles']} compile(s)")
            lines.append(
                f"  program {h['program']}: {h['total_s']:.2f}s "
                f"building{extra}")
    mem = report.get("memory") or {}
    for r in mem.get("capacity_retries") or []:
        lines.append(
            "  capacity retry [{}]: task {} attempt {} overflowed "
            "{} rows".format(r.get("bound"), r.get("task"),
                             r.get("attempt"), r.get("overflow_rows")))

    phases = report.get("phases") or {}
    lines.append(
        "phase breakdown: claim {:.3f}s | run {:.3f}s | write {:.3f}s".format(
            phases.get("claim_s", 0.0), phases.get("run_s", 0.0),
            phases.get("write_s", 0.0)))
    dev = phases.get("device")
    if dev:
        lines.append(
            "  device: upload {:.3f}s  compute {:.3f}s  readback "
            "{:.3f}s".format(dev.get("upload_s", 0.0),
                             dev.get("compute_s", 0.0),
                             dev.get("readback_s", 0.0)))
    workers = report.get("workers") or {}
    for w, st in sorted(workers.items()):
        lines.append(
            "  worker {}: {} job(s), median {:.3f}s, total {:.3f}s".format(
                w, st["jobs"], st["median_s"], st["total_s"]))

    tasks = report.get("tasks") or {}
    for t, r in sorted(tasks.items()):
        lines.append(
            "  task {}: {:.0f} records, {:.0f} B, {:.3f} device s, "
            "{:.3g} FLOP".format(t, r.get("records", 0),
                                 r.get("bytes", 0),
                                 r.get("device_seconds", 0.0),
                                 r.get("flops", 0)))
    for note in report.get("notes") or []:
        lines.append(f"note: {note}")
    return "\n".join(lines) + "\n"
