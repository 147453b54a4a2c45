"""Cluster telemetry plane: push collector, clock alignment, merged timeline
(port of ``mapreduce_tpu/obs/collector.py``).

* :class:`TelemetryPusher` — the client half.  A per-process background
  thread batches NEW span-ring events (``Tracer.events_since``) plus a
  full metrics snapshot and POSTs them to the docserver's
  ``/telemetry`` endpoint over its OWN socket (never the board handle —
  a slow collector can never delay a heartbeat).  Pushing is
  lossy-but-counted by construction: failures park the batch in a
  bounded backlog, overflow and shutdown losses land in
  ``mrtpu_telemetry_dropped_total``, and nothing here ever raises into
  the caller — telemetry can degrade, jobs cannot.

* :class:`Collector` — the server half, hosted by the docserver.  Keeps
  a bounded per-process span buffer, the latest parsed metrics snapshot
  per process, and a **monotonic clock offset** per process: each push
  carries the sender's ``time.monotonic()`` at send time, the collector
  stamps its own at receipt, and the minimum of ``recv - send`` over
  all pushes estimates ``offset + min_network_delay`` (Cristian's
  algorithm on monotonic clocks).

* :meth:`Collector.cluster_doc` — the assembler.  Merges this process's
  own span ring with every pushed process's spans, shifted onto ONE
  timebase under per-process Perfetto tracks; served at ``/clusterz``
  with the cluster aggregates under ``mrtpuCluster`` (the history's
  trend windows and the alert plane's snapshot among them).

* ``Collector(history=)`` — every accepted push with a parseable metrics
  snapshot appends its deltas to the durable
  :class:`~.history.MetricHistory`; an append that fails is counted and
  logged, never refuses the push.

The push payload, its ack and ``/clusterz`` are the JAX package's, so a
pusher of either package feeds a collector of the other.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import socket
import threading
import time
import uuid
from typing import Any, Deque, Dict, List, Optional, Tuple

from .history import HistoryCorruptError, MetricHistory, note_error
from .metrics import REGISTRY, Registry, counter, gauge, parse_prometheus
from .trace import TRACER, Tracer

logger = logging.getLogger("mapreduce_tpu_torch.obs.collector")

#: the docserver path push batches are POSTed to (auth-gated like /rpc)
TELEMETRY_PATH = "/telemetry"

#: this process's stable telemetry identity; spans pushed under it are
#: recognised by the assembler so a process that pushes to a collector
#: IN ITS OWN PROCESS never appears twice in the merged timeline
PROC_ID = (f"{socket.gethostname()}-{os.getpid()}-"
           f"{uuid.uuid4().hex[:6]}")

# -- client-side instruments -------------------------------------------------
_PUSHES = counter(
    "mrtpu_telemetry_pushes_total",
    "telemetry push batches attempted (labels: outcome=ok|error)")
_DROPPED = counter(
    "mrtpu_telemetry_dropped_total",
    "span events lost to the telemetry plane (labels: reason=ring "
    "[evicted before the pusher read them] | backlog [push-failure "
    "backlog overflowed] | shutdown [still undelivered at stop])")

# -- server-side (collector) instruments -------------------------------------
_COLLECTED_PUSHES = counter(
    "mrtpu_collector_pushes_total",
    "push batches accepted by the collector (labels: role)")
_COLLECTED_SPANS = counter(
    "mrtpu_collector_spans_total",
    "span events accepted by the collector")
_COLLECTED_BYTES = counter(
    "mrtpu_collector_bytes_total",
    "telemetry payload bytes accepted by the collector")
_COLLECTOR_EVICTED = counter(
    "mrtpu_collector_evicted_spans_total",
    "spans evicted from a process's bounded collector buffer")
_COLLECTOR_LOST = counter(
    "mrtpu_collector_lost_spans_total",
    "spans the pushers themselves reported losing client-side")
_COLLECTOR_PROCS = gauge(
    "mrtpu_collector_procs",
    "distinct processes that have pushed telemetry to this collector")
_CLOCK_OFFSET = gauge(
    "mrtpu_clock_offset_seconds",
    "per-process monotonic clock offset estimated by the collector "
    "(Cristian minimum of recv-send over pushes; labels: proc)")

#: spans kept per pushing process (bounded like the local span ring)
MAX_SPANS_PER_PROC = 50_000

#: the task roll-up fields and the labelled families that feed them —
#: summed across every process's latest snapshot, grouped by ``task``;
#: the third element is a ``(label, value)`` the series must carry
_ROLLUP_FIELDS: Tuple[Tuple[str, str, Optional[Tuple[str, str]]], ...] = (
    ("records", "mrtpu_task_records_total", None),
    ("bytes", "mrtpu_task_bytes_total", None),
    ("device_seconds", "mrtpu_device_seconds_total",
     ("stage", "compute")),
    ("flops", "mrtpu_device_flops_total", None),
)

#: metric families carried (summed across processes) in the cluster doc
#: for obs/analysis — counters/gauges whose cluster-wide totals drive
#: skew, hotspot and phase diagnosis — and the blob plane's raw and wire
#: bytes
DIAG_FAMILIES = frozenset({
    "mrtpu_blob_raw_bytes_total", "mrtpu_blob_wire_bytes_total",
    "mrtpu_partition_records_total", "mrtpu_partition_bytes_total",
    "mrtpu_task_records_total", "mrtpu_task_bytes_total",
    "mrtpu_worker_jobs_total", "mrtpu_worker_job_seconds_sum",
    "mrtpu_worker_job_seconds_count", "mrtpu_worker_lease_lost_total",
    "mrtpu_worker_released_jobs_total",
    "mrtpu_http_retries_total", "mrtpu_http_retryable_status_total",
    "mrtpu_http_exhausted_total",
    "mrtpu_docserver_requests_total",
    "mrtpu_telemetry_dropped_total", "mrtpu_telemetry_pushes_total",
    "mrtpu_client_failovers_total",
    # the device plane (engine/device_engine, obs/profile, obs/memory):
    # per-partition skew, FLOPs, stage seconds, waves and retries, live
    # device memory and the capacity-retry forensics counter
    "mrtpu_device_partition_records", "mrtpu_device_partition_bytes",
    "mrtpu_device_flops_total", "mrtpu_device_seconds_total",
    "mrtpu_device_waves_total", "mrtpu_device_retries_total",
    "mrtpu_device_memory_bytes",
    "mrtpu_device_capacity_retry_events_total",
    # the compile plane (obs/compile): per-process build seconds and
    # outcomes roll up for obs/analysis' compile-hotspot notes
    "mrtpu_compile_total", "mrtpu_compile_seconds_sum",
    "mrtpu_compile_seconds_count",
    "mrtpu_compile_cache_disabled_total",
    # the comms plane (obs/comms): the exchange traffic matrix, its
    # link-class roll-up and the imbalance/overlap/roofline gauges, so
    # diagnose sees who-sends-to-whom cluster-wide (the skew check's
    # matrix fallback rides these rows)
    "mrtpu_exchange_records_total", "mrtpu_exchange_bytes_total",
    "mrtpu_comms_bytes_total",
    "mrtpu_exchange_imbalance",
    "mrtpu_comms_modeled_exchange_seconds",
    "mrtpu_comms_exchange_frac_of_compute",
    "mrtpu_upload_overlap_frac",
    # the resident sessions' per-task streaming volume, spill/restore
    # traffic and feed-queue backpressure
    "mrtpu_session_chunks_total", "mrtpu_session_waves_total",
    "mrtpu_session_overflow_rows_total",
    "mrtpu_session_spills_total", "mrtpu_session_restores_total",
    "mrtpu_session_backpressure_total",
    # the multi-tenant service plane (sched/): queue depths, admission
    # decisions and task transitions
    "mrtpu_sched_queue_depth", "mrtpu_sched_queued_work",
    "mrtpu_sched_admission_total", "mrtpu_sched_tasks_total",
    "mrtpu_sched_served_records_total",
    # the serving-SLO plane (obs/slo): per-tenant lifecycle histograms
    # (cumulative _bucket/_sum/_count samples sum across processes —
    # per-process monotonic totals, so the sum IS the cluster view),
    # breach counts, and the derived percentile/burn/threshold gauges
    # plus queue-age and stream-age gauges (all merged by MAX below)
    "mrtpu_slo_queue_wait_seconds_bucket",
    "mrtpu_slo_queue_wait_seconds_sum",
    "mrtpu_slo_queue_wait_seconds_count",
    "mrtpu_slo_admit_to_running_seconds_bucket",
    "mrtpu_slo_admit_to_running_seconds_sum",
    "mrtpu_slo_admit_to_running_seconds_count",
    "mrtpu_slo_submit_first_result_seconds_bucket",
    "mrtpu_slo_submit_first_result_seconds_sum",
    "mrtpu_slo_submit_first_result_seconds_count",
    "mrtpu_slo_snapshot_staleness_seconds_bucket",
    "mrtpu_slo_snapshot_staleness_seconds_sum",
    "mrtpu_slo_snapshot_staleness_seconds_count",
    "mrtpu_slo_breach_total",
    "mrtpu_slo_percentile_seconds", "mrtpu_slo_burn_rate",
    "mrtpu_slo_threshold_seconds",
    "mrtpu_sched_oldest_queued_age_seconds",
    "mrtpu_session_stream_age_seconds",
    # the replicated board (coord/ha): failovers, fences, refusals
    "mrtpu_board_promotions_total", "mrtpu_board_fences_total",
    "mrtpu_board_replayed_rid_refusals_total",
    # the control plane (obs/control + engine/autotune): every automatic
    # decision's controller/outcome counts roll up cluster-wide (the
    # decisions themselves travel as control_decision spans)
    "mrtpu_control_decisions_total",
    # the alerting plane (obs/alerts): lifecycle transitions, sink
    # delivery outcomes and history-store GC pressure, so diagnose can
    # cross-reference firing alerts wherever the board that evaluated
    # them ran
    "mrtpu_alert_transitions_total",
    "mrtpu_alert_notifications_total",
    "mrtpu_alerts_firing",
    "mrtpu_history_gc_total",
    # the engine-host fleet (coord/fleet + engine/migrate): membership
    # states, heartbeats, failed-host recoveries and stream migrations,
    # so diagnose's fleet findings see a drain or a recovery that another
    # process made (added in the port: the JAX collector leaves them out,
    # and its diagnose reads them from offline documents alone)
    "mrtpu_fleet_hosts", "mrtpu_fleet_heartbeats_total",
    "mrtpu_fleet_recoveries_total", "mrtpu_session_migrations_total",
})

#: diagnosis gauges that merge across processes by MAX, not sum: the
#: device label is a bare device id, so two processes sharing one card
#: land on the SAME label key, and the worst process's view is what
#: pressure, skew and SLO diagnosis want (a fresh replica must not hide
#: a stale one)
_DIAG_GAUGE_MAX = frozenset({
    "mrtpu_device_memory_bytes",
    # queue depths are board-authoritative on whichever process hosts
    # the scheduler; a second process's stale view must not sum in
    "mrtpu_sched_queue_depth", "mrtpu_sched_queued_work",
    # last-run gauges, not cluster-additive quantities
    "mrtpu_exchange_imbalance",
    "mrtpu_comms_modeled_exchange_seconds",
    "mrtpu_comms_exchange_frac_of_compute",
    "mrtpu_slo_percentile_seconds", "mrtpu_slo_burn_rate",
    "mrtpu_slo_threshold_seconds",
    "mrtpu_sched_oldest_queued_age_seconds",
    "mrtpu_session_stream_age_seconds",
    # firing-alert counts are primary-authoritative; a standby's zero
    # (or a stale pushed copy) must not dilute the evaluating board's
    "mrtpu_alerts_firing",
    # every process that snapshots the fleet renders the same board truth
    "mrtpu_fleet_hosts",
})

#: and gauges where the WORST view is the smallest value: an overlap
#: fraction merged by max would let one healthy feeder hide another
#: process's feeder-bound run
_DIAG_GAUGE_MIN = frozenset({
    "mrtpu_upload_overlap_frac",
})


def _proc_obs(parsed: Dict[Any, float]) -> Dict[str, Any]:
    """Per-process build/memory roll-up from one pushed metrics snapshot
    (the /statusz per-proc rows)."""
    compile_s = 0.0
    compiles = 0.0
    hbm = 0.0
    for (name, labelkey), value in parsed.items():
        if name == "mrtpu_compile_seconds_sum":
            compile_s += value
        elif name == "mrtpu_compile_total":
            labels = dict(labelkey)
            if labels.get("outcome") in ("compiled", "persistent_hit"):
                compiles += value
        elif name == "mrtpu_device_memory_bytes":
            if dict(labelkey).get("stat") == "bytes_in_use":
                hbm += value
    out: Dict[str, Any] = {}
    if compile_s or compiles:
        out["compile_s"] = round(compile_s, 3)
        out["compiles"] = int(compiles)
    if hbm:
        out["hbm_bytes_in_use"] = int(hbm)
    return out


class Collector:
    """Server half of the telemetry plane (one per docserver)."""

    def __init__(self, max_spans_per_proc: int = MAX_SPANS_PER_PROC,
                 local_role: str = "server",
                 history: Optional[MetricHistory] = None) -> None:
        self.max_spans_per_proc = max(1, int(max_spans_per_proc))
        self.local_role = local_role
        #: durable telemetry history (obs/history): every accepted push
        #: with a parseable metrics snapshot appends its deltas there
        self.history = history
        self._lock = threading.Lock()
        self._procs: Dict[str, Dict[str, Any]] = {}

    # -- ingest ------------------------------------------------------------

    def push(self, payload: Dict[str, Any],
             received_mono: Optional[float] = None,
             nbytes: int = 0) -> Dict[str, Any]:
        """Accept one decoded push batch; returns the ack document.

        Malformed fields degrade (a bad metrics snapshot keeps the
        previous one) — the collector never refuses telemetry it can
        partially use, and never raises for content it cannot.
        """
        now = (received_mono if received_mono is not None
               else time.monotonic())
        proc = str(payload.get("proc") or "?")
        role = str(payload.get("role") or "?")
        spans = payload.get("spans") or []
        if not isinstance(spans, list):
            spans = []
        seqs = payload.get("span_seqs")
        if not (isinstance(seqs, list) and len(seqs) == len(spans)):
            seqs = None
        evicted = 0
        lost_delta = 0
        accepted = 0
        with self._lock:
            st = self._procs.get(proc)
            if st is None:
                st = self._procs[proc] = {
                    "role": role,
                    "pid": payload.get("pid"),
                    "offset": None,   # sender mono + offset = our mono
                    "spans": collections.deque(),
                    "applied_seq": 0,  # idempotency high-water mark
                    "metrics": {},
                    "sections": {},
                    "pushes": 0,
                    "missed": 0,
                    "last_push": now,
                }
            t_send = payload.get("t_mono")
            if isinstance(t_send, (int, float)):
                # min over pushes ≈ true offset + smallest one-way delay
                # seen; monotonic both sides, so NTP steps cannot move it
                delta = now - float(t_send)
                if st["offset"] is None or delta < st["offset"]:
                    st["offset"] = delta
            if role and role != "?":
                st["role"] = role
            st["pushes"] += 1
            try:
                # the pusher reports its loss CUMULATIVELY, so a re-sent
                # batch (lost ack) cannot double-count it: keep the max
                reported = max(int(payload.get("missed") or 0), 0)
                lost_delta = max(0, reported - st["missed"])
                st["missed"] = max(st["missed"], reported)
            except (TypeError, ValueError):
                pass
            st["last_push"] = now
            buf: Deque[Dict[str, Any]] = st["spans"]
            for i, e in enumerate(spans):
                if not isinstance(e, dict):
                    continue
                if seqs is not None:
                    # idempotent ingest: a batch re-sent because its ack
                    # was lost replays seqs at or below the high-water
                    # mark and is skipped instead of duplicating spans
                    try:
                        s = int(seqs[i])
                    except (TypeError, ValueError):
                        continue
                    if s <= st["applied_seq"]:
                        continue
                buf.append(e)
                accepted += 1
            if seqs is not None:
                try:
                    st["applied_seq"] = max(
                        st["applied_seq"],
                        max(int(s) for s in seqs) if seqs else 0)
                except (TypeError, ValueError):
                    pass
            while len(buf) > self.max_spans_per_proc:
                buf.popleft()
                evicted += 1
            sections = payload.get("sections")
            if isinstance(sections, dict):
                st["sections"] = sections
            mtext = payload.get("metrics")
            new_parsed = None
            if mtext:
                try:
                    new_parsed = parse_prometheus(str(mtext))
                    st["metrics"] = new_parsed
                except ValueError:
                    logger.warning(
                        "telemetry push from %s carried an unparseable "
                        "metrics snapshot; keeping the previous one", proc)
            n_procs = len(self._procs)
            missed = st["missed"]
            offset_now = st["offset"]
        if offset_now is not None:
            _CLOCK_OFFSET.set(round(offset_now, 6), proc=proc)
        if self.history is not None and new_parsed is not None:
            # history append failures degrade, never refuse telemetry —
            # but they are counted, and corruption is logged loudly
            try:
                self.history.append_snapshot(
                    proc, new_parsed, role=role, offset_s=offset_now)
            except HistoryCorruptError as exc:
                note_error("corrupt")
                logger.error("telemetry history is corrupt; refusing "
                             "to append until repaired: %s", exc)
            except OSError as exc:
                note_error("io")
                logger.warning("telemetry history append failed: %s",
                               exc)
        _COLLECTED_PUSHES.inc(role=role)
        _COLLECTED_SPANS.inc(accepted)
        if nbytes:
            _COLLECTED_BYTES.inc(nbytes)
        if evicted:
            _COLLECTOR_EVICTED.inc(evicted)
        if lost_delta:
            _COLLECTOR_LOST.inc(lost_delta)
        _COLLECTOR_PROCS.set(n_procs)
        return {"t_mono": now, "procs": n_procs, "missed_seen": missed}

    # -- snapshots ---------------------------------------------------------

    def _snapshot(self, spans: bool = True) -> Dict[str, Dict[str, Any]]:
        """Consistent copy of the per-proc state; ``spans=False`` skips
        copying the (up to 50k-per-proc) span buffers."""
        now = time.monotonic()
        with self._lock:
            return {
                proc: {
                    "role": st["role"], "pid": st["pid"],
                    "offset": st["offset"],
                    "spans": list(st["spans"]) if spans else [],
                    "n_spans": len(st["spans"]),
                    "metrics": dict(st["metrics"]),
                    "sections": st["sections"],
                    "pushes": st["pushes"], "missed": st["missed"],
                    "last_push_age_s": round(now - st["last_push"], 3),
                } for proc, st in self._procs.items()}

    @staticmethod
    def _parsed_local(registry: Registry) -> Dict[Any, float]:
        return parse_prometheus(registry.render())

    def metric_snapshots(self, exclude_self: bool = True,
                         ) -> List[Dict[Any, float]]:
        """Latest parsed metrics snapshot per pushing process.
        ``exclude_self`` drops this process's own pushed snapshot; it
        contributes through the live registry instead."""
        snap = self._snapshot(spans=False)
        return [st["metrics"] for proc, st in snap.items()
                if not (exclude_self and proc == PROC_ID)]

    def pushed_sections(self) -> List[Tuple[str, Dict[str, Any]]]:
        """``(proc, sections)`` of every other process that pushed its
        engine-side /statusz sections (:func:`..obs.statusz.
        process_sections`), the freshest push first."""
        snap = self._snapshot(spans=False)
        return [(proc, st["sections"]) for proc, st in sorted(
            snap.items(), key=lambda kv: kv[1]["last_push_age_s"])
            if proc != PROC_ID and st["sections"]]

    @staticmethod
    def _rollups(snapshots: List[Dict[Any, float]]) -> Dict[str, Dict[str,
                                                                      float]]:
        """Per-task roll-ups: sum each process's task-labelled series.
        Counters are per-process monotonic totals, so summing the latest
        snapshot per process IS the cluster total."""
        tasks: Dict[str, Dict[str, float]] = {}
        for parsed in snapshots:
            for (name, labelkey), value in parsed.items():
                for field, family, extra in _ROLLUP_FIELDS:
                    if name != family:
                        continue
                    labels = dict(labelkey)
                    task = labels.get("task")
                    if not task or task == "-":
                        continue
                    if extra is not None and labels.get(extra[0]) != extra[1]:
                        continue
                    t = tasks.setdefault(task, {
                        f: 0.0 for f, _, _ in _ROLLUP_FIELDS})
                    t[field] += value
        for t in tasks.values():
            t["device_seconds"] = round(t["device_seconds"], 4)
        return tasks

    @staticmethod
    def _diag_metrics(snapshots: List[Dict[Any, float]],
                      ) -> List[List[Any]]:
        """Cluster-wide roll-ups of the diagnosis families (sums; MAX or
        MIN for the gauges named above), JSON-shaped as ``[name,
        {labels}, value]`` rows."""
        agg: Dict[Tuple[str, Any], float] = {}
        for parsed in snapshots:
            for (name, labelkey), value in parsed.items():
                if name not in DIAG_FAMILIES:
                    continue
                key = (name, labelkey)
                if key not in agg:
                    agg[key] = value
                elif name in _DIAG_GAUGE_MAX:
                    agg[key] = max(agg[key], value)
                elif name in _DIAG_GAUGE_MIN:
                    agg[key] = min(agg[key], value)
                else:
                    agg[key] = agg[key] + value
        return [[name, dict(labelkey), value]
                for (name, labelkey), value in sorted(agg.items())]

    def summary(self, registry: Registry = REGISTRY) -> Dict[str, Any]:
        """The /statusz telemetry section: per-process push health and
        the per-task roll-ups (collector state + this process's own
        registry)."""
        snap = self._snapshot(spans=False)
        # a process that pushed to its own collector contributes through
        # the live registry below, not its (staler) pushed snapshot
        parsed = [st["metrics"] for proc, st in snap.items()
                  if proc != PROC_ID]
        parsed.append(self._parsed_local(registry))
        return {
            "procs": {
                proc: dict(
                    {k: v for k, v in st.items()
                     if k not in ("spans", "metrics", "sections")},
                    **_proc_obs(st["metrics"]))
                for proc, st in snap.items()},
            "tasks": self._rollups(parsed),
        }

    # -- the assembler -----------------------------------------------------

    def cluster_doc(self, tracer: Tracer = TRACER,
                    registry: Registry = REGISTRY) -> Dict[str, Any]:
        """ONE merged, Perfetto-loadable Chrome-trace object: this
        process's span ring plus every pushed process's spans, all
        timestamps shifted onto THIS process's monotonic timebase, one
        Perfetto process track per cluster process.  Cluster aggregates
        ride under ``mrtpuCluster`` (ignored by Perfetto)."""
        snap = self._snapshot()
        # local process first (offset 0 by definition); pushed processes
        # in stable order.  A process that pushed to ITSELF is
        # recognised by PROC_ID and its pushed copy skipped — the live
        # ring is the fresher truth.
        tracks: List[Tuple[str, Dict[str, Any]]] = [(PROC_ID, {
            "role": self.local_role, "offset": 0.0,
            "spans": tracer.events(), "pushes": None, "missed": 0,
        })]
        for proc in sorted(snap):
            if proc != PROC_ID:
                tracks.append((proc, snap[proc]))
        events: List[Dict[str, Any]] = []
        procs_out: Dict[str, Any] = {}
        for idx, (proc, st) in enumerate(tracks, start=1):
            # synthetic pid per process: os pids can collide across
            # hosts, and a stable small index keeps Perfetto tracks tidy
            events.append({"name": "process_name", "ph": "M", "pid": idx,
                           "tid": 0,
                           "args": {"name": f"{st['role']} [{proc}]"}})
            off_us = (st.get("offset") or 0.0) * 1e6
            for e in st["spans"]:
                if not isinstance(e, dict):
                    continue
                e2 = dict(e)
                e2["pid"] = idx
                try:
                    e2["ts"] = round(float(e.get("ts", 0.0)) + off_us, 1)
                except (TypeError, ValueError):
                    continue
                events.append(e2)
            procs_out[proc] = {
                "track_pid": idx, "role": st["role"],
                "offset_s": (None if st.get("offset") is None
                             else round(st["offset"], 6)),
                "pushes": st.get("pushes"),
                "missed": st.get("missed", 0),
                "spans": len(st["spans"]),
                "last_push_age_s": st.get("last_push_age_s"),
            }
        parsed = [st["metrics"] for _, st in tracks[1:]
                  if st.get("metrics")]
        parsed.append(self._parsed_local(registry))
        cluster: Dict[str, Any] = {
            "aligned_to": PROC_ID,
            "procs": procs_out,
            "tasks": self._rollups(parsed),
            "metrics": self._diag_metrics(parsed),
        }
        if self.history is not None:
            # trend windows computed from PERSISTED deltas travel with
            # the cluster doc, so `cli diagnose` gets the same findings
            # live, offline on a saved trace, and across restarts
            try:
                cluster["history"] = self.history.trends()
            except (OSError, HistoryCorruptError) as exc:
                cluster["history"] = {"error": str(exc)}
        # the alert plane rides the cluster doc the way the control
        # ledger's decisions do: diagnose cross-references a firing
        # alert into its findings live AND offline on a saved trace
        from . import alerts as _alerts

        alert_snap = _alerts.alerts_snapshot()
        if alert_snap:
            cluster["alerts"] = alert_snap
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"clock": "monotonic", "aligned_to": PROC_ID},
            "mrtpuCluster": cluster,
        }


def _process_sections(registry: Registry) -> Dict[str, Any]:
    """This process's engine-side /statusz sections, pushed beside its
    metrics so a docserver that runs no engine can show them (a JAX
    collector ignores the field)."""
    from .statusz import process_sections  # late: statusz pulls coord

    return process_sections(registry)


class TelemetryPusher:
    """Client half: batch this process's telemetry to a collector.

    Design contract — telemetry can never block or fail a job:

    * its OWN :class:`~..utils.httpclient.FailoverClient` with a short
      deadline and a circuit breaker (a dead collector costs a bounded
      backlog, never a heartbeat's lock);
    * :meth:`flush` never raises; failed batches wait in a bounded
      backlog, whose overflow (and anything still undelivered at
      :meth:`stop`) is counted in ``mrtpu_telemetry_dropped_total``;
    * the push carries ``time.monotonic()`` at send time, which is all
      the collector needs for clock alignment.
    """

    def __init__(self, address: str, auth_token: Optional[str] = None,
                 role: str = "proc", interval: float = 1.0,
                 max_backlog: int = 20_000,
                 registry: Registry = REGISTRY,
                 tracer: Tracer = TRACER) -> None:
        # lazy import: utils.httpclient imports obs.metrics at module
        # scope, so a top-level import here would cycle when the package
        # is first entered through httpclient
        from ..utils.httpclient import FailoverClient, RetryPolicy

        self._client = FailoverClient(
            address, what="telemetry collector", auth_token=auth_token,
            retry=RetryPolicy(max_attempts=2, base_delay=0.05,
                              max_delay=0.25, deadline=3.0,
                              breaker_threshold=4, breaker_cooldown=2.0))
        self.role = role or "proc"
        self.interval = max(float(interval), 0.05)
        self.max_backlog = max(int(max_backlog), 1)
        self._registry = registry
        self._tracer = tracer
        self._last_seq = 0
        # (ring seq, event) pairs: the seqs travel in the payload so the
        # collector can ingest idempotently
        self._backlog: List[Tuple[int, Dict[str, Any]]] = []
        #: CUMULATIVE spans lost over this pusher's lifetime (reported
        #: as-is; the collector keeps the max)
        self._missed_total = 0
        self._flush_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TelemetryPusher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"mrtpu-telemetry-{self.role}")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.flush()

    def flush(self) -> bool:
        """Send everything pending in one batch; True on delivery.
        Never raises — a failure parks the batch in the (bounded)
        backlog for the next flush."""
        with self._flush_lock:
            seq, fresh, missed = self._tracer.events_since(self._last_seq)
            first_seq = seq - len(fresh) + 1  # ring seqs are contiguous
            self._last_seq = seq
            if missed:
                _DROPPED.inc(missed, reason="ring")
                self._missed_total += missed
            self._backlog.extend(
                (first_seq + i, e) for i, e in enumerate(fresh))
            over = len(self._backlog) - self.max_backlog
            if over > 0:
                del self._backlog[:over]
                _DROPPED.inc(over, reason="backlog")
                self._missed_total += over
            payload = {
                "proc": PROC_ID,
                "role": self.role,
                "pid": os.getpid(),
                "missed": self._missed_total,
                "spans": [e for _, e in self._backlog],
                "span_seqs": [s for s, _ in self._backlog],
                "metrics": self._registry.render(),
                "sections": _process_sections(self._registry),
                # stamped LAST: the closer to the actual send, the
                # tighter the collector's offset estimate
                "t_mono": time.monotonic(),
            }
            try:
                body = json.dumps(payload, default=float).encode()
                status, _raw = self._client.request(
                    "POST", TELEMETRY_PATH, body=body,
                    headers={"Content-Type": "application/json"})
            except Exception as exc:
                # ANY failure (retry exhaustion, open breaker, refused
                # socket) degrades to "try again next interval"
                _PUSHES.inc(outcome="error")
                logger.debug("telemetry push failed: %s", exc)
                return False
            if status != 200:
                _PUSHES.inc(outcome="error")
                logger.debug("telemetry push rejected: HTTP %d", status)
                return False
            _PUSHES.inc(outcome="ok")
            self._backlog.clear()
            return True

    def stop(self, flush: bool = True) -> None:
        """Stop the background thread; one best-effort final flush, then
        count anything still undelivered as dropped."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 5.0)
            self._thread = None
        delivered = self.flush() if flush else False
        if not delivered:
            with self._flush_lock:
                if self._backlog:
                    _DROPPED.inc(len(self._backlog), reason="shutdown")
                    self._missed_total += len(self._backlog)
                    self._backlog.clear()
        self._client.close()


class _PusherLease:
    """Refcounted handle on a process-shared :class:`TelemetryPusher`
    (see :func:`acquire_pusher`)."""

    def __init__(self, address: str, pusher: TelemetryPusher) -> None:
        self.address = address
        self.pusher = pusher
        self.refs = 1


_SHARED_LOCK = threading.Lock()
_SHARED_PUSHERS: Dict[str, _PusherLease] = {}


def acquire_pusher(address: Optional[str], auth_token: Optional[str],
                   role: str, interval: float,
                   max_backlog: int = 20_000) -> Optional[_PusherLease]:
    """Lease the process's shared pusher for *address*, starting it on
    first acquire.  ONE pusher per (process, collector): every pusher
    drains the same process-global span ring under the same PROC_ID, so
    N workers in one process each running their own pusher would
    deliver every span N times.  The first acquirer's *role* labels the
    process.  Returns None (telemetry off, never an error) when
    *address* is empty, *interval* <= 0, or construction fails.  Pair
    with :func:`release_pusher`; the LAST release stops the pusher with
    a final flush."""
    if not address or interval is None or interval <= 0:
        return None
    with _SHARED_LOCK:
        lease = _SHARED_PUSHERS.get(address)
        if lease is not None:
            lease.refs += 1
            return lease
        try:
            pusher = TelemetryPusher(address, auth_token=auth_token,
                                     role=role, interval=interval,
                                     max_backlog=max_backlog).start()
        except Exception as exc:
            logger.warning("telemetry disabled: cannot push to %r (%s)",
                           address, exc)
            return None
        lease = _PusherLease(address, pusher)
        _SHARED_PUSHERS[address] = lease
        return lease


def release_pusher(lease: Optional[_PusherLease]) -> None:
    """Release a lease from :func:`acquire_pusher`; the last holder's
    release stops the pusher (final flush, undelivered spans counted)."""
    if lease is None:
        return
    with _SHARED_LOCK:
        lease.refs -= 1
        last = lease.refs <= 0
        if last and _SHARED_PUSHERS.get(lease.address) is lease:
            del _SHARED_PUSHERS[lease.address]
    if last:
        lease.pusher.stop()
