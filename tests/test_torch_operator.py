"""The port's operator plane, status and diagnosis half, against the JAX
package's, on the CPU.

Held equal (tolerance: none — these are pure functions over dicts, and
integer counters):

* ``cli.render_status`` over the same ``/statusz`` snapshot, every
  section present (alerts and history included), and
  ``obs.analysis.render_diagnosis`` over the same report: identical text
  but for the port's words for its own build — the build line names
  torch and CUDA where the JAX one names jax, and a build's seconds are
  "building" where the JAX text says "in XLA";
* ``obs.analysis.diagnose`` over the same ``/clusterz`` documents
  (stragglers, skew from both planes, the exchange-matrix fallback,
  hotspots, compile, memory, control, comms, the critical path, the
  scheduler, durability, SLO, trends and alerts), and over a document
  taken from a port run at P = 8 on the CPU;
* ``obs.statusz.cluster_status`` over two boards with the same contents
  (its ``now``, ``build``, ``device`` and ``memory`` name the process);
* ``obs.comms``' roll-ups and ``record_exchange``'s counters, and the
  exchange counters of a P = 8 device word count against the JAX lax
  engine on its 8-device CPU mesh;
* ``obs.slo``'s objective parser and ``SloPlane.evaluate``.
"""

import dataclasses
import math
import uuid

import pytest

from mapreduce_tpu import cli as jcli
from mapreduce_tpu.coord.docstore import MemoryDocStore as JMemoryDocStore
from mapreduce_tpu.engine import wordcount as jwc
from mapreduce_tpu.obs import analysis as janalysis
from mapreduce_tpu.obs import comms as jcomms
from mapreduce_tpu.obs import metrics as jmetrics
from mapreduce_tpu.obs import slo as jslo
from mapreduce_tpu.obs import statusz as jstatusz
from mapreduce_tpu.obs.trace import TRACER as JTRACER
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu.sched import scheduler as jsched
from mapreduce_tpu_torch import cli as tcli
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.coord.docstore import MemoryDocStore
from mapreduce_tpu_torch.engine import wordcount as twc
from mapreduce_tpu_torch.obs import analysis as tanalysis
from mapreduce_tpu_torch.obs import comms as tcomms
from mapreduce_tpu_torch.obs import metrics as tmetrics
from mapreduce_tpu_torch.obs import slo as tslo
from mapreduce_tpu_torch.obs import statusz as tstatusz
from mapreduce_tpu_torch.obs.collector import Collector
from mapreduce_tpu_torch.obs.trace import TRACER as TTRACER
from mapreduce_tpu_torch.parallel import mesh as tmesh
from mapreduce_tpu_torch.sched import scheduler as tsched
from tests.test_torch_device_obs import CHUNK, DATA, WAVES
from tests.test_torch_wordcount import CFG

# -- the port's words for its own build ---------------------------------------


def _jax_words(text: str) -> str:
    """A port text in the JAX package's words for a build (the one
    wording the two packages do not share)."""
    return text.replace("s building", "s in XLA")


def _jax_report(report):
    """A port diagnose report with its notes in the JAX words."""
    return dict(report, notes=[_jax_words(n) for n in report["notes"]])


# -- render_status -------------------------------------------------------------


def _full_snapshot():
    """A /statusz snapshot with every section render_status draws."""
    return {
        "now": 1000.0,
        "build": {"version": "0.1.0", "python": "3.12.1", "jax": "0.4.30",
                  "torch": "2.5.1", "cuda": "12.4", "backend": "cuda",
                  "device_kind": "NVIDIA H100 80GB HBM3"},
        "ha": {"role": "primary", "generation": 2,
               "lease": {"holder": "h:1"}, "log_appended": 10,
               "log_replayed": 3, "log_bytes": 900,
               "replay_lag_bytes": 7, "promotions": 1,
               "failed": "log dir gone"},
        "device": {"waves": 4, "retries": 1,
                   "seconds": {"upload": 0.5, "compute": 1.25,
                               "readback": 0.1},
                   "flops_total": 3e9, "bytes_total": 2e9, "mfu": 0.0012,
                   "roofline_frac": 0.03, "model_flops_per_s": 1.2e9,
                   "arith_intensity": 1.5},
        "compile": {"buckets": 3, "total_compile_s": 7.5,
                    "cache_dir": None,
                    "programs": {
                        "wave": {"compiled": 1, "persistent_hit": 2,
                                 "cached": 5, "compile_s": 3.0,
                                 "last_compile_s": 1.0},
                        "nvcc:radix": {"compiled": 1, "compile_s": 4.5,
                                       "last_compile_s": 4.5}}},
        "memory": {"devices": {"cuda:0": {"bytes_in_use": 1e9,
                                          "peak_bytes_in_use": 2e9,
                                          "bytes_limit": 8e10},
                               "cuda:1": {"bytes_in_use": 5}},
                   "device_source": "measured",
                   "programs": {"wave": {"total": 5e8, "arguments": 1e8,
                                         "outputs": 2e8, "temp": 2e8,
                                         "source": "analytic"}},
                   "donation": {"wave": {"bytes": 1e6,
                                         "donated_bytes": 2e6,
                                         "source": "analytic"}}},
        "comms": {"exchange": {"records": 1000, "bytes": 12000,
                               "partitions": 8, "imbalance_send": 1.1,
                               "imbalance_recv": 3.5, "hot_dst": 2,
                               "hot_dst_share": 0.44,
                               "bytes_by_link": {"self": 12000,
                                                 "host": 10},
                               "modeled_exchange_s": 3.6e-9,
                               "exchange_frac_of_compute": 1e-8,
                               "peak_source": "datasheet"},
                  "upload_overlap_frac": 0.75},
        "checkpoint": {"saves": 3, "last_saved_step": 12,
                       "restores_ok": 1, "restores_corrupt": 1,
                       "corrupt_shards": 2, "fallbacks": 1, "gc": 2,
                       "lease_fences": 1, "recovery_s": 0.25},
        "sched": {"config": {"max_inflight": 2}, "inflight": 1,
                  "lease": {"holder": "runner-1", "generation": 3},
                  "tenants": {"acme": {"queued": 1, "running": 1,
                                       "done": 2, "queued_jobs": 4,
                                       "queued_bytes": 100,
                                       "served_records": 5000,
                                       "oldest_queued_age_s": 1.5},
                              "beta": {}}},
        "fleet": {"hosts": {"h:1": {"state": "live", "generation": 1,
                                    "lease_expires_in": 4.2,
                                    "streams": 2, "warm_programs": 3,
                                    "hbm_frac": 0.5},
                            "h:2": {"state": "left", "generation": 2}},
                  "routes": 2, "routes_unhosted": 1},
        "slo": {"objectives": [
            {"name": "queue_wait", "pct": "p99", "threshold_s": 1e-06,
             "long_window_s": 600.0, "short_window_s": 60.0},
            {"name": "submit_first_result", "pct": "p99",
             "threshold_s": 120.0, "long_window_s": 600.0,
             "short_window_s": 60.0}],
            "tenants": {"acme": {
                "queue_wait": {"p": 0.003, "n": 4, "window_n": 4,
                               "burn_short": 100.0, "burn_long": 100.0,
                               "budget_remaining": 0.0,
                               "breaching": True},
                "submit_first_result": {"p": None, "n": 0,
                                        "window_n": 0}}}},
        "control": {"counts": {"repartition": {"applied": 1}},
                    "decisions": [{"controller": "repartition", "id": 1,
                                   "task": "t", "outcome": "improved",
                                   "age_s": 3.0, "note": "rebalanced"}]},
        "alerts": {"rules": [{"name": "r"}], "counts": {"firing": 1},
                   "log": {"seq": 3, "generation": 1, "skipped_stale": 1},
                   "instances": [
                       {"state": "firing", "rule": "r",
                        "labels": {"tenant": "acme"}, "age_s": 5,
                        "value": 3.2, "suppressed": True, "acked": True},
                       {"state": "pending", "rule": "q", "age_s": 1},
                       {"state": "inactive", "rule": "z"}],
                   "silences": [{"id": 1, "rule": "r",
                                 "expires_in_s": 30}]},
        "telemetry": {"tasks": {"t": {"records": 100, "bytes": 2000,
                                      "device_seconds": 0.5,
                                      "flops": 1e6}},
                      "procs": {"p1": {"role": "runner", "pushes": 3,
                                       "last_push_age_s": 0.4,
                                       "missed": 2}}},
        "history": {"segments": 2, "bytes": 1000, "entries": 10,
                    "series": 5, "procs": 2, "oldest_t": 100.0,
                    "newest_t": 160.0, "rotations": 1, "gc_segments": 0,
                    "keep_segments": 8},
        "tasks": {
            "db1": {"status": 3, "iteration": 2, "device": True,
                    "phases": {"map": {"FINISHED": 3, "RUNNING": 1},
                               "reduce": {}},
                    "trainer": {"holder": "tr-1", "generation": 4,
                                "held": True, "lease_expires_in": 2.5},
                    "workers": {"w1": {"alive": True, "running": 1,
                                       "jobs": 2,
                                       "lease_expires_in": 3.0},
                                "w2": {"alive": False, "running": 0,
                                       "jobs": 1,
                                       "lease_expires_in": None},
                                "w3": {"alive": False, "running": 1,
                                       "jobs": 1,
                                       "lease_expires_in": -2.0}},
                    "errors": 2,
                    "stats": {"map": {"count": 3, "failed": 0,
                                      "sum_cpu_time": 1.5},
                              "reduce": {"count": 1, "failed": 1,
                                         "sum_cpu_time": 0.25},
                              "cluster_time": 2.0, "iteration": 2,
                              "device": {"waves": 4, "upload_s": 0.5,
                                         "compute_s": 1.0,
                                         "readback_s": 0.1,
                                         "mfu": 0.001}}},
            "db2": {"status": 1, "iteration": 1, "phases": {},
                    "workers": {}}},
    }


def _snapshots():
    full = _full_snapshot()
    bare = {"now": 1.0, "tasks": {}}
    broken = dict(full, history={"error": "history directory unreadable"},
                  compile=dict(full["compile"], cache_dir="/c"))
    return {"full": full, "no_tasks": bare, "history_error": broken}


@pytest.mark.parametrize("name", ["full", "no_tasks", "history_error"])
def test_render_status_text_equals_jax(name):
    snap = _snapshots()[name]
    port = tcli.render_status(snap).split("\n")
    jax = jcli.render_status(snap).split("\n")
    if snap.get("build"):
        assert port[0] == ("build: mrtpu 0.1.0 | python 3.12.1 | torch "
                           "2.5.1 | cuda 12.4 | backend cuda (NVIDIA H100 "
                           "80GB HBM3)")
        assert jax[0].startswith("build: mrtpu 0.1.0 | python 3.12.1 | jax")
        port, jax = port[1:], jax[1:]
    assert [_jax_words(line) for line in port] == jax
    if name == "full":
        text = "\n".join(port)
        for needle in ("device plane (4 waves", "compile ledger",
                       "7.5s building", "device memory:",
                       "comms (exchange & dataflow):", "scheduler:",
                       "serving SLOs", "BREACHING", "engine fleet",
                       "control plane", "alerts:", "history:",
                       "[db1]", "  device: 4 waves"):
            assert needle in text, needle


# -- diagnose: the documents ---------------------------------------------------


def _x(name, ts_s, dur_s, pid=1, **args):
    return {"name": name, "ph": "X", "ts": round(ts_s * 1e6, 1),
            "dur": round(dur_s * 1e6, 1), "pid": pid, "tid": 1,
            "args": args}


def _doc(events, metrics, **cluster):
    c = {"aligned_to": "self", "procs": {}, "tasks": {},
         "metrics": metrics}
    c.update(cluster)
    return {"traceEvents": events, "mrtpuCluster": c}


def _straggler_doc():
    events = [_x("job", 1.0 + i, 0.02, worker="w_fast", phase="map")
              for i in range(6)]
    events += [_x("job", 8.0 + i, 0.40, worker="w_slow", phase="map")
               for i in range(3)]
    events += [_x("claim", 1.0, 0.005, worker="w_fast"),
               _x("write", 2.0, 0.008, worker="w_fast"),
               _x("run", 2.5, 0.3, worker="w_slow")]
    metrics = [
        ["mrtpu_partition_records_total",
         {"task": "t", "phase": "map", "partition": "P00000"}, 900],
        ["mrtpu_partition_records_total",
         {"task": "t", "phase": "map", "partition": "P00001"}, 60],
        ["mrtpu_partition_records_total",
         {"task": "t", "phase": "map", "partition": "P00002"}, 40],
        ["mrtpu_partition_bytes_total",
         {"task": "t", "phase": "map", "partition": "P00000"}, 9000],
        ["mrtpu_http_retries_total", {"endpoint": "h:1"}, 7],
        ["mrtpu_worker_jobs_total",
         {"worker": "w_fast", "outcome": "broken"}, 2],
        ["mrtpu_worker_jobs_total",
         {"worker": "w_fast", "outcome": "ok"}, 20],
        ["mrtpu_docserver_requests_total",
         {"op": "find", "outcome": "error"}, 3],
    ]
    return _doc(events, metrics)


def _device_skew_doc():
    """A skewed device partition through its gauges, and the exchange
    counters beside it."""
    metrics = []
    for p, n in enumerate([5000, 300, 250, 200, 150, 100, 50, 25]):
        metrics.append(["mrtpu_device_partition_records",
                        {"task": "skewed", "partition": f"P{p:05d}"}, n])
        metrics.append(["mrtpu_device_partition_bytes",
                        {"task": "skewed", "partition": f"P{p:05d}"},
                        12 * n])
        metrics.append(["mrtpu_device_partition_records",
                        {"task": "even", "partition": f"P{p:05d}"}, 100])
    for s in range(8):
        for d in range(8):
            n = 600 if d == 0 else 20
            metrics.append(["mrtpu_exchange_records_total",
                            {"task": "skewed", "src": f"D{s:03d}",
                             "dst": f"D{d:03d}"}, n])
    metrics += [["mrtpu_comms_bytes_total",
                 {"link": "self", "task": "skewed"}, 12 * 5920],
                ["mrtpu_comms_modeled_exchange_seconds", {}, 2.6e-8],
                ["mrtpu_comms_exchange_frac_of_compute", {}, 1.3e-6]]
    return _doc([], metrics)


def _matrix_fallback_doc():
    """No device partition gauges survived: skew from the exchange
    matrix's receive totals."""
    metrics = []
    for s in range(4):
        for d in range(4):
            metrics.append(["mrtpu_exchange_records_total",
                            {"task": "m", "src": f"D{s:03d}",
                             "dst": f"D{d:03d}"}, 90 if d == 3 else 3])
            metrics.append(["mrtpu_exchange_bytes_total",
                            {"task": "m", "src": f"D{s:03d}",
                             "dst": f"D{d:03d}"}, 1080 if d == 3 else 36])
    return _doc([], metrics)


def _clean_doc():
    events = ([_x("job", 1 + i, 0.02 + 0.001 * i, worker="a")
               for i in range(4)]
              + [_x("job", 9 + i, 0.021 + 0.001 * i, worker="b")
                 for i in range(4)])
    return _doc(events, [
        ["mrtpu_partition_records_total",
         {"task": "t", "partition": "P00000"}, 50],
        ["mrtpu_partition_records_total",
         {"task": "t", "partition": "P00001"}, 55]])


def _metrics_fallback_doc():
    return _doc([], [
        ["mrtpu_worker_job_seconds_sum", {"worker": "a"}, 0.10],
        ["mrtpu_worker_job_seconds_count", {"worker": "a"}, 5],
        ["mrtpu_worker_job_seconds_sum", {"worker": "b"}, 4.0],
        ["mrtpu_worker_job_seconds_count", {"worker": "b"}, 5]])


def _rich_doc():
    """Every finding section at once: the device timeline, compile and
    capacity-retry forensics, control decisions, SLO gauges, the
    scheduler, durability, fleet, trends and alerts."""
    doc = _straggler_doc()
    skew = _device_skew_doc()["mrtpuCluster"]["metrics"]
    ev = doc["traceEvents"]
    ev += [_x("device_run", 20.0, 2.0, pid=2, span_id="dr"),
           _x("wave", 20.0, 1.0, pid=2, span_id="w0", parent_id="dr"),
           _x("upload", 20.0, 0.6, pid=2, parent_id="w0"),
           _x("compute", 20.5, 0.4, pid=2, parent_id="w0"),
           _x("readback", 20.95, 0.05, pid=2, parent_id="w0"),
           _x("wave", 21.0, 1.0, pid=2, span_id="w1", parent_id="dr"),
           _x("upload", 21.0, 0.5, pid=2, parent_id="w1"),
           _x("compute", 21.6, 0.3, pid=2, parent_id="w1"),
           _x("upload", 22.0, 0.2, pid=3),
           _x("wave", 22.1, 0.3, pid=3, span_id="w9"),
           _x("compile", 19.0, 6.5, pid=2, program="wave"),
           _x("compile", 18.0, 1.5, pid=2, program="nvcc:radix"),
           _x("capacity_retry", 20.9, 0.0, pid=2, task="skewed",
              attempt=1, overflow_rows=77, bound="capacity",
              program_memory={"total": 1e8},
              device_memory={"devices": {"0": {"bytes_limit": 8e10}}},
              new_capacities={"out": 4096}),
           _x("capacity_retry", 20.95, 0.0, pid=2, task="t2", attempt=1,
              overflow_rows=5, bound="hbm"),
           _x("control_decision", 23.0, 0.0, pid=2,
              controller="repartition", task="skewed", decision_id=1,
              outcome="applied", evidence={"imbalance_recv": 5.3},
              action={"map": [0]}, note="rebalanced hot partition"),
           _x("control_decision", 24.0, 0.0, pid=2,
              controller="repartition", task="skewed", decision_id=1,
              outcome="improved", evidence={"imbalance_recv": 5.3},
              outcome_evidence={"imbalance_recv_after": 1.2},
              note="rebalanced hot partition"),
           _x("control_decision", 25.0, 0.0, pid=1,
              controller="reclaim", task="t", decision_id=2,
              outcome="neutral", evidence={"worker": "w_slow"},
              note="re-claimed a straggler's job")]
    ev += [_x("control_decision", 26.0 + i, 0.0, pid=1,
              controller="capacity", task="t", decision_id=10 + i,
              outcome="applied") for i in range(9)]
    doc["mrtpuCluster"]["metrics"] += skew + [
        ["mrtpu_compile_seconds_sum", {"program": "wave",
                                       "stage": "build"}, 6.5],
        ["mrtpu_compile_seconds_count", {"program": "wave",
                                         "stage": "build"}, 2],
        ["mrtpu_device_memory_bytes", {"device": "0",
                                       "stat": "bytes_in_use"}, 7e10],
        ["mrtpu_device_memory_bytes", {"device": "0",
                                       "stat": "bytes_limit"}, 8e10],
        ["mrtpu_control_decisions_total",
         {"controller": "repartition", "outcome": "improved"}, 1],
        ["mrtpu_slo_percentile_seconds",
         {"tenant": "acme", "objective": "queue_wait", "pct": "p99"},
         0.004],
        ["mrtpu_slo_threshold_seconds",
         {"objective": "queue_wait", "pct": "p99"}, 1e-6],
        ["mrtpu_slo_burn_rate", {"tenant": "acme",
                                 "objective": "queue_wait",
                                 "window": "long"}, 100.0],
        ["mrtpu_slo_burn_rate", {"tenant": "acme",
                                 "objective": "queue_wait",
                                 "window": "short"}, 50.0],
        ["mrtpu_slo_breach_total", {"tenant": "acme",
                                    "objective": "queue_wait"}, 4],
        ["mrtpu_sched_oldest_queued_age_seconds", {"tenant": "acme"}, 90],
        ["mrtpu_session_stream_age_seconds",
         {"task": "s1", "stamp": "feed"}, 2.5],
        ["mrtpu_sched_queue_depth", {"tenant": "acme",
                                     "state": "queued"}, 2],
        ["mrtpu_sched_admission_total",
         {"tenant": "acme", "outcome": "rejected",
          "reason": "queued_tasks"}, 3],
        ["mrtpu_sched_served_records_total", {"tenant": "acme"}, 9000],
        ["mrtpu_session_overflow_rows_total", {"task": "s1"}, 12],
        ["mrtpu_board_promotions_total", {}, 1],
        ["mrtpu_board_fences_total", {}, 2],
        ["mrtpu_board_replayed_rid_refusals_total", {}, 1],
        ["mrtpu_client_failovers_total", {"endpoint": "h:2"}, 3],
        ["mrtpu_session_backpressure_total", {"task": "s1"}, 4],
        ["mrtpu_session_spills_total", {"task": "s1"}, 2],
        ["mrtpu_session_restores_total", {"task": "s1"}, 1],
        ["mrtpu_fleet_hosts", {"state": "live"}, 2],
        ["mrtpu_fleet_hosts", {"state": "expired"}, 1],
        ["mrtpu_session_migrations_total", {"reason": "rebalance",
                                            "task": "s1"}, 1],
        ["mrtpu_fleet_recoveries_total", {"host": "h:3"}, 2],
        ["mrtpu_alert_transitions_total", {"to": "firing"}, 2],
        ["mrtpu_alert_notifications_total", {"sink": "pager",
                                             "outcome": "delivered"}, 1],
    ]
    doc["mrtpuCluster"]["procs"] = {"a": {"role": "server"},
                                    "b": {"role": "runner"}}
    doc["mrtpuCluster"]["tasks"] = {"skewed": {"records": 6000,
                                               "bytes": 72000,
                                               "device_seconds": 0.7,
                                               "flops": 3e6}}
    doc["mrtpuCluster"]["history"] = {
        "window_s": 300, "span_s": 900, "entries": 40, "procs": 2,
        "compute_s_per_wave": {"old": 0.1, "new": 0.3, "ratio": 3.0},
        "rates": [{"name": "mrtpu_http_retries_total", "rate_old": 0.0,
                   "rate_new": 0.5, "ratio": None}],
        "burn": [{"tenant": "acme", "objective": "queue_wait",
                  "burn": 4.0}],
        "offset_jumps": {"b": {"jump_s": 1.25}}}
    doc["mrtpuCluster"]["alerts"] = {
        "rules": [{"name": "slo"}], "counts": {"firing": 1},
        "instances": [{"state": "firing", "rule": "slo",
                       "labels": {"tenant": "acme",
                                  "objective": "queue_wait"},
                       "age_s": 30, "value": 100.0, "acked": True},
                      {"state": "pending", "rule": "other",
                       "pending_for_s": 3}],
        "silences": []}
    return doc


def _port_p8_doc():
    """A /clusterz document of a port P = 8 device word count on the CPU
    (the run's own spans and this process's diagnosis families)."""
    task = "op" + uuid.uuid4().hex[:8]
    tcfg = convert.engine_config_from_jax(dataclasses.asdict(CFG))
    wc = twc.DeviceWordCount(tmesh.Partitions(8, "cpu"), chunk_len=CHUNK,
                             config=tcfg)
    chunks, L = wc._to_chunks(DATA)
    eng = wc._engine_for(L)
    eng.task_label = task
    with TTRACER.span("root") as root:
        eng.run(chunks, timings={}, waves=WAVES)
    doc = Collector().cluster_doc()
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if e.get("ph") == "M" or e["args"].get(
                              "trace_id") == root.trace_id]
    return doc


DOCS = {"straggler": _straggler_doc, "device_skew": _device_skew_doc,
        "matrix_fallback": _matrix_fallback_doc, "clean": _clean_doc,
        "metrics_fallback": _metrics_fallback_doc, "rich": _rich_doc,
        "port_p8_cpu": _port_p8_doc}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_diagnose_report_equals_jax(name):
    doc = DOCS[name]()
    port = tanalysis.diagnose(doc)
    assert _jax_report(port) == janalysis.diagnose(doc)
    assert (_jax_words(tanalysis.render_diagnosis(port))
            == janalysis.render_diagnosis(janalysis.diagnose(doc)))


def test_diagnose_findings_on_the_fixtures():
    """What the documents are built to show, read off the port's
    reports."""
    rep = tanalysis.diagnose(_straggler_doc())
    assert [s["worker"] for s in rep["stragglers"]] == ["w_slow"]
    assert [(s["plane"], s["partition"]) for s in rep["skew"]] \
        == [("host", "P00000")]
    assert {h["metric"] for h in rep["hotspots"]} == {
        "mrtpu_http_retries_total", "mrtpu_worker_jobs_total",
        "mrtpu_docserver_requests_total"}
    rep = tanalysis.diagnose(_device_skew_doc())
    assert [(s["task"], s["partition"], s["source"]) for s in rep["skew"]] \
        == [("skewed", "P00000", "partition_gauges")]
    assert rep["comms"]["exchange"]["skewed"]["hot_dst"] == "D000"
    rep = tanalysis.diagnose(_matrix_fallback_doc())
    assert rep["skew"][0]["source"] == "exchange_matrix"
    rep = tanalysis.diagnose(_rich_doc())
    text = tanalysis.render_diagnosis(rep)
    assert "program wave: 6.50s building" in text
    assert any("spent 6.5s building" in n for n in rep["notes"])
    acted = [s.get("acted", "") for s in rep["skew"]
             if s["task"] == "skewed"]
    assert acted and acted[0].startswith("rebalanced")
    assert rep["slo"]["objectives"][0]["alerted"] == "slo"
    assert rep["critical_path"]["upload_overlap_frac_by_proc"]
    assert rep["phases"]["device"]["wave_s"] > 0
    assert "HISTORY TRENDS" in text and "FIRING slo" in text
    rep = tanalysis.diagnose(_port_p8_doc())
    assert set(rep["phases"]["device"]) >= {"wave_s", "upload_s",
                                            "compute_s", "readback_s"}
    assert rep["comms"]["exchange"], "no exchange rows in the port doc"
    assert rep["comms"]["bytes_by_link"].get("host", 0) > 0


# -- cluster_status over two boards ---------------------------------------------


NOW = 5000.0


def _fill_board(store, sched_mod):
    """The same board contents on either package's store: two task dbs
    (jobs, workers, a trainer lease, errors, a stats doc) and a
    scheduler with queued, admitted and finished tasks."""
    store.insert("wc.task", {"_id": "unique", "status": 3, "iteration": 2,
                             "device": True,
                             "stats": {"map": {"count": 3},
                                       "device": {"waves": 2}}})
    store.insert_many("wc.map_jobs", [
        {"_id": "m0", "status": 2, "worker": "w1",
         "lease_expires": NOW + 3.0},
        {"_id": "m1", "status": 3, "worker": "w1",
         "lease_expires": NOW + 5.0},
        {"_id": "m2", "status": 2, "worker": "w2",
         "lease_expires": NOW - 4.0},
        {"_id": "m3", "status": 0},
        {"_id": "m4", "status": 4, "worker": "server",
         "lease_expires": NOW}])
    store.insert_many("wc.red_jobs", [
        {"_id": "r0", "status": 1, "worker": "w3",
         "lease_expires": NOW + 1.0}])
    store.insert_many("wc.errors", [{"_id": "e0", "msg": "boom"},
                                    {"_id": "e1", "msg": "bang"}])
    store.insert("tr.task", {"_id": "unique", "status": 2,
                             "iteration": 1})
    store.insert("tr.trainer_lease", {"_id": "trainer", "holder": "t-1",
                                      "generation": 3,
                                      "lease_expires": NOW + 7.5})
    s = sched_mod.Scheduler(store, config=sched_mod.SchedulerConfig(
        max_inflight=1))
    s.submit("acme", est_jobs=3, est_bytes=10, db="a0")
    s.submit("acme", est_jobs=1, db="a1")
    s.submit("beta", est_jobs=2, db="b0")
    s.tick()
    s.mark_running(s.list_tasks(state="ADMITTED")[0]["_id"])
    s.mark_done(s.list_tasks(state="RUNNING")[0]["_id"], records=40)
    s.tick()
    return s


def _sections(status_mod, store, sched):
    out = status_mod.cluster_status(store, now=NOW, scheduler=sched)
    for key in ("now", "build", "device", "memory", "compile", "comms",
                "slo", "control", "checkpoint"):
        out.pop(key, None)
    out["sched"].pop("lease")
    for t in out["sched"]["tenants"].values():
        t.pop("oldest_queued_age_s", None)
    return out


def test_cluster_status_sections_equal_jax():
    """Board-derived sections: tasks (phases, workers with lease
    headroom, the trainer lease, errors, stats) and the scheduler.  The
    process-global sections (compile, comms, SLO, control, checkpoint)
    read each package's own process state; their producers are held
    equal in the tests beside this one."""
    tstore, jstore = MemoryDocStore(), JMemoryDocStore()
    tsch, jsch = _fill_board(tstore, tsched), _fill_board(jstore, jsched)
    try:
        port = _sections(tstatusz, tstore, tsch)
        jax = _sections(jstatusz, jstore, jsch)
    finally:
        tsch.release()
        jsch.release()
    assert port == jax
    wc = port["tasks"]["wc"]
    assert wc["workers"]["w1"]["alive"] and not wc["workers"]["w2"]["alive"]
    assert wc["errors"] == 2
    assert port["tasks"]["tr"]["trainer"] == {
        "holder": "t-1", "generation": 3, "lease_expires_in": 7.5,
        "held": True}
    assert set(port["sched"]["tenants"]) == {"acme", "beta"}


def test_cluster_status_sections_and_render():
    """The port's own /statusz carries the process sections it has data
    for, with the alerts and history rows off the page, and renders."""
    store = MemoryDocStore()
    sch = _fill_board(store, tsched)
    try:
        snap = tstatusz.cluster_status(store, collector=Collector(),
                                       scheduler=sch)
    finally:
        sch.release()
    assert {"now", "tasks", "device", "build", "sched",
            "telemetry"} <= set(snap)
    assert "alerts" not in snap and "history" not in snap
    assert "fleet" not in snap
    text = tcli.render_status(snap)
    assert "[wc]  status=3" in text and "scheduler:" in text


# -- comms ---------------------------------------------------------------------


def _matrix(P=8, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    m = rng.integers(0, 50, (P, P))
    m[:, 3] *= 9  # a hot destination
    m[1, 2] = 0
    return m.tolist()


def test_cpu_link_classes_equal_the_jax_cpu_mesh():
    import jax

    jdev = jax.devices()[:8]
    tdev = tmesh.partition_devices(8, "cpu")
    from mapreduce_tpu.parallel.mesh import device_link_matrix

    assert tmesh.device_link_matrix(tdev) == device_link_matrix(jdev)


def test_card_link_classes_are_self():
    """On one CUDA device every partition pair is a transpose in HBM.
    A stand-in ``cuda`` device: building a torch.device needs no card."""
    import torch

    devs = tmesh.partition_devices(8, torch.device("cuda", 0))
    assert {c for row in tmesh.device_link_matrix(devs) for c in row} \
        == {"self"}
    by_link = tcomms.rollup_by_link(_matrix(), 12, devs)
    assert by_link["self"] == 12 * sum(map(sum, _matrix()))
    assert by_link["nvlink"] == by_link["pcie"] == by_link["host"] == 0


def test_link_peaks_datasheet_and_overrides(monkeypatch):
    peaks = tmesh.link_peaks()
    assert (peaks["self"], peaks["nvlink"], peaks["pcie"]) \
        == (3.35e12, 450e9, 64e9)
    assert peaks["peak_source"] == "datasheet"
    monkeypatch.setenv("MAPREDUCE_TPU_PEAK_NVLINK_BYTES_PER_S", "1e9")
    peaks = tmesh.link_peaks()
    assert peaks["nvlink"] == 1e9 and peaks["peak_source"] == "env:nvlink"


@pytest.mark.parametrize("seed", [0, 1])
def test_comms_rollups_equal_jax(seed, monkeypatch):
    """The same matrix on the 8-device CPU mesh and 8 CPU partitions:
    equal stats, link roll-ups (every class either package names), and
    modeled seconds under the same self peak (the packages' datasheets
    differ: v5e HBM and H100 HBM)."""
    import jax

    monkeypatch.setenv("MAPREDUCE_TPU_PEAK_SELF_BYTES_PER_S", "2e12")
    m = _matrix(seed=seed)
    assert tcomms.matrix_stats(m) == jcomms.matrix_stats(m)
    tlink = tcomms.rollup_by_link(m, 12, tmesh.partition_devices(8, "cpu"))
    jlink = jcomms.rollup_by_link(m, 12, jax.devices()[:8])
    assert {k: v for k, v in tlink.items() if v} \
        == {k: v for k, v in jlink.items() if v}
    assert set(tlink) == {"self", "nvlink", "pcie", "host"}
    assert tcomms.modeled_exchange_seconds(tlink, 8) \
        == jcomms.modeled_exchange_seconds(jlink, 8)


def _exchange_counts(reg, task):
    fam = reg.counter("mrtpu_exchange_records_total")
    out = {}
    for line in fam.samples():
        labels = dict(kv.split("=", 1) for kv in line[
            line.index("{") + 1:line.index("}")].split(","))
        labels = {k: v.strip('"') for k, v in labels.items()}
        if labels["task"] == task:
            out[(labels["src"], labels["dst"])] = float(line.split()[-1])
    return out


def test_record_exchange_counters_equal_jax(monkeypatch):
    import jax

    monkeypatch.setenv("MAPREDUCE_TPU_PEAK_SELF_BYTES_PER_S", "2e12")
    m = _matrix(seed=2)
    ttask, jtask = "rx" + uuid.uuid4().hex[:6], "rx" + uuid.uuid4().hex[:6]
    tder = tcomms.record_exchange(m, 12, task=ttask,
                                  devices=tmesh.partition_devices(8, "cpu"),
                                  compute_s=0.5)
    jder = jcomms.record_exchange(m, 12, task=jtask,
                                  devices=jax.devices()[:8], compute_s=0.5)
    assert tder == jder
    treg, jreg = tmetrics.REGISTRY, jmetrics.REGISTRY
    assert _exchange_counts(treg, ttask) == _exchange_counts(jreg, jtask)
    assert len(_exchange_counts(treg, ttask)) == 63  # one zero cell
    for fam, labels in (("mrtpu_exchange_bytes_total", {"src": "D001",
                                                        "dst": "D003"}),
                        ("mrtpu_comms_bytes_total", {"link": "host"}),
                        ("mrtpu_comms_bytes_total", {"link": "self"})):
        assert treg.value(fam, task=ttask, **labels) \
            == jreg.value(fam, task=jtask, **labels) > 0
    for side in ("send", "recv"):
        assert treg.value("mrtpu_exchange_imbalance", side=side,
                          task=ttask) == jreg.value(
                              "mrtpu_exchange_imbalance", side=side,
                              task=jtask)
    snap = tcomms.comms_snapshot()
    tcomms.validate_comms({"kind": "mrtpu-comms", "version": 1,
                           "snapshot": snap})
    assert snap["exchange"]["task"] == ttask
    assert snap["exchange"]["bytes_by_link"] == tder[
        "exchange_bytes_by_link"]
    with pytest.raises(ValueError, match="row sums"):
        bad = dict(snap["exchange"], row_sums=[0] * 8)
        tcomms.validate_comms({"kind": "mrtpu-comms",
                               "snapshot": {"exchange": bad}})


def test_p8_wordcount_publishes_the_jax_exchange_counters():
    """A P = 8 device word count on the CPU publishes the JAX lax
    engine's ``mrtpu_exchange_records_total{src,dst}`` on its 8-device
    CPU mesh, and the run's timings carry the same roll-ups (the
    modeled seconds aside: the self peaks differ)."""
    ttask, jtask = "px" + uuid.uuid4().hex[:6], "px" + uuid.uuid4().hex[:6]
    jw = jwc.DeviceWordCount(make_mesh(8), chunk_len=CHUNK, config=CFG)
    chunks, L = jw._to_chunks(DATA)
    jeng = jw._engine_for(L)
    jeng.task_label = jtask
    jtm = {}
    with JTRACER.span("root"):
        jeng.run(chunks, timings=jtm, waves=WAVES)
    tcfg = convert.engine_config_from_jax(dataclasses.asdict(CFG))
    tw = twc.DeviceWordCount(tmesh.Partitions(8, "cpu"), chunk_len=CHUNK,
                             config=tcfg)
    chunks, L = tw._to_chunks(DATA)
    teng = tw._engine_for(L)
    teng.task_label = ttask
    ttm = {}
    teng.run(chunks, timings=ttm, waves=WAVES)
    port = _exchange_counts(tmetrics.REGISTRY, ttask)
    assert port and port == _exchange_counts(jmetrics.REGISTRY, jtask)
    for key in ("exchange", "exchange_records", "exchange_bytes",
                "exchange_imbalance", "exchange_imbalance_send",
                "exchange_hot_dst", "exchange_hot_dst_share",
                "exchange_bytes_by_link", "comms_source"):
        assert ttm[key] == jtm[key], key
    assert ttm["exchange_bytes_by_link"]["host"] > 0
    assert sum(port.values()) == ttm["exchange_records"]


# -- SLO objectives -------------------------------------------------------------


SPECS = ["queue_wait:p99:0.000001", "submit_first_result:p99:120",
         "snapshot_staleness:p99.9:1.0:600:60", "queue_wait:P50:2:30",
         "queue_wait:p99", "nope:p99:1", "queue_wait:p100:1",
         "queue_wait:p99:0", "queue_wait:p99:1:10:20",
         "queue_wait:pxx:1"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_objective_equals_jax(spec):
    def parse(mod):
        try:
            return dataclasses.asdict(mod.parse_objective(spec)), None
        except ValueError as exc:
            return None, str(exc)

    assert parse(tslo) == parse(jslo)


class _Pushed:
    """A collector stand-in holding one pushed process's snapshot."""

    def __init__(self, parsed):
        self.parsed = parsed

    def metric_snapshots(self):
        return [self.parsed]


def _observe_script(mod, reg, hist_mod):
    objectives = [mod.parse_objective("queue_wait:p99:0.05:60:10"),
                  mod.parse_objective("submit_first_result:p90:1.0"),
                  mod.parse_objective("snapshot_staleness:p50:0.2:30:5")]
    plane = mod.SloPlane(objectives)
    for fam in (mod.QUEUE_WAIT_FAMILY, mod.FIRST_RESULT_FAMILY,
                mod.STALENESS_FAMILY):
        reg.histogram(fam, buckets=hist_mod.SLO_BUCKETS)
    qw = reg.histogram(mod.QUEUE_WAIT_FAMILY)
    fr = reg.histogram(mod.FIRST_RESULT_FAMILY)
    st = reg.histogram(mod.STALENESS_FAMILY)
    pushed = hist_mod.Registry()
    ph = pushed.histogram(mod.QUEUE_WAIT_FAMILY,
                          buckets=hist_mod.SLO_BUCKETS)
    for v in (0.01, 0.3, 0.7):
        ph.observe(v, tenant="acme")
    collector = _Pushed(hist_mod.parse_prometheus(pushed.render()))
    out = []
    for tick, vals in enumerate([(0.001, 0.002), (0.2, 0.9, 3.0),
                                 (), (0.04,), (12.0, 0.03)]):
        for v in vals:
            qw.observe(v, tenant="acme")
            fr.observe(v * 2, tenant="beta")
            st.observe(v / 3, tenant="acme")
        out.append(plane.evaluate(registry=reg, collector=collector,
                                  now=100.0 + 20.0 * tick))
    return out


def test_slo_plane_evaluates_like_jax():
    port = _observe_script(tslo, tmetrics.Registry(), tmetrics)
    jax = _observe_script(jslo, jmetrics.Registry(), jmetrics)
    assert port == jax
    last = port[-1]["tenants"]
    assert last["acme"]["queue_wait"]["breaching"]
    assert last["acme"]["queue_wait"]["burn_long"] > 1.0
    assert not math.isnan(last["beta"]["submit_first_result"]["p"])
    for snap in port:
        doc = {"kind": "mrtpu-slo", "version": 1, "snapshot": snap}
        tslo.validate_slo(doc)
        jslo.validate_slo(doc)


@pytest.mark.parametrize("doc", [
    {"kind": "mrtpu-slo"},
    {"kind": "mrtpu-slo", "snapshot": {"objectives": [], "tenants": {}}},
    {"kind": "mrtpu-slo", "snapshot": {
        "objectives": [{"name": "q", "percentile": 0.99,
                        "threshold_s": 1, "long_window_s": 60,
                        "short_window_s": 6}],
        "tenants": {"t": {"q": {"n": 1, "burn_short": 0.0,
                                "burn_long": 0.0}}}}},
    {"kind": "mrtpu-comms"}], ids=["no_snapshot", "empty", "no_breaching",
                                   "wrong_kind"])
def test_validate_slo_refuses_like_jax(doc):
    def verdict(mod):
        try:
            mod.validate_slo(doc)
            return None
        except ValueError as exc:
            return str(exc)

    assert verdict(tslo) == verdict(jslo) is not None


def test_statusz_takes_engine_sections_from_a_pushing_runner():
    """The docserver of a docserver/runner topology runs no engine: its
    /statusz takes the engine sections a runner pushed with its
    telemetry (the freshest push first), marked with the runner's id."""
    from mapreduce_tpu_torch.obs.collector import _process_sections

    tcomms.record_exchange(_matrix(), 16, task="pushed",
                           devices=tmesh.partition_devices(8, "cpu"))
    sections = _process_sections(tmetrics.REGISTRY)
    assert sections["comms"]["exchange"]["task"] == "pushed"
    tcomms.reset_state()
    assert "comms" not in _process_sections(tmetrics.REGISTRY)
    import time

    c = Collector()
    for proc, sec, age in (
            ("runner-old", {"comms": {"exchange": {"task": "a"}}}, 5.0),
            ("runner-new", sections, 0.0)):
        c.push({"proc": proc, "role": "runner", "sections": sec,
                "metrics": ""}, received_mono=time.monotonic() - age)
    snap = tstatusz.cluster_status(MemoryDocStore(), collector=c)
    assert snap["comms"]["from_proc"] == "runner-new"
    assert snap["comms"]["exchange"]["task"] == "pushed"
    assert snap["telemetry"]["procs"]["runner-new"]["role"] == "runner"
    assert "sections" not in snap["telemetry"]["procs"]["runner-new"]
    assert "comms" not in tstatusz.cluster_status(MemoryDocStore())
