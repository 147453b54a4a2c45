"""Device-plane cost model, MFU/roofline accounting, and profile bundles
(port of ``mapreduce_tpu/obs/profile.py``).

The engine's wave timings say how long the device worked; this module
says how much work that was.  There is no XLA ``cost_analysis()`` to
read here, so every run is costed by :func:`analytic_costs` (the
sort-hierarchy estimate, labelled ``source="analytic"`` everywhere it
lands), and the totals become counters and the two standard "as fast as
the hardware allows" lenses:

* **MFU**: achieved FLOP/s ÷ the device's peak;
* **roofline fraction**: achieved FLOP/s ÷ the roofline-attainable rate
  ``min(peak_flops, intensity × peak_bytes/s)``, the honest ceiling
  for a memory-bound workload like sort-heavy MapReduce.

Peak numbers come from the JAX package's per-device-kind table
(datasheet bf16 / peak-memory values), matched against
``torch.cuda.get_device_name()`` on the card, so an ``NVIDIA H100 80GB
HBM3`` reads as ``kind:h100`` (989 TFLOP/s, 3.35 TB/s), and overridable
with ``MAPREDUCE_TPU_PEAK_FLOPS`` and ``MAPREDUCE_TPU_PEAK_BYTES_PER_S``:
they are denominators for a ratio, not measurements, and the
``peak_source`` field says where they came from.

**Profile bundles** (:func:`write_bundle` / :func:`load_bundle`): one
directory holding a Chrome trace, a ``/metrics`` snapshot, a
``statusz.json`` (a live docserver's ``/statusz``, or this process's
device, compile, memory and comms sections), the compile ledger
(``compile_ledger.json``: :mod:`.compile`'s snapshot and buckets), the
comms, SLO, control and alerts artifacts when their planes recorded
anything, a ``/clusterz`` merged timeline with its diagnosis when the
caller passes one, the durable history's segments (``history/``) when
the caller passes a history that holds entries, and a manifest that
names an optional ``torch.profiler`` trace directory.  The loader re-validates with the strict parsers
(``parse_prometheus``, :func:`validate_trace` and each artifact's
validator), so a bundle that loads is one Perfetto and Prometheus
accept, and a bundle of either package loads in the other.

The manifest's ``created_time`` is a persisted timestamp minted through
``coord/docstore.now``; every duration here is somebody else's
monotonic measurement.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional

from .metrics import REGISTRY, Registry, counter, gauge, parse_prometheus
from .trace import TRACER, Tracer

# -- peak table --------------------------------------------------------------

#: (peak FLOP/s, peak memory bytes/s) per device kind (the JAX package's
#: table: bf16 matmul peak, peak memory bandwidth), matched by substring
#: of the lower-cased device kind; first hit wins (v5p before v5).
_PEAKS_BY_KIND = (
    ("v6", (918e12, 1640e9)),
    ("v5p", (459e12, 2765e9)),
    ("v5", (197e12, 819e9)),
    ("v4", (275e12, 1228e9)),
    ("h100", (989e12, 3350e9)),
    ("a100", (312e12, 2039e9)),
)

#: platform fallbacks when no kind matched; the cpu number is a nominal
#: few-core figure so a CPU run's MFU is a small nonzero ratio
_PEAKS_BY_PLATFORM = {
    "tpu": (197e12, 819e9),
    "gpu": (312e12, 2039e9),
    "cpu": (5e10, 5e10),
}
_DEFAULT_PEAKS = (1e12, 1e11)


class DeviceKind:
    """What the peak table reads of a device: ``device_kind`` and
    ``platform``, the attributes of a JAX ``Device``."""

    __slots__ = ("device_kind", "platform")

    def __init__(self, device_kind: str, platform: str) -> None:
        self.device_kind = device_kind
        self.platform = platform


def describe_device(device: Any) -> DeviceKind:
    """A torch device as :class:`DeviceKind`: a CUDA device by its
    ``torch.cuda.get_device_name`` on platform ``gpu``, the CPU as
    ``cpu``."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return DeviceKind(torch.cuda.get_device_name(device), "gpu")
    return DeviceKind(device.type, device.type)


def device_peaks(device: Any = None) -> Dict[str, Any]:
    """Assumed peak FLOP/s and bytes/s for *device* (any object with
    ``device_kind``/``platform`` attributes, e.g. :class:`DeviceKind`),
    with env overrides; ``peak_source`` says where the numbers came
    from."""
    env_f = os.environ.get("MAPREDUCE_TPU_PEAK_FLOPS")
    env_b = os.environ.get("MAPREDUCE_TPU_PEAK_BYTES_PER_S")
    kind = str(getattr(device, "device_kind", "") or "").lower()
    platform = str(getattr(device, "platform", "") or "").lower()
    flops, nbytes, source = None, None, "default"
    for sub, peaks in _PEAKS_BY_KIND:
        if sub in kind:
            flops, nbytes = peaks
            source = f"kind:{sub}"
            break
    if flops is None:
        if platform in _PEAKS_BY_PLATFORM:
            flops, nbytes = _PEAKS_BY_PLATFORM[platform]
            source = f"platform:{platform}"
        else:
            flops, nbytes = _DEFAULT_PEAKS
    if env_f:
        flops, source = float(env_f), "env"
    if env_b:
        nbytes = float(env_b)
        source = "env" if env_f else source + "+env_bw"
    return {"flops_per_s": float(flops), "bytes_per_s": float(nbytes),
            "peak_source": source}


# -- program costs -----------------------------------------------------------

#: analytic model constants (the JAX package's): a multi-operand
#: compare-exchange touches two 64-bit keys plus carried lanes (~16
#: scalar ops), and the segmented-scan/compaction tail is ~32 ops per
#: record.
_SORT_CMP_FLOPS = 16
_SEGSCAN_FLOPS = 32
#: the two-pass argsort tier's extra work per record
_GATHER_FLOPS = 4
#: the fused segmented-reduce kernel's per-record work (one pass)
_SEGREDUCE_KERNEL_FLOPS = 12
#: read+write passes per record of the ladder segmented reduce vs the
#: kernel's single pass
_SEGSCAN_LAX_BYTE_PASSES = 8
_SEGREDUCE_KERNEL_BYTE_PASSES = 1
#: the JAX radix formulation's digit passes (4-bit digits over the
#: 64-bit key); the port's kernels run 8 passes of 8-bit digits and the
#: engine passes that count
_RADIX_PASSES = 16
_RADIX_HIST_FLOPS = 16
_RADIX_SCATTER_FLOPS = 8
#: bytes per radix pass: the three sort lanes (k1, k2, perm)
_RADIX_LANE_BYTES = 12


def analytic_costs(input_bytes: int, n_records: int,
                   record_bytes: int,
                   fold_records: int = 0,
                   argsort: bool = False,
                   segment_impl: str = "lax",
                   sort_impl: Optional[str] = None,
                   radix_passes: int = _RADIX_PASSES) -> Dict[str, float]:
    """Rough cost of one engine wave: the program is sort-dominated, so
    FLOPs ≈ records × log2(records) compare-exchanges + a
    segmented-reduce term, and bytes ≈ the input read plus one
    read+write of the record buffer per sort pass plus the
    segmented-reduce passes.  ``fold_records`` accounts for the wave
    fold re-sorting the accumulator rows; ``argsort`` for the tier-0
    program's second sort pass and permutation gathers;
    ``segment_impl="pallas"`` for the one-pass segmented-reduce kernel
    (``"lax"``: the ladder chain); ``sort_impl="radix"`` replaces the
    comparator terms with *radix_passes* digit passes, each moving the
    three 12-byte sort lanes, plus one full-record gather.  With the
    defaults this is the JAX function bit for bit.  An estimate with
    the right shape and order of magnitude, labelled
    ``source="analytic"`` wherever it lands."""
    if segment_impl == "pallas":
        seg_flops = _SEGREDUCE_KERNEL_FLOPS
        seg_byte_passes = _SEGREDUCE_KERNEL_BYTE_PASSES
    else:
        seg_flops = _SEGSCAN_FLOPS
        seg_byte_passes = _SEGSCAN_LAX_BYTE_PASSES
    radix = sort_impl == "radix"
    rb = max(int(record_bytes), 1)
    n = max(int(n_records), 1)
    passes = max(int(math.ceil(math.log2(n))), 1)
    if radix:
        sort_flops_per_rec = (int(radix_passes)
                              * (_RADIX_HIST_FLOPS + _RADIX_SCATTER_FLOPS))
        sort_bytes_per_rec = (2 * _RADIX_LANE_BYTES * int(radix_passes)
                              + 2 * rb)
        flops = float(n * sort_flops_per_rec + n * seg_flops)
        nbytes = float(max(int(input_bytes), 0)
                       + n * sort_bytes_per_rec
                       + 2 * n * rb * seg_byte_passes)
        if fold_records > 0:
            m = int(fold_records)
            flops += float(m * sort_flops_per_rec + m * seg_flops)
            nbytes += float(m * sort_bytes_per_rec
                            + 2 * m * rb * seg_byte_passes)
        return {"flops": flops, "bytes": nbytes}
    flops = float(n * passes * _SORT_CMP_FLOPS + n * seg_flops)
    nbytes = float(max(int(input_bytes), 0)
                   + 2 * n * rb * passes
                   + 2 * n * rb * seg_byte_passes)
    if fold_records > 0:
        m = int(fold_records)
        fold_passes = max(int(math.ceil(math.log2(m))), 1)
        flops += float(m * fold_passes * _SORT_CMP_FLOPS
                       + m * seg_flops)
        nbytes += float(2 * m * rb * (fold_passes + seg_byte_passes))
    if argsort:
        total = n + max(int(fold_records), 0)
        flops += float(total * passes * _SORT_CMP_FLOPS
                       + total * _GATHER_FLOPS)
        nbytes += float(2 * total * 12 * passes
                        + 2 * total * max(int(record_bytes), 1))
    return {"flops": flops, "bytes": nbytes}


# -- registry instruments ----------------------------------------------------

_FLOPS = counter(
    "mrtpu_device_flops_total",
    "device-engine FLOPs executed, from the analytic cost model "
    "(labels: source=analytic, task)")
_BYTES = counter(
    "mrtpu_device_bytes_total",
    "device-engine bytes accessed per the analytic cost model "
    "(labels: source, task)")
_MFU = gauge(
    "mrtpu_device_mfu",
    "model FLOP/s utilisation of the last device run (achieved / peak)")
_FLOPS_PER_S = gauge(
    "mrtpu_device_model_flops_per_s",
    "achieved model FLOP/s of the last device run (flops / compute_s)")
_INTENSITY = gauge(
    "mrtpu_device_arith_intensity",
    "arithmetic intensity of the last device run (flops / byte)")
_ROOFLINE = gauge(
    "mrtpu_device_roofline_frac",
    "achieved FLOP/s over the roofline-attainable rate "
    "min(peak_flops, intensity * peak_bw) for the last device run")
_PEAK_FLOPS = gauge(
    "mrtpu_device_peak_flops_per_s",
    "assumed aggregate peak FLOP/s (devices x per-device peak)")
_PEAK_BW = gauge(
    "mrtpu_device_peak_bytes_per_s",
    "assumed aggregate peak memory bytes/s")


def record_run(costs: Dict[str, Any], waves: int, compute_s: float,
               n_dev: int, device: Any = None,
               task: str = "-") -> Dict[str, Any]:
    """Publish one device run's cost accounting (counters + derived
    MFU/roofline gauges) and return the derived fields, which the
    engine folds into its ``timings``.  *costs* are one wave's,
    *n_dev* the number of physical devices (one card however many
    partitions it holds), *task* the accounting label the collector
    rolls FLOPs up by."""
    source = str(costs.get("source", "measured"))
    task = task or "-"
    flops = float(costs.get("flops", 0.0)) * max(int(waves), 0)
    nbytes = float(costs.get("bytes", 0.0)) * max(int(waves), 0)
    _FLOPS.inc(flops, source=source, task=task)
    _BYTES.inc(nbytes, source=source, task=task)
    peaks = device_peaks(device)
    peak_f = peaks["flops_per_s"] * max(int(n_dev), 1)
    peak_b = peaks["bytes_per_s"] * max(int(n_dev), 1)
    _PEAK_FLOPS.set(peak_f)
    _PEAK_BW.set(peak_b)
    out: Dict[str, Any] = {
        "flops": flops, "cost_bytes": nbytes, "cost_source": source,
        "peak_source": peaks["peak_source"],
    }
    if compute_s > 0.0 and flops > 0.0:
        fps = flops / compute_s
        intensity = flops / max(nbytes, 1.0)
        attainable = min(peak_f, intensity * peak_b)
        mfu = fps / peak_f
        roof = fps / attainable if attainable > 0 else 0.0
        _FLOPS_PER_S.set(fps)
        _INTENSITY.set(intensity)
        _MFU.set(mfu)
        _ROOFLINE.set(roof)
        out.update({
            "model_flops_per_s": round(fps, 1),
            "arith_intensity": round(intensity, 4),
            "mfu": round(mfu, 8),
            "roofline_frac": round(roof, 6),
        })
    return out


def device_snapshot(registry: Registry = REGISTRY) -> Dict[str, Any]:
    """The device section of ``statusz.json``: this process's
    device-plane registry state, summed over the task label.  Zero
    everywhere means no device run happened here."""
    val = registry.value
    return {
        "waves": int(registry.sum("mrtpu_device_waves_total")),
        "retries": int(registry.sum("mrtpu_device_retries_total")),
        "seconds": {
            stage: round(registry.sum("mrtpu_device_seconds_total",
                                      stage=stage), 4)
            for stage in ("upload", "compute", "readback")},
        "flops_total": registry.sum("mrtpu_device_flops_total"),
        "bytes_total": registry.sum("mrtpu_device_bytes_total"),
        "model_flops_per_s": val("mrtpu_device_model_flops_per_s"),
        "mfu": val("mrtpu_device_mfu"),
        "arith_intensity": val("mrtpu_device_arith_intensity"),
        "roofline_frac": val("mrtpu_device_roofline_frac"),
        "peak_flops_per_s": val("mrtpu_device_peak_flops_per_s"),
        "peak_bytes_per_s": val("mrtpu_device_peak_bytes_per_s"),
        "trace_spans": int(registry.sum("mrtpu_trace_spans_total")),
        "trace_dropped": int(val("mrtpu_trace_dropped_total")),
    }


# -- profile bundles ---------------------------------------------------------

#: files every bundle contains (the manifest lists what actually landed)
BUNDLE_FILES = ("manifest.json", "metrics.prom", "statusz.json",
                "trace.json")


def validate_trace(doc: Any) -> None:
    """Strict structural check of a Chrome trace-event object, the shape
    Perfetto accepts: any violation raises ValueError."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace: not a Chrome trace-event object "
                         "(missing traceEvents)")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("trace: traceEvents is not a list")
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ValueError(f"trace event {i}: not an object")
        if e.get("ph") == "M":
            # metadata events (process_name tracks of a merged cluster
            # timeline) carry no interval, only identity
            missing = {"name", "pid"} - set(e)
            if missing:
                raise ValueError(
                    f"trace event {i}: metadata missing {sorted(missing)}")
            continue
        missing = {"name", "ph", "ts", "dur", "pid", "tid"} - set(e)
        if missing:
            raise ValueError(f"trace event {i}: missing {sorted(missing)}")
        if e["ph"] != "X":
            raise ValueError(f"trace event {i}: ph {e['ph']!r} != 'X'")
        if not isinstance(e["ts"], (int, float)) or e["ts"] < 0:
            raise ValueError(f"trace event {i}: bad ts {e['ts']!r}")
        if not isinstance(e["dur"], (int, float)) or e["dur"] < 0:
            raise ValueError(f"trace event {i}: bad dur {e['dur']!r}")


def _dump(out_dir: str, name: str, doc: Any, **kw: Any) -> None:
    with open(os.path.join(out_dir, name), "w", encoding="utf-8") as f:
        json.dump(doc, f, default=float, **kw)


def write_bundle(out_dir: str,
                 metrics_text: Optional[str] = None,
                 statusz_doc: Optional[Dict[str, Any]] = None,
                 trace_doc: Optional[Dict[str, Any]] = None,
                 torch_trace_dir: Optional[str] = None,
                 registry: Registry = REGISTRY,
                 tracer: Tracer = TRACER,
                 store: Any = None,
                 cluster_doc: Optional[Dict[str, Any]] = None,
                 history: Any = None) -> str:
    """Capture a self-contained profile bundle into *out_dir*.

    Defaults snapshot THIS process: the registry's exposition, the
    tracer's Chrome trace and — with a *store* — the full /statusz
    cluster snapshot (without one, a statusz document with the device
    section and the compile, memory and comms sections once anything
    was recorded).  The ``profile`` CLI instead passes the text and docs
    it fetched from a live docserver.  *cluster_doc* (a ``/clusterz``
    merged cluster timeline) additionally lands as
    ``cluster_trace.json`` with its structured diagnosis
    (:mod:`.analysis`) as ``diagnosis.json``.  *history* (a
    :class:`~.history.MetricHistory`) lands its segments, re-validated,
    under ``history/``.  *torch_trace_dir* (a
    ``torch.profiler`` trace directory) is recorded in the manifest when
    it exists.  Returns *out_dir*."""
    from ..coord import docstore  # lazy: the wall-clock mint point
    from .control import control_snapshot, validate_control

    os.makedirs(out_dir, exist_ok=True)
    if metrics_text is None:
        metrics_text = registry.render()
    parse_prometheus(metrics_text)  # refuse to write a corrupt bundle
    if statusz_doc is None:
        if store is not None:
            from .statusz import cluster_status

            statusz_doc = cluster_status(store)
        else:
            from .statusz import (
                comms_snapshot_section, compile_snapshot,
                memory_snapshot_section)

            statusz_doc = {"tasks": {},
                           "device": device_snapshot(registry)}
            comp = compile_snapshot()
            if comp:
                statusz_doc["compile"] = comp
            mem = memory_snapshot_section()
            if mem:
                statusz_doc["memory"] = mem
            comms_sec = comms_snapshot_section()
            if comms_sec:
                statusz_doc["comms"] = comms_sec
    if trace_doc is None:
        trace_doc = tracer.chrome_trace()
    validate_trace(trace_doc)
    if cluster_doc is not None:
        validate_trace(cluster_doc)

    with open(os.path.join(out_dir, "metrics.prom"), "w",
              encoding="utf-8") as f:
        f.write(metrics_text)
    _dump(out_dir, "statusz.json", statusz_doc, indent=1)
    _dump(out_dir, "trace.json", trace_doc)
    files = ["metrics.prom", "statusz.json", "trace.json"]
    # the compile ledger (obs/compile): what this process built, loaded
    # and captured, and where the shape registry lives
    from .compile import LEDGER, validate_compile_ledger

    ledger_doc = {"kind": "mrtpu-compile-ledger", "version": 1,
                  "snapshot": LEDGER.snapshot(),
                  "buckets": LEDGER.buckets()}
    validate_compile_ledger(ledger_doc)
    _dump(out_dir, "compile_ledger.json", ledger_doc, indent=1)
    files.append("compile_ledger.json")
    # the comms plane: only when an instrumented run happened here (an
    # empty file would read as "the exchange sent nothing")
    from .comms import comms_snapshot, validate_comms

    comms_snap = comms_snapshot()
    if comms_snap:
        comms_doc = {"kind": "mrtpu-comms", "version": 1,
                     "snapshot": comms_snap}
        validate_comms(comms_doc)
        _dump(out_dir, "comms.json", comms_doc, indent=1)
        files.append("comms.json")
    # the serving-SLO plane: only when some tenant produced SLO
    # observations (an empty file would read as "every objective green")
    from .slo import slo_snapshot, validate_slo

    slo_snap = slo_snapshot()
    if slo_snap:
        slo_doc = {"kind": "mrtpu-slo", "version": 1,
                   "snapshot": slo_snap}
        validate_slo(slo_doc)
        _dump(out_dir, "slo.json", slo_doc, indent=1)
        files.append("slo.json")
    # the control plane: written only when a controller decided
    # something (an empty file would claim the loop ran and did nothing)
    ctrl_snap = control_snapshot()
    if ctrl_snap:
        ctrl_doc = {"kind": "mrtpu-control", "version": 1,
                    "snapshot": ctrl_snap}
        validate_control(ctrl_doc)
        _dump(out_dir, "control_ledger.json", ctrl_doc, indent=1)
        files.append("control_ledger.json")
    # the alerting plane: only when rules are armed, validated on write
    # AND reload like the control ledger
    from .alerts import alerts_snapshot, validate_alerts

    alert_snap = alerts_snapshot()
    if alert_snap:
        alert_doc = {"kind": "mrtpu-alerts", "version": 1,
                     "snapshot": alert_snap}
        validate_alerts(alert_doc)
        _dump(out_dir, "alerts.json", alert_doc, indent=1)
        files.append("alerts.json")
    if cluster_doc is not None:
        from .analysis import diagnose

        _dump(out_dir, "cluster_trace.json", cluster_doc)
        _dump(out_dir, "diagnosis.json", diagnose(cluster_doc), indent=1)
        files += ["cluster_trace.json", "diagnosis.json"]
    # the durable history: the live segments, copied and re-validated
    # after landing; only when it holds entries (an empty history/ would
    # read as "nothing ever changed")
    history_dir_rel = None
    if history is not None and history.snapshot().get("entries"):
        history.copy_segments(os.path.join(out_dir, "history"))
        history_dir_rel = "history"
    manifest: Dict[str, Any] = {
        "kind": "mrtpu-profile-bundle",
        "version": 1,
        "created_time": docstore.now(),
        "files": files,
        "trace_events": len(trace_doc.get("traceEvents", [])),
    }
    if torch_trace_dir and os.path.isdir(torch_trace_dir):
        manifest["torch_trace_dir"] = os.path.relpath(torch_trace_dir,
                                                      out_dir)
    if history_dir_rel is not None:
        manifest["history_dir"] = history_dir_rel
    try:
        import torch
        manifest["torch_version"] = torch.__version__
    except ImportError:
        pass  # bundles from torch-free processes are fine
    _dump(out_dir, "manifest.json", manifest, indent=1)
    return out_dir


def load_bundle(path: str) -> Dict[str, Any]:
    """Load and re-validate a bundle of either package: the metrics
    snapshot must survive the strict Prometheus parser, the traces the
    structural check and each artifact its validator.  Returns
    ``{"manifest", "metrics_text", "metrics", "statusz", "trace"}`` plus
    ``"compile_ledger"``, ``"comms"``, ``"slo"``, ``"control_ledger"``,
    ``"alerts"``, ``"cluster_trace"``, ``"diagnosis"`` and ``"history"``
    (:func:`~.history.read_history` of its segments) when the bundle has
    them."""
    with open(os.path.join(path, "manifest.json"), encoding="utf-8") as f:
        manifest = json.load(f)
    if manifest.get("kind") != "mrtpu-profile-bundle":
        raise ValueError(f"{path}: not a profile bundle manifest")
    with open(os.path.join(path, "metrics.prom"), encoding="utf-8") as f:
        metrics_text = f.read()
    with open(os.path.join(path, "statusz.json"), encoding="utf-8") as f:
        statusz_doc = json.load(f)
    with open(os.path.join(path, "trace.json"), encoding="utf-8") as f:
        trace_doc = json.load(f)
    validate_trace(trace_doc)
    out = {
        "manifest": manifest,
        "metrics_text": metrics_text,
        "metrics": parse_prometheus(metrics_text),
        "statusz": statusz_doc,
        "trace": trace_doc,
    }
    comp_path = os.path.join(path, "compile_ledger.json")
    if os.path.exists(comp_path):
        from .compile import validate_compile_ledger

        with open(comp_path, encoding="utf-8") as f:
            comp_doc = json.load(f)
        validate_compile_ledger(comp_doc)
        out["compile_ledger"] = comp_doc
    ctrl_path = os.path.join(path, "control_ledger.json")
    if os.path.exists(ctrl_path):
        from .control import validate_control

        with open(ctrl_path, encoding="utf-8") as f:
            ctrl_doc = json.load(f)
        validate_control(ctrl_doc)
        out["control_ledger"] = ctrl_doc
    from .alerts import validate_alerts
    from .comms import validate_comms
    from .slo import validate_slo

    for key, check in (("comms", validate_comms), ("slo", validate_slo),
                       ("alerts", validate_alerts)):
        art_path = os.path.join(path, f"{key}.json")
        if os.path.exists(art_path):
            with open(art_path, encoding="utf-8") as f:
                art_doc = json.load(f)
            check(art_doc)
            out[key] = art_doc
    cluster_path = os.path.join(path, "cluster_trace.json")
    if os.path.exists(cluster_path):
        with open(cluster_path, encoding="utf-8") as f:
            cluster_doc = json.load(f)
        validate_trace(cluster_doc)
        out["cluster_trace"] = cluster_doc
    diag_path = os.path.join(path, "diagnosis.json")
    if os.path.exists(diag_path):
        with open(diag_path, encoding="utf-8") as f:
            out["diagnosis"] = json.load(f)
    hist_dir = os.path.join(path, str(manifest.get("history_dir")
                                      or "history"))
    if os.path.isdir(hist_dir):
        # every entry re-validated; a corrupt segment refuses the load
        # loudly (HistoryCorruptError) instead of serving a wrong series
        from .history import read_history

        out["history"] = read_history(hist_dir)
    return out
