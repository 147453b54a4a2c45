"""Device-memory observability: per-program footprints, live
device-memory gauges and capacity-retry forensics (port of
``mapreduce_tpu/obs/memory.py``).

Device memory is the force behind the engine's capacity/retry machinery:
static capacities exist so a wave's working set fits.  Two sources,
mirrored on :mod:`.profile`'s cost model:

* **per-program footprints**: there is no XLA ``memory_analysis()`` to
  read, so a wave's footprint is :func:`analytic_program_memory` of the
  arrays it takes (exact argument bytes, one argument-sized working
  copy), labelled ``source="analytic"`` on both devices;
* **live device memory**: on CUDA the caching allocator's own counters,
  ``torch.cuda.memory_allocated`` (``bytes_in_use``) and
  ``max_memory_allocated`` (``peak_bytes_in_use``), host-side reads that
  never wait for the device, with ``torch.cuda.mem_get_info()[1]``
  (``bytes_limit``) read once a process.  On the CPU there are no
  stats: the caller's own estimate renders instead, labelled analytic,
  as the JAX function does on a backend without ``memory_stats()``.
  Nothing here resets the allocator's peak: that is the caller's to do
  around what it measures.

**Capacity-retry forensics**: every engine capacity retry emits one
structured ``capacity_retry`` trace event carrying the program footprint
and the device-memory state, classified ``hbm`` (the device was near its
byte limit, :data:`HBM_PRESSURE_RATIO`) or ``capacity`` (a static
capacity overflowed with memory to spare or unknown).

A last-sample mirror (:func:`memory_snapshot`) feeds ``statusz.json`` in
the profile bundles from the same calls the gauges ride.  Left out
(ROADMAP): the donation accounting (``donation_savings``,
``record_donation``, the ``donation_saved_bytes`` timing): PyTorch has
no buffer donation to measure.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from .metrics import counter, gauge
from .trace import TRACER

# -- instruments -------------------------------------------------------------

_DEVICE_MEMORY = gauge(
    "mrtpu_device_memory_bytes",
    "live per-device memory (labels: device, stat=bytes_in_use|"
    "peak_bytes_in_use|bytes_limit, source=measured|analytic; measured "
    "= the CUDA caching allocator's counters, analytic = the caller's "
    "own held-bytes estimate on the CPU)")
_PROGRAM_MEMORY = gauge(
    "mrtpu_program_memory_bytes",
    "per-program device-memory footprint (labels: program, kind="
    "arguments|outputs|temp|generated_code|total, source=analytic)")
_RETRY_EVENTS = counter(
    "mrtpu_device_capacity_retry_events_total",
    "engine capacity retries that emitted a memory-forensics event "
    "(labels: task, bound=hbm|capacity)")

#: bytes_in_use / bytes_limit above this ratio classifies a capacity
#: retry as memory-bound rather than merely static-capacity-bound
HBM_PRESSURE_RATIO = 0.8

# -- last-sample mirror (what statusz.json reads) ----------------------------

_STATE_LOCK = threading.Lock()
_STATE: Dict[str, Dict[str, Any]] = {"devices": {}, "programs": {}}

#: per CUDA device index, its total memory (mem_get_info()[1]), read
#: once a process
_LIMITS: Dict[int, int] = {}


def _flatten(tree: Any) -> List[Any]:
    """The leaves of nested lists / tuples / dicts of arrays (anything
    with a ``shape`` is a leaf)."""
    if hasattr(tree, "shape"):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flatten(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _nbytes(aval: Any) -> int:
    """Bytes of one shaped leaf: a tensor, a numpy array, or anything
    with ``shape`` and ``dtype`` (a torch or numpy dtype)."""
    import numpy as np

    shape = tuple(getattr(aval, "shape", ()) or ())
    size = 1
    for d in shape:
        size *= int(d)
    dtype = getattr(aval, "dtype", "uint8")
    itemsize = getattr(dtype, "itemsize", None)
    if not isinstance(itemsize, int):
        itemsize = np.dtype(dtype).itemsize
    return size * itemsize


# -- per-program footprints --------------------------------------------------


def analytic_program_memory(arg_avals: Sequence[Any],
                            out_avals: Sequence[Any] = (),
                            ) -> Dict[str, Any]:
    """A program's footprint from its arrays: the argument and (known)
    output bytes are exact; temp is taken as one argument-sized working
    copy (the engine's waves are sort-dominated: one extra record-buffer
    copy is the right order of magnitude).  Labelled
    ``source="analytic"`` wherever it lands."""
    args = sum(_nbytes(a) for a in _flatten(arg_avals))
    outs = sum(_nbytes(a) for a in _flatten(out_avals))
    return {"arguments": args, "outputs": outs, "temp": args,
            "generated_code": 0, "alias": 0,
            "total": args + outs + args, "source": "analytic"}


def record_program_memory(program: str, mem: Dict[str, Any]) -> None:
    """Publish one program's footprint (gauges + the snapshot mirror)."""
    source = str(mem.get("source", "measured"))
    for kind in ("arguments", "outputs", "temp", "generated_code",
                 "total"):
        _PROGRAM_MEMORY.set(float(mem.get(kind, 0)), program=program,
                            kind=kind, source=source)
    with _STATE_LOCK:
        _STATE["programs"][program] = dict(mem)


# -- live device memory ------------------------------------------------------


def _cuda_stats(index: int) -> Dict[str, int]:
    import torch

    limit = _LIMITS.get(index)
    if limit is None:
        limit = _LIMITS[index] = int(torch.cuda.mem_get_info(index)[1])
    return {"bytes_in_use": int(torch.cuda.memory_allocated(index)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(index)),
            "bytes_limit": limit}


def device_memory(devices: Sequence[Any]) -> List[Dict[str, Any]]:
    """Raw per-device readings: one dict per torch device, ``stats``
    from the CUDA allocator, or None on the CPU."""
    out: List[Dict[str, Any]] = []
    for d in devices:
        dev_type = getattr(d, "type", str(d))
        index = getattr(d, "index", None)
        stats = None
        if dev_type == "cuda":
            import torch

            if index is None:
                index = torch.cuda.current_device()
            stats = _cuda_stats(index)
        out.append({"device": str(index or 0), "platform": dev_type,
                    "stats": stats})
    return out


def sample_device_memory(devices: Sequence[Any],
                         analytic_bytes_in_use: Optional[int] = None,
                         ) -> Dict[str, Any]:
    """Sample every device's memory into the gauges (the per-wave and
    per-epoch hook).  Where there are no stats (the CPU) the caller's
    own estimate (*analytic_bytes_in_use*) renders instead, labelled
    analytic.  Returns the summary that also lands in retry-forensics
    events."""
    summary: Dict[str, Any] = {"devices": {}, "source": "measured"}
    measured = False
    for row in device_memory(devices):
        dev = row["device"]
        stats = row["stats"]
        if stats:
            measured = True
            for stat, v in stats.items():
                _DEVICE_MEMORY.set(float(v), device=dev, stat=stat,
                                   source="measured")
            summary["devices"][dev] = dict(stats)
        elif analytic_bytes_in_use is not None:
            share = float(analytic_bytes_in_use) / max(len(devices), 1)
            _DEVICE_MEMORY.set(share, device=dev, stat="bytes_in_use",
                               source="analytic")
            summary["devices"][dev] = {"bytes_in_use": int(share)}
    if not measured:
        summary["source"] = "analytic"
    with _STATE_LOCK:
        _STATE["devices"] = dict(summary["devices"])
        _STATE["device_source"] = summary["source"]
    return summary


# -- capacity-retry forensics ------------------------------------------------


def capacity_retry_event(task: str, attempt: int, overflow_rows: int,
                         program_memory_doc: Optional[Dict[str, Any]],
                         devices: Sequence[Any],
                         old_capacities: Dict[str, int],
                         new_capacities: Dict[str, int],
                         tracer=TRACER) -> str:
    """Emit the forensics of ONE engine capacity retry: a zero-duration
    ``capacity_retry`` span whose args carry the program footprint and
    the device-memory state, plus its counter.  Returns the
    classification: ``"hbm"`` when the device was measurably near its
    byte limit, else ``"capacity"``."""
    mem = sample_device_memory(devices)
    bound = "capacity"
    footprint = int((program_memory_doc or {}).get("total", 0))
    for entry in mem["devices"].values():
        limit = entry.get("bytes_limit")
        in_use = entry.get("bytes_in_use", 0)
        if limit and (max(in_use, footprint) >= HBM_PRESSURE_RATIO
                      * limit):
            bound = "hbm"
            break
    _RETRY_EVENTS.inc(task=task or "-", bound=bound)
    now = time.monotonic()
    tracer.end(
        tracer.begin("capacity_retry", start=now, task=task or "-"),
        now, attempt=int(attempt), overflow_rows=int(overflow_rows),
        bound=bound, program_memory=program_memory_doc,
        device_memory=mem, old_capacities=dict(old_capacities),
        new_capacities=dict(new_capacities))
    return bound


# -- snapshots ---------------------------------------------------------------


def memory_snapshot() -> Dict[str, Any]:
    """The memory section of ``statusz.json``: this process's last
    device samples and per-program footprints (empty when nothing was
    recorded).  The JAX section's ``donation`` key is always empty
    here."""
    with _STATE_LOCK:
        devices = dict(_STATE["devices"])
        programs = {p: dict(m) for p, m in _STATE["programs"].items()}
        source = _STATE.get("device_source")
    if not (devices or programs):
        return {}
    out: Dict[str, Any] = {"programs": programs, "donation": {}}
    if devices:
        out["devices"] = devices
        out["device_source"] = source
    return out


def reset_state() -> None:
    """Tests only: forget the last-sample mirror."""
    with _STATE_LOCK:
        _STATE["devices"] = {}
        _STATE["programs"] = {}
        _STATE.pop("device_source", None)
