"""Exchange & dataflow observability: traffic matrix, link-class
roofline, upload/compute overlap (port of ``mapreduce_tpu/obs/comms.py``).

* **exchange traffic matrix** — the engine accumulates, on the card, a
  P×P int32 src×dst matrix of rows each partition ROUTED to each
  partition (the exchange plan's per-destination counts, which the wave
  already computes for overflow accounting) and reads it back once per
  run beside ``n_live``.  :func:`record_exchange` publishes it as
  ``mrtpu_exchange_records_total{src,dst}`` /
  ``mrtpu_exchange_bytes_total{src,dst}`` plus derived send/recv
  imbalance gauges (max-row over mean-row);

* **link-class roll-up + comms roofline** — the matrix rolled up by
  :func:`~mapreduce_tpu_torch.parallel.mesh.link_class`
  (self/nvlink/pcie/host) against the env-overridable per-class
  peak-bandwidth table
  (:func:`~mapreduce_tpu_torch.parallel.mesh.link_peaks`) yields a
  modeled exchange time, labelled ``source="analytic"`` because the
  bandwidths are datasheet denominators, not measurements;

* **upload/compute overlap** — :func:`overlap_fraction` (pure interval
  arithmetic, shared by the engine's live accounting and the offline
  diagnosis) measures how much of the feeder's upload time hid under
  device execution.

Like obs/memory, a last-sample mirror (:func:`comms_snapshot`) feeds
/statusz and the profile bundles from the same ``record_*`` calls the
gauges ride, so the two surfaces cannot drift.  ``comms.json`` in a
bundle is validated strictly on write AND reload
(:func:`validate_comms`).

Matrix semantics (the JAX package's): an entry ``[src][dst]`` counts
VALID records partition *src* asked the exchange to route to partition
*dst* — post local-reduce, pre capacity-capping (an overflowing wave
still reports what it WANTED to send; the engine retries until nothing
truncates, and the final attempt re-processes every wave, so a
converged run's matrix is exact).  Row sums are records sent per
partition; column sums are records received per partition.

It reads no clocks at all.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .metrics import counter, gauge

# -- instruments -------------------------------------------------------------

_EXCHANGE_RECORDS = counter(
    "mrtpu_exchange_records_total",
    "records routed partition src -> partition dst by the wave's "
    "exchange, accumulated on the device and read back once per run "
    "(labels: src, dst, task)")
_EXCHANGE_BYTES = counter(
    "mrtpu_exchange_bytes_total",
    "approximate bytes routed partition src -> partition dst (records x "
    "record row bytes; labels: src, dst, task)")
_IMBALANCE = gauge(
    "mrtpu_exchange_imbalance",
    "exchange skew of the last device run: max-row / mean-row of the "
    "traffic matrix (labels: side=send|recv, task); 1.0 = perfectly "
    "balanced")
_COMMS_BYTES = counter(
    "mrtpu_comms_bytes_total",
    "exchange bytes by link class (labels: link=self|nvlink|pcie|host, "
    "task) — the traffic matrix rolled up over the partitions' devices")
_MODELED_S = gauge(
    "mrtpu_comms_modeled_exchange_seconds",
    "modeled seconds the last run's exchange traffic occupies its "
    "bottleneck link class (bytes / per-class peak bandwidth; "
    "source=analytic — the peaks are datasheet denominators)")
_EXCHANGE_FRAC = gauge(
    "mrtpu_comms_exchange_frac_of_compute",
    "modeled exchange seconds over the last run's measured compute "
    "seconds — the comms roofline: how much of the wave time the wire "
    "alone would account for (source=analytic)")
_OVERLAP = gauge(
    "mrtpu_upload_overlap_frac",
    "fraction of the last device run's upload time that overlapped "
    "device execution (1.0 = the feeder fully hid the host->device "
    "link; low values mean the run was feeder-bound).  On CUDA both "
    "sides are device intervals from CUDA events (the copies on the "
    "feeder's stream, the waves' kernels); on the CPU the host's "
    "upload waits against the waves' compute")

#: matrices up to this many partitions ride verbatim in timings dicts /
#: the snapshot mirror; bigger ones keep the roll-ups only
MATRIX_INLINE_MAX = 64

# -- last-sample mirror (what /statusz and bundles read) ---------------------

_STATE_LOCK = threading.Lock()
_STATE: Dict[str, Any] = {}


# -- pure helpers ------------------------------------------------------------


def _union_length(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of ``(t0, t1)`` intervals."""
    total = 0.0
    end = None
    for t0, t1 in sorted(i for i in intervals if i[1] > i[0]):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def _intersect(a: List[Tuple[float, float]],
               b: List[Tuple[float, float]]) -> float:
    """Length of ``union(a) ∩ union(b)``."""
    return (_union_length(a) + _union_length(b)
            - _union_length(list(a) + list(b)))


#: total upload time below this is NEGLIGIBLE: a staged (or fully
#: prefetched) run's waits are microsecond epsilons whose placement
#: relative to busy windows is noise, so the share reads 1.0
NEGLIGIBLE_UPLOAD_S = 1e-3


def overlap_fraction(uploads: List[Tuple[float, float]],
                     busy: List[Tuple[float, float]]) -> float:
    """Fraction of the upload intervals' union that overlaps the
    device-busy intervals' union: the feeder-effectiveness number.  With
    no upload time (or a negligible total below
    :data:`NEGLIGIBLE_UPLOAD_S`) the feeder hid everything: 1.0."""
    up = _union_length(uploads)
    if up <= NEGLIGIBLE_UPLOAD_S:
        return 1.0
    return max(0.0, min(1.0, _intersect(uploads, busy) / up))


def matrix_stats(matrix: Sequence[Sequence[int]]) -> Dict[str, Any]:
    """Pure roll-ups of one P×P records matrix: row/col sums, total,
    send/recv imbalance (max/mean over nonempty sides), and the hottest
    destination's share."""
    rows = [[int(v) for v in row] for row in matrix]
    P = len(rows)
    row_sums = [sum(r) for r in rows]
    col_sums = [sum(rows[s][d] for s in range(P)) for d in range(P)]
    total = sum(row_sums)

    def _imb(sums: List[int]) -> float:
        if total <= 0 or not sums:
            return 1.0
        return max(sums) / (total / len(sums))

    hot_dst = max(range(P), key=lambda d: col_sums[d]) if P else 0
    return {
        "records": total,
        "row_sums": row_sums,
        "col_sums": col_sums,
        "imbalance_send": round(_imb(row_sums), 4),
        "imbalance_recv": round(_imb(col_sums), 4),
        "hot_dst": hot_dst,
        "hot_dst_share": (round(col_sums[hot_dst] / total, 4)
                          if total > 0 else 0.0),
    }


def rollup_by_link(matrix: Sequence[Sequence[int]], row_bytes: int,
                   devices: Optional[Sequence[Any]]) -> Dict[str, int]:
    """Bytes per link class: the traffic matrix against the partitions'
    devices (``parallel.mesh.device_link_matrix``).  Without devices (an
    offline doc) everything off-diagonal is conservatively classed
    ``nvlink``, the JAX package's interconnect default."""
    from ..parallel.mesh import LINK_CLASSES, device_link_matrix

    out = {cls: 0 for cls in LINK_CLASSES}
    P = len(matrix)
    if devices is not None and len(devices) >= P:
        links = device_link_matrix(list(devices)[:P])
    else:
        links = [["self" if s == d else "nvlink" for d in range(P)]
                 for s in range(P)]
    for s in range(P):
        for d in range(P):
            out[links[s][d]] += int(matrix[s][d]) * int(row_bytes)
    return out


def modeled_exchange_seconds(bytes_by_link: Dict[str, int],
                             n_dev: int) -> Dict[str, Any]:
    """The comms roofline's numerator: per-class seconds = class bytes /
    (per-pair peak × participating partitions — each drives its own
    links concurrently), bottleneck = the slowest class.  Labelled
    analytic: the peaks are denominators, not measurements."""
    from ..parallel.mesh import link_peaks

    peaks = link_peaks()
    per_class: Dict[str, float] = {}
    for cls, nbytes in bytes_by_link.items():
        if nbytes <= 0:
            continue
        bw = float(peaks[cls]) * max(int(n_dev), 1)
        per_class[cls] = nbytes / bw if bw > 0 else 0.0
    bottleneck = max(per_class, key=per_class.get) if per_class else None
    return {
        "seconds_by_link": {c: round(s, 6) for c, s in per_class.items()},
        "modeled_exchange_s": round(max(per_class.values()), 6)
        if per_class else 0.0,
        "bottleneck_link": bottleneck,
        "peak_source": peaks["peak_source"],
        "source": "analytic",
    }


# -- recording ---------------------------------------------------------------


def record_exchange(matrix: Sequence[Sequence[int]], row_bytes: int,
                    task: str = "-", devices: Optional[Sequence[Any]] = None,
                    compute_s: float = 0.0,
                    publish: bool = True) -> Dict[str, Any]:
    """Publish one device run's exchange traffic matrix (a host list of
    lists): per-(src,dst) record/byte counters, imbalance gauges, the
    link-class roll-up and the modeled exchange seconds vs *compute_s*
    (the comms roofline).  Returns the derived dict the engine merges
    into its ``timings``.

    ``publish=False`` computes the derived dict and the snapshot mirror
    but touches NO registry counter or gauge: over a process group every
    rank holds the identical matrix, the collector sums counter families
    across processes, and only one rank may publish or the cluster
    roll-ups would multiply the traffic by the world size."""
    task = task or "-"
    rows = [[int(v) for v in row] for row in matrix]
    stats = matrix_stats(rows)
    P = len(rows)
    if publish:
        for s in range(P):
            for d in range(P):
                n = rows[s][d]
                if n:
                    src, dst = f"D{s:03d}", f"D{d:03d}"
                    _EXCHANGE_RECORDS.inc(n, src=src, dst=dst, task=task)
                    _EXCHANGE_BYTES.inc(n * int(row_bytes), src=src,
                                        dst=dst, task=task)
        _IMBALANCE.set(stats["imbalance_send"], side="send", task=task)
        _IMBALANCE.set(stats["imbalance_recv"], side="recv", task=task)

    by_link = rollup_by_link(rows, row_bytes, devices)
    if publish:
        for cls, nbytes in by_link.items():
            if nbytes:
                _COMMS_BYTES.inc(nbytes, link=cls, task=task)
    model = modeled_exchange_seconds(by_link, n_dev=max(P, 1))
    frac = (model["modeled_exchange_s"] / compute_s
            if compute_s > 0 else 0.0)
    if publish:
        _MODELED_S.set(model["modeled_exchange_s"])
        _EXCHANGE_FRAC.set(frac)

    derived: Dict[str, Any] = {
        "exchange_records": stats["records"],
        "exchange_bytes": stats["records"] * int(row_bytes),
        "exchange_imbalance": stats["imbalance_recv"],
        "exchange_imbalance_send": stats["imbalance_send"],
        "exchange_hot_dst": stats["hot_dst"],
        "exchange_hot_dst_share": stats["hot_dst_share"],
        "exchange_bytes_by_link": {c: b for c, b in by_link.items() if b},
        "modeled_exchange_s": model["modeled_exchange_s"],
        "exchange_frac_of_compute": round(frac, 6),
        "comms_source": "analytic",
    }
    snap = {
        "task": task,
        "partitions": P,
        "records": stats["records"],
        "bytes": stats["records"] * int(row_bytes),
        "imbalance_send": stats["imbalance_send"],
        "imbalance_recv": stats["imbalance_recv"],
        "hot_dst": stats["hot_dst"],
        "hot_dst_share": stats["hot_dst_share"],
        "row_sums": stats["row_sums"],
        "col_sums": stats["col_sums"],
        "bytes_by_link": derived["exchange_bytes_by_link"],
        "modeled_exchange_s": model["modeled_exchange_s"],
        "exchange_frac_of_compute": derived["exchange_frac_of_compute"],
        "bottleneck_link": model["bottleneck_link"],
        "peak_source": model["peak_source"],
        "source": "analytic",
    }
    if P <= MATRIX_INLINE_MAX:
        snap["matrix"] = rows
        derived["exchange"] = {"matrix": rows,
                               "row_sums": stats["row_sums"],
                               "col_sums": stats["col_sums"]}
    with _STATE_LOCK:
        _STATE["exchange"] = snap
    return derived


def record_upload_overlap(frac: float, task: str = "-") -> float:
    """Publish one run's upload/compute overlap fraction (gauge + the
    snapshot mirror); returns the clipped value."""
    frac = max(0.0, min(1.0, float(frac)))
    _OVERLAP.set(frac)
    with _STATE_LOCK:
        _STATE["upload_overlap_frac"] = round(frac, 4)
        _STATE["upload_overlap_task"] = task or "-"
    return frac


# -- snapshots + the bundle validator ----------------------------------------


def comms_snapshot() -> Dict[str, Any]:
    """The comms section of /statusz, the ``status`` CLI and profile
    bundles: this process's last exchange matrix roll-ups and overlap
    fraction (empty dict when no instrumented run happened here — the
    section then stays off the page)."""
    with _STATE_LOCK:
        if not _STATE:
            return {}
        out: Dict[str, Any] = {}
        if "exchange" in _STATE:
            out["exchange"] = dict(_STATE["exchange"])
        if "upload_overlap_frac" in _STATE:
            out["upload_overlap_frac"] = _STATE["upload_overlap_frac"]
            out["upload_overlap_task"] = _STATE.get("upload_overlap_task")
        return out


def validate_comms(doc: Any) -> None:
    """Strict structural check of a bundle's ``comms.json`` — enforced
    on write AND reload like the trace and compile-ledger validators,
    so a bundle that loads is a bundle the analysis tools accept."""
    if not isinstance(doc, dict) or doc.get("kind") != "mrtpu-comms":
        raise ValueError("comms: not a mrtpu-comms document")
    snap = doc.get("snapshot")
    if not isinstance(snap, dict):
        raise ValueError("comms: snapshot is not an object")
    ex = snap.get("exchange")
    if ex is not None:
        if not isinstance(ex, dict):
            raise ValueError("comms: exchange is not an object")
        for field in ("records", "imbalance_send", "imbalance_recv"):
            if not isinstance(ex.get(field), (int, float)):
                raise ValueError(f"comms: exchange missing numeric "
                                 f"{field!r}")
        for field in ("row_sums", "col_sums"):
            sums = ex.get(field)
            if not (isinstance(sums, list)
                    and all(isinstance(v, (int, float)) for v in sums)):
                raise ValueError(f"comms: exchange {field} is not a "
                                 "number list")
        matrix = ex.get("matrix")
        if matrix is not None:
            if not (isinstance(matrix, list)
                    and all(isinstance(r, list) and len(r) == len(matrix)
                            for r in matrix)):
                raise ValueError("comms: matrix is not square")
            rs = [sum(int(v) for v in r) for r in matrix]
            if rs != [int(v) for v in ex["row_sums"]]:
                raise ValueError("comms: matrix row sums disagree with "
                                 "row_sums")
    frac = snap.get("upload_overlap_frac")
    if frac is not None and not (isinstance(frac, (int, float))
                                 and 0.0 <= float(frac) <= 1.0):
        raise ValueError(f"comms: bad upload_overlap_frac {frac!r}")


def reset_state() -> None:
    """Tests only: forget the last-sample mirror."""
    with _STATE_LOCK:
        _STATE.clear()
