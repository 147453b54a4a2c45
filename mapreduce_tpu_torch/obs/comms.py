"""Exchange-traffic roll-ups and upload/compute overlap (port of parts of
``mapreduce_tpu/obs/comms.py``).

The skew controller (:mod:`..engine.autotune`) reads one control
window's ``[P, P]`` src x dst matrix of routed rows through
:func:`matrix_stats`.  The engine measures how much of its input
uploads hid under its kernels with :func:`overlap_fraction` (pure
interval arithmetic) and publishes the share with
:func:`record_upload_overlap`.  The rest of the JAX module (the
per-link roll-ups over the mesh's link classes, ``record_exchange``,
the ``comms`` snapshot and artifact) is not ported yet (ROADMAP A.8c).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

from .metrics import gauge

_OVERLAP = gauge(
    "mrtpu_upload_overlap_frac",
    "fraction of the last device run's upload time that overlapped "
    "device execution (1.0 = the feeder fully hid the host->device "
    "link; low values mean the run was feeder-bound).  On CUDA both "
    "sides are device intervals from CUDA events (the copies on the "
    "feeder's stream, the waves' kernels); on the CPU the host's "
    "upload waits against the waves' compute")


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


def record_upload_overlap(frac: float, task: str = "-") -> float:
    """Publish one run's upload/compute overlap fraction (the gauge);
    returns the clipped value.  *task* is accepted for the JAX
    signature; the JAX snapshot mirror that records it waits for the
    ``comms`` snapshot (ROADMAP A.8c)."""
    frac = max(0.0, min(1.0, float(frac)))
    _OVERLAP.set(frac)
    return frac


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
