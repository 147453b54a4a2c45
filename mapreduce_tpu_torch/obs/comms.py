"""Exchange-traffic roll-ups (port of ``matrix_stats`` from
``mapreduce_tpu/obs/comms.py``).

The skew controller (:mod:`..engine.autotune`) reads one control
window's ``[P, P]`` src x dst matrix of routed rows through
:func:`matrix_stats`.  The rest of the JAX module (the per-link
roll-ups over the mesh's ICI/DCN classes, the upload-overlap share, the
``comms`` artifact) is not ported yet (ROADMAP A.8).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence


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
