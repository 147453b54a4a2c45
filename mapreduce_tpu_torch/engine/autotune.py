"""Skew-aware repartition planning (port of ``plan_rebalance`` from
``engine/autotune.py``).

The JAX package's controllers, which watch the exchange traffic matrix
and rebalance a stream mid-run, are not ported yet (ROADMAP).  What is
here is the pure planner they call: it turns per-bucket weights into a
bucket->partition table for :meth:`.device_engine.DeviceEngine.
set_partition_map`.
"""

from __future__ import annotations

import numpy as np


def plan_rebalance(bucket_weights: np.ndarray, n_dev: int) -> np.ndarray:
    """Greedy longest-processing-time binning of hash buckets onto
    partitions: heaviest bucket first, each onto the currently lightest
    partition.  Deterministic (ties break on bucket index, then on
    partition index): the same weights always give the same table."""
    w = np.asarray(bucket_weights, dtype=np.int64)
    order = sorted(range(w.shape[0]), key=lambda b: (-int(w[b]), b))
    load = [0] * n_dev
    pmap = np.zeros(w.shape[0], dtype=np.int32)
    for b in order:
        p = min(range(n_dev), key=lambda d: (load[d], d))
        pmap[b] = p
        load[p] += int(w[b])
    return pmap
