"""Straggler statistics (port of ``STRAGGLER_MAD_K``, ``_median`` and
``_mad`` from ``mapreduce_tpu/obs/analysis.py``).

The speculative re-claimer (:mod:`..engine.autotune`) applies the JAX
package's MAD straggler test to live job documents with these.  The
rest of the JAX module (``diagnose`` over a cluster document, its
render) is not ported yet (ROADMAP A.8).
"""

from __future__ import annotations

from typing import List

#: a worker is a straggler when its job latency exceeds the pooled
#: median by K scaled MADs (and the caller's ratio and floor)
STRAGGLER_MAD_K = 3.0


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if not n:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def _mad(xs: List[float], med: float) -> float:
    return _median([abs(x - med) for x in xs])
