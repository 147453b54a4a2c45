"""Observability of the job plane (port of ``mapreduce_tpu/obs``):

* :mod:`.metrics` — thread-safe counters, gauges and histograms with
  labels and the process-global :data:`~.metrics.REGISTRY`;
* :mod:`.trace` — the monotonic span tracer, its spans kept as Chrome
  trace events.

The rest of the JAX package's ``obs/`` (profiles, compile and memory
ledgers, the collector, SLOs, alerts) is not ported yet (ROADMAP A.8).
"""
