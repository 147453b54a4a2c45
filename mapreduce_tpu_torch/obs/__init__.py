"""Observability of the job plane (port of ``mapreduce_tpu/obs``):

* :mod:`.metrics` — thread-safe counters, gauges and histograms with
  labels, the process-global :data:`~.metrics.REGISTRY`, its Prometheus
  text and the parser of that text;
* :mod:`.trace` — the monotonic span tracer, its spans exported as
  Chrome trace events and carried across the wire by ``X-Mrtpu-Trace``;
* :mod:`.collector` — the telemetry plane: the process-shared pusher and
  the docserver's collector behind ``/clusterz``;
* :mod:`.statusz` — the board gauges the docserver refreshes before it
  renders ``/metrics``.

The rest of the JAX package's ``obs/`` (``/statusz``, profiles, compile
and memory ledgers, history, SLOs, alerts) is not ported yet (ROADMAP
A.8).
"""
