"""Observability (port of ``mapreduce_tpu/obs``):

* :mod:`.metrics` — thread-safe counters, gauges and histograms with
  labels, the process-global :data:`~.metrics.REGISTRY`, its Prometheus
  text and the parser of that text;
* :mod:`.trace` — the monotonic span tracer, its spans exported as
  Chrome trace events and carried across the wire by ``X-Mrtpu-Trace``;
* :mod:`.wavetrace` — the device engine's per-attempt span timeline,
  from CUDA events on the card;
* :mod:`.profile` — the analytic cost model with MFU and the roofline
  share, the peak table, and profile bundles;
* :mod:`.memory` — device-memory gauges, per-program footprints and the
  capacity-retry forensics;
* :mod:`.buildinfo` — the ``mrtpu_build_info`` identity gauge;
* :mod:`.collector` — the telemetry plane: the process-shared pusher and
  the docserver's collector behind ``/clusterz``;
* :mod:`.statusz` — the ``/statusz`` cluster snapshot and the board
  gauges the docserver refreshes before it renders ``/metrics``;
* :mod:`.slo` — the serving-SLO lifecycle histograms and the objectives
  evaluated over them (percentiles, burn rates, breaches);
* :mod:`.comms` — the exchange traffic matrix, its link-class roll-up
  and modeled exchange seconds, and the upload overlap;
* :mod:`.analysis` — ``diagnose`` over a ``/clusterz`` document
  (stragglers, skew, hotspots, the critical path) and its render;
* :mod:`.flight` — the flight recorder ``--trace-out`` arms: SIGTERM
  dumps the span ring and the registry;
* :mod:`.control` — the control ledger of the controllers' decisions;
* :mod:`.compile` — the compile ledger of the builds, loads and
  captures, and the shape registry;
* :mod:`.history` — the durable telemetry history behind ``/queryz``:
  delta-encoded JSONL segments every collector push appends to;
* :mod:`.alerts` — the alerting plane behind ``/alertz``: threshold,
  burn and anomaly rules, a generation-fenced transition log and its
  notification sinks.
"""

from .metrics import DEVICE_BUCKETS  # noqa: F401
from .profile import (  # noqa: F401
    analytic_costs, device_peaks, device_snapshot, load_bundle,
    record_run, validate_trace, write_bundle)
from .memory import (  # noqa: F401
    capacity_retry_event, memory_snapshot, sample_device_memory)
from .comms import (  # noqa: F401
    comms_snapshot, overlap_fraction, record_exchange,
    record_upload_overlap, validate_comms)
from .buildinfo import build_info  # noqa: F401
