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
* :mod:`.statusz` — the board gauges the docserver refreshes before it
  renders ``/metrics``;
* :mod:`.slo` — the serving-SLO lifecycle histograms;
* :mod:`.control` — the control ledger of the controllers' decisions,
  with :mod:`.comms`' ``matrix_stats`` and upload overlap and
  :mod:`.analysis`' MAD helpers.

* :mod:`.compile` — the compile ledger of the builds, loads and
  captures, and the shape registry.

Not ported yet (ROADMAP A.8c): ``/statusz``, ``diagnose``, the comms
link classes, the SLO objectives, the durable history and the alerts.
"""

from .metrics import DEVICE_BUCKETS  # noqa: F401
from .profile import (  # noqa: F401
    analytic_costs, device_peaks, device_snapshot, load_bundle,
    record_run, validate_trace, write_bundle)
from .memory import (  # noqa: F401
    capacity_retry_event, memory_snapshot, sample_device_memory)
from .comms import overlap_fraction, record_upload_overlap  # noqa: F401
from .buildinfo import build_info  # noqa: F401
