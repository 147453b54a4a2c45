"""Flight recorder: dump telemetry on abnormal exit (port of
``mapreduce_tpu/obs/flight.py``).

A worker killed by SIGTERM (orchestrator eviction, operator Ctrl-C on a
wrapper, OOM-adjacent shutdowns) would take its span ring and metrics
registry with it — exactly the runs whose telemetry an operator wants
most.  :func:`install_flight_recorder` arms a SIGTERM handler plus an
``atexit`` hook that write the tracer ring and a registry snapshot to
paths derived from ``--trace-out``:

    <trace-out>.flight.trace.json     Chrome trace (Perfetto-loadable)
    <trace-out>.flight.metrics.prom   Prometheus exposition snapshot

The dump runs AT MOST ONCE (SIGTERM and atexit both firing is the
normal kill path), and the CLI disarms it after a successful normal
``--trace-out`` export, so flight files appear only when the normal
path didn't run — their presence IS the abnormal-exit signal.

SIGTERM semantics: dump, then exit with the conventional 143 via
``SystemExit`` so ``finally`` blocks and other atexit hooks still run.
Installation is best-effort — signal handlers only install from the
main thread; elsewhere the atexit hook alone is armed.
"""

from __future__ import annotations

import atexit
import logging
import signal
import threading
from typing import Optional, Tuple

from .metrics import REGISTRY, Registry
from .trace import TRACER, Tracer

logger = logging.getLogger("mapreduce_tpu_torch.obs.flight")


class FlightRecorder:
    def __init__(self, trace_out: str, registry: Registry = REGISTRY,
                 tracer: Tracer = TRACER) -> None:
        self.trace_path = f"{trace_out}.flight.trace.json"
        self.metrics_path = f"{trace_out}.flight.metrics.prom"
        self._registry = registry
        self._tracer = tracer
        self._lock = threading.Lock()
        self._done = False
        self._prev_term = None

    def dump(self) -> Optional[Tuple[str, str]]:
        """Write the ring + registry snapshot (idempotent: the second
        caller — atexit after a SIGTERM, say — is a no-op)."""
        with self._lock:
            if self._done:
                return None
            self._done = True
        try:
            self._tracer.export(self.trace_path)
            with open(self.metrics_path, "w", encoding="utf-8") as f:
                f.write(self._registry.render())
        except OSError as exc:
            # a full disk must not turn a clean shutdown into a crash
            logger.warning("flight-recorder dump failed: %s", exc)
            return None
        logger.warning("flight recorder: telemetry dumped to %s / %s",
                       self.trace_path, self.metrics_path)
        return self.trace_path, self.metrics_path

    def disarm(self) -> None:
        """Normal exit path completed (e.g. --trace-out was exported):
        suppress the dump so flight files mark only abnormal exits."""
        with self._lock:
            self._done = True


def install_flight_recorder(trace_out: str,
                            registry: Registry = REGISTRY,
                            tracer: Tracer = TRACER) -> FlightRecorder:
    rec = FlightRecorder(trace_out, registry=registry, tracer=tracer)
    atexit.register(rec.dump)

    def _on_term(signum, frame):
        rec.dump()
        # restore whatever was there so a second SIGTERM kills for real
        signal.signal(signal.SIGTERM, rec._prev_term or signal.SIG_DFL)
        raise SystemExit(143)

    try:
        rec._prev_term = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        # not the main thread: the atexit hook alone is armed
        logger.debug("flight recorder: SIGTERM hook unavailable off the "
                     "main thread; atexit hook armed")
    return rec
