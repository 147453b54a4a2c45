"""The device engine's span timeline of one run attempt:
``device_run(attempt, waves) ⊃ wave(wave) ⊃ {upload, compute,
readback(kind="overflow")}`` (the JAX engine's tree,
``mapreduce_tpu/engine/device_engine.py``'s ``run``).

The JAX engine reads each wave's overflow some waves later, and that
read proves the wave finished and closes its span.  The port's engine
reads the overflow once an attempt, after its last wave: that read, the
feeder's staging-buffer waits and the result's copy are the only host
waits of its loop, and this recorder adds none.  So the spans are laid
out after the read, from what the loop noted on the way:

* on CUDA, timing events: an anchor recorded on the kernels' stream at
  the attempt's start (beside a host ``time.monotonic()`` stamp), one
  at each wave's first and last launch, and the feeder's pair around
  each wave's copy on its own stream.  ``elapsed_time`` is read only in
  :meth:`WaveTimeline.finish`, once the attempt's overflow read has
  returned and every event has completed; each event lands on the host
  clock at anchor + elapsed.  ``upload`` and ``compute`` are then device
  intervals, with a ``device_ms`` argument;
* on the CPU, host-clock stamps of the same points (the plain versions
  run synchronously, so the host clock is the device's).

Every ``wave`` span closes at the attempt's one overflow read, whose
interval is each wave's ``readback`` child, as a JAX wave closes at the
read that proves it finished.  A failed attempt closes the waves it
began ``truncated=True``, with no children (a failed device must not be
asked for its events).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from .trace import TRACER, Tracer

Interval = Tuple[float, float]


class WaveTimeline:
    """Notes one attempt's waves and lays out its spans at the end.

    *histogram* (``mrtpu_device_wave_seconds``) observes each span's
    duration by stage: on CUDA ``upload`` and ``compute`` are device
    time, ``wave`` and ``readback`` host-clock intervals laid out with
    them; on the CPU all are host time."""

    def __init__(self, device: Any, attempt: int, waves: int, t0: float,
                 histogram=None, tracer: Tracer = TRACER) -> None:
        self.tracer = tracer
        self.histogram = histogram
        self.cuda = device.type == "cuda"
        self.run_sp = tracer.begin("device_run", start=t0,
                                   attempt=attempt, waves=waves)
        self._waves: List[Dict[str, Any]] = []
        self._anchor = None
        if self.cuda:
            import torch

            self._stream = torch.cuda.current_stream(device)
            self._anchor = self._event()
            self.t_anchor = time.monotonic()

    def _event(self):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    # -- the loop's notes ---------------------------------------------------

    def wave(self, w: int, tb: float, t_up: float,
             copy_events: Optional[tuple] = None) -> None:
        """Wave *w* began at *tb* and had its input at *t_up* (host);
        *copy_events* are the feeder's ``(start, done)`` events of its
        copy on CUDA (None for a staged wave)."""
        self._waves.append({"w": w, "tb": tb, "upload": (tb, t_up),
                            "copy": copy_events, "compute": None})

    def _mark(self):
        return self._event() if self.cuda else time.monotonic()

    def compute_begin(self) -> None:
        """Mark the current wave's first launch."""
        self._waves[-1]["compute"] = (self._mark(), None)

    def compute_end(self) -> None:
        """Mark the current wave's last launch."""
        rec = self._waves[-1]
        rec["compute"] = (rec["compute"][0], self._mark())

    # -- the end of the attempt -----------------------------------------------

    def _on_host(self, ev) -> float:
        return self.t_anchor + self._anchor.elapsed_time(ev) / 1e3

    def finish(self, tr0: float, tr1: float,
               ) -> Tuple[List[Interval], List[Interval]]:
        """Lay out the spans after the attempt's overflow read
        (``tr0``-``tr1``, host).  Returns ``(uploads, busy)``: the
        upload and compute intervals, for the overlap share."""
        lo = self.run_sp.t0
        uploads: List[Interval] = []
        busy: List[Interval] = []

        def clamp(t: float) -> float:
            # the anchor's host stamp and the moment the device reached
            # it differ by the work queued ahead of it on the stream and
            # by the recording call: mapped instants can land a little
            # before the attempt began or after the read returned.  Clamp
            # into [run start, read end] so every child stays inside its
            # wave and every wave inside device_run; the device_ms
            # arguments keep the unclamped durations.
            return min(max(t, lo), tr1)

        for rec in self._waves:
            args_up: Dict[str, Any] = {"clock": "host"}
            args_c: Dict[str, Any] = {"clock": "host"}
            up = rec["upload"]
            c0, c1 = rec["compute"]
            if self.cuda:
                if rec["copy"] is not None:
                    s, d = rec["copy"]
                    up = (self._on_host(s), self._on_host(d))
                    args_up = {"clock": "device",
                               "device_ms": s.elapsed_time(d)}
                args_c = {"clock": "device",
                          "device_ms": c0.elapsed_time(c1)}
                c0, c1 = self._on_host(c0), self._on_host(c1)
            up = (clamp(up[0]), clamp(max(up)))
            comp = (clamp(c0), clamp(max(c0, c1)))
            sp = self.tracer.begin(
                "wave", parent=self.run_sp,
                start=max(min(rec["tb"], up[0], comp[0]), lo), wave=rec["w"])
            self._span("upload", sp, up, args_up)
            self._span("compute", sp, comp, args_c)
            uploads.append(up)
            busy.append(comp)
            self._span("readback", sp, (tr0, tr1), {"kind": "overflow"})
            self.tracer.end(sp, tr1)
            self._observe("wave", tr1 - sp.t0)
        self._waves.clear()
        self.tracer.end(self.run_sp)
        return uploads, busy

    def abort(self) -> None:
        """A failed attempt: close the waves it began, truncated, and the
        run span."""
        now = time.monotonic()
        for rec in self._waves:
            self.tracer.end(self.tracer.begin(
                "wave", parent=self.run_sp, start=rec["tb"], wave=rec["w"]),
                now, truncated=True)
        self._waves.clear()
        self.tracer.end(self.run_sp, now)

    def _span(self, name: str, parent, ival: Interval,
              args: Dict[str, Any]) -> None:
        self.tracer.end(self.tracer.begin(name, parent=parent,
                                          start=ival[0], **args), ival[1])
        seconds = (args["device_ms"] / 1e3 if "device_ms" in args
                   else ival[1] - ival[0])
        self._observe(name, seconds)

    def _observe(self, stage: str, seconds: float) -> None:
        if self.histogram is not None:
            self.histogram.observe(max(0.0, seconds), stage=stage)
