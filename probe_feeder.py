#!/usr/bin/env python3
"""Three ways to feed the word count's waves to one CUDA card, timed in
turns.

    python3 probe_feeder.py

Runs ``DeviceEngine.run`` over chip_smoke.py's corpus (16M words, 24
chunks of 1<<22 bytes, seed 0) with the engine's feeder swapped for each
design in turn (A B C C B A), at P = 1 (``bench_engine_config()``, auto
waves: 2) and at P = 8 (``sort_impl='radix'``, ``waves=2``):

- ``staging``: the package's ``_WaveFeeder``: a worker thread copies
  each wave into one of two pinned host buffers and from there to the
  device on a copy stream; the kernels' stream waits on the copy's
  event;
- ``registered``: the caller's array page-locked for the run
  (``cudaHostRegister``) and each wave copied straight out of it on the
  copy stream (no host copy; the pad rows zeroed on the device);
- ``pageable``: the engine's upload before the feeder: a pageable
  ``.to(device)`` of each wave on the kernels' stream, inline (the
  ``_upload`` this PR replaced, line for line).

Each turn is five timed runs (``upload_s``, ``compute_s``, ``total_s``,
``first_dispatch_s`` and wall seconds, host clock, and the seconds of
each ``cudaHostRegister``; the counts held against ``Counter``) and one
run under ``torch.profiler`` (the host-to-device copies' device ms,
their kinds and the share of them that overlaps kernel time, as
chip_smoke.py's ``upload_report`` reads them).  Prints one JSON line a turn and the
card's name and power limit.  Needs one card; exits non-zero without
one.
"""

import json
import os
import subprocess
import sys
import time

#: (label, partitions, sort_impl, waves) of the two slices
SLICES = (("P1", 1, "variadic", None), ("P8", 8, "radix", 2))
ORDER = ("staging", "registered", "pageable", "pageable", "registered",
         "staging")
#: timed runs a turn
REPS = 5


def feeders(torch, de):
    """The two designs beside the package's, as ``_WaveFeeder``
    subclasses."""

    class Registered(de._WaveFeeder):
        #: seconds of each cudaHostRegister call (the probe reads them)
        register_s = []

        def __init__(self, engine, chunks, *args, **kwargs):
            super().__init__(engine, chunks, *args, **kwargs)
            self._registered = False
            if self._cuda and chunks.nbytes:
                t0 = time.monotonic()
                err = torch.cuda.cudart().cudaHostRegister(
                    chunks.ctypes.data, chunks.nbytes, 0)
                self.register_s.append(time.monotonic() - t0)
                if int(err) != 0:
                    raise RuntimeError(f"cudaHostRegister: {err}")
                self._registered = True

        def _put_wave(self, w):
            if not self._cuda:
                return super()._put_wave(w)
            lo = w * self.rpw
            n = min(self.rpw, self.S - lo)
            src = torch.from_numpy(self._chunks[lo:lo + n])
            with torch.cuda.stream(self._stream):
                dev = torch.empty(self._shape, dtype=self._dtype,
                                  device=self.device)
                dev[:n].copy_(src, non_blocking=True)
                dev[n:].zero_()
                done = torch.cuda.Event()
                done.record(self._stream)
            return dev, done

        def close(self):
            super().close()
            if self._registered:
                self._stream.synchronize()
                torch.cuda.cudart().cudaHostUnregister(
                    self._chunks.ctypes.data)
                self._registered = False

    class Pageable(de._WaveFeeder):
        """The engine's ``_upload`` before the feeder, line for line."""

        def start(self):
            pass

        def get(self, w):
            import numpy as np

            lo = w * self.rpw
            block = self._chunks[lo:lo + self.rpw]
            if block.shape[0] < self.rpw:
                pad = np.zeros((self.rpw - block.shape[0],)
                               + self._chunks.shape[1:],
                               dtype=self._chunks.dtype)
                block = np.concatenate([block, pad])
            return torch.from_numpy(np.ascontiguousarray(block)).to(
                self.device)

    return {"staging": de._WaveFeeder, "registered": Registered,
            "pageable": Pageable}


def main():
    import torch

    if not torch.cuda.is_available():
        print("probe_feeder: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from collections import Counter
    from dataclasses import replace

    import chip_smoke as cs
    from mapreduce_tpu_torch.corpus import N_LINES
    from mapreduce_tpu_torch.corpus import N_WORDS as EUROPARL_WORDS
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.engine import device_engine as de
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from torch.profiler import ProfilerActivity, profile

    kc.build_all(names=("tokenize", "segreduce", "radix"))
    data = make_corpus(cs.N_WORDS, cs.N_WORDS * N_LINES // EUROPARL_WORDS,
                       seed=0)
    want = Counter(data.split())
    designs = feeders(torch, de)
    package_feeder = de._WaveFeeder
    for label, parts, impl, waves in SLICES:
        cfg = replace(wcmod.bench_engine_config(), sort_impl=impl)
        wc = wcmod.DeviceWordCount(Partitions(parts, "cuda"),
                                   chunk_len=cs.CHUNK_LEN, config=cfg)
        chunks, L = wc._to_chunks(data)
        engine = wc._engine_for(L)
        check = wcmod.materialize_counts(chunks, engine.run(chunks,
                                                            waves=waves))
        cs.check(check == want, f"{label}: counts differ (warm run)")
        for design in ORDER:
            de._WaveFeeder = designs[design]
            designs["registered"].register_s.clear()
            runs = []
            try:
                for _ in range(REPS):
                    torch.cuda.synchronize()
                    tm = {}
                    t0 = time.monotonic()
                    res = engine.run(chunks, timings=tm, waves=waves)
                    tm["wall_s"] = time.monotonic() - t0
                    runs.append(tm)
                    cs.check(wcmod.materialize_counts(chunks, res) == want,
                             f"{label} {design}: counts differ")
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    engine.run(chunks, waves=waves)
                    torch.cuda.synchronize()
            finally:
                de._WaveFeeder = package_feeder
            events = cs.trace_events(prof)
            h2d = [e for e in events
                   if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
            kern = [(e["ts"], e["ts"] + e["dur"]) for e in events
                    if e["cat"] == "kernel"]
            busy = []
            for a, b in sorted(kern):
                if busy and a <= busy[-1][1]:
                    busy[-1][1] = max(busy[-1][1], b)
                else:
                    busy.append([a, b])
            h2d_us = sum(e["dur"] for e in h2d)
            overlap = sum(cs._covered(busy, e["ts"], e["ts"] + e["dur"])
                          for e in h2d)
            print(json.dumps({"feeder": {
                "slice": label, "design": design, "waves": tm["waves"],
                **{key: [r[key] for r in runs]
                   for key in ("upload_s", "compute_s", "total_s",
                               "first_dispatch_s", "wall_s")},
                "register_s": list(designs["registered"].register_s),
                "h2d_ms": h2d_us / 1e3, "copies": len(h2d),
                "kinds": sorted({e["name"] for e in h2d}),
                "overlap_share": overlap / h2d_us if h2d_us else None,
                "kernel_ms": sum(b - a for a, b in kern) / 1e3}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
