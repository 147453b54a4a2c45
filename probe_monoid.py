#!/usr/bin/env python3
"""Times the collision-verify word count with its callable monoid against
the same count with the monoid's per-lane codes, on one card.

    python3 probe_monoid.py [--runs N]

Builds the path's kernels, makes ``chip_smoke.py``'s corpus (16M words,
seed 0, 24 chunks of 1<<22 bytes), and for P = 1 variadic and P = 8
radix runs ``DeviceWordCount(verify_collisions=True)`` at the flagship
config N times (default 6) with each monoid, in turns (callable,
codes, codes, callable, ...), each engine warmed by one run first;
counts are held against ``Counter``.  One more run of each under ``torch.profiler``
gives the device time by kernel (the monoid kernel's segreduce against
the codes kernel's, and everything else).  Prints one JSON line per
configuration.  Needs a CUDA card.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter


def device_ms(torch, run):
    """Device milliseconds and calls of *run* by group (the monoid
    kernel's segreduce, the codes kernel's, the other kernels, copies),
    from ``torch.profiler``'s device-side events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    groups, calls = {}, {}
    for ev in prof.key_averages():
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)
                or ev.key == "Activity Buffer Request"):
            continue
        us = float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        if us <= 0:
            continue
        name = ev.key
        g = ("segreduce (monoid)" if "MonoidOp" in name
             else "segreduce (codes)" if "SegOp" in name
             else "copies" if "Memcpy" in name or "Memset" in name
             else "other kernels")
        groups[g] = groups.get(g, 0.0) + us / 1e3
        calls[g] = calls.get(g, 0) + ev.count
    return {"wall_s": wall, "device_ms": groups, "calls": calls}


def main():
    runs = int(sys.argv[sys.argv.index("--runs") + 1]) \
        if "--runs" in sys.argv else 6
    import torch

    if not torch.cuda.is_available():
        print("probe_monoid: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dataclasses import replace

    from mapreduce_tpu_torch.corpus import N_LINES
    from mapreduce_tpu_torch.corpus import N_WORDS as EUROPARL_WORDS
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.ops import monoid
    from mapreduce_tpu_torch.parallel.mesh import Partitions

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    kc.build_all(names=kc.SOURCES + (kc.monoid_library(
        monoid.lower(wcmod.VERIFY_REDUCE_OP)),))
    n_words = 16_000_000
    data = make_corpus(n_words, n_words * N_LINES // EUROPARL_WORDS, seed=0)
    want = Counter(data.split())
    ops = {"callable": wcmod.VERIFY_REDUCE_OP,
           "codes": ("sum", "min", "max")}
    for label, n_parts, impl in (("P1", 1, "variadic"), ("P8", 8, "radix")):
        counts = {}
        for name, op in ops.items():
            cfg = replace(wcmod.bench_engine_config(), sort_impl=impl)
            wc = wcmod.DeviceWordCount(Partitions(n_parts, "cuda"),
                                       chunk_len=1 << 22, config=cfg,
                                       verify_collisions=True)
            wc.config = replace(wc.config, reduce_op=op)
            wc.warm()
            if wc.count_bytes(data) != want:
                raise RuntimeError(f"probe_monoid: {label} {name} differs "
                                   "from Counter")
            counts[name] = wc
        times = {name: [] for name in ops}
        walls = {name: [] for name in ops}
        for i in range(runs):
            for name in (("callable", "codes") if i % 2 == 0
                         else ("codes", "callable")):
                tm = {}
                t0 = time.monotonic()
                if counts[name].count_bytes(data, timings=tm) != want:
                    raise RuntimeError(f"probe_monoid: {label} {name}")
                walls[name].append(time.monotonic() - t0)
                times[name].append(tm["compute_s"])
        prof = {name: device_ms(torch, lambda w=counts[name]:
                                w.count_bytes(data)) for name in ops}
        print(json.dumps({"probe_monoid": {
            "run": label, "card": smi, "words": n_words, "runs": runs,
            "compute_s": times, "wall_s": walls,
            "median_compute_s": {n: statistics.median(v)
                                 for n, v in times.items()},
            "profiled": prof}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
