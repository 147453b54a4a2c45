#!/usr/bin/env python3
"""Times the word-count slices on one card, to weigh the device engine's
telemetry against a tree without it.

    python3 probe_telemetry.py [--root DIR] [--runs N]

Imports ``mapreduce_tpu_torch`` from DIR (default: this script's
directory), builds the slices' kernels there, makes ``chip_smoke.py``'s
corpus (16M words, seed 0, 24 chunks of 1<<22 bytes), warms the P = 1
variadic and P = 8 radix slices once each, then runs them N times in
turns (counts held against ``Counter``) and prints one JSON line: each
run's ``compute_s`` and ``upload_s`` and their medians.  To compare two
trees on one card, run it on both in one command, in turns (parent,
change, change, parent).  Needs a CUDA card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
from collections import Counter


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    p.add_argument("--runs", type=int, default=10)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_telemetry: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from dataclasses import replace

    from mapreduce_tpu_torch.corpus import N_LINES
    from mapreduce_tpu_torch.corpus import N_WORDS as EUROPARL_WORDS
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.parallel.mesh import Partitions

    words = 16_000_000
    data = make_corpus(words, words * N_LINES // EUROPARL_WORDS, seed=0)
    want = Counter(data.split())
    cfg = wcmod.bench_engine_config()
    slices = {
        "p1_variadic": (wcmod.DeviceWordCount(
            device="cuda", chunk_len=1 << 22, config=cfg), None),
        "p8_radix": (wcmod.DeviceWordCount(
            Partitions(8, "cuda"), chunk_len=1 << 22,
            config=replace(cfg, sort_impl="radix")), 2)}
    for wc, waves in slices.values():
        if wc.count_bytes(data, waves=waves) != want:  # warm
            raise RuntimeError("probe_telemetry: counts differ")
    out = {name: {"compute_s": [], "upload_s": []} for name in slices}
    for _ in range(args.runs):
        for name, (wc, waves) in slices.items():
            tm = {}
            torch.cuda.synchronize()
            if wc.count_bytes(data, timings=tm, waves=waves) != want:
                raise RuntimeError("probe_telemetry: counts differ")
            for key in ("compute_s", "upload_s"):
                out[name][key].append(tm[key])
    for rec in out.values():
        rec["median_compute_s"] = statistics.median(rec["compute_s"])
        rec["median_upload_s"] = statistics.median(rec["upload_s"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"probe_telemetry": {
        "root": args.root, "card": card, "runs": args.runs,
        "telemetry": os.path.exists(os.path.join(
            args.root, "mapreduce_tpu_torch", "obs", "wavetrace.py")),
        "slices": out}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
