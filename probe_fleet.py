#!/usr/bin/env python3
"""Runs phase 22 of ``chip_smoke.py`` (the engine-host fleet and the
two-controller gloo mesh) alone, on one card.

    python3 probe_fleet.py

Builds the word-count kernels, copies them into a build directory of the
run's own (``chip_smoke.own_build_dir``: every child of the phase loads
them from there through ``$MAPREDUCE_TPU_CACHE``), makes the smoke's
corpus (16M words, seed 0, 24 chunks of 1<<22 bytes) and runs phase 7's
radix slice (whose traffic matrix and ``compute_s`` phase 22 (e) is held
against), then ``chip_smoke.fleet_phase``: (a) the migration, (b) two
fleet hosts on the card, (c) a SIGKILLed engine host re-homed and
restored, (d) ``cli drain`` through a docserver and two runners, (e) two
controllers over gloo.  Phase 8's one-host rate is not run here, so (b)
prints no ratio.  Prints the phase's ``fleet_*`` lines, then one
``probe_fleet`` line with its launches and wall.  Needs a CUDA card.
"""

import json
import os
import subprocess
import sys
import time
from collections import Counter


def main():
    import torch

    if not torch.cuda.is_available():
        print("probe_fleet: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from mapreduce_tpu_torch.corpus import N_LINES
    from mapreduce_tpu_torch.corpus import N_WORDS as EUROPARL_WORDS
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.ops import radix_sort as rs
    from mapreduce_tpu_torch.ops import segscan as seg
    from mapreduce_tpu_torch.parallel.mesh import Partitions

    t_start = time.monotonic()
    kc.build_all(names=kc.SOURCES)
    print(f"build: {time.monotonic() - t_start:.2f} s; build dir "
          f"{cs.own_build_dir()}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    data = make_corpus(cs.N_WORDS, cs.N_WORDS * N_LINES // EUROPARL_WORDS,
                       seed=0)
    want = Counter(data.split())
    wc = wcmod.DeviceWordCount(device="cuda", chunk_len=cs.CHUNK_LEN,
                               config=wcmod.bench_engine_config())
    chunks, _ = wc._to_chunks(data)
    _, _, rmatrix = cs.radix_slice_phase(torch, kc, rs, wcmod, Partitions,
                                         data, want)
    launches = cs.fleet_phase(torch, kc, seg, rs, wcmod, Partitions, data,
                              want, chunks, rmatrix, smi)
    print(json.dumps({"probe_fleet": {
        "wall_s": time.monotonic() - t_start, "launches": launches,
        "card": smi}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
