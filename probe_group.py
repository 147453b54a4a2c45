#!/usr/bin/env python3
"""Runs phase 23 of ``chip_smoke.py`` (the resident session, ``fit`` and
the transformer's ring over a gloo group of two ranks) alone, on one
card.

    python3 probe_group.py

Builds the word-count and flash kernels, copies them into a build
directory of the run's own (``chip_smoke.own_build_dir``: both ranks
load them from there through ``$MAPREDUCE_TPU_CACHE``), makes the
smoke's corpus (16M words, seed 0, 24 chunks of 1<<22 bytes), takes
phase 21 (b)'s one-process ring step (bench_longctx, seed 0, the same
tokens) as phase 23 (c)'s reference, then runs ``chip_smoke.group_phase``:
(a) the flagship stream as a session over 8 partitions, 4 a rank; (b)
``fit`` of the bench_train MLP with a lease on rank 0, a resume and a
fence; (c) bench_longctx's step over the ring across the two ranks.
Phase 8's rates are not run here, so (a) prints no phase 8 figure.
Prints the phase's ``group_*`` lines, then one ``probe_group`` line with
its launches and wall.  Needs a CUDA card.
"""

import json
import os
import subprocess
import sys
import time
from collections import Counter


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_group: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from mapreduce_tpu_torch.corpus import N_LINES
    from mapreduce_tpu_torch.corpus import N_WORDS as EUROPARL_WORDS
    from mapreduce_tpu_torch.corpus import make_corpus
    from mapreduce_tpu_torch.engine import wordcount as wcmod
    from mapreduce_tpu_torch.models import transformer as tmod
    from mapreduce_tpu_torch.ops import kernel_compat as kc

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
    # phase 21 (b)'s one-process ring step from the same parameters
    cfg = tmod.TransformerConfig(**cs.RING_CONFIG, flash=False)
    tr = tmod.TransformerTrainer(cfg, learning_rate=cs.TF_LR, seed=0,
                                 device="cuda", n_data=cs.RING_PARTS)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(1, cs.RING_T + 1)).astype(np.int32)
    p0 = {n: t.clone() for n, t in tr.init_params().state_dict().items()}
    t0 = time.monotonic()
    loss, state = cs.step_from(tmod, tr, p0, toks)
    torch.cuda.synchronize()
    ring_s = time.monotonic() - t0
    cs.PHASE_NUMBERS["ring_step"] = (
        {n: t.cpu() for n, t in p0.items()},
        (loss, {n: t.cpu() for n, t in state.items()}))
    del p0, state
    launches = cs.group_phase(torch, kc, wcmod, chunks, want, smi)
    print(json.dumps({"probe_group": {
        "wall_s": time.monotonic() - t_start,
        "one_process_ring_step_s": ring_s, "launches": launches,
        "card": smi}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
