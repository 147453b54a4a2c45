#!/usr/bin/env python3
"""Times phase 21 (c) of ``chip_smoke.py`` (``PipelineConfig()``, 8
stages, 16 microbatches, seed 0, the batch of seed 4) on the port's
package of one or more checkouts, for an A/B of two trees on one card:

    python3 probe_pipeline.py ROOT [ROOT ...]

Each ROOT runs in a process of its own, in the order given (parent,
change, change, parent for an A/B), and prints one ``probe_pipeline``
line: the ROOT, the pipelined step s as phase 21 (c) times it (the loss
of ``pipeline_loss``, ``autograd.grad``, SGD in place), the
``PipelinedTrainer.step`` s, each the median of 10 after a warm one,
and the card's name and power limit.  The timing code is this file's
and this checkout's ``chip_smoke.py``, so only the package differs
between the rows.  Needs a CUDA card.
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def one(root):
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_pipeline: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from mapreduce_tpu_torch.models import pipeline as pmod

    if not pmod.__file__.startswith(root + os.sep):
        print(f"probe_pipeline: imported {pmod.__file__}, not {root}'s "
              "package", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = pmod.PipelineConfig()
    tr = pmod.PipelinedTrainer(cfg, learning_rate=0.1, seed=0,
                               n_stages=cs.PIPE_STAGES, device="cuda")
    params = tr.init_params()
    x, y = cs.pipeline_batch(np, cfg)
    xd, yd = tr.place_batch(x, y)
    names = list(params)

    def loss_step():
        for n in names:
            params[n].requires_grad_(True)
        grads = torch.autograd.grad(
            pmod.pipeline_loss(params, xd, yd, cfg),
            [params[n] for n in names])
        with torch.no_grad():
            for n, g in zip(names, grads):
                params[n].requires_grad_(False)
                params[n].sub_(g * tr.lr)

    loss_s, loss_times = cs.median_step_s(torch, loss_step)
    step_s, step_times = cs.median_step_s(
        torch, lambda: tr.step(params, x, y))
    print(json.dumps({"probe_pipeline": {
        "root": root, "pipelined_step_s": loss_s,
        "pipelined_step_times": loss_times, "trainer_step_s": step_s,
        "trainer_step_times": step_times, "card": smi}}), flush=True)
    return 0


def main(argv):
    if argv[:1] == ["--one"]:
        return one(argv[1])
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in argv:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
