"""The port's training plane over a process group: ``fit`` with its
checkpoints and lease, and the transformer's sequence axis across ranks.

Two gloo rank processes on the CPU (``python -m
tests.test_torch_multiproc_train train RANK 2 PORT ROOT OUT``, no JAX in
the rank body) run every scenario in one spawn while the parent computes
the references (``ring RANK 2 PORT OUT DEVICE`` is the card test's causal
ring over the group, in ``tests/test_torch_cuda.py``):

* ``DistributedTrainer(n_data=8, group=WORLD).fit`` of the f32 digits
  MLP over 3 epochs with a ``CheckpointManager``: the history and
  ``best_epoch`` are equal on both ranks; each epoch's losses are within
  1e-6 relative of a one-process ``fit`` and the final parameters within
  :data:`FIT_PARAM_ATOL` of its (the halves' gradients are summed in
  another order); a resume from epoch 2's checkpoint equals the
  uninterrupted run bit for bit; a lease fenced on rank 0 before epoch 3
  raises ``TrainerFencedError`` on both ranks with no step-3 manifest; a
  lease given to rank 1 raises ``ValueError``; the group's checkpoints
  are a one-process save's files, which the JAX ``CheckpointManager``
  restores;
* the dense transformer (f32, 2 layers) at ``n_data=4`` over 2 ranks:
  the ring's output and lse within 1e-6 of the one-process ring, the
  loss equal on both ranks and within 1e-5 relative of the one-process
  ``TransformerTrainer(n_data=4)`` and of the JAX trainer on a 4-device
  CPU mesh, the updated parameters within :data:`TF_PARAM_ATOL` of the
  one-process step's and equal on both ranks; the same for the MoE
  (``n_model=2``, 2 experts, ``n_data=2``) with the routing pinned to a
  fixed rule (:func:`pinned_route`) on both sides of the step;
* ``PipelinedTrainer(group=WORLD)`` (:data:`PIPE_CASES`): 4 stages, 2 a
  rank, over 2 data shards of 4 microbatches, f32 and bf16, and the
  data axis across the ranks (1 stage, 4 shards): the forward on each
  rank within ``tests/test_torch_pipeline.py``'s tolerances (rtol 2e-5,
  atol 2e-6) of the one-process port's and, in f32, of the JAX
  ``PipelinedTrainer``'s on its CPU mesh; the loss equal on both ranks;
  after one step every parameter (``w_in``, each rank's own ``w_stage``
  and ``b_stage`` blocks, ``w_out``) within :data:`PIPE_PARAM_ATOL` of
  the one-process step's and the shared ones equal on both ranks, and
  the blocks a rank does not own as they were placed.
"""

import datetime
import json
import os
import sys
import uuid

import numpy as np
import pytest
import torch

from tests.test_torch_multiproc import RANK_THREADS, _start, _wait

#: seconds a collective may wait for the other rank before it fails
GROUP_TIMEOUT_S = 60
FIT_CFG = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-3,
               bunch_size=8, max_epochs=3, min_epochs=1, patience=5)
N_DATA = 8
#: the final MLP parameters against the one-process fit's (max abs a
#: leaf): six f32 steps whose halves' gradients sum in another order
#: differ by 3e-8 here; a fit whose gradients are not all-reduced (only
#: its loss) by 1.7e-2 or more
FIT_PARAM_ATOL = 1e-6
TF_SMALL = dict(vocab=64, embed=32, n_layers=2, n_heads=2, head_dim=16,
                ffn=64)
TF_B, TF_T, TF_LR = 2, 64, 1e-2
#: the transformer's updated parameters against the one-process step's
#: (3e-8 here; 3.5e-3 or more when only the loss is all-reduced)
TF_PARAM_ATOL = 1e-6
#: the ring over the group against one process's (output, lse and the
#: non-causal case's gradients, max abs)
RING_ATOL = 1e-6
#: (name, config overrides, n_model, n_data)
TF_CASES = (("dense", {}, 1, 4), ("moe", {"moe_experts": 2}, 2, 2))
#: the pipeline's narrow config, microbatches a shard and learning rate;
#: (name, dtype, n_stages, n_data) over the two ranks: the stages across
#: them, then the data shards
PIPE_CFG = dict(n_in=16, hidden=32, n_classes=10, microbatch=4)
PIPE_M, PIPE_LR = 4, 0.1
PIPE_CASES = (("f32", "float32", 4, 2), ("bf16", "bfloat16", 4, 2),
              ("data", "float32", 1, 4))
#: the forward against one process's and the JAX trainer's
#: (tests/test_torch_pipeline.py's), and the updated parameters against
#: the one-process step's (max abs)
PIPE_RTOL, PIPE_ATOL = 2e-5, 2e-6
PIPE_PARAM_ATOL = 1e-6


# -- the rank body (run as a module in each child) ----------------------------


def _init_group(rank, world, port):
    import torch.distributed as dist

    torch.set_num_threads(RANK_THREADS)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return dist


def pinned_route(route):
    """The router *route* with its experts pinned: token ``n`` of every
    partition goes to expert ``n % n_exp`` (the gates stay the router's
    own probabilities)."""
    def pinned(flat, w_router):
        probs, _ = route(flat, w_router)
        n_exp = w_router.shape[1]
        expert = torch.arange(flat.shape[1], device=flat.device) % n_exp
        return probs, expert.expand(flat.shape[0], -1)

    return pinned


def tf_tokens():
    return np.random.default_rng(0).integers(
        0, TF_SMALL["vocab"], size=(TF_B, TF_T + 1)).astype(np.int32)


def fit_data():
    from mapreduce_tpu_torch.models import digits

    return digits.make_digits(n_train=160, n_val=40)


def _trainer(group=None):
    from mapreduce_tpu_torch.models import (
        DistributedTrainer, MLPConfig, TrainConfig)

    def make(**over):
        return DistributedTrainer(
            MLPConfig(dtype=torch.float32),
            TrainConfig(**dict(FIT_CFG, **over)), n_data=N_DATA,
            device="cpu", group=group)
    return make


def _fit_record(got):
    return {"history": got["history"], "best_epoch": got["best_epoch"],
            "epochs_run": got["epochs_run"],
            "start_epoch": got["start_epoch"], "restored": got["restored"]}


def _rank_fit(dist, rank, root, out, meta):
    """The fit scenarios: uninterrupted, interrupted and resumed, fenced,
    and a lease on rank 1."""
    from mapreduce_tpu_torch.coord import (
        Connection, TrainerFencedError, TrainerLease)
    from mapreduce_tpu_torch.models.checkpoint import CheckpointManager
    from mapreduce_tpu_torch.storage.localdir import LocalDirStorage

    make = _trainer(dist.group.WORLD)
    data = fit_data()

    def manager(name):
        return CheckpointManager(LocalDirStorage(os.path.join(root, name)))

    got = make().fit(*data, manager=manager("whole"))
    meta["fit"] = _fit_record(got)
    out.update({f"fit.{n}": t.detach().numpy()
                for n, t in got["params"].items()})
    assert make(max_epochs=2).fit(*data, manager=manager("resumed"))[
        "epochs_run"] == 2
    got = make().fit(*data, manager=manager("resumed"))
    meta["resumed"] = _fit_record(got)
    out.update({f"resumed.{n}": t.detach().numpy()
                for n, t in got["params"].items()})

    lease = successor = None
    if rank == 0:
        board = f"mem://{uuid.uuid4().hex}"
        lease = TrainerLease(Connection(board, "t"), holder="a", lease=5.0)
        lease.acquire(timeout=5)
        successor = TrainerLease(Connection(board, "t"), holder="b",
                                 lease=5.0)

    def take_over(rec):
        """After epoch 2 commits, a successor takes rank 0's lease."""
        if rec["epoch"] == 2 and lease is not None:
            lease.lease = 0.2
            assert lease.heartbeat()
            import time

            time.sleep(0.3)
            assert successor.try_acquire()

    try:
        make().fit(*data, manager=manager("fenced"), lease=lease,
                   on_epoch=take_over)
        meta["fenced"] = None
    except TrainerFencedError as exc:
        meta["fenced"] = f"{type(exc).__name__}: {exc}"
    dist.barrier()
    if rank == 1:
        try:
            make().fit(*data, lease=object())
            meta["rank1_lease"] = None
        except ValueError as exc:
            meta["rank1_lease"] = str(exc)


def ring_nc_inputs(rank=None):
    """The non-causal ring case's q, k, v and output cotangent ``[2, 32,
    2, 8]`` f32 from a seed; with *rank*, that rank's half of the
    sequence."""
    rng = np.random.default_rng(6)
    ts = [torch.tensor(rng.normal(size=(2, 32, 2, 8)).astype(np.float32))
          for _ in range(4)]
    return ts if rank is None else [t[:, rank * 16:(rank + 1) * 16]
                                    for t in ts]


def _rank_transformer(dist, out, meta):
    """The ring alone, then each case's loss and one SGD step."""
    from mapreduce_tpu_torch.models import transformer as tmod
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.parallel import ring

    rank = dist.get_rank()
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.normal(size=(2, 32, 2, 8)).astype(
        np.float32))[:, rank * 16:(rank + 1) * 16] for _ in range(3))
    kc.reset_counts()
    o, lse = ring._ring_flash(q, k, v, 4, True, 8 ** -0.5,
                              group=dist.group.WORLD)
    out["ring.out"], out["ring.lse"] = o.numpy(), lse.numpy()
    meta["ring_calls"] = kc.PLAIN_CALLS["flash_fwd"]
    # non-causal, with its backward: every block crosses every boundary
    q, k, v, do = (t.contiguous().requires_grad_()
                   for t in ring_nc_inputs(rank))
    o, _ = ring._ring_flash(q, k, v, 4, False, 8 ** -0.5,
                            group=dist.group.WORLD)
    o.backward(do.detach())
    out.update({f"ring_nc.{n}": t.detach().numpy() for n, t in (
        ("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))})
    toks = tf_tokens()
    route = tmod._route
    for name, over, n_model, n_data in TF_CASES:
        cfg = tmod.TransformerConfig(dtype=torch.float32,
                                     **dict(TF_SMALL, **over))
        tr = tmod.TransformerTrainer(cfg, learning_rate=TF_LR, seed=1,
                                     device="cpu", n_model=n_model,
                                     n_data=n_data, group=dist.group.WORLD)
        params = tr.init_params()
        meta[f"{name}.loss"] = float(tr.loss(params, toks))
        tmod._route = pinned_route(route)
        try:
            params, loss = tr.step(params, toks)
        finally:
            tmod._route = route
        meta[f"{name}.step_loss"] = float(loss)
        out.update({f"{name}.{n}": t.detach().numpy()
                    for n, t in params.state_dict().items()})


def pipe_batch(n_data):
    """A pipeline case's whole batch: PIPE_M microbatches a shard."""
    rng = np.random.default_rng(9)
    n = PIPE_CFG["microbatch"] * PIPE_M * n_data
    x = rng.normal(size=(n, PIPE_CFG["n_in"])).astype(np.float32)
    return x, x[:, :PIPE_CFG["n_classes"]].argmax(-1)


def pipe_trainer(dtype, n_stages, n_data, device, group=None):
    from mapreduce_tpu_torch.models import pipeline as pmod

    cfg = pmod.PipelineConfig(dtype=getattr(torch, dtype), **PIPE_CFG)
    return pmod.PipelinedTrainer(cfg, learning_rate=PIPE_LR, seed=3,
                                 n_stages=n_stages, n_data=n_data,
                                 device=device, group=group)


def _rank_pipeline(dist, out, meta, device):
    """Each pipeline case over the group: the forward of this rank's
    rows, the loss, one step and the updated parameters."""
    from mapreduce_tpu_torch.models import pipeline as pmod

    for name, dtype, n_stages, n_data in PIPE_CASES:
        tr = pipe_trainer(dtype, n_stages, n_data, device, dist.group.WORLD)
        params = tr.init_params()
        x, y = pipe_batch(n_data)
        xd, _ = tr._rows(*tr.place_batch(x, y))
        with torch.no_grad():
            out[f"pipe.{name}.forward"] = pmod.pipeline_forward_local(
                params, xd, tr.cfg, n_data, dist.group.WORLD).cpu().numpy()
        meta[f"pipe.{name}.loss"] = float(tr.loss(params, x, y))
        params, loss = tr.step(params, x, y)
        meta[f"pipe.{name}.step_loss"] = float(loss)
        out.update({f"pipe.{name}.{n}": t.cpu().numpy()
                    for n, t in params.items()})


def _rank_train(rank, world, port, root, out_path):
    dist = _init_group(rank, world, port)
    try:
        out, meta = {}, {}
        _rank_fit(dist, rank, root, out, meta)
        _rank_transformer(dist, out, meta)
        _rank_pipeline(dist, out, meta, "cpu")
        dist.barrier()
        np.savez(out_path, **out)
        with open(out_path + ".json", "w") as f:
            json.dump(meta, f)
    finally:
        dist.destroy_process_group()


def ring_inputs(device):
    """The card test's global q, k, v and output cotangent: ``[2, 1024,
    4, 64]`` bf16 from a seed."""
    rng = np.random.default_rng(7)
    return [torch.from_numpy(rng.standard_normal(
        (2, 1024, 4, 64)).astype(np.float32)).to(torch.bfloat16).to(device)
        for _ in range(4)]


def _rank_ring(rank, world, port, out_path, device):
    """The causal ring over the group on *device*: this rank's slice of
    the output and of the q, k, v gradients, and its flash launches."""
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.parallel.ring import ring_attention

    dist = _init_group(rank, world, port)
    try:
        per = 1024 // world
        q, k, v, do = (t[:, rank * per:(rank + 1) * per]
                       for t in ring_inputs(device))
        q, k, v = (t.contiguous().requires_grad_() for t in (q, k, v))
        kc.reset_counts()
        out = ring_attention(q, k, v, 4, causal=True,
                             group=dist.group.WORLD)
        out.backward(do)
        meta = {"launches": dict(kc.LAUNCHES),
                "plain_calls": dict(kc.PLAIN_CALLS)}
        dist.barrier()
        np.savez(out_path, **{n: t.detach().float().cpu().numpy()
                              for n, t in (("out", out), ("dq", q.grad),
                                           ("dk", k.grad), ("dv", v.grad))})
        with open(out_path + ".json", "w") as f:
            json.dump(meta, f)
    finally:
        dist.destroy_process_group()


def _rank_pipe(rank, world, port, out_path, device):
    """The pipeline cases over the group on *device* (the card test's)."""
    dist = _init_group(rank, world, port)
    try:
        out, meta = {}, {}
        _rank_pipeline(dist, out, meta, device)
        dist.barrier()
        np.savez(out_path, **out)
        with open(out_path + ".json", "w") as f:
            json.dump(meta, f)
    finally:
        dist.destroy_process_group()


def _main(argv) -> int:
    if argv[0] == "ring":
        _rank_ring(int(argv[1]), int(argv[2]), int(argv[3]), *argv[4:6])
    elif argv[0] == "pipe":
        _rank_pipe(int(argv[1]), int(argv[2]), int(argv[3]), *argv[4:6])
    else:
        _rank_train(int(argv[1]), int(argv[2]), int(argv[3]), *argv[4:6])
    return 0


# -- the parent side ----------------------------------------------------------


def _one_process_fit(root):
    from mapreduce_tpu_torch.models.checkpoint import CheckpointManager
    from mapreduce_tpu_torch.storage.localdir import LocalDirStorage

    return _trainer()().fit(*fit_data(), manager=CheckpointManager(
        LocalDirStorage(os.path.join(root, "one"))))


def _one_process_transformer():
    """Each case's one-process loss, pinned step and updated parameters,
    and the one-process ring's output and lse."""
    from mapreduce_tpu_torch.models import transformer as tmod
    from mapreduce_tpu_torch.parallel import ring

    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.normal(size=(2, 32, 2, 8)).astype(
        np.float32)) for _ in range(3))
    refs = {"ring": ring._ring_flash(q, k, v, 4, True, 8 ** -0.5)}
    q, k, v, do = (t.requires_grad_() for t in ring_nc_inputs())
    o, _ = ring._ring_flash(q, k, v, 4, False, 8 ** -0.5)
    o.backward(do.detach())
    refs["ring_nc"] = {n: t.detach().numpy() for n, t in (
        ("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}
    toks = tf_tokens()
    route = tmod._route
    for name, over, n_model, n_data in TF_CASES:
        cfg = tmod.TransformerConfig(dtype=torch.float32,
                                     **dict(TF_SMALL, **over))
        tr = tmod.TransformerTrainer(cfg, learning_rate=TF_LR, seed=1,
                                     device="cpu", n_model=n_model,
                                     n_data=n_data)
        params = tr.init_params()
        init = {n: t.detach().numpy().copy()
                for n, t in params.state_dict().items()}
        loss = float(tr.loss(params, toks))
        tmod._route = pinned_route(route)
        try:
            params, step_loss = tr.step(params, toks)
        finally:
            tmod._route = route
        refs[name] = (loss, float(step_loss), init,
                      {n: t.detach().numpy()
                       for n, t in params.state_dict().items()})
    return refs


def one_process_pipeline(device):
    """Each pipeline case in one process on *device*: ``{name: (initial
    parameters, forward, loss, step loss, updated parameters)}``."""
    from mapreduce_tpu_torch.models import pipeline as pmod

    refs = {}
    for name, dtype, n_stages, n_data in PIPE_CASES:
        tr = pipe_trainer(dtype, n_stages, n_data, device)
        params = tr.init_params()
        init = {n: t.cpu().numpy().copy() for n, t in params.items()}
        x, y = pipe_batch(n_data)
        with torch.no_grad():
            fwd = pmod.pipeline_forward_local(
                params, tr.place_batch(x, y)[0], tr.cfg, n_data)
        loss = float(tr.loss(params, x, y))
        params, step_loss = tr.step(params, x, y)
        refs[name] = (init, fwd.cpu().numpy(), loss, float(step_loss),
                      {n: t.cpu().numpy() for n, t in params.items()})
    return refs


def check_pipeline(ranks, metas, refs):
    """The ranks' pipeline cases against one process's (*refs*, from
    :func:`one_process_pipeline`); the parameter names and shapes are
    the JAX ones on both ranks."""
    for name, _, n_stages, n_data in PIPE_CASES:
        init, fwd, loss, step_loss, want = refs[name]
        for key, ref in (("loss", loss), ("step_loss", step_loss)):
            got = [m[f"pipe.{name}.{key}"] for m in metas]
            assert got[0] == got[1], (name, key, got)
            assert got[0] == pytest.approx(ref, rel=1e-6), (name, key)
        split = n_stages > 1  # the stages span the ranks, else the data
        per = fwd.shape[0] // 2
        for r, rk in enumerate(ranks):
            rows = slice(None) if split else slice(r * per, (r + 1) * per)
            np.testing.assert_allclose(rk[f"pipe.{name}.forward"],
                                       fwd[rows], rtol=PIPE_RTOL,
                                       atol=PIPE_ATOL, err_msg=name)
        own = n_stages // 2
        for n, a in want.items():
            got = [rk[f"pipe.{name}.{n}"] for rk in ranks]
            assert all(g.shape == a.shape for g in got), (name, n)
            if split and n in ("w_stage", "b_stage"):
                for r, g in enumerate(got):
                    mine = slice(r * own, (r + 1) * own)
                    np.testing.assert_allclose(
                        g[mine], a[mine], rtol=0, atol=PIPE_PARAM_ATOL,
                        err_msg=f"{name}.{n} rank {r}")
                    theirs = slice((1 - r) * own, (2 - r) * own)
                    assert np.array_equal(g[theirs], init[n][theirs]), (
                        name, n, r)
                continue
            assert np.array_equal(got[0], got[1]), (name, n)
            np.testing.assert_allclose(got[0], a, rtol=0,
                                       atol=PIPE_PARAM_ATOL,
                                       err_msg=f"{name}.{n}")


def _jax_pipeline_forwards(refs):
    """The JAX pipelined forward of each f32 case's initial parameters
    on its ``(n_stages, n_data)`` CPU mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS

    from mapreduce_tpu.models import pipeline as jpipe
    from mapreduce_tpu.parallel import make_mesh

    out = {}
    for name, dtype, n_stages, n_data in PIPE_CASES:
        if dtype != "float32":
            continue  # bf16 products round apart: held in one process
        jcfg = jpipe.PipelineConfig(dtype=jnp.float32, **PIPE_CFG)
        mesh = make_mesh(n_data=n_data, n_model=n_stages)
        params = refs[name][0]
        fwd = jax.jit(jax.shard_map(
            lambda p, xx: jpipe.pipeline_forward_local(p, xx, jcfg),
            mesh=mesh, in_specs=({n: jpipe.pipeline_param_spec(n)
                                  for n in params}, PS("data")),
            out_specs=PS("data")))
        out[name] = np.asarray(fwd(params, pipe_batch(n_data)[0]))
    return out


def _jax_losses(init):
    """The JAX trainer's loss of each case's initial parameters on its
    4-device CPU mesh (f32 products)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from mapreduce_tpu.models import transformer as jtf
    from mapreduce_tpu.parallel import make_mesh
    from mapreduce_tpu_torch import convert
    from mapreduce_tpu_torch.models import transformer as tmod

    out = {}
    for name, over, n_model, n_data in TF_CASES:
        jcfg = jtf.TransformerConfig(dtype=jnp.float32,
                                     **dict(TF_SMALL, **over))
        jtr = jtf.TransformerTrainer(make_mesh(n_data=n_data,
                                               n_model=n_model), jcfg)
        tcfg = convert.transformer_config_from_jax(
            dict(dataclasses.asdict(jcfg), dtype="float32"))
        model = tmod.Transformer(tcfg, device="cpu")
        model.load_state_dict({n: torch.from_numpy(a)
                               for n, a in init[name].items()})
        host = convert.transformer_params_to_numpy(model)
        x, y = jtr.place_batch(tf_tokens())
        with jax.default_matmul_precision("float32"):
            out[name] = float(jtr._loss(jtr._place_params(host), x, y))
    return out


def test_fit_and_transformer_over_two_ranks_match_one_process_and_jax(
        tmp_path):
    import jax.numpy as jnp

    from mapreduce_tpu.models import DistributedTrainer as JTrainer
    from mapreduce_tpu.models import MLPConfig as JMLP
    from mapreduce_tpu.models import TrainConfig as JConfig
    from mapreduce_tpu.models.checkpoint import CheckpointManager as JManager
    from mapreduce_tpu.models.trainer import TRAINER_PARTITION_RULES
    from mapreduce_tpu.parallel import make_mesh
    from mapreduce_tpu.storage.localdir import LocalDirStorage as JLocal
    from mapreduce_tpu_torch.models.checkpoint import CheckpointManager
    from mapreduce_tpu_torch.storage.localdir import LocalDirStorage
    from tests.test_torch_training import _jax_state

    procs = _start("train", str(tmp_path),
                   lambda r: str(tmp_path / f"rank{r}.npz"),
                   module="tests.test_torch_multiproc_train")
    # the references run while the ranks do, on as few threads as a
    # rank (the suite's other workers share the host)
    threads = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    try:
        one_fit = _one_process_fit(str(tmp_path))
        tf_refs = _one_process_transformer()
        jax_losses = _jax_losses({name: tf_refs[name][2]
                                  for name, *_ in TF_CASES})
        jt = JTrainer(make_mesh(), JMLP(dtype=jnp.float32),
                      JConfig(**FIT_CFG))
        pipe_refs = one_process_pipeline("cpu")
        jax_pipe = _jax_pipeline_forwards(pipe_refs)
        outs = _wait(procs)
    finally:
        torch.set_num_threads(threads)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out}"
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    metas = [json.loads((tmp_path / f"rank{r}.npz.json").read_text())
             for r in range(2)]

    # fit: one history on both ranks, the one-process fit's within 1e-6
    fit = metas[0]["fit"]
    assert fit == metas[1]["fit"]
    assert fit["epochs_run"] == one_fit["epochs_run"] == 3
    assert fit["best_epoch"] == one_fit["best_epoch"]
    for g, w in zip(fit["history"], one_fit["history"]):
        for key in ("train_loss", "val_loss"):
            assert g[key] == pytest.approx(w[key], rel=1e-6), (key, g, w)
        assert g["val_acc"] == w["val_acc"]
    for n, t in one_fit["params"].items():
        assert np.array_equal(ranks[0][f"fit.{n}"], ranks[1][f"fit.{n}"])
        np.testing.assert_allclose(ranks[0][f"fit.{n}"], t.detach().numpy(),
                                   rtol=0, atol=FIT_PARAM_ATOL)
    # the resume from epoch 2 equals the uninterrupted run, bit for bit
    resumed = metas[0]["resumed"]
    assert resumed == metas[1]["resumed"]
    assert resumed["restored"] and resumed["start_epoch"] == 3
    assert resumed["history"] == fit["history"][2:]
    assert resumed["best_epoch"] == fit["best_epoch"]
    for n in one_fit["params"]:
        assert np.array_equal(ranks[0][f"resumed.{n}"],
                              ranks[0][f"fit.{n}"]), n
    # the fence reached both ranks; nothing committed for epoch 3
    for m in metas:
        assert m["fenced"] and m["fenced"].startswith("TrainerFencedError")
    assert CheckpointManager(LocalDirStorage(
        str(tmp_path / "fenced"))).steps() == [1, 2]
    assert "rank 0's alone" in metas[1]["rank1_lease"]
    # the group's checkpoints are the one-process save's files
    group_files = sorted(p.relative_to(tmp_path / "whole")
                         for p in (tmp_path / "whole").rglob("*"))
    one_files = sorted(p.relative_to(tmp_path / "one")
                       for p in (tmp_path / "one").rglob("*"))
    assert group_files == one_files
    gm, om = (json.loads(LocalDirStorage(str(tmp_path / d)).read(
        "ckpt-00000003/MANIFEST.json")) for d in ("whole", "one"))
    for doc in (gm, om):
        for leaf in doc["leaves"].values():
            for shard in leaf["shards"]:
                shard.pop("sha256")
        doc["meta"].pop("val_loss")
        doc["meta"].pop("best_val")
    assert gm == om
    # ... which the port restores in one process, and the JAX manager
    # onto its mesh
    mine, _ = CheckpointManager(LocalDirStorage(
        str(tmp_path / "whole"))).restore_latest()
    for n in one_fit["params"]:
        assert np.array_equal(mine[f"params/{n}"], ranks[0][f"fit.{n}"])
    state, manifest = JManager(JLocal(str(tmp_path / "whole"))).restore_latest(
        jt.abstract_state(), mesh=jt.mesh, rules=TRAINER_PARTITION_RULES)
    assert manifest["step"] == 3
    got = _jax_state(state["params"], state["opt"])
    assert set(got) == set(mine)
    for n, a in mine.items():
        np.testing.assert_array_equal(got[n], a)

    # the transformer: the ring, then each case's loss and step
    want_out, want_lse = tf_refs["ring"]
    for r, rk in enumerate(ranks):
        sl = slice(r * 16, (r + 1) * 16)
        np.testing.assert_allclose(rk["ring.out"], want_out[:, sl].numpy(),
                                   rtol=0, atol=RING_ATOL)
        np.testing.assert_allclose(rk["ring.lse"],
                                   want_lse[2 * r:2 * r + 2].numpy(),
                                   rtol=0, atol=RING_ATOL)
    for r, rk in enumerate(ranks):
        sl = slice(r * 16, (r + 1) * 16)
        for n, a in tf_refs["ring_nc"].items():
            np.testing.assert_allclose(rk[f"ring_nc.{n}"], a[:, sl], rtol=0,
                                       atol=RING_ATOL, err_msg=n)
    # rank 0 (partitions 0-1) launches steps 0-1 only, rank 1 steps 0-3
    assert [m["ring_calls"] for m in metas] == [2, 4]
    for name, *_ in TF_CASES:
        loss, step_loss, _, want = tf_refs[name]
        for key, ref in (("loss", loss), ("step_loss", step_loss)):
            assert metas[0][f"{name}.{key}"] == metas[1][f"{name}.{key}"]
            assert metas[0][f"{name}.{key}"] == pytest.approx(ref,
                                                              rel=1e-5)
        assert metas[0][f"{name}.loss"] == pytest.approx(jax_losses[name],
                                                         rel=1e-5)
        for n, a in want.items():
            assert np.array_equal(ranks[0][f"{name}.{n}"],
                                  ranks[1][f"{name}.{n}"]), (name, n)
            np.testing.assert_allclose(ranks[0][f"{name}.{n}"], a, rtol=0,
                                       atol=TF_PARAM_ATOL,
                                       err_msg=f"{name}.{n}")


    # the pipeline: one process's, and the JAX trainer's forward
    check_pipeline(ranks, metas, pipe_refs)
    for name, want in jax_pipe.items():
        for r, rk in enumerate(ranks):
            got = rk[f"pipe.{name}.forward"]
            rows = slice(r * len(got), (r + 1) * len(got)) if len(
                got) < len(want) else slice(None)
            np.testing.assert_allclose(got, want[rows], rtol=PIPE_RTOL,
                                       atol=PIPE_ATOL, err_msg=name)


if __name__ == "__main__":
    raise SystemExit(_main(sys.argv[1:]))
