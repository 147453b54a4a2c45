"""The port's pipelined classifier (``models/pipeline.py``) against the JAX
package's, on the CPU.

The JAX pipeline runs its S stages over the mesh's ``model`` axis and the
batch over ``data``; the port runs both as leading axes on one device,
on the same schedule.  Parameters cross with ``convert``.  Tolerances
(f32): the forward rtol 2e-5 / atol 2e-6 (``tests/test_pipeline.py``'s,
against the sequential oracle); one SGD step: loss rtol 1e-5, each
parameter's update within 1e-3 of its norm.  The layouts of the grid
over a process group and their refusals are checked here with a stand-in
group; the two-rank runs are ``tests/test_torch_multiproc_train.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from mapreduce_tpu.models import pipeline as jpipe
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.models import pipeline as tpipe


def _cfgs(dtype="float32", **kw):
    base = dict(n_in=16, hidden=32, n_classes=10, microbatch=4)
    base.update(kw)
    return (jpipe.PipelineConfig(dtype=getattr(jnp, dtype), **base),
            tpipe.PipelineConfig(dtype=getattr(torch, dtype), **base))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("n_stages", [2, 4])
def test_forward_matches_jax(n_stages):
    mesh = make_mesh(n_model=n_stages)
    n_data = mesh.shape["data"]
    jcfg, tcfg = _cfgs()
    params = {n: np.array(a) for n, a in jpipe.init_pipeline_params(
        jax.random.key(1), jcfg, n_stages).items()}
    x = np.random.default_rng(0).normal(
        size=(jcfg.microbatch * 3 * n_data, 16)).astype(np.float32)
    pspecs = {n: jpipe.pipeline_param_spec(n) for n in params}
    fwd = jax.jit(jax.shard_map(
        lambda p, xx: jpipe.pipeline_forward_local(p, xx, jcfg),
        mesh=mesh, in_specs=(pspecs, PS("data")), out_specs=PS("data")))
    want = np.asarray(fwd(params, x))
    tp = convert.pipeline_params_from_numpy(params, tcfg, n_stages)
    got = tpipe.pipeline_forward_local(tp, torch.tensor(x), tcfg,
                                       n_data).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(tpipe.pipeline_reference(tp, x, tcfg), want,
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(
        tpipe.pipeline_reference(tp, x, tcfg),
        jpipe.pipeline_reference(params, x, jcfg), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipelined_equals_sequential(dtype):
    """The schedule (bubble ticks included) computes exactly what the
    stages do one after another, at S = 8 and M = 16."""
    _, cfg = _cfgs(dtype)
    params = tpipe.init_pipeline_params(cfg, 8,
                                        torch.Generator().manual_seed(0))
    x = torch.randn((16 * cfg.microbatch, 16),
                    generator=torch.Generator().manual_seed(1))
    got = tpipe.pipeline_forward_local(params, x, cfg)
    want = tpipe.sequential_forward(params, x, cfg)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_sgd_step_matches_jax(n_stages):
    lr = 0.1
    mesh = make_mesh(n_model=n_stages)
    n_data = mesh.shape["data"]
    jcfg, tcfg = _cfgs(n_classes=4)
    jtr = jpipe.PipelinedTrainer(mesh, jcfg, learning_rate=lr)
    p0 = jtr.init_params()
    host0 = {n: np.array(a) for n, a in p0.items()}
    rng = np.random.default_rng(0)
    n = jcfg.microbatch * 2 * n_data
    x = rng.normal(size=(n, 16)).astype(np.float32)
    y = x.reshape(n, 4, 4).sum(-1).argmax(-1).astype(np.int32)
    with jax.default_matmul_precision("float32"):
        p1, j_loss = jtr.step(p0, x, y)  # donates p0
    host1 = {k: np.array(a) for k, a in p1.items()}

    ttr = tpipe.PipelinedTrainer(tcfg, learning_rate=lr, n_stages=n_stages,
                                 n_data=n_data, device="cpu")
    params = ttr.place_params(convert.pipeline_params_from_numpy(
        host0, tcfg, n_stages))
    t_loss = float(ttr.loss(params, x, y))
    params, s_loss = ttr.step(params, x, y)
    assert float(s_loss) == t_loss
    assert abs(t_loss - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    out = convert.pipeline_params_to_numpy(params)
    for k in host1:
        err = _rel(out[k] - host0[k], host1[k] - host0[k])
        assert err < 1e-3, (k, err)


def test_pipelined_trainer_learns():
    """``tests/test_pipeline.py``'s task on the port: 2 stages, 4 data
    shards, bf16 products, 60 SGD steps."""
    _, cfg = _cfgs("bfloat16", n_classes=4)
    tr = tpipe.PipelinedTrainer(cfg, learning_rate=0.1, n_stages=2,
                                n_data=4, device="cpu")
    params = tr.init_params()
    rng = np.random.default_rng(0)
    n = cfg.microbatch * 2 * 4
    losses = []
    for _ in range(60):
        x = rng.normal(size=(n, 16)).astype(np.float32)
        y = x.reshape(n, 4, 4).sum(-1).argmax(-1)
        params, loss = tr.step(params, x, y)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.6, (losses[0], losses[-1])


def test_rejects_partial_microbatch():
    _, cfg = _cfgs(microbatch=8)
    tr = tpipe.PipelinedTrainer(cfg, n_stages=2, n_data=4, device="cpu")
    params = tr.init_params()
    x = np.zeros((4 * 4, 16), np.float32)  # 4 rows a shard < microbatch 8
    with pytest.raises(ValueError, match="microbatch"):
        tr.step(params, x, np.zeros(16, np.int64))
    with pytest.raises(ValueError, match="does not split"):
        tpipe.pipeline_forward_local(params, torch.zeros((18, 16)), cfg, 4)


def test_init_and_converters():
    jcfg, tcfg = _cfgs()
    j = jpipe.init_pipeline_params(jax.random.key(0), jcfg, 4)
    t = tpipe.init_pipeline_params(tcfg, 4, torch.Generator().manual_seed(0))
    assert list(t) == list(j) == list(tpipe.param_shapes(tcfg, 4))
    for n in j:
        a, b = np.asarray(j[n]), t[n].numpy()
        assert a.shape == b.shape and b.dtype == np.float32, n
        if n == "b_stage":
            assert (b == 0).all()
        else:
            assert abs(b.std() / a.std() - 1) < 0.15, (n, b.std(), a.std())
    host = convert.pipeline_params_to_numpy(t)
    back = convert.pipeline_params_from_numpy(host, tcfg, 4)
    assert all(torch.equal(back[n], t[n]) for n in t)
    with pytest.raises(ValueError, match="w_stage"):
        convert.pipeline_params_from_numpy(host, tcfg, 2)


def test_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.PipelinedTrainer(tpipe.PipelineConfig(), n_stages=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.PipelinedTrainer(tpipe.PipelineConfig(), n_stages=2,
                               group=object())


@pytest.mark.parametrize("n_stages, n_data, world, rank, stages, data", [
    (8, 1, 2, 1, range(4, 8), range(1)),     # the stages across ranks
    (4, 2, 4, 2, range(2, 3), range(2)),
    (1, 4, 2, 1, range(1), range(2, 4)),     # the data across ranks
    (2, 2, 1, 0, range(2), range(2)),        # a group of one
])
def test_group_layout(monkeypatch, n_stages, n_data, world, rank, stages,
                      data):
    """``make_mesh``'s row-major grid over a group's ranks."""
    import torch.distributed as dist

    from mapreduce_tpu_torch.parallel.mesh import pipeline_layout

    monkeypatch.setattr(dist, "get_backend", lambda g=None: "gloo")
    monkeypatch.setattr(dist, "get_world_size", lambda g=None: world)
    monkeypatch.setattr(dist, "get_rank", lambda g=None: rank)
    got = pipeline_layout(object(), n_stages, n_data)
    assert (got.world, got.rank, got.stages, got.data) == (
        world, rank, stages, data)
    assert pipeline_layout(None, n_stages, n_data)[2:] == (
        range(n_stages), range(n_data))


@pytest.mark.parametrize("n_stages, n_data, world", [
    (2, 4, 4),   # a rank would hold half a stage's shards
    (3, 2, 2),   # neither axis splits over the ranks
    (2, 3, 4),   # the world size divides no grid
])
def test_group_refuses_unsupported_layouts(monkeypatch, n_stages, n_data,
                                           world):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_backend", lambda g=None: "gloo")
    monkeypatch.setattr(dist, "get_world_size", lambda g=None: world)
    monkeypatch.setattr(dist, "get_rank", lambda g=None: 0)
    with pytest.raises(ValueError, match=rf"n_stages={n_stages}, "
                                         rf"n_data={n_data}"):
        tpipe.PipelinedTrainer(n_stages=n_stages, n_data=n_data,
                               device="cpu", group=object())


def test_group_refuses_other_backends(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_backend", lambda g=None: "nccl")
    with pytest.raises(NotImplementedError, match="gloo"):
        tpipe.PipelinedTrainer(n_stages=2, device="cpu", group=object())
    with pytest.raises(NotImplementedError, match="gloo"):
        tpipe.pipeline_forward_local(
            tpipe.init_pipeline_params(tpipe.PipelineConfig(), 2,
                                       torch.Generator().manual_seed(0)),
            torch.zeros((8, 64)), tpipe.PipelineConfig(), group=object())
