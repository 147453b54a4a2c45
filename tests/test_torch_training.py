"""The port's digits trainer against the JAX package's, on the CPU.

``mapreduce_tpu_torch.models.trainer.DistributedTrainer(device="cpu")``
runs the epoch as a loop of eager steps; the JAX ``DistributedTrainer``
runs its ``lax.scan`` over the 8-device CPU mesh of ``tests/conftest.py``
(``data`` = 8) or a 1-device mesh.  The port's ``n_data`` is the JAX
``data`` axis size, kept as a logical width (global batch and
smoothing).  JAX state crosses with ``convert.trainer_state_from_numpy``
under the JAX leaf names.  Tolerances:

* ``dtype=float32``: each parameter and momentum buffer within 1e-5 of
  its norm after an epoch (measured below 4e-7: XLA sums the 8 shards'
  gradients in another order), losses within 1e-5;
* ``dtype=bfloat16`` (the default): each leaf within 3e-2 of its norm
  (measured up to 1.2e-2, in the biases, which start at 0 so the whole
  leaf is update; bf16 products round at other places in the two
  frameworks), losses within 1e-3;
* the optimizer alone against optax on the same gradients: 1e-6 of each
  leaf's norm, for 1 and 3 steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mapreduce_tpu.models import DistributedTrainer as JTrainer
from mapreduce_tpu.models import MLPConfig as JMLP
from mapreduce_tpu.models import TrainConfig as JConfig
from mapreduce_tpu.models import digits as jdigits
from mapreduce_tpu.models import mlp as jmlp
from mapreduce_tpu.models.checkpoint import CheckpointManager as JManager
from mapreduce_tpu.models.trainer import (
    TRAINER_PARTITION_RULES as J_RULES)
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu.parallel.partition import (
    flatten_with_names, leaf_path as j_leaf_path,
    match_partition_rules as j_match)
from mapreduce_tpu.storage.localdir import LocalDirStorage as JLocal

from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.models import digits as tdigits
from mapreduce_tpu_torch.models import mlp as tmlp
from mapreduce_tpu_torch.models import trainer as ttrainer
from mapreduce_tpu_torch.models.checkpoint import (
    CheckpointError, CheckpointManager)
from mapreduce_tpu_torch.parallel import partition as tpart
from mapreduce_tpu_torch.storage.localdir import LocalDirStorage

SIZES = (256, 32, 10)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: (each leaf's error over its norm, loss atol) by compute dtype
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (3e-2, 1e-3)}
HYPER = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-3)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _mesh(n_data):
    return make_mesh() if n_data == 8 else make_mesh(n_data=n_data)


def _jax_state(params, opt_state):
    named, _ = flatten_with_names({"params": params, "opt": opt_state})
    return {n: np.array(a) for n, a in named}


def _pair(dtype, n_data, **cfg):
    """A JAX trainer and the port's at the same configuration."""
    jdt, tdt = DTYPES[dtype]
    jt = JTrainer(_mesh(n_data), JMLP(sizes=SIZES, dtype=jdt),
                  JConfig(**cfg))
    tt = ttrainer.DistributedTrainer(
        tmlp.MLPConfig(sizes=SIZES, dtype=tdt), ttrainer.TrainConfig(**cfg),
        n_data=n_data, device="cpu")
    return jt, tt


def _port_state(tt, host):
    return tt.place_state(*convert.trainer_state_from_numpy(host,
                                                            tt.mlp_cfg))


def test_make_digits_is_bit_equal_to_jax():
    for seed in (0, 7):
        for a, b in zip(jdigits.make_digits(seed=seed),
                        tdigits.make_digits(seed=seed)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = JMLP(sizes=SIZES, dtype=jdt), tmlp.MLPConfig(SIZES, tdt)
    host = {n: np.array(a) for n, a in
            jmlp.init_params(jax.random.key(3), jcfg).items()}
    params = convert.mlp_params_from_numpy(host, tcfg)
    back = convert.mlp_params_to_numpy(params)
    assert all(np.array_equal(back[n], host[n]) for n in host)
    with pytest.raises(ValueError, match="missing"):
        convert.mlp_params_from_numpy({"w0": host["w0"]}, tcfg)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 256)).astype(np.float32)
    y = rng.integers(0, 10, size=64).astype(np.int32)
    j_logp = np.array(jmlp.forward(host, x, jcfg))
    t_logp = tmlp.forward(params, torch.from_numpy(x), tcfg)
    assert t_logp.dtype == torch.float32
    _, atol = TOL[dtype]
    np.testing.assert_allclose(t_logp.numpy(), j_logp, atol=atol * 30,
                               rtol=0)
    j_loss, j_acc = jmlp.loss_and_accuracy(host, x, y, jcfg)
    t_loss, t_acc = tmlp.loss_and_accuracy(params, torch.from_numpy(x),
                                           torch.from_numpy(y), tcfg)
    assert abs(float(t_loss) - float(j_loss)) <= atol
    assert abs(float(t_acc) - float(j_acc)) <= 1 / 64
    assert float(tmlp.nll_loss(params, torch.from_numpy(x),
                               torch.from_numpy(y), tcfg)) == float(t_loss)


def test_init_params_shapes_scales_and_generator():
    cfg = tmlp.MLPConfig(sizes=(256, 64, 32, 10))
    a = tmlp.init_params(cfg, torch.Generator().manual_seed(5))
    b = tmlp.init_params(cfg, torch.Generator().manual_seed(5))
    ref = jmlp.init_params(jax.random.key(0), JMLP(sizes=(256, 64, 32, 10)))
    assert list(a) == list(ref)
    for n in a:
        assert tuple(a[n].shape) == ref[n].shape
        assert a[n].dtype == torch.float32
        assert torch.equal(a[n], b[n])
    assert float(a["b1"].abs().max()) == 0.0
    std = float(a["w0"].std())
    assert abs(std / (2.0 / (256 + 64)) ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("steps", [1, 3])
def test_optimizer_matches_optax(steps):
    """``chain(add_decayed_weights(wd), sgd(lr, momentum))`` on given
    gradients, the smoothing scale included."""
    cfg = ttrainer.TrainConfig(smoothing=True, **HYPER)
    tt = ttrainer.DistributedTrainer(tmlp.MLPConfig(SIZES), cfg,
                                     n_data=4, device="cpu")
    opt = optax.chain(optax.add_decayed_weights(cfg.weight_decay),
                      optax.sgd(cfg.learning_rate, momentum=cfg.momentum))
    rng = np.random.default_rng(1)
    shapes = tmlp.param_shapes(tt.mlp_cfg)
    host = {n: rng.normal(size=s).astype(np.float32)
            for n, s in shapes.items()}
    j_params = {n: jnp.asarray(a) for n, a in host.items()}
    j_state = opt.init(j_params)
    params, trace = tt.place_state(host, {n: np.zeros(s, np.float32)
                                          for n, s in shapes.items()})
    for _ in range(steps):
        grads = {n: rng.normal(size=s).astype(np.float32)
                 for n, s in shapes.items()}
        scaled = {n: jnp.asarray(g) * (1 / np.sqrt(4))
                  for n, g in grads.items()}
        upd, j_state = opt.update(scaled, j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for n, p in params.items():
            p.grad = torch.from_numpy(grads[n].copy())
        tt._apply_update(params, trace)
    want = _jax_state(j_params, j_state)
    got = convert.trainer_state_to_numpy(params, trace)
    assert set(got) == set(want)
    for n in want:
        assert _rel(got[n], want[n]) < 1e-6, n


@pytest.mark.parametrize("dtype,n_data,smoothing", [
    ("float32", 8, False), ("float32", 8, True), ("float32", 1, False),
    ("float32", 1, True), ("bfloat16", 8, False), ("bfloat16", 1, True)])
def test_epoch_matches_jax(dtype, n_data, smoothing):
    jt, tt = _pair(dtype, n_data, bunch_size=64 // n_data,
                   smoothing=smoothing, **HYPER)
    params, opt_state = jt.init_state()
    host = _jax_state(params, opt_state)
    rng = np.random.default_rng(2)
    S = 3
    xs = rng.normal(size=(S, 64, 256)).astype(np.float32)
    ys = rng.integers(0, 10, size=(S, 64)).astype(np.int32)
    jp, jo, j_losses = jt._train_epoch(
        params, opt_state, jax.device_put(xs, jt.epoch_sharding),
        jax.device_put(ys, jt.epoch_sharding))
    want = _jax_state(jp, jo)
    tp, to = _port_state(tt, host)
    tp, to, t_losses = tt._train_epoch(tp, to, xs, ys)
    got = convert.trainer_state_to_numpy(tp, to)
    leaf_tol, loss_tol = TOL[dtype]
    np.testing.assert_allclose(t_losses.numpy(), np.array(j_losses),
                               atol=loss_tol, rtol=0)
    assert set(got) == set(want)
    for n in want:
        assert _rel(got[n], want[n]) < leaf_tol, (n, _rel(got[n], want[n]))


def test_epoch_equals_its_steps():
    """On the CPU the epoch is a loop of eager steps, bit for bit."""
    _, tt = _pair("bfloat16", 2, bunch_size=8, **HYPER)
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(4, 16, 256)).astype(np.float32)
    ys = rng.integers(0, 10, size=(4, 16)).astype(np.int32)
    a = tt.init_state()
    b = tt.init_state()
    a = tt._train_epoch(*a, xs, ys)
    for i in range(4):
        b = tt.step(*b[:2], *tt.place_batch(xs[i], ys[i]))
    for n in a[0]:
        assert torch.equal(a[0][n], b[0][n]) and torch.equal(a[1][n],
                                                              b[1][n])


def _small_digits():
    return tdigits.make_digits(n_train=160, n_val=40)


def test_fit_history_matches_jax(monkeypatch):
    """Three epochs of fit from the same (JAX) initial state: the
    permutation of each epoch, the wrap-around and the history."""
    jt, tt = _pair("float32", 8, bunch_size=8, max_epochs=3, min_epochs=1,
                   **HYPER)
    params, opt_state = jt.init_state()
    host = _jax_state(params, opt_state)
    monkeypatch.setattr(jt, "init_state", lambda: (params, opt_state))
    monkeypatch.setattr(tt, "init_state", lambda: _port_state(tt, host))
    data = _small_digits()
    want = jt.fit(*data)
    got = tt.fit(*data)
    assert got["epochs_run"] == want["epochs_run"] == 3
    assert got["best_epoch"] == want["best_epoch"]
    for g, w in zip(got["history"], want["history"]):
        assert g["epoch"] == w["epoch"]
        for k in ("train_loss", "val_loss", "val_acc"):
            assert abs(g[k] - w[k]) <= 1e-5, (k, g, w)


def test_partition_rules_match_jax():
    for sizes in (SIZES, (256, 64, 32, 16, 10)):
        jt = JTrainer(make_mesh(), JMLP(sizes=sizes), JConfig())
        tt = ttrainer.DistributedTrainer(tmlp.MLPConfig(sizes), device="cpu")
        jspecs = j_match(J_RULES, jt.abstract_state())
        flat = jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]
        want = {j_leaf_path(p): list(s) for p, s in flat}
        got = tpart.match_partition_rules(ttrainer.TRAINER_PARTITION_RULES,
                                          tt.abstract_state())
        assert got == want
    assert tpart.leaf_path(("opt", 1, 0, "trace", "w0")) == \
        "opt/1/0/trace/w0"
    # scalar passthrough, then first match wins
    rules = ttrainer.TRAINER_PARTITION_RULES
    assert tpart.match_partition_rules(
        rules, {"opt/0/count": np.int32(3), "one": np.zeros((1, 1)),
                "w12": np.zeros((2, 2))}) == {
        "opt/0/count": [], "one": [], "w12": [None, "model"]}
    with pytest.raises(tpart.UnmatchedLeafError, match="mystery.*x7"):
        tpart.match_partition_rules(rules, {"mystery": np.zeros((2, 2)),
                                            "x7": np.zeros(3),
                                            "w0": np.zeros((2, 2))})


# -- checkpoints across the packages ------------------------------------------


def test_jax_checkpoint_resumes_in_port_and_back(tmp_path):
    """A JAX fit commits epochs 1-2 to a shared directory; the port's fit
    resumes at epoch 3 with the same early-stopping state and matches an
    uninterrupted 3-epoch JAX run there; JAX's restore_latest reads the
    port's step 3 back onto its mesh."""
    data = _small_digits()
    cfg = dict(bunch_size=8, min_epochs=1, patience=5, **HYPER)
    jt2, _ = _pair("float32", 8, max_epochs=2, **cfg)
    jt3, tt3 = _pair("float32", 8, max_epochs=3, **cfg)
    ref = jt3.fit(*data)  # the JAX init is the same (seed) in both
    first = jt2.fit(*data, checkpoint_dir=str(tmp_path / "c"))
    assert first["epochs_run"] == 2

    manager = CheckpointManager(LocalDirStorage(str(tmp_path / "c")))
    got = tt3.fit(*data, manager=manager)
    assert got["restored"] and got["start_epoch"] == 3
    assert got["epochs_run"] == 1
    assert got["best_epoch"] == ref["best_epoch"]
    for k in ("train_loss", "val_loss", "val_acc"):
        assert abs(got["history"][0][k] - ref["history"][2][k]) <= 1e-5, k
    assert manager.steps()[-1] == 3

    jm = JManager(JLocal(str(tmp_path / "c")))
    state, manifest = jm.restore_latest(jt3.abstract_state(),
                                        mesh=jt3.mesh, rules=J_RULES)
    assert manifest["step"] == 3
    assert manifest["meta"]["train_config"] == ttrainer.lineage_config(
        tt3.cfg)
    assert manifest["leaves"]["params/w0"]["spec"] == [None, "model"]
    assert manifest["leaves"]["opt/1/0/trace/w1"]["spec"] == ["model",
                                                              None]
    mine = convert.trainer_state_to_numpy(got["params"], got["opt_state"])
    for n, a in _jax_state(state["params"], state["opt"]).items():
        np.testing.assert_array_equal(a, mine[n])
    assert state["params"]["w0"].sharding.spec == \
        jax.sharding.PartitionSpec(None, "model")


def test_port_resume_refuses_foreign_lineage(tmp_path):
    data = _small_digits()
    cfg = ttrainer.TrainConfig(learning_rate=0.1, bunch_size=32,
                               max_epochs=2, min_epochs=1, patience=5)
    manager = CheckpointManager(LocalDirStorage(str(tmp_path / "c")))
    ttrainer.DistributedTrainer(tmlp.MLPConfig(), cfg, device="cpu").fit(
        *data, manager=manager)
    foreign = dataclasses.replace(cfg, seed=99, learning_rate=0.5)
    with pytest.raises(CheckpointError) as ei:
        ttrainer.DistributedTrainer(tmlp.MLPConfig(), foreign,
                                    device="cpu").fit(*data,
                                                      manager=manager)
    assert "seed" in str(ei.value) and "learning_rate" in str(ei.value)
    relaxed = dataclasses.replace(cfg, max_epochs=3)
    out = ttrainer.DistributedTrainer(tmlp.MLPConfig(), relaxed,
                                      device="cpu").fit(*data,
                                                        manager=manager)
    assert out["restored"] and out["start_epoch"] == 3


def test_port_resume_after_early_stop_trains_nothing(tmp_path):
    data = _small_digits()
    # lr 0: no epoch after the first can improve the holdout
    cfg = ttrainer.TrainConfig(learning_rate=0.0, bunch_size=32,
                               max_epochs=10, min_epochs=1, patience=2)
    manager = CheckpointManager(LocalDirStorage(str(tmp_path / "c")))
    first = ttrainer.DistributedTrainer(tmlp.MLPConfig(), cfg,
                                        device="cpu").fit(*data,
                                                          manager=manager)
    assert first["epochs_run"] == 3
    assert manager.best_step() == 1
    again = ttrainer.DistributedTrainer(tmlp.MLPConfig(), cfg,
                                        device="cpu").fit(*data,
                                                          manager=manager)
    assert again["restored"] and again["epochs_run"] == 0
    assert again["best_epoch"] == first["best_epoch"]
    for n in first["params"]:
        assert torch.equal(first["params"][n], again["params"][n])


def test_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrainer.DistributedTrainer()
