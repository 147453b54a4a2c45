"""The port's transformer training step against the JAX package's, on the
CPU.

The JAX ``TransformerTrainer`` runs on a 1 x 1 mesh with ``flash=True``
(its Pallas kernels in interpret mode) under ``jax.default_matmul_precision
("float32")``; the port's ``TransformerTrainer(device="cpu")`` runs the
plain versions of its kernels.  Parameters cross with ``convert``, copied
to numpy before the JAX step (which donates them).  Tolerances:

* ``dtype=float32``: loss rtol 1e-5; each parameter's one-step update
  ``p1 - p0`` within 1e-3 of its norm (the two frameworks sum in other
  orders; the update is the gradient times the learning rate);
* ``dtype=bfloat16``: loss rtol 2e-3; updates within 5e-2 of their norm
  (bf16 products round at other places in the two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapreduce_tpu.models import transformer as jtf
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.models import transformer as ttf
from mapreduce_tpu_torch.ops import kernel_compat as kc
from tests.test_transformer import _batch

SMALL = dict(vocab=64, embed=32, n_layers=2, n_heads=2, head_dim=16, ffn=64)
B, T = 2, 64
TOL = {"float32": (1e-5, 1e-3), "bfloat16": (2e-3, 5e-2)}


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab"], size=(B, T + 1)).astype(np.int32)


def _port_params(cfg, host):
    params = ttf.Transformer(cfg, device="cpu")
    params.load_state_dict(convert.transformer_params_from_numpy(host, cfg))
    return params


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_sgd_step_match_jax(dtype):
    lr = 1e-2
    jcfg = jtf.TransformerConfig(flash=True, dtype=getattr(jnp, dtype),
                                 **SMALL)
    tcfg = convert.transformer_config_from_jax(
        dict(dataclasses.asdict(jcfg), dtype=dtype))
    assert tcfg.dtype == getattr(torch, dtype) and tcfg.flash is True
    jtr = jtf.TransformerTrainer(make_mesh(n_data=1, n_model=1), jcfg,
                                 learning_rate=lr)
    p0 = jtr.init_params()
    host0 = {n: np.array(a) for n, a in p0.items()}
    toks = _tokens()
    x, y = jtr.place_batch(toks)
    with jax.default_matmul_precision("float32"):
        j_loss = float(jtr._loss(p0, x, y))
        p1, j_loss_step = jtr._train_step(p0, x, y)  # donates p0
    host1 = {n: np.array(a) for n, a in p1.items()}
    assert abs(float(j_loss_step) - j_loss) < 1e-6

    ttr = ttf.TransformerTrainer(tcfg, learning_rate=lr, device="cpu")
    params = _port_params(tcfg, host0)
    t_loss = float(ttr.loss(params, toks))
    params, t_loss_step = ttr.step(params, toks)
    out = convert.transformer_params_to_numpy(params)
    loss_tol, upd_tol = TOL[dtype]
    assert abs(t_loss - j_loss) <= loss_tol * abs(j_loss), (t_loss, j_loss)
    assert float(t_loss_step) == t_loss
    assert set(out) == set(host1)
    for n in host1:
        err = _rel(out[n] - host0[n], host1[n] - host0[n])
        assert err < upd_tol, (n, err)


def _one_step(cfg, toks, lr=1e-2):
    tr = ttf.TransformerTrainer(cfg, learning_rate=lr, device="cpu")
    params, loss = tr.step(tr.init_params(), toks)
    return float(loss), convert.transformer_params_to_numpy(params)


@pytest.mark.parametrize("knob", [dict(loss_block=16), dict(remat=True)])
def test_loss_block_and_remat_keep_the_math(knob):
    """``loss_block`` chunks the cross-entropy and ``remat`` recomputes each
    layer in the backward pass: the loss and the step are unchanged."""
    base = ttf.TransformerConfig(dtype=torch.float32, **SMALL)
    toks = _tokens(1)
    l0, p0 = _one_step(base, toks)
    l1, p1 = _one_step(dataclasses.replace(base, **knob), toks)
    assert abs(l0 - l1) <= 1e-6 * abs(l0)
    for n in p0:
        np.testing.assert_allclose(p1[n], p0[n], rtol=1e-6, atol=1e-7,
                                   err_msg=n)


def test_loss_block_must_divide_t():
    cfg = ttf.TransformerConfig(dtype=torch.float32, loss_block=24, **SMALL)
    with pytest.raises(ValueError, match="loss_block"):
        _one_step(cfg, _tokens())


def test_init_shapes_and_scales_match_jax():
    """Names and shapes equal the JAX init's; each tensor's std within 10%
    (the draws differ: torch's generator, not jax.random)."""
    jcfg = jtf.TransformerConfig(**SMALL)
    j = jtf.init_transformer(jax.random.key(0), jcfg)
    t = ttf.init_transformer(ttf.TransformerConfig(**SMALL),
                             torch.Generator().manual_seed(0))
    assert list(t) == list(j) == list(ttf.param_shapes(
        ttf.TransformerConfig(**SMALL)))
    for n in j:
        a, b = np.asarray(j[n]), t[n].numpy()
        assert a.shape == b.shape and b.dtype == np.float32, n
        if n.endswith("_scale"):
            assert (b == 1).all(), n
        else:
            assert abs(b.std() / a.std() - 1) < 0.1, (n, b.std(), a.std())


def test_loss_falls_on_learnable_task():
    """The port trains: ``tests/test_transformer.py``'s next-token task
    (tok[t+1] = tok[t] + 1 mod K), bf16 products, 60 SGD steps."""
    cfg = ttf.TransformerConfig(vocab=32, embed=64, n_layers=2, n_heads=4,
                                head_dim=16, ffn=128)
    tr = ttf.TransformerTrainer(cfg, learning_rate=3e-2, device="cpu")
    params = tr.init_params()
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(60):
        params, loss = tr.step(params, _batch(rng, cfg, B=8, T=32))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.4, (losses[0], losses[-1])


def test_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttf.TransformerTrainer(ttf.TransformerConfig(**SMALL))


@pytest.mark.parametrize("knob,msg", [(dict(moe_experts=2), "MoE"),
                                      (dict(flash=False), "ring")])
def test_unported_paths_raise(knob, msg):
    cfg = ttf.TransformerConfig(**SMALL, **knob)
    with pytest.raises(NotImplementedError, match=msg):
        ttf.TransformerTrainer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttf.init_transformer(cfg, torch.Generator())


def test_convert_round_trip_and_mismatches():
    cfg = ttf.TransformerConfig(**SMALL)
    host = {n: p.numpy() for n, p in ttf.init_transformer(
        cfg, torch.Generator().manual_seed(1)).items()}
    sd = convert.transformer_params_from_numpy(host, cfg)
    assert "layers.1.wqkv" in sd and "L1.wqkv" not in sd
    back = convert.transformer_params_to_numpy(sd)
    assert all(np.array_equal(back[n], host[n]) for n in host)
    with pytest.raises(ValueError, match="missing"):
        convert.transformer_params_from_numpy(
            {n: a for n, a in host.items() if n != "L0.wo"}, cfg)
    with pytest.raises(ValueError, match="L0.wqkv"):
        convert.transformer_params_from_numpy(
            dict(host, **{"L0.wqkv": host["L0.wqkv"].reshape(32, 96)}), cfg)
    with pytest.raises(ValueError, match="float32"):
        convert.transformer_params_from_numpy(
            dict(host, embed=host["embed"].astype(np.float16)), cfg)
    with pytest.raises(ValueError, match="dtype"):
        convert.transformer_config_from_jax(dict(dtype="int8"))
    with pytest.raises(ValueError, match="unknown"):
        convert.transformer_config_from_jax(dict(depth=3))


def test_cpu_step_runs_the_plain_flash_versions():
    kc.reset_counts()
    _one_step(ttf.TransformerConfig(**SMALL), _tokens())
    assert kc.PLAIN_CALLS["flash_fwd"] == SMALL["n_layers"]
    assert kc.PLAIN_CALLS["flash_dq"] == SMALL["n_layers"]
    assert kc.PLAIN_CALLS["flash_dkv"] == SMALL["n_layers"]
    assert all(v == 0 for v in kc.LAUNCHES.values())
