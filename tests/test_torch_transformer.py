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
  (bf16 products round at other places in the two frameworks);
* ``optimizer="adamw"`` (optax's ``adamw`` against ``torch.optim.AdamW``),
  f32: loss rtol 1e-5; each parameter's update and each moment within
  1e-3 of its norm after 1 and 3 steps (measured up to 8.0e-5 and
  1.9e-5: Adam's first steps are near ``lr * sign(g)``, which magnifies
  a gradient's last-place difference where it is near 0).  Checkpoints
  cross both ways bit for bit.
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


@pytest.mark.parametrize("knob,axes,seq,msg", [
    pytest.param(dict(moe_experts=2), dict(n_model=1), None, "expert",
                 id="knob0-MoE"),
    pytest.param(dict(flash=True), dict(n_data=4), None, "ring path",
                 id="knob1-ring"),
    pytest.param(dict(moe_experts=2), dict(n_model=1, n_data=4), None,
                 "expert", id="moe-with-data-axis"),
    pytest.param(dict(), dict(n_data=3), T, "does not split",
                 id="t-over-n-data"),
    pytest.param(dict(loss_block=16), dict(n_data=8), T, "T_local 8",
                 id="loss-block-over-t-local"),
    pytest.param(dict(), dict(n_model=3), None, "heads must split",
                 id="heads-over-n-model"),
])
def test_unported_paths_raise(knob, axes, seq, msg):
    """The refusals of the model and data axes, each with the JAX
    trainer's words: experts other than one a model rank, ``flash=True``
    over a split sequence, a T the partitions do not divide, a
    ``loss_block`` that does not divide T_local, heads that do not split
    over the model axis."""
    cfg = ttf.TransformerConfig(**SMALL, **knob)
    with pytest.raises(ValueError, match=msg):
        tr = ttf.TransformerTrainer(cfg, device="cpu", **axes)
        tr.step(tr.init_params(), _tokens()[:, :seq + 1])


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


# -- the optimizer path (optax adamw) and the checkpoints ----------------------

#: the adamw path in f32: (loss rtol, each parameter's update and each
#: moment within this of its norm).  The first Adam step is about
#: lr * sign(g), so an element whose gradient is near 0 in one framework
#: moves by a fraction of lr in the other.
ADAMW_TOL = (1e-5, 1e-3)


def _adamw_pair(lr=1e-2):
    jcfg = jtf.TransformerConfig(flash=True, dtype=jnp.float32, **SMALL)
    tcfg = convert.transformer_config_from_jax(
        dict(dataclasses.asdict(jcfg), dtype="float32"))
    jtr = jtf.TransformerTrainer(make_mesh(n_data=1, n_model=1), jcfg,
                                 learning_rate=lr, optimizer="adamw")
    ttr = ttf.TransformerTrainer(tcfg, learning_rate=lr, optimizer="adamw",
                                 device="cpu")
    return jtr, ttr


def _jax_opt_leaves(opt_state):
    from mapreduce_tpu.parallel.partition import flatten_with_names

    return {n: np.array(a) for n, a in flatten_with_names(opt_state)[0]}


def _port_state_from_jax(ttr, params, opt_state):
    host = {n: np.array(a) for n, a in params.items()}
    tp, topt = ttr.init_state()
    tp.load_state_dict(convert.transformer_params_from_numpy(host, ttr.cfg))
    convert.adamw_state_from_numpy(tp, topt, _jax_opt_leaves(opt_state))
    return tp, topt


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_step_opt_matches_jax(steps):
    jtr, ttr = _adamw_pair()
    jp, jo = jtr.init_state()
    host0 = {n: np.array(a) for n, a in jp.items()}
    tp, topt = _port_state_from_jax(ttr, jp, jo)
    assert topt.defaults["weight_decay"] == 1e-4
    assert topt.defaults["betas"] == (0.9, 0.999)
    j_losses, t_losses = [], []
    for i in range(steps):
        toks = _tokens(10 + i)
        with jax.default_matmul_precision("float32"):
            jp, jo, loss = jtr.step_opt(jp, jo, toks)  # donates
        j_losses.append(float(loss))
        tp, topt, loss = ttr.step_opt(tp, topt, toks)
        t_losses.append(float(loss))
    loss_tol, tol = ADAMW_TOL
    np.testing.assert_allclose(t_losses, j_losses, rtol=loss_tol)
    want = {n: np.array(a) for n, a in jp.items()}
    got = convert.transformer_params_to_numpy(tp)
    for n in want:
        err = _rel(got[n] - host0[n], want[n] - host0[n])
        assert err < tol, (n, err)
    j_opt = _jax_opt_leaves(jo)
    t_opt = convert.adamw_state_to_numpy(tp, topt)
    assert set(t_opt) == set(j_opt)
    assert t_opt["0/count"].dtype == np.int32
    assert int(t_opt["0/count"]) == int(j_opt["0/count"]) == steps
    for n in j_opt:
        if n != "0/count":
            assert _rel(t_opt[n], j_opt[n]) < tol, (n, _rel(t_opt[n],
                                                            j_opt[n]))


@pytest.mark.parametrize("optimizer", [None, "adamw"])
def test_train_steps_equal_their_steps(optimizer):
    """``_train_steps`` over ``[S, B, T+1]`` tokens equals S single steps
    (on the CPU, bit for bit)."""
    cfg = ttf.TransformerConfig(**SMALL)
    tr = ttf.TransformerTrainer(cfg, learning_rate=1e-2, optimizer=optimizer,
                                device="cpu")
    toks = np.stack([_tokens(20 + i) for i in range(3)])
    xs, ys = tr.place_batch(toks)
    assert xs.shape == (3, B, T)
    if optimizer is None:
        a, b = tr.init_params(), tr.init_params()
        a, losses = tr._train_steps(a, None, xs, ys)
        want = [float(tr.step(b, toks[i])[1]) for i in range(3)]
    else:
        (a, oa), (b, ob) = tr.init_state(), tr.init_state()
        a, oa, losses = tr._train_steps(a, oa, xs, ys)
        want = [float(tr.step_opt(b, ob, toks[i])[2]) for i in range(3)]
        sa, sb = (convert.adamw_state_to_numpy(p, o)
                  for p, o in ((a, oa), (b, ob)))
        assert all(np.array_equal(sa[n], sb[n]) for n in sa)
    assert losses.tolist() == want
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n


def test_optimizer_strings_and_stateless_refusals():
    cfg = ttf.TransformerConfig(**SMALL)
    with pytest.raises(ValueError, match="adamw"):
        ttf.TransformerTrainer(cfg, optimizer="lamb", device="cpu")
    sgd = ttf.TransformerTrainer(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="stateless-SGD"):
        sgd.init_state()


def test_checkpoints_cross_both_ways(tmp_path):
    """JAX ``save`` -> the port's ``load_state``, and the port's ``save``
    -> JAX ``load_state``: params, moments and the step count equal; the
    next step after the round trip equals the step without it."""
    jtr, ttr = _adamw_pair()
    jp, jo = jtr.init_state()
    with jax.default_matmul_precision("float32"):
        jp, jo, _ = jtr.step_opt(jp, jo, _tokens(30))
    jtr.save(str(tmp_path / "j"), jp, step=1, opt_state=jo)
    tp, topt, step = ttr.load_state(str(tmp_path / "j"))
    assert step == 1
    got = convert.transformer_params_to_numpy(tp)
    for n, a in jp.items():
        np.testing.assert_array_equal(got[n], np.array(a))
    t_opt = convert.adamw_state_to_numpy(tp, topt)
    for n, a in _jax_opt_leaves(jo).items():
        np.testing.assert_array_equal(t_opt[n], a)
    lp, lstep = ttr.load(str(tmp_path / "j"))
    assert lstep == 1 and all(
        torch.equal(x, y) for x, y in zip(lp.parameters(),
                                          tp.parameters()))

    # the port: one more step, saved; JAX restores it exactly
    tp, topt, _ = ttr.step_opt(tp, topt, _tokens(31))
    ttr.save(str(tmp_path / "t"), tp, step=2, opt_state=topt)
    jp2, jo2, jstep = jtr.load_state(str(tmp_path / "t"))
    assert jstep == 2
    mine = convert.transformer_params_to_numpy(tp)
    for n, a in jp2.items():
        np.testing.assert_array_equal(np.array(a), mine[n])
    mine_opt = convert.adamw_state_to_numpy(tp, topt)
    j_opt = _jax_opt_leaves(jo2)
    assert j_opt["0/count"].dtype == np.int32 and int(j_opt["0/count"]) == 2
    for n, a in j_opt.items():
        np.testing.assert_array_equal(a, mine_opt[n])

    # the port's round trip leaves the next step unchanged
    rp, ropt, _ = ttr.load_state(str(tmp_path / "t"))
    toks = _tokens(32)
    _, _, l1 = ttr.step_opt(tp, topt, toks)
    _, _, l2 = ttr.step_opt(rp, ropt, toks)
    assert float(l1) == float(l2)
    for (n, x), (_, y) in zip(tp.state_dict().items(),
                              rp.state_dict().items()):
        assert torch.equal(x, y), n


def test_checkpoint_refusals(tmp_path):
    _, ttr = _adamw_pair()
    tp, topt = ttr.init_state()
    ttr.save(str(tmp_path / "a"), tp, step=0)
    # saved without moments: fresh ones
    lp, fresh, _ = ttr.load_state(str(tmp_path / "a"))
    assert int(convert.adamw_state_to_numpy(lp, fresh)["0/count"]) == 0
    other = ttf.TransformerTrainer(
        dataclasses.replace(ttr.cfg, n_heads=4, head_dim=8),
        optimizer="adamw", device="cpu")
    with pytest.raises(ValueError, match="arch"):
        other.load(str(tmp_path / "a"))
    with pytest.raises(Exception, match="no complete checkpoint"):
        ttr.load(str(tmp_path / "empty"))
    with pytest.raises(ValueError, match="optimizer state does not match"):
        convert.adamw_state_from_numpy(tp, topt, {"0/count": np.int32(1)})
