"""The port's Switch MoE FFN and its model and data axes against the JAX
package, on the CPU.

The JAX ``_moe_ffn`` runs inside ``jax.shard_map`` over a mesh whose
``model`` axis holds one expert a rank and whose ``data`` axis splits the
sequence; the port's ``_moe_ffn`` runs every expert and every sequence
partition on one device.  Forward values, routing, dropped tokens and
the aux loss are compared with the JAX function as the JAX trainer runs
it; gradients with the JAX function under ``check_vma=False``.  Under
jax 0.9's default varying-axes check (the JAX trainer's), the cotangents
of the router and of the expert inputs through ``_moe_ffn`` at
``n_model > 1`` disagree with an independent float64 loop reference of
the same math (:func:`_reference`) by more than the gradients' own size,
while the port and the JAX function without the check agree with it;
``test_moe_grads_equal_an_independent_reference`` holds the port to that
reference.  Tolerances (f32): forward atol 1e-5, gradients atol 5e-5,
the trainer's loss rtol 1e-5 and each parameter's update within 1e-3 of
its norm (``tests/test_torch_transformer.py``'s ``TOL``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as PS

from mapreduce_tpu.models import transformer as jtf
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.models import transformer as ttf
from tests.test_transformer import _batch

E, FFN = 16, 32
#: the whole trainer's small config
SMALL = dict(vocab=64, embed=32, n_layers=2, n_heads=2, head_dim=16, ffn=64)
B, T = 2, 64
TOL = (1e-5, 1e-3)


def _ffn_inputs(n_exp, seed=0, T_=32):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(2, T_, E)).astype(np.float32)
    lp = {"w_in": (rng.normal(size=(E, FFN)) / 4).astype(np.float32),
          "w_out": (rng.normal(size=(FFN, E)) / 6).astype(np.float32),
          "w_router": (rng.normal(size=(E, n_exp)) / 4).astype(np.float32)}
    ct = rng.normal(size=h.shape).astype(np.float32)
    return h, lp, ct


def _jax_ffn(h, lp, n_exp, n_data, cap_factor, check_vma=True, ct=None,
             cta=None):
    """The JAX ``_moe_ffn`` on a (model=n_exp, data=n_data) mesh: (out,
    aux [n_data]) and, with cotangents, the gradients of ``<out, ct> +
    <aux, cta>`` in w_in, w_out, w_router and h."""
    cfg = jtf.TransformerConfig(embed=E, ffn=FFN, moe_experts=n_exp,
                                moe_capacity_factor=cap_factor,
                                dtype=jnp.float32)
    mesh = make_mesh(n_model=n_exp, n_data=n_data)
    specs = {"w_in": PS(None, "model"), "w_out": PS("model", None),
             "w_router": PS()}

    def local(lp, h):
        out, aux = jtf._moe_ffn(h, lp, cfg, "model")
        return out, aux[None]

    fn = jax.shard_map(local, mesh=mesh, in_specs=(specs, PS(None, "data")),
                       out_specs=(PS(None, "data"), PS("data")),
                       check_vma=check_vma)
    with jax.default_matmul_precision("float32"):
        if ct is None:
            out, aux = jax.jit(fn)(lp, h)
            return np.array(out), np.array(aux)

        def obj(lp, h):
            o, a = fn(lp, h)
            return (o * ct).sum() + (a * cta).sum(), (o, a)

        (_, (out, aux)), (g_lp, g_h) = jax.jit(jax.value_and_grad(
            obj, argnums=(0, 1), has_aux=True))(lp, h)
    grads = {n: np.array(g_lp[n]) for n in g_lp}
    grads["h"] = np.array(g_h)
    return np.array(out), np.array(aux), grads


class _Layer:
    pass


def _port_ffn(h, lp, n_exp, n_data, cap_factor):
    cfg = ttf.TransformerConfig(embed=E, ffn=FFN, moe_experts=n_exp,
                                moe_capacity_factor=cap_factor,
                                dtype=torch.float32)
    layer = _Layer()
    tensors = {n: torch.tensor(a, requires_grad=True) for n, a in lp.items()}
    for n, t in tensors.items():
        setattr(layer, n, t)
    th = torch.tensor(h, requires_grad=True)
    out, aux = ttf._moe_ffn(th, layer, cfg, n_data)
    return out, aux, tensors, th


def _reference(h, lp, n_exp, n_data, cap_factor):
    """The Switch FFN as one loop a partition and an expert, float64."""
    Bh, Th, _ = h.shape
    Tl = Th // n_data
    N = Bh * Tl
    cap = max(1, int(N * cap_factor / n_exp))
    Fe = FFN // n_exp
    outs, auxs = [], []
    for p in range(n_data):
        flat = h[:, p * Tl:(p + 1) * Tl].reshape(N, E)
        logits = flat @ lp["w_router"]
        probs = torch.softmax(logits, -1)
        expert = logits.argmax(-1)
        out = torch.zeros((N, E), dtype=h.dtype)
        for r in range(n_exp):
            idx = torch.nonzero(expert == r)[:, 0][:cap]
            u = F.gelu(flat[idx] @ lp["w_in"][:, r * Fe:(r + 1) * Fe],
                       approximate="tanh")
            y = u @ lp["w_out"][r * Fe:(r + 1) * Fe] * probs[idx, r][:, None]
            out = out.index_add(0, idx, y)
        outs.append(out.reshape(Bh, Tl, E))
        frac = torch.stack([(expert == r).double().mean()
                            for r in range(n_exp)])
        auxs.append(n_exp * (frac * probs.mean(0)).sum() - 1)
    return torch.cat(outs, 1), torch.stack(auxs)


AXES = [(1, 1), (2, 4), (4, 2)]


@pytest.mark.parametrize("cap_factor", [1.25, 0.5])
@pytest.mark.parametrize("n_exp,n_data", AXES)
def test_moe_ffn_matches_jax(n_exp, n_data, cap_factor):
    """Output, aux, routing and the dropped tokens equal the JAX
    ``_moe_ffn`` as its trainer runs it (``(1, 1)``: the 1-rank mesh;
    capacity 0.5 drops tokens, so which ones an expert keeps is held:
    the first in token order)."""
    h, lp, _ = _ffn_inputs(n_exp)
    j_out, j_aux = _jax_ffn(h, lp, n_exp, n_data, cap_factor)
    t_out, t_aux, _, _ = _port_ffn(h, lp, n_exp, n_data, cap_factor)
    t_out = t_out.detach().numpy()
    np.testing.assert_allclose(t_out, j_out, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_aux.detach().numpy(), j_aux, atol=1e-6)
    # routing: the f32 router's first maximum, per partition, token order
    Tl = h.shape[1] // n_data
    flat = h.reshape(2, n_data, Tl, E).transpose(1, 0, 2, 3).reshape(
        n_data, -1, E)
    with jax.default_matmul_precision("float32"):
        want = np.array(jnp.argmax(jnp.einsum(
            "pne,ex->pnx", flat, lp["w_router"]), axis=-1))
    _, got = ttf._route(torch.tensor(flat), torch.tensor(lp["w_router"]))
    np.testing.assert_array_equal(got.numpy(), want)
    # dropped tokens: zero rows in both, as many as the capacity says
    N = flat.shape[1]
    cap = ttf.moe_capacity(ttf.TransformerConfig(
        moe_experts=n_exp, moe_capacity_factor=cap_factor), N)
    assert cap == max(1, int(N * cap_factor / n_exp))
    dropped = sum(max(0, int((want[p] == r).sum()) - cap)
                  for p in range(n_data) for r in range(n_exp))
    t_zero = (t_out == 0).all(axis=-1)
    np.testing.assert_array_equal(t_zero, (j_out == 0).all(axis=-1))
    assert int(t_zero.sum()) == dropped
    if cap_factor < 1 and n_exp > 1:
        assert dropped > 0


@pytest.mark.parametrize("n_exp,n_data", AXES)
def test_moe_ffn_gradients_match_jax(n_exp, n_data):
    """Gradients in every input against ``jax.grad`` of the JAX function
    (``check_vma=False``; module docstring)."""
    h, lp, ct = _ffn_inputs(n_exp, seed=1)
    cta = np.random.default_rng(2).normal(size=(n_data,)).astype(np.float32)
    _, _, jg = _jax_ffn(h, lp, n_exp, n_data, 1.0, check_vma=False, ct=ct,
                        cta=cta)
    out, aux, tensors, th = _port_ffn(h, lp, n_exp, n_data, 1.0)
    obj = (out * torch.tensor(ct)).sum() + (aux * torch.tensor(cta)).sum()
    names = ["w_in", "w_out", "w_router"]
    got = torch.autograd.grad(obj, [tensors[n] for n in names] + [th])
    for n, g in zip(names + ["h"], got):
        np.testing.assert_allclose(g.numpy(), jg[n], atol=5e-5, rtol=1e-4,
                                   err_msg=n)


@pytest.mark.parametrize("n_exp,n_data", AXES)
def test_moe_grads_equal_an_independent_reference(n_exp, n_data):
    h, lp, ct = _ffn_inputs(n_exp, seed=3)
    cta = np.random.default_rng(4).normal(size=(n_data,))
    out, aux, tensors, th = _port_ffn(h, lp, n_exp, n_data, 1.0)
    obj = (out * torch.tensor(ct)).sum() + (aux * torch.tensor(
        cta, dtype=torch.float32)).sum()
    names = ["w_in", "w_out", "w_router"]
    got = torch.autograd.grad(obj, [tensors[n] for n in names] + [th])
    ref = {n: torch.tensor(a, dtype=torch.float64, requires_grad=True)
           for n, a in lp.items()}
    rh = torch.tensor(h, dtype=torch.float64, requires_grad=True)
    r_out, r_aux = _reference(rh, ref, n_exp, n_data, 1.0)
    np.testing.assert_allclose(out.detach().numpy(), r_out.detach().numpy(),
                               atol=1e-5)
    r_obj = (r_out * torch.tensor(ct, dtype=torch.float64)).sum() + (
        r_aux * torch.tensor(cta)).sum()
    want = torch.autograd.grad(r_obj, [ref[n] for n in names] + [rh])
    for n, g, w in zip(names + ["h"], got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-5,
                                   rtol=1e-4, err_msg=n)


def test_single_expert_equals_dense():
    """``moe_experts=1`` reproduces the dense FFN on the same parameters:
    the gate is a softmax over one logit (1), the capacity exceeds N, so
    ``take`` has N rows (never ``cap``), and the aux is 0; one SGD step
    equal too, on the flash path and on the ring."""
    toks = _batch(np.random.default_rng(4), ttf.TransformerConfig(**SMALL),
                  B=2, T=32)
    base = ttf.TransformerConfig(dtype=torch.float32, **SMALL)
    moe = dataclasses.replace(base, moe_experts=1)
    host = {n: p.numpy() for n, p in ttf.init_transformer(
        moe, torch.Generator().manual_seed(0)).items()}
    for n_data in (1, 4):
        out = {}
        for cfg in (base, moe):
            tr = ttf.TransformerTrainer(cfg, learning_rate=1e-2,
                                        device="cpu", n_data=n_data)
            want = ttf.param_shapes(cfg)
            params = ttf.Transformer(tr.cfg, device="cpu")
            params.load_state_dict(convert.transformer_params_from_numpy(
                {n: host[n] for n in want}, tr.cfg))
            params, loss = tr.step(params, toks)
            out[cfg.moe_experts] = (float(loss),
                                    convert.transformer_params_to_numpy(
                                        params))
        assert abs(out[0][0] - out[1][0]) <= 1e-6 * out[0][0]
        for n, a in out[0][1].items():
            np.testing.assert_allclose(out[1][1][n], a, rtol=1e-5,
                                       atol=1e-7, err_msg=n)
        np.testing.assert_array_equal(out[1][1]["L0.w_router"],
                                      host["L0.w_router"])


def _jax_step(mesh, jcfg, host, toks, lr):
    """Loss and one SGD step of the JAX ``loss_local`` as the JAX trainer
    builds it, under ``check_vma=False`` (module docstring)."""
    n_model = mesh.shape["model"]
    pspecs = {n: jtf.transformer_param_spec(n) for n in host}
    loss_fn = jax.shard_map(
        lambda p, a, b: jtf.loss_local(p, a, b, jcfg, n_model), mesh=mesh,
        in_specs=(pspecs, PS(None, "data"), PS(None, "data")),
        out_specs=PS(), check_vma=False)
    with jax.default_matmul_precision("float32"):
        loss, g = jax.jit(jax.value_and_grad(loss_fn))(
            host, toks[:, :-1], toks[:, 1:])
    return float(loss), {n: host[n] - lr * np.array(g[n]) for n in host}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_moe_ring_trainer_matches_jax():
    """``n_model=2, n_data=4``: two experts and the sequence ring, f32.
    The loss equals the JAX trainer's on ``make_mesh(n_model=2)``; the
    loss and one SGD step equal the JAX ``loss_local``'s gradient step."""
    lr = 1e-2
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, moe_experts=2, **SMALL)
    mesh = make_mesh(n_model=2)
    assert mesh.shape["data"] == 4
    jtr = jtf.TransformerTrainer(mesh, jcfg, learning_rate=lr)
    assert jtr.cfg.flash is False
    host0 = {n: np.array(a) for n, a in jtr.init_params().items()}
    toks = np.random.default_rng(0).integers(
        0, SMALL["vocab"], size=(B, T + 1)).astype(np.int32)
    x, y = jtr.place_batch(toks)
    with jax.default_matmul_precision("float32"):
        j_loss = float(jtr._loss(jtr._place_params(host0), x, y))
    s_loss, host1 = _jax_step(mesh, jtr.cfg, host0, toks, lr)
    assert abs(s_loss - j_loss) <= 1e-6 * abs(j_loss)

    tcfg = convert.transformer_config_from_jax(
        dict(dataclasses.asdict(jcfg), dtype="float32"))
    ttr = ttf.TransformerTrainer(tcfg, learning_rate=lr, device="cpu",
                                 n_model=2, n_data=4)
    assert ttr.cfg.flash is False
    params = ttf.Transformer(ttr.cfg, device="cpu")
    params.load_state_dict(convert.transformer_params_from_numpy(host0,
                                                                 ttr.cfg))
    t_loss = float(ttr.loss(params, toks))
    params, _ = ttr.step(params, toks)
    out = convert.transformer_params_to_numpy(params)
    loss_tol, upd_tol = TOL
    assert abs(t_loss - j_loss) <= loss_tol * abs(j_loss), (t_loss, j_loss)
    assert set(out) == set(host1)
    for n in host1:
        err = _rel(out[n] - host0[n], host1[n] - host0[n])
        assert err < upd_tol, (n, err)


def test_moe_ring_trains_on_learnable_task():
    """``tests/test_transformer.py``'s expert-parallel case on the port:
    2 experts, the 4-way ring, bf16 products, 80 SGD steps."""
    cfg = ttf.TransformerConfig(vocab=32, embed=64, n_layers=2, n_heads=4,
                                head_dim=16, ffn=128, moe_experts=2)
    tr = ttf.TransformerTrainer(cfg, learning_rate=3e-2, device="cpu",
                                n_model=2, n_data=4)
    params = tr.init_params()
    assert "w_router" in dict(params.layers[0].named_parameters())
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(80):
        params, loss = tr.step(params, _batch(rng, cfg, B=8, T=32))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_moe_remat_keeps_the_math():
    cfg = ttf.TransformerConfig(dtype=torch.float32, moe_experts=2,
                                **SMALL)
    toks = _batch(np.random.default_rng(5), cfg, B=2, T=32)
    out = []
    for remat in (False, True):
        tr = ttf.TransformerTrainer(dataclasses.replace(cfg, remat=remat),
                                    learning_rate=1e-2, device="cpu",
                                    n_model=2, n_data=2)
        params, loss = tr.step(tr.init_params(), toks)
        out.append((float(loss), convert.transformer_params_to_numpy(params)))
    assert out[0][0] == out[1][0]
    for n, a in out[0][1].items():
        np.testing.assert_allclose(out[1][1][n], a, rtol=1e-6, atol=1e-7,
                                   err_msg=n)


def test_moe_losses_and_aux_by_partition():
    """The loss is the mean over partitions of each one's mean token loss
    plus ``moe_aux_weight`` times its aux (the JAX ``pmean``)."""
    cfg = ttf.TransformerConfig(dtype=torch.float32, moe_experts=2,
                                moe_aux_weight=0.5, **SMALL)
    tr = ttf.TransformerTrainer(cfg, device="cpu", n_model=2, n_data=4)
    params = tr.init_params()
    toks = _batch(np.random.default_rng(6), cfg, B=2, T=32)
    x, y = tr.place_batch(toks)
    with torch.no_grad():
        hidden, aux = ttf.forward_local(params, x, tr.cfg, 4)
        nll = torch.nn.functional.cross_entropy(
            (hidden @ params.unembed).reshape(-1, cfg.vocab), y.reshape(-1),
            reduction="none").reshape(2, 4, 8).mean(dim=(0, 2))
        want = float((nll + 0.5 * aux).mean())
        got = float(ttf.loss_local(params, x, y, tr.cfg, 4))
    assert aux.shape == (4,) and (aux != aux[0]).any()
    assert abs(got - want) <= 1e-5 * abs(want)


def test_moe_checkpoints_cross_both_ways(tmp_path):
    """A JAX checkpoint saved on a ``model=2`` mesh (its ``wqkv``,
    ``w_in``, ``w_out`` and ``unembed`` leaves in several shards) with
    ``w_router`` and the AdamW moments, loaded by the port; the port's
    save loaded by the JAX trainer on the same mesh: every leaf equal."""
    import json

    lr = 1e-2
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, moe_experts=2, **SMALL)
    jtr = jtf.TransformerTrainer(make_mesh(n_model=2), jcfg,
                                 learning_rate=lr, optimizer="adamw")
    jp, jo = jtr.init_state()
    toks = np.random.default_rng(7).integers(
        0, SMALL["vocab"], size=(B, T + 1)).astype(np.int32)
    with jax.default_matmul_precision("float32"):
        jp, jo, _ = jtr.step_opt(jp, jo, toks)
    jtr.save(str(tmp_path / "j"), jp, step=1, opt_state=jo)
    (manifest,) = (tmp_path / "j").rglob("*MANIFEST*")
    leaves = json.loads(manifest.read_text())["leaves"]
    for n in ("L0.wqkv", "L0.w_in", "L0.w_out", "unembed"):
        assert len(leaves["params/" + n]["shards"]) == 2, n
    assert len(leaves["params/L0.w_router"]["shards"]) == 1

    tcfg = convert.transformer_config_from_jax(
        dict(dataclasses.asdict(jcfg), dtype="float32"))
    ttr = ttf.TransformerTrainer(tcfg, learning_rate=lr, optimizer="adamw",
                                 device="cpu", n_model=2, n_data=4)
    tp, topt, step = ttr.load_state(str(tmp_path / "j"))
    assert step == 1
    got = convert.transformer_params_to_numpy(tp)
    assert "L1.w_router" in got
    for n, a in jp.items():
        np.testing.assert_array_equal(got[n], np.array(a), err_msg=n)
    from mapreduce_tpu.parallel.partition import flatten_with_names

    j_opt = {n: np.array(a) for n, a in flatten_with_names(jo)[0]}
    t_opt = convert.adamw_state_to_numpy(tp, topt)
    assert "0/mu/L0.w_router" in t_opt and set(t_opt) == set(j_opt)
    for n, a in j_opt.items():
        np.testing.assert_array_equal(t_opt[n], a, err_msg=n)

    tp, topt, _ = ttr.step_opt(tp, topt, toks)
    ttr.save(str(tmp_path / "t"), tp, step=2, opt_state=topt)
    jp2, jo2, jstep = jtr.load_state(str(tmp_path / "t"))
    assert jstep == 2
    mine = convert.transformer_params_to_numpy(tp)
    for n, a in jp2.items():
        np.testing.assert_array_equal(np.array(a), mine[n], err_msg=n)
    assert jp2["L0.w_in"].sharding.spec == PS(None, "model")
    mine_opt = convert.adamw_state_to_numpy(tp, topt)
    for n, a in flatten_with_names(jo2)[0]:
        np.testing.assert_array_equal(np.array(a), mine_opt[n], err_msg=n)
