"""The port's ring attention (``parallel/ring.py``) against the JAX ring,
on the CPU.

The JAX ``ring_attention`` runs inside ``jax.shard_map`` over the 8-device
test mesh's ``data`` axis, on ``[B, T/8, H, D]`` blocks; the port's over
the global ``[B, T, H, D]`` tensors split into 8 partitions on one device.
Both port formulations (``use_flash`` None: each step on the flash
kernels, here their plain versions; False: the plain online-softmax path,
chunked by ``block_size``) are held against the JAX jnp ring at rtol 2e-4
/ atol 2e-5 (``tests/test_transformer.py``'s tolerance), forward and the
gradients in q, k and v, and against the JAX flash ring (its Pallas
kernel in interpret mode, under ``jax.shard_map(check_vma=False)``,
which that path needs on jax 0.9).  The transformer's ring path (dense,
``n_data=8``) is held against the JAX trainer on the same mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from mapreduce_tpu.models import transformer as jtf
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu.parallel import ring as jring
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.models import transformer as ttf
from mapreduce_tpu_torch.ops import kernel_compat as kc
from mapreduce_tpu_torch.parallel import ring as tring

P = 8
ATOL, RTOL = 2e-5, 2e-4


def _qkv(B=2, T=32, H=4, D=8, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda: rng.normal(size=(B, T, H, D)).astype(np.float32)  # noqa
    return mk(), mk(), mk()


def _jax_ring(causal, block=None, use_flash=False, grad_ct=None):
    """The JAX ring on the 8-device ``data`` axis (jitted); with a
    cotangent, returns ``(out, (dq, dk, dv))`` of ``<out, ct>``."""
    def fn(q, k, v):
        return jring.ring_attention(q, k, v, "data", causal=causal,
                                    block_size=block, use_flash=use_flash)

    sm = jax.shard_map(fn, mesh=make_mesh(), in_specs=(PS(None, "data"),) * 3,
                       out_specs=PS(None, "data"),
                       check_vma=not use_flash)
    if grad_ct is None:
        return jax.jit(sm)
    return jax.jit(jax.value_and_grad(
        lambda q, k, v: ((sm(q, k, v) * grad_ct).sum(), sm(q, k, v)),
        argnums=(0, 1, 2), has_aux=True))


def _port(q, k, v, causal, block=None, use_flash=None, ct=None):
    tq, tk, tv = (torch.tensor(a, requires_grad=ct is not None)
                  for a in (q, k, v))
    out = tring.ring_attention(tq, tk, tv, P, causal=causal,
                               block_size=block, use_flash=use_flash)
    if ct is None:
        return out.detach().numpy()
    grads = torch.autograd.grad((out * torch.tensor(ct)).sum(), (tq, tk, tv))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("block", [None, 1, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_flash", [None, False])
def test_ring_matches_jax(use_flash, causal, block):
    q, k, v = _qkv()
    want = np.asarray(_jax_ring(causal, block)(q, k, v))
    got = _port(q, k, v, causal, block, use_flash)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    full = tring.full_attention_reference(
        *(torch.tensor(a) for a in (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(got, full, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_flash,block", [(None, None), (False, None),
                                             (False, 2)])
def test_ring_gradients_match_jax(use_flash, block, causal):
    q, k, v = _qkv(seed=1)
    ct = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    (_, want_out), want = _jax_ring(causal, block, grad_ct=ct)(q, k, v)
    out, grads = _port(q, k, v, causal, block, use_flash, ct)
    np.testing.assert_allclose(out, np.asarray(want_out), rtol=RTOL,
                               atol=ATOL)
    for name, g, w in zip("qkv", grads, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_the_jax_flash_ring(causal):
    """The JAX ring whose steps run its Pallas kernel (interpret mode), and
    for the causal ring its gradients."""
    q, k, v = _qkv(seed=3)
    ct = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    if causal:
        (_, want_out), want = _jax_ring(True, use_flash=True,
                                        grad_ct=ct)(q, k, v)
        out, grads = _port(q, k, v, True, ct=ct)
        for name, g, w in zip("qkv", grads, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL,
                                       atol=ATOL, err_msg=f"d{name}")
    else:
        want_out = _jax_ring(False, use_flash=True)(q, k, v)
        out = _port(q, k, v, False)
    np.testing.assert_allclose(out, np.asarray(want_out), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ring_is_one_call_a_step(causal):
    """P calls of each flash kernel (here their plain versions) a ring
    pass, forward and backward: step s folds its partitions into one
    call, and a causal step skips the blocks after the query block."""
    q, k, v = _qkv(seed=5)
    kc.reset_counts()
    _port(q, k, v, causal, ct=q)
    assert {n: kc.PLAIN_CALLS[n] for n in ("flash_fwd", "flash_dq",
                                           "flash_dkv")} == {
        "flash_fwd": P, "flash_dq": P, "flash_dkv": P}
    assert all(v == 0 for v in kc.LAUNCHES.values())


def test_ring_refusals():
    q, k, v = (torch.tensor(a) for a in _qkv(T=36))
    with pytest.raises(ValueError, match="does not split"):
        tring.ring_attention(q, k, v, P)
    q, k, v = (torch.tensor(a) for a in _qkv())
    with pytest.raises(ValueError, match="block_size 3 must divide"):
        tring.ring_attention(q, k, v, P, block_size=3, use_flash=False)
    with pytest.raises(ValueError, match="one shape"):
        tring.ring_attention(q, k[:, :16], v, P)


SMALL = dict(vocab=64, embed=32, n_layers=2, n_heads=2, head_dim=16, ffn=64)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_ring_trainer_matches_jax():
    """The dense transformer on the ring (``n_data=8``, f32) against the
    JAX trainer on the 8-device mesh: loss rtol 1e-5, each parameter's
    one-step update within 1e-3 of its norm."""
    lr = 1e-2
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **SMALL)
    jtr = jtf.TransformerTrainer(make_mesh(), jcfg, learning_rate=lr)
    p0 = jtr.init_params()
    host0 = {n: np.array(a) for n, a in p0.items()}
    toks = np.random.default_rng(0).integers(
        0, SMALL["vocab"], size=(2, 65)).astype(np.int32)
    x, y = jtr.place_batch(toks)
    with jax.default_matmul_precision("float32"):
        j_loss = float(jtr._loss(p0, x, y))
        p1, _ = jtr._train_step(p0, x, y)
    host1 = {n: np.array(a) for n, a in p1.items()}

    tcfg = convert.transformer_config_from_jax(
        dict(dataclasses.asdict(jcfg), dtype="float32"))
    ttr = ttf.TransformerTrainer(tcfg, learning_rate=lr, device="cpu",
                                 n_data=P)
    params = ttf.Transformer(ttr.cfg, device="cpu")
    params.load_state_dict(convert.transformer_params_from_numpy(host0,
                                                                 ttr.cfg))
    kc.reset_counts()
    t_loss = float(ttr.loss(params, toks))
    assert kc.PLAIN_CALLS["flash_fwd"] == P * SMALL["n_layers"]
    params, _ = ttr.step(params, toks)
    out = convert.transformer_params_to_numpy(params)
    assert abs(t_loss - j_loss) <= 1e-5 * abs(j_loss), (t_loss, j_loss)
    for n in host1:
        err = _rel(out[n] - host0[n], host1[n] - host0[n])
        assert err < 1e-3, (n, err)


def test_ring_of_one_partition_is_the_flash_path():
    """``flash=False`` at ``n_data=1`` is a one-step ring: the same loss
    and step as the flash path (f32)."""
    toks = np.random.default_rng(1).integers(
        0, SMALL["vocab"], size=(2, 33)).astype(np.int32)
    out = []
    for flash in (None, False):
        cfg = ttf.TransformerConfig(dtype=torch.float32, flash=flash,
                                    **SMALL)
        tr = ttf.TransformerTrainer(cfg, learning_rate=1e-2, device="cpu")
        assert tr.cfg.flash is (flash is None)
        params, loss = tr.step(tr.init_params(), toks)
        out.append((float(loss), convert.transformer_params_to_numpy(params)))
    assert abs(out[0][0] - out[1][0]) <= 1e-6 * out[0][0]
    for n, a in out[0][1].items():
        np.testing.assert_allclose(out[1][1][n], a, rtol=1e-5, atol=1e-7,
                                   err_msg=n)
