"""The port's flash attention against the JAX package's, on the CPU.

The JAX ``flash_attention`` / ``flash_attention_lse`` run their Pallas
kernels in interpret mode under ``jax.default_matmul_precision
("float32")`` (the CPU backend's default f32 dot is bf16-grade), as
``tests/test_flash_attention.py`` runs them; the port runs its plain
PyTorch versions (CPU tensors take them).  Inputs are numpy draws from a
seed, fed to both.  Tolerances:

* f32, forward (out and lse): atol 1e-5 -- the two differ only in the
  order of f32 sums (tiles of 64 or 96 rows there, whole rows here);
* f32, gradients: atol 5e-5 / rtol 1e-4, as the JAX suite holds its
  kernel against its oracle;
* bf16: atol = rtol = 2e-2 on out, dq, dk, dv and 1e-3 on lse -- a
  bf16 value carries 8 mantissa bits, and a rounding point (p to v's
  type, ds to k's) that lands on the other side of a tie moves a term
  by one unit in the last place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapreduce_tpu.ops import flash_attention as jfa
from mapreduce_tpu_torch.ops import flash_attention as tfa
from mapreduce_tpu_torch.ops import kernel_compat as kc

F32_FWD = dict(atol=1e-5, rtol=0)
F32_GRAD = dict(atol=5e-5, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _inputs(B=2, H=2, Tq=64, Tk=None, D=16, seed=0):
    """(q, k, v, w) numpy f32 ``[B, H, T, D]``; w weights the loss."""
    rng = np.random.default_rng(seed)
    Tk = Tq if Tk is None else Tk
    q = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Tk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Tk, D)).astype(np.float32)
    w = rng.standard_normal((B, H, Tq, 1)).astype(np.float32)
    return q, k, v, w


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float64).numpy()
    return np.asarray(t).astype(np.float64)


def _assert_close(got, want, name, tol):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=name, **tol)


@pytest.mark.parametrize("T", [64, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax(causal, T):
    """out and lse in the kernel layout, and out in the ``bthd`` layout;
    T = 96 is ragged for every CUDA tile (64 and 128 rows or keys)."""
    q, k, v, _ = _inputs(Tq=T, seed=T)
    with jax.default_matmul_precision("float32"):
        j_out, j_lse = jfa.flash_attention_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
        j_bthd = jfa.flash_attention(
            *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)),
            causal=causal, layout="bthd")
    t_out, t_lse = tfa.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    t_bthd = tfa.flash_attention(
        *(torch.from_numpy(a.transpose(0, 2, 1, 3).copy())
          for a in (q, k, v)), causal=causal, layout="bthd")
    assert t_lse.shape == (2, 2, T, 1) and t_lse.dtype == torch.float32
    _assert_close(t_out, j_out, "out", F32_FWD)
    _assert_close(t_lse, j_lse, "lse", F32_FWD)
    _assert_close(t_bthd, j_bthd, "out (bthd)", F32_FWD)


def _grads_jax(q, k, v, w, causal, use_lse, dtype=jnp.float32):
    def loss(q, k, v):
        out, lse = jfa.flash_attention_lse(q, k, v, causal=causal)
        total = jnp.sum(out.astype(jnp.float32) ** 2)
        if use_lse:
            total = total + jnp.sum(lse * w)
        return total

    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    with jax.default_matmul_precision("float32"):
        return jax.grad(loss, argnums=(0, 1, 2))(*args)


def _grads_torch(q, k, v, w, causal, use_lse, dtype=torch.float32):
    args = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out, lse = tfa.flash_attention_lse(*args, causal=causal)
    total = out.float().square().sum()
    if use_lse:
        total = total + (lse * torch.from_numpy(w)).sum()
    return torch.autograd.grad(total, args)


@pytest.mark.parametrize("use_lse", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(causal, use_lse):
    """dq, dk, dv of sum(out**2), and of a loss that also weights lse (the
    lse cotangent folded into delta)."""
    q, k, v, w = _inputs(Tq=96, seed=1)
    gj = _grads_jax(q, k, v, w, causal, use_lse)
    gt = _grads_torch(q, k, v, w, causal, use_lse)
    for name, a, b in zip(("dq", "dk", "dv"), gt, gj):
        _assert_close(a, b, f"{name} (causal={causal}, lse={use_lse})",
                      F32_GRAD)


def test_unequal_lengths_match_jax():
    """Tq != Tk: the causal mask compares absolute positions."""
    q, k, v, w = _inputs(Tq=64, Tk=128, seed=2)
    with jax.default_matmul_precision("float32"):
        j_out, j_lse = jfa.flash_attention_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    t_out, t_lse = tfa.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True)
    _assert_close(t_out, j_out, "out", F32_FWD)
    _assert_close(t_lse, j_lse, "lse", F32_FWD)
    gj = _grads_jax(q, k, v, w, True, True)
    gt = _grads_torch(q, k, v, w, True, True)
    for name, a, b in zip(("dq", "dk", "dv"), gt, gj):
        _assert_close(a, b, name, F32_GRAD)


def test_bf16_matches_jax():
    q, k, v, w = _inputs(Tq=64, seed=3)
    with jax.default_matmul_precision("float32"):
        j_out, j_lse = jfa.flash_attention_lse(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True)
    t_out, t_lse = tfa.flash_attention_lse(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=True)
    assert t_out.dtype == torch.bfloat16
    _assert_close(t_out, j_out, "out", BF16)
    _assert_close(t_lse, j_lse, "lse", dict(atol=1e-3, rtol=0))
    gj = _grads_jax(q, k, v, w, True, True, jnp.bfloat16)
    gt = _grads_torch(q, k, v, w, True, True, torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), gt, gj):
        assert a.dtype == torch.bfloat16
        _assert_close(a, b, name, BF16)


@pytest.mark.parametrize("D", [48, 80])
def test_bf16_gradients_at_inexact_scales_match_jax(D):
    """Head dims whose 1/sqrt(D) is inexact and which fill part of the
    64- and 128-wide kernel instantiations: dq is scale * acc rounded
    once, as the TPU kernel emits it."""
    q, k, v, w = _inputs(Tq=64, D=D, seed=D)
    gj = _grads_jax(q, k, v, w, True, True, jnp.bfloat16)
    gt = _grads_torch(q, k, v, w, True, True, torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), gt, gj):
        _assert_close(a, b, f"{name} (D={D})", BF16)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN16mr_flash_kernels9dq_kernelINS_4Bf16ELi128EEEv14CUtensorMap_stS2_S2_S2_PKfS4_Ptiiiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN16mr_flash_kernels9dq_kernelINS_4Bf16ELi128EEEv14CUtensorMap_stS2_S2_S2_PKfS4_Ptiiiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelPi' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPi
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 356 bytes cmem[0]
"""


def test_ptxas_usage_reads_each_kernel():
    """The build's ``-Xptxas -v`` log -> registers and spill bytes per
    kernel instantiation (what ``chip_smoke.py`` checks the flash kernels
    against), whether or not a demangler is installed."""
    usage = kc.ptxas_usage(PTXAS_LOG)
    assert sorted(u["registers"] for u in usage.values()) == [168, 255]
    assert sorted((u["spill_stores"], u["spill_loads"])
                  for u in usage.values()) == [(0, 0), (4, 8)]
    assert kc.ptxas_usage("") == {}


@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_match_softmax_reference(causal):
    """The plain versions (f32) against textbook attention in f64 autograd
    on the same values (no JAX), at a ragged Tq != Tk: forward, and the
    backward kernels' split of the gradient through delta = rowsum(do *
    out) - dlse.  Tolerance: f32 rounding, atol 2e-5 / rtol 1e-5."""
    q, k, v, w = (torch.from_numpy(a)
                  for a in _inputs(Tq=50, Tk=70, D=32, seed=4))
    do = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 2, 50, 32)).astype(np.float32))
    scale = 32 ** -0.5
    qh = tfa._prescale(q, scale)
    ref = [t.double().requires_grad_() for t in (qh, k, v)]
    s = torch.matmul(ref[0], ref[1].transpose(-1, -2))
    if causal:
        s = s.masked_fill(torch.ones(50, 70, dtype=torch.bool).triu(1),
                          float("-inf"))
    ref_out = torch.softmax(s, -1) @ ref[2]
    ref_lse = torch.logsumexp(s, -1, keepdim=True)
    g = torch.autograd.grad((ref_out * do.double()).sum()
                            + (ref_lse * w.double()).sum(), ref)
    out, lse = tfa.flash_fwd_plain(qh, k, v, causal)
    tol = dict(atol=2e-5, rtol=1e-5)
    _assert_close(out, ref_out, "out", tol)
    _assert_close(lse, ref_lse, "lse", tol)
    delta = (do * out).sum(-1, keepdim=True) - w
    # dq is the gradient through q = qh / scale
    dq = tfa.flash_dq_plain(qh, k, v, do, lse, delta, causal, scale)
    dk, dv = tfa.flash_dkv_plain(qh, k, v, do, lse, delta, causal)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv),
                          (g[0] * scale, g[1], g[2])):
        _assert_close(a, b, name, tol)


def test_cpu_tensors_take_the_plain_versions():
    kc.reset_counts()
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    tfa.flash_attention(q, q, q).sum().backward()
    assert (kc.PLAIN_CALLS["flash_fwd"], kc.PLAIN_CALLS["flash_dq"],
            kc.PLAIN_CALLS["flash_dkv"]) == (1, 1, 1)
    assert all(v == 0 for v in kc.LAUNCHES.values())


@pytest.mark.parametrize("dtype,D,msg", [
    (torch.float32, 64, "bfloat16 or float16"),
    (torch.bfloat16, 24, "multiple of 16"),
    (torch.bfloat16, 144, "multiple of 16"),
    (torch.bfloat16, 64, "CUDA tensors")])
def test_kernel_limits_raise_before_launch(dtype, D, msg):
    """The CUDA wrappers' argument check runs before any build or launch,
    so its ValueError shows here on the CPU."""
    q = torch.zeros((1, 1, 8, D), dtype=dtype)
    with pytest.raises(ValueError, match=msg):
        tfa._flash_fwd_cuda(q, q, q, True)


def test_unknown_layout_raises():
    q = torch.zeros((1, 1, 8, 16))
    with pytest.raises(ValueError, match="layout"):
        tfa.flash_attention(q, q, q, layout="tbhd")
