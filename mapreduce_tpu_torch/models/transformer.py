"""Transformer LM training on the flash-attention kernels (port of
``models/transformer.py``), on one device.

The JAX package runs the model inside one ``shard_map`` over a ``(model,
data)`` mesh.  This port is its single-device case: model and data axes
of size 1, so every ``psum``/``pmax``/``pmean`` is the identity, and the
attention is the flash path (``cfg.flash``): the layer projects straight
into the kernel layout ``[B, H, T, D]`` with one einsum, runs
:func:`..ops.flash_attention.flash_attention` (the hand-written CUDA
kernels on the card, their plain versions on the CPU), and contracts
back with one einsum.  Products are in ``cfg.dtype`` (bf16 by default) on
f32 parameters; the logits are f32.  The large products outside the
kernels stay ``torch.matmul``/``einsum``, as the JAX package leaves them
to XLA.

Parameters keep the JAX shapes (``wqkv`` is ``[E, 3, H*D]``, not
``nn.Linear``'s ``[out, in]``) and live in an ``nn.Module``
(:class:`Transformer`).  Module names cannot hold the JAX ``L0.wqkv``
dots, so layer ``i``'s parameters are ``layers.{i}.<name>``;
:func:`module_name` and :func:`jax_name` map between the two, and
``convert`` carries JAX parameters across.

Not ported yet (ROADMAP A10): the ring / jnp attention path
(``flash=False``), MoE (``moe_experts > 0``), the optax optimizer path,
``_train_steps`` and checkpoints.  The first two raise
``NotImplementedError`` here.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import kernel_compat as kc
from ..ops.flash_attention import flash_attention

_TODO = "not ported yet (ROADMAP A10)"


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256          # byte-level by default
    embed: int = 128
    n_layers: int = 2
    n_heads: int = 8
    head_dim: int = 16
    ffn: int = 512
    dtype: torch.dtype = torch.bfloat16
    #: recompute each layer in the backward pass (torch.utils.checkpoint)
    remat: bool = False
    #: the JAX flash path's kernel tile request; passed on as block_q /
    #: block_kv, which the CUDA kernels do not read (their tiles are fixed)
    attn_block: Any = None
    #: sequence-chunked cross-entropy: logits exist [B, loss_block, V] at a
    #: time, recomputed in the backward pass; None = unchunked; must
    #: divide T
    loss_block: Any = None
    #: MoE FFN: not ported (raises)
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    #: None or True: the flash kernels; False (the ring / jnp path) raises
    flash: Any = None


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.moe_experts:
        raise NotImplementedError(f"moe_experts={cfg.moe_experts}: the MoE "
                                  f"FFN is {_TODO}")
    if cfg.flash is False:
        raise NotImplementedError(f"flash=False: the ring / jnp attention "
                                  f"path is {_TODO}")


def param_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """The JAX package's flat parameter names and shapes, in its order."""
    E, H, D, F_, V = (cfg.embed, cfg.n_heads, cfg.head_dim, cfg.ffn,
                      cfg.vocab)
    shapes = OrderedDict(embed=(V, E), unembed=(E, V))
    for i in range(cfg.n_layers):
        shapes[f"L{i}.ln1_scale"] = (E,)
        shapes[f"L{i}.ln2_scale"] = (E,)
        shapes[f"L{i}.wqkv"] = (E, 3, H * D)
        shapes[f"L{i}.wo"] = (H * D, E)
        shapes[f"L{i}.w_in"] = (E, F_)
        shapes[f"L{i}.w_out"] = (F_, E)
    return shapes


def module_name(name: str) -> str:
    """``L3.wqkv`` -> ``layers.3.wqkv``; other names are unchanged."""
    if name.startswith("L") and "." in name:
        layer, rest = name[1:].split(".", 1)
        return f"layers.{layer}.{rest}"
    return name


def jax_name(name: str) -> str:
    """``layers.3.wqkv`` -> ``L3.wqkv``; the inverse of module_name."""
    if name.startswith("layers."):
        _, layer, rest = name.split(".", 2)
        return f"L{layer}.{rest}"
    return name


def init_transformer(cfg: TransformerConfig,
                     generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Flat f32 CPU parameters under the JAX names, with its shapes and
    scales (unit normals over sqrt(fan_in); the embedding at 0.02; norm
    scales at 1), drawn from *generator* in the JAX order.  The draws are
    torch's, not ``jax.random``'s."""
    _check_supported(cfg)

    def norm(shape, fan_in):
        return torch.randn(shape, generator=generator) / math.sqrt(fan_in)

    E, H, D, F_, V = (cfg.embed, cfg.n_heads, cfg.head_dim, cfg.ffn,
                      cfg.vocab)
    params = {"embed": norm((V, E), 1.0) * 0.02,
              "unembed": norm((E, V), E)}
    for i in range(cfg.n_layers):
        params[f"L{i}.ln1_scale"] = torch.ones(E)
        params[f"L{i}.ln2_scale"] = torch.ones(E)
        params[f"L{i}.wqkv"] = norm((E, 3, H * D), E)
        params[f"L{i}.wo"] = norm((H * D, E), H * D)
        params[f"L{i}.w_in"] = norm((E, F_), E)
        params[f"L{i}.w_out"] = norm((F_, E), F_)
    return params


class _Layer(nn.Module):
    def __init__(self, shapes, device):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=torch.float32, device=device)))


class Transformer(nn.Module):
    """The parameters, f32, JAX shapes: ``embed``, ``unembed`` and
    ``layers[i].{ln1_scale, ln2_scale, wqkv, wo, w_in, w_out}``.
    Uninitialised; fill with ``load_state_dict``."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        shapes = param_shapes(cfg)
        self.embed = nn.Parameter(torch.empty(shapes["embed"],
                                              device=device))
        self.unembed = nn.Parameter(torch.empty(shapes["unembed"],
                                                device=device))
        self.layers = nn.ModuleList(
            _Layer({n.split(".", 1)[1]: s for n, s in shapes.items()
                    if n.startswith(f"L{i}.")}, device)
            for i in range(cfg.n_layers))


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def _layer_local(x: torch.Tensor, lp: _Layer,
                 cfg: TransformerConfig) -> torch.Tensor:
    """One block: attention through the flash kernels, then the FFN."""
    H, D, dt = cfg.n_heads, cfg.head_dim, cfg.dtype
    E = x.shape[-1]
    h = _rmsnorm(x, lp.ln1_scale.to(dt))
    w = lp.wqkv.to(dt).reshape(E, 3, H, D)
    qkv = torch.einsum("bte,echd->bchtd", h, w)
    bk = (dict(block_q=cfg.attn_block, block_kv=cfg.attn_block)
          if cfg.attn_block else {})
    attn = flash_attention(qkv[:, 0], qkv[:, 1], qkv[:, 2], causal=True,
                           **bk).to(dt)
    o = torch.einsum("bhtd,hde->bte", attn, lp.wo.to(dt).reshape(H, D, E))
    x = x + o
    h = _rmsnorm(x, lp.ln2_scale.to(dt))
    # jax.nn.gelu's default is the tanh form; torch's is erf
    u = F.gelu(torch.matmul(h, lp.w_in.to(dt)), approximate="tanh")
    return x + torch.matmul(u, lp.w_out.to(dt))


def forward_local(params: Transformer, tokens: torch.Tensor,
                  cfg: TransformerConfig):
    """``tokens`` [B, T] int -> ``(hidden [B, T, E] f32, aux)``; aux is the
    MoE load-balance term, 0 here."""
    x = params.embed[tokens].to(cfg.dtype)
    for lp in params.layers:
        if cfg.remat:
            x = checkpoint(_layer_local, x, lp, cfg, use_reentrant=False)
        else:
            x = _layer_local(x, lp, cfg)
    return x.float(), torch.zeros((), device=x.device)


class _LogitsF32(torch.autograd.Function):
    """``x [N, E] @ w [E, V]`` with operands in the compute type and an
    f32 result (the JAX ``preferred_element_type=f32``).  On the card the
    forward is one bf16 GEMM writing f32 (``torch.mm(out_dtype=)``); the
    backward rounds the f32 cotangent to the compute type and runs two
    GEMMs in it.  On the CPU (where ``out_dtype`` has no kernel) both
    directions upcast to f32, and the gradients round to the operand type
    at the end, as JAX's transpose rule does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return torch.mm(x, w, out_dtype=torch.float32)
        return torch.mm(x.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if x.is_cuda:
            g = g.to(x.dtype)
            return torch.mm(g, w.t()), torch.mm(x.t(), g)
        dx = torch.mm(g, w.float().t()).to(x.dtype)
        dw = torch.mm(x.float().t(), g).to(w.dtype)
        return dx, dw


def _chunk_nll(x_c: torch.Tensor, t_c: torch.Tensor, w: torch.Tensor,
               dt: torch.dtype) -> torch.Tensor:
    """[B, Tc, E] hidden + [B, Tc] targets -> [B, Tc] nll."""
    B, Tc, E = x_c.shape
    logits = _LogitsF32.apply(x_c.to(dt).reshape(B * Tc, E),
                              w.to(dt)).reshape(B, Tc, -1)
    # the shift is gradient-neutral (the logsumexp identity)
    gmax = logits.amax(dim=-1).detach()
    denom = torch.exp(logits - gmax[..., None]).sum(dim=-1)
    t_logit = torch.gather(logits, -1, t_c[..., None])[..., 0]
    return (gmax + torch.log(denom)) - t_logit


def loss_local(params: Transformer, tokens: torch.Tensor,
               targets: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Mean next-token cross-entropy; ``targets`` are the shifted tokens."""
    x, _ = forward_local(params, tokens, cfg)
    w = params.unembed
    Tc = cfg.loss_block
    if Tc is None:
        nll = _chunk_nll(x, targets, w, cfg.dtype)
    else:
        T = x.shape[1]
        if T % Tc != 0:
            raise ValueError(f"loss_block {Tc} must divide T {T}")
        # each chunk's logits are recomputed in the backward pass: full
        # logits never exist in memory, forward or backward
        nll = torch.cat([
            checkpoint(_chunk_nll, x[:, c:c + Tc], targets[:, c:c + Tc], w,
                       cfg.dtype, use_reentrant=False)
            for c in range(0, T, Tc)], dim=1)
    return nll.mean()


def train_flops(cfg: TransformerConfig, n_params: int, B: int,
                T: int) -> float:
    """Training FLOPs of one step (``bench_train._train_flops``): 6ND for
    the dense products plus attention, whose forward QK^T and AV are
    2*B*H*T^2*D each, times 3 for training."""
    attn = 3 * 2 * 2 * B * cfg.n_heads * T * T * cfg.head_dim
    return 6.0 * n_params * (B * T) + attn


class TransformerTrainer:
    """The stateless-SGD training step of the JAX ``TransformerTrainer``
    on one device: ``p - learning_rate * g`` on f32 parameters.

    ``device=None`` means ``"cuda"`` and raises without it; the tests pass
    ``device="cpu"`` for the plain versions of the kernels."""

    def __init__(self, cfg: TransformerConfig, learning_rate: float = 3e-3,
                 seed: int = 0, device=None) -> None:
        self.device = kc.resolve_device(device)
        _check_supported(cfg)
        if cfg.flash is None:
            cfg = replace(cfg, flash=True)
        self.cfg, self.lr, self.seed = cfg, learning_rate, seed

    def init_params(self) -> Transformer:
        """Fresh parameters from ``torch.Generator().manual_seed(seed)``."""
        g = torch.Generator().manual_seed(self.seed)
        params = init_transformer(self.cfg, g)
        model = Transformer(self.cfg, device=self.device)
        model.load_state_dict({module_name(n): p for n, p in params.items()})
        return model

    def place_batch(self, tokens: np.ndarray
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[B, T+1]`` host tokens -> (inputs, shifted targets), int64 on
        the trainer's device."""
        t = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        t = t.to(self.device)
        return t[..., :-1], t[..., 1:]

    def loss(self, params: Transformer, tokens: np.ndarray) -> torch.Tensor:
        """The loss of one ``[B, T+1]`` batch, without gradients."""
        x, y = self.place_batch(tokens)
        with torch.no_grad():
            return loss_local(params, x, y, self.cfg)

    def step(self, params: Transformer, tokens: np.ndarray
             ) -> Tuple[Transformer, torch.Tensor]:
        """One SGD step on a ``[B, T+1]`` batch; returns ``(params,
        loss)``.  The update is in place (the parameters are the module's
        own storage; JAX donates them instead)."""
        x, y = self.place_batch(tokens)
        params.zero_grad(set_to_none=True)
        loss = loss_local(params, x, y, self.cfg)
        loss.backward()
        with torch.no_grad():
            for p in params.parameters():
                p.sub_(p.grad.mul_(self.lr))
                p.grad = None
        return params, loss.detach()
