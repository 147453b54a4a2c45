"""Transformer LM training on the flash-attention kernels (port of
``models/transformer.py``), on one device.

The JAX package runs the model inside one ``shard_map`` over a ``(model,
data)`` mesh.  Here both axes are modelled on one device, as
:class:`..parallel.mesh.Partitions` models the engine's ``data`` axis:
:class:`TransformerTrainer` takes ``n_model`` and ``n_data``, the JAX
``make_mesh(n_model=, n_data=)``.

* ``data`` (sequence parallelism): the sequence is ``n_data`` partitions
  of ``T / n_data`` tokens.  With ``n_data == 1`` the attention is the
  flash path (``cfg.flash`` None or True): the layer projects straight
  into the kernel layout ``[B, H, T, D]`` with one einsum, runs
  :func:`..ops.flash_attention.flash_attention` (the hand-written CUDA
  kernels on the card, their plain versions on the CPU) and contracts
  back with one einsum.  With ``n_data > 1`` (or ``flash=False``) it is
  the ring, :func:`..parallel.ring.ring_attention`, over the partitions.
  The loss is the mean over partitions of each partition's mean token
  loss plus its MoE aux term (the JAX ``pmean``), and the MoE routes and
  caps each partition's tokens on their own.
* ``model`` (tensor and expert parallelism): the dense layers stay the
  unsharded math.  On one device the JAX split of heads, FFN columns and
  vocabulary over model ranks changes only the order of an f32 sum (the
  ``psum(o.astype(f32))`` after each row-sharded product and the
  cross-entropy's ``psum``/``pmax``), so ``n_model`` matters for the
  validation (:meth:`TransformerConfig.validate`) and for the MoE FFN,
  whose experts are the model ranks: expert ``r`` is the column block
  ``w_in[:, r*F/E:(r+1)*F/E]`` and the row block of ``w_out``.

Over a process group (``TransformerTrainer(..., group=G)``, gloo) the
``data`` axis spans processes, as ``make_mesh`` lays the JAX ``data``
axis innermost over a ``jax.distributed`` mesh: rank ``r`` of ``W`` holds
the ``n_data / W`` sequence partitions from ``r * n_data / W`` (its
``T / W`` tokens of every row), the ring's K/V blocks cross the group
(:func:`..parallel.ring.ring_attention`), each rank's loss is its
partitions' share of the global mean (token loss and MoE aux), and the
replicated parameters' gradients and the loss are all-reduced once a
step in one flat host buffer, so every rank applies the same update.
``n_model`` (and the MoE's experts with it) stays within a rank.

Products are in ``cfg.dtype`` (bf16 by default) on f32 parameters; the
logits and the router are f32.  The large products outside the kernels
stay ``torch.matmul``/``einsum``, as the JAX package leaves them to XLA.

Parameters keep the JAX shapes (``wqkv`` is ``[E, 3, H*D]``, not
``nn.Linear``'s ``[out, in]``) and live in an ``nn.Module``
(:class:`Transformer`).  Module names cannot hold the JAX ``L0.wqkv``
dots, so layer ``i``'s parameters are ``layers.{i}.<name>``;
:func:`module_name` and :func:`jax_name` map between the two, and
``convert`` carries JAX parameters across.

:class:`TransformerTrainer` runs the SGD step or optax's ``adamw`` (as
``torch.optim.AdamW``), S steps in one dispatch (a CUDA graph on the
card), and the JAX package's checkpoints.
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
from ..parallel.mesh import all_reduce_sum, group_shape
from ..parallel.ring import ring_attention


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
    #: the attention tile request: the flash path passes it on as block_q
    #: / block_kv, which the CUDA kernels do not read (their tiles are
    #: fixed); the ring's flash steps ignore it too, and only the ring's
    #: plain path (``ring_attention(use_flash=False)``) chunks by it
    attn_block: Any = None
    #: sequence-chunked cross-entropy: logits exist [B, loss_block, V] at a
    #: time, recomputed in the backward pass; None = unchunked; must
    #: divide T_local = T / n_data
    loss_block: Any = None
    #: Switch-style top-1 MoE FFN: one expert per model rank (so it must
    #: equal n_model), each the dense layer's column block of w_in and row
    #: block of w_out, over its capacity-gathered tokens; tokens past
    #: capacity fall through on the residual.  0 = dense FFN
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    #: weight of the Switch load-balance loss
    moe_aux_weight: float = 0.01
    #: None: the flash kernels when n_data == 1, the ring when n_data > 1;
    #: True: the flash kernels (n_data must be 1); False: the ring at any
    #: n_data (its steps on the flash kernels, ring.py)
    flash: Any = None

    def validate(self, n_model: int) -> None:
        """The JAX ``validate``: heads, ffn and vocab split over the model
        axis, and one expert per model rank.  Raises ``ValueError`` (the
        JAX package asserts)."""
        if n_model < 1:
            raise ValueError(f"n_model must be at least 1, got {n_model}")
        for what, n in (("heads", self.n_heads), ("ffn", self.ffn),
                        ("vocab", self.vocab)):
            if n % n_model:
                raise ValueError(f"{what} must split over model axis: "
                                 f"{n} % n_model={n_model} != 0")
        if self.moe_experts and self.moe_experts != n_model:
            raise ValueError(
                "expert parallelism maps one expert per model-axis rank: "
                f"moe_experts={self.moe_experts} != n_model={n_model}")


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
        if cfg.moe_experts:
            shapes[f"L{i}.w_router"] = (E, cfg.moe_experts)
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
        if cfg.moe_experts:
            params[f"L{i}.w_router"] = norm((E, cfg.moe_experts), E)
    return params


class _Layer(nn.Module):
    def __init__(self, shapes, device):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=torch.float32, device=device)))


class Transformer(nn.Module):
    """The parameters, f32, JAX shapes: ``embed``, ``unembed`` and
    ``layers[i].{ln1_scale, ln2_scale, wqkv, wo, w_in, w_out}`` (and
    ``w_router`` with experts).  Uninitialised; fill with
    ``load_state_dict``."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
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


def _layer_local(x: torch.Tensor, lp: _Layer, cfg: TransformerConfig,
                 n_data: int, group=None):
    """One block: attention (the flash kernels, or the ring over *n_data*
    sequence partitions, across *group*'s ranks when given), then the
    FFN (dense or MoE).  Returns ``(x, aux [n_local])``, ``n_local`` the
    partitions *x* holds (``n_data / W`` over a group of ``W``)."""
    H, D, dt = cfg.n_heads, cfg.head_dim, cfg.dtype
    B, T, E = x.shape
    h = _rmsnorm(x, lp.ln1_scale.to(dt))
    if cfg.flash:
        w = lp.wqkv.to(dt).reshape(E, 3, H, D)
        qkv = torch.einsum("bte,echd->bchtd", h, w)
        bk = (dict(block_q=cfg.attn_block, block_kv=cfg.attn_block)
              if cfg.attn_block else {})
        attn = flash_attention(qkv[:, 0], qkv[:, 1], qkv[:, 2], causal=True,
                               **bk).to(dt)
        o = torch.einsum("bhtd,hde->bte", attn,
                         lp.wo.to(dt).reshape(H, D, E))
    else:
        qkv = torch.einsum("bte,ecf->btcf", h, lp.wqkv.to(dt))
        q, k, v = (qkv[:, :, j].reshape(B, T, H, D) for j in range(3))
        attn = ring_attention(q, k, v, n_data, causal=True,
                              block_size=cfg.attn_block, group=group).to(dt)
        o = torch.einsum("btf,fe->bte", attn.reshape(B, T, H * D),
                         lp.wo.to(dt))
    x = x + o
    h = _rmsnorm(x, lp.ln2_scale.to(dt))
    n_local = n_data // group_shape(group, n_data, "the ring")[0]
    if cfg.moe_experts:
        m, aux = _moe_ffn(h, lp, cfg, n_local)
    else:
        # jax.nn.gelu's default is the tanh form; torch's is erf
        u = F.gelu(torch.matmul(h, lp.w_in.to(dt)), approximate="tanh")
        m = torch.matmul(u, lp.w_out.to(dt))
        aux = torch.zeros(n_local, device=x.device)
    return x + m, aux


def moe_capacity(cfg: TransformerConfig, n_tokens: int) -> int:
    """Tokens an expert takes from a partition of *n_tokens* (the JAX
    ``max(1, int(N * moe_capacity_factor / n_exp))``, Python float
    arithmetic)."""
    return max(1, int(n_tokens * cfg.moe_capacity_factor / cfg.moe_experts))


def _route(flat: torch.Tensor, w_router: torch.Tensor):
    """The f32 router over ``[P, N, E]`` tokens: ``(probs [P, N, n_exp],
    expert [P, N])``, the expert the first maximum of the logits (the JAX
    ``argmax``).  A product in full f32: TF32 is off by PyTorch's default
    (``torch.backends.cuda.matmul.allow_tf32``)."""
    r_logits = torch.matmul(flat.float(), w_router)
    return torch.softmax(r_logits, dim=-1), r_logits.argmax(dim=-1)


def _moe_ffn(h: torch.Tensor, lp: _Layer, cfg: TransformerConfig,
             n_data: int):
    """The JAX ``_moe_ffn`` (Switch-style top-1) for every expert and
    every sequence partition at once.  Each partition's ``N = B * T/n_data``
    tokens are routed by an f32 router (``argmax`` takes the first
    maximum); expert ``r`` takes its first ``cap`` tokens in token order
    (a stable sort of ``expert != r``, the JAX ``argsort(~mine)``), padded
    with foreign tokens when it owns fewer, which are weighted by 0; the
    ``[P, n_exp, cap, E]`` gathers run through the experts as one batched
    product each way, are gate-weighted in f32 and scatter-added back (one
    non-zero term a token: the sum is exact in any order), and tokens
    past capacity get 0 and fall through on the residual.  The gather's
    backward is a scatter-add too, and a foreign row's gradient is 0, so
    both directions are exact whatever order the card's atomics take.  No
    step reads anything back to the host (no ``nonzero``, no boolean
    mask), so the FFN captures into a CUDA graph.
    Returns ``(out [B, T, E] in cfg.dtype, aux [n_data] f32)``."""
    B, T, E = h.shape
    dt, n_exp, P = cfg.dtype, cfg.moe_experts, n_data
    Tl = T // P
    N = B * Tl
    C = min(moe_capacity(cfg, N), N)
    Fe = cfg.ffn // n_exp
    dev = h.device
    # partition p's tokens in the JAX local order (b, t)
    flat = h.reshape(B, P, Tl, E).transpose(0, 1).reshape(P, N, E)
    probs, expert = _route(flat, lp.w_router)       # [P, N, n_exp], [P, N]
    gate = probs.gather(-1, expert[..., None])[..., 0]        # [P, N]
    ranks = torch.arange(n_exp, device=dev)
    foreign = (expert[:, None, :] != ranks[None, :, None]).to(torch.int32)
    # my tokens first, in token order: take has min(cap, N) rows
    take = torch.argsort(foreign, dim=-1, stable=True)[..., :C]
    took_mine = foreign.gather(-1, take) == 0                  # [P, n_exp, C]
    idx = take.reshape(P, n_exp * C, 1).expand(P, n_exp * C, E)
    xs = flat.gather(1, idx).reshape(P, n_exp, C, E)
    w_in = lp.w_in.to(dt).reshape(E, n_exp, Fe).transpose(0, 1)
    u = F.gelu(torch.matmul(xs, w_in), approximate="tanh")
    y = torch.matmul(u, lp.w_out.to(dt).reshape(n_exp, Fe, E))
    # gate-weight the rows before the scatter (the router's gradient
    # path); foreign padding rows weigh 0
    wgt = gate.gather(-1, take.reshape(P, n_exp * C)).reshape(P, n_exp, C)
    y = y.float() * (wgt * took_mine)[..., None]
    out = torch.zeros((P, N, E), dtype=torch.float32, device=dev)
    out = out.scatter_add(1, idx, y.reshape(P, n_exp * C, E))
    # Switch load balance: n * sum_e(frac_e * meanP_e) - 1, per partition
    frac = (expert[..., None] == ranks).float().mean(dim=1)   # [P, n_exp]
    aux = n_exp * (frac * probs.mean(dim=1)).sum(dim=-1) - 1.0
    out = out.reshape(P, B, Tl, E).transpose(0, 1).reshape(B, T, E)
    return out.to(dt), aux


def forward_local(params: Transformer, tokens: torch.Tensor,
                  cfg: TransformerConfig, n_data: int = 1, group=None):
    """``tokens`` [B, T] int -> ``(hidden [B, T, E] f32, aux [n_local])``;
    aux is each sequence partition's MoE load-balance excess summed over
    the layers (0 for dense layers).  Over *group* the tokens are this
    rank's slice of the sequence and ``n_local = n_data / W``."""
    x = params.embed[tokens].to(cfg.dtype)
    world = group_shape(group, n_data, "the ring")[0]
    if cfg.remat and world > 1:
        raise NotImplementedError(
            "remat over a process group: a recomputed layer would repeat "
            "the ring's cross-rank hops inside the backward pass")
    aux = torch.zeros(n_data // world, device=x.device)
    for lp in params.layers:
        if cfg.remat:
            x, a = checkpoint(_layer_local, x, lp, cfg, n_data,
                              use_reentrant=False)
        else:
            x, a = _layer_local(x, lp, cfg, n_data, group)
        aux = aux + a
    return x.float(), aux


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
               targets: torch.Tensor, cfg: TransformerConfig,
               n_data: int = 1, group=None) -> torch.Tensor:
    """Next-token cross-entropy; ``targets`` are the shifted tokens.  The
    mean over the *n_data* sequence partitions of each one's mean token
    loss plus ``moe_aux_weight`` times its aux (the JAX ``pmean``).

    Over *group* the tokens and targets are this rank's slice and the
    result is its partitions' share of that mean (their sum over
    *n_data*): the ranks' losses sum to the global one, and so do their
    gradients."""
    x, aux = forward_local(params, tokens, cfg, n_data, group)
    w = params.unembed
    Tc = cfg.loss_block
    B, T = targets.shape
    n_local = aux.shape[0]
    T_local = T // n_local
    if Tc is None:
        nll = _chunk_nll(x, targets, w, cfg.dtype)
    else:
        if T_local % Tc != 0:
            raise ValueError(f"loss_block {Tc} must divide T_local "
                             f"{T_local} (T {T} over n_data {n_data})")
        # each chunk's logits are recomputed in the backward pass: full
        # logits never exist in memory, forward or backward
        nll = torch.cat([
            checkpoint(_chunk_nll, x[:, c:c + Tc], targets[:, c:c + Tc], w,
                       cfg.dtype, use_reentrant=False)
            for c in range(0, T, Tc)], dim=1)
    per_part = nll.reshape(B, n_local, T_local).mean(dim=(0, 2))
    if group is not None:
        return (per_part + cfg.moe_aux_weight * aux).sum() / n_data
    return (per_part + cfg.moe_aux_weight * aux).mean()


def train_flops(cfg: TransformerConfig, n_params: int, B: int,
                T: int) -> float:
    """Training FLOPs of one step (``bench_train._train_flops``): 6ND for
    the dense products plus attention, whose forward QK^T and AV are
    2*B*H*T^2*D each, times 3 for training."""
    attn = 3 * 2 * 2 * B * cfg.n_heads * T * T * cfg.head_dim
    return 6.0 * n_params * (B * T) + attn




#: ``optax.adamw``'s defaults, which the JAX trainer's ``"adamw"`` takes
#: (torch's AdamW defaults to weight_decay 0.01: it is passed explicitly)
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def _optax_adamw_treedef(cfg: TransformerConfig) -> str:
    """``str(jax.tree.structure(optax.adamw(lr).init(params)))`` of the
    JAX trainer for *cfg*: its ``load_state`` checks a checkpoint's
    ``opt_tree`` against it."""
    d = "{" + ", ".join(f"'{n}': *" for n in sorted(param_shapes(cfg))) + "}"
    return ("PyTreeDef((CustomNode(namedtuple[ScaleByAdamState], "
            f"[*, {d}, {d}]), CustomNode(namedtuple[EmptyState], []), "
            "CustomNode(namedtuple[EmptyState], [])))")


def adamw_state_to_numpy(params: Transformer, opt: torch.optim.AdamW
                         ) -> Dict[str, np.ndarray]:
    """The AdamW state as optax's adamw leaves, by their names inside the
    optimizer state: ``0/count`` (an int32 scalar), ``0/mu/<name>`` and
    ``0/nu/<name>`` (f32), from torch's ``step`` (a float tensor, the
    same for every parameter), ``exp_avg`` and ``exp_avg_sq``.  With
    :func:`adamw_state_from_numpy`, the one place the two spellings
    meet."""
    out: Dict[str, np.ndarray] = {}
    for name, p in params.named_parameters():
        st = opt.state[p]
        out["0/count"] = np.array(int(st["step"]), dtype=np.int32)
        out[f"0/mu/{jax_name(name)}"] = \
            st["exp_avg"].detach().cpu().numpy().astype(np.float32)
        out[f"0/nu/{jax_name(name)}"] = \
            st["exp_avg_sq"].detach().cpu().numpy().astype(np.float32)
    return out


def adamw_state_from_numpy(params: Transformer, opt: torch.optim.AdamW,
                           leaves: Dict[str, Any]) -> None:
    """Fill *opt*'s state (allocated by :meth:`TransformerTrainer.
    init_state`) from optax's adamw leaves (the names of
    :func:`adamw_state_to_numpy`); raises ``ValueError`` on a missing or
    extra leaf or a wrong shape."""
    want = {"0/count"} | {f"0/{m}/{jax_name(n)}" for m in ("mu", "nu")
                          for n, _ in params.named_parameters()}
    if set(leaves) != want:
        raise ValueError(
            "optimizer state does not match: missing "
            f"{sorted(want - set(leaves))}, extra "
            f"{sorted(set(leaves) - want)}")
    with torch.no_grad():
        for name, p in params.named_parameters():
            st = opt.state[p]
            for m, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                a = np.asarray(leaves[f"0/{m}/{jax_name(name)}"])
                if a.shape != tuple(p.shape):
                    raise ValueError(f"{m} of {jax_name(name)}: shape "
                                     f"{a.shape}, want {tuple(p.shape)}")
                st[key].copy_(torch.from_numpy(a.astype(np.float32)))
            st["step"].fill_(float(int(np.asarray(leaves["0/count"]))))


class TransformerTrainer:
    """The JAX ``TransformerTrainer`` on one device: the stateless-SGD
    step (``p - learning_rate * g`` on f32 parameters, :meth:`step`) or,
    with ``optimizer="adamw"``, optax's ``adamw(learning_rate)`` as
    ``torch.optim.AdamW`` with optax's defaults (:data:`ADAMW`: the
    decoupled decay on the old ``p``), through :meth:`init_state` and
    :meth:`step_opt`.  :meth:`_train_steps` runs S steps of either kind
    on ``[S, B, T+1]`` tokens in one dispatch: on the card, one replay of
    a CUDA graph that holds all S steps.  The JAX trainer also takes any
    optax ``GradientTransformation``; that has no counterpart here, and
    any optimizer but ``None`` or ``"adamw"`` raises ``ValueError``.

    :meth:`save`, :meth:`load` and :meth:`load_state` keep the JAX
    package's checkpoints: leaves ``params/<jax name>`` and optax's
    ``opt/0/count`` / ``opt/0/mu/...`` / ``opt/0/nu/...``, the ``arch``
    tag and the ``opt_tree`` attestation in the manifest's meta, so
    either package restores the other's.

    ``n_model`` and ``n_data`` are the JAX mesh's axes, modelled on the
    one device (module docstring): ``cfg.validate(n_model)`` runs here,
    and ``flash=None`` resolves to the flash kernels at ``n_data == 1``
    and to the ring above it (``flash=True`` with ``n_data > 1`` raises
    ``ValueError``, as in JAX).

    With *group* (a gloo ``torch.distributed`` process group whose world
    size ``W`` divides ``n_data``) the ``data`` axis spans the group's
    ranks (module docstring): every rank is given the same global tokens
    and parameters, :meth:`place_batch` keeps its slice of the sequence,
    the loss is the global one on every rank and the update the same;
    :meth:`_train_steps` runs its S steps eagerly (a CUDA graph cannot
    hold the gloo collectives), and :meth:`save` is rank 0's write of
    the one-process checkpoint while the other ranks wait for its
    commit.

    ``device=None`` means ``"cuda"`` and raises without it; the tests pass
    ``device="cpu"`` for the plain versions of the kernels."""

    def __init__(self, cfg: TransformerConfig, learning_rate: float = 3e-3,
                 seed: int = 0, optimizer=None, device=None,
                 n_model: int = 1, n_data: int = 1, group=None) -> None:
        self.device = kc.resolve_device(device)
        cfg.validate(n_model)
        if n_data < 1:
            raise ValueError(f"n_data must be at least 1, got {n_data}")
        self.group = group
        self.world, self.rank = group_shape(
            group, n_data, f"TransformerTrainer(n_data={n_data})")
        if optimizer not in (None, "adamw"):
            raise ValueError(
                f"unknown optimizer {optimizer!r}: only 'adamw' (an optax "
                "GradientTransformation has no counterpart in the port)")
        if cfg.flash is None:
            cfg = replace(cfg, flash=n_data == 1)
        elif cfg.flash and n_data > 1:
            raise ValueError(
                "flash=True computes local attention only; a sequence "
                "sharded over data axis > 1 needs the ring path")
        self.n_data = n_data
        self.cfg, self.lr, self.seed = cfg, learning_rate, seed
        self.optimizer = optimizer
        self._graph = None

    def init_params(self) -> Transformer:
        """Fresh parameters from ``torch.Generator().manual_seed(seed)``."""
        g = torch.Generator().manual_seed(self.seed)
        return self._place_params(init_transformer(self.cfg, g))

    def _place_params(self, flat: Dict[str, Any]) -> Transformer:
        """A :class:`Transformer` on this device from a flat dict under
        the JAX names (tensors or numpy arrays)."""
        model = Transformer(self.cfg, device=self.device)
        model.load_state_dict({module_name(n): torch.as_tensor(p)
                               for n, p in flat.items()})
        return model

    def place_batch(self, tokens: np.ndarray
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[B, T+1]`` (or ``[S, B, T+1]``) host tokens -> (inputs,
        shifted targets), int64 on the trainer's device; T must divide by
        ``n_data``."""
        tokens = np.asarray(tokens)
        T = tokens.shape[-1] - 1
        if T % self.n_data:
            raise ValueError(f"sequence length {T} does not split over "
                             f"n_data={self.n_data} partitions")
        t = torch.as_tensor(tokens, dtype=torch.int64)
        x, y = t[..., :-1], t[..., 1:]
        if self.group is not None:
            # this rank's n_data / W partitions of the sequence
            per = T // self.world
            x = x[..., self.rank * per:(self.rank + 1) * per]
            y = y[..., self.rank * per:(self.rank + 1) * per]
        return x.to(self.device), y.to(self.device)

    def _loss(self, params: Transformer, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
        """``loss_local`` on placed tokens: over a group, this rank's
        share of the global loss."""
        return loss_local(params, x, y, self.cfg, self.n_data, self.group)

    def loss(self, params: Transformer, tokens: np.ndarray) -> torch.Tensor:
        """The loss of one ``[B, T+1]`` batch, without gradients (the
        global loss on every rank of a group)."""
        x, y = self.place_batch(tokens)
        with torch.no_grad():
            loss = self._loss(params, x, y)
        if self.group is not None:
            loss = loss.reshape(1).clone()
            all_reduce_sum([loss], self.group)
            loss = loss[0]
        return loss

    # -- the step ---------------------------------------------------------

    def _step_impl(self, params: Transformer, opt, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
        """One step in place on placed tokens: forward, the gradients
        (``autograd.grad``: nothing accumulates into ``.grad``, so no
        zeroing pass and no gradient memory between steps), then SGD
        (*opt* None) or *opt*'s update.  Reads nothing back to the host,
        so it captures into a CUDA graph.  Over a group the gradients and
        the loss are summed over the ranks first (one all-reduce of a
        flat host buffer), so it runs eagerly."""
        ps = list(params.parameters())
        loss = self._loss(params, x, y)
        grads = torch.autograd.grad(loss, ps)
        if self.group is not None:
            loss = loss.detach().reshape(1).clone()
            all_reduce_sum(list(grads) + [loss], self.group)
            loss = loss[0]
        with torch.no_grad():
            if opt is None:
                for p, g in zip(ps, grads):
                    p.sub_(g.mul_(self.lr))
            else:
                for p, g in zip(ps, grads):
                    p.grad = g
                opt.step()
                opt.zero_grad(set_to_none=True)
        return loss.detach()

    def step(self, params: Transformer, tokens: np.ndarray
             ) -> Tuple[Transformer, torch.Tensor]:
        """One SGD step on a ``[B, T+1]`` batch; returns ``(params,
        loss)``.  The update is in place (the parameters are the module's
        own storage; JAX donates them instead)."""
        x, y = self.place_batch(tokens)
        return params, self._step_impl(params, None, x, y)

    # -- the optimizer path ------------------------------------------------

    def _need_tx(self) -> None:
        if self.optimizer is None:
            raise RuntimeError(
                "this trainer runs the stateless-SGD path; construct "
                "with optimizer='adamw' for init_state/step_opt/load_state")

    def _opt_init(self, params: Transformer) -> torch.optim.AdamW:
        """AdamW over *params* with its state allocated now (zero moments,
        step 0), as optax's ``init`` makes it; on the card the step count
        lives on the device (``capturable``), so a graph can hold it."""
        cuda = self.device.type == "cuda"
        opt = torch.optim.AdamW(params.parameters(), lr=self.lr,
                                capturable=cuda, **ADAMW)
        for p in params.parameters():
            opt.state[p] = {
                "step": torch.zeros((), dtype=torch.float32,
                                    device=p.device if cuda else "cpu"),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}
        return opt

    def init_state(self) -> Tuple[Transformer, torch.optim.AdamW]:
        """-> ``(params, opt_state)`` for the optimizer path."""
        self._need_tx()
        params = self.init_params()
        return params, self._opt_init(params)

    def step_opt(self, params: Transformer, opt_state: torch.optim.AdamW,
                 tokens: np.ndarray):
        """One optimizer step; returns ``(params, opt_state, loss)``, both
        updated in place."""
        self._need_tx()
        x, y = self.place_batch(tokens)
        return params, opt_state, self._step_impl(params, opt_state, x, y)

    def _train_steps(self, params: Transformer, opt_state, xs: torch.Tensor,
                     ys: torch.Tensor):
        """S steps on placed ``[S, B, T]`` inputs and targets
        (``place_batch`` of ``[S, B, T+1]`` tokens) in one dispatch: SGD
        when *opt_state* is None, returning ``(params, losses [S])``, else
        the optimizer's, returning ``(params, opt_state, losses)``.  On
        the card the S steps are captured whole into one CUDA graph (on
        the first call, and again for other state or shapes) and each
        call replays it; on the CPU, and over a process group (whose
        all-reduce a graph cannot hold), they run in a loop."""
        if opt_state is not None:
            self._need_tx()
        if self.device.type == "cuda" and self.group is None:
            g = self._graph
            if g is None or not g.fits((params, opt_state), xs):
                self._graph = None
                state = list(params.parameters())
                if opt_state is not None:
                    state += [t for st in opt_state.state.values()
                              for t in st.values()]
                self._graph = g = kc.StepsGraph(
                    lambda x, y: self._step_impl(params, opt_state, x, y),
                    xs, ys, state, owners=(params, opt_state),
                    program="tf_steps")
            losses = g.run(xs, ys)
        else:
            losses = torch.stack([self._step_impl(params, opt_state, xs[i],
                                                  ys[i])
                                  for i in range(xs.shape[0])])
        if opt_state is None:
            return params, losses
        return params, opt_state, losses

    # -- checkpoints (the JAX package's format, models/checkpoint.py) -----

    def _arch_tag(self) -> str:
        """Canonical architecture string: catches same-shape scrambles
        (n_heads=4/head_dim=8 vs 8/4 give IDENTICAL wqkv shapes)."""
        c = self.cfg
        return (f"v{c.vocab}.e{c.embed}.l{c.n_layers}.h{c.n_heads}."
                f"d{c.head_dim}.f{c.ffn}.moe{c.moe_experts}")

    def save(self, path: str, params: Transformer, step: int = 0,
             opt_state: torch.optim.AdamW = None, keep: int = 3) -> None:
        """Commit a manifest-committed checkpoint under the *path*
        directory (one shard a leaf, the manifest last), keeping the
        newest *keep*.  With *opt_state*, the AdamW state goes too, under
        optax's leaf names."""
        from ..storage.localdir import LocalDirStorage
        from .checkpoint import CheckpointManager

        tree: Dict[str, Any] = {
            "params/" + jax_name(n): t
            for n, t in params.state_dict().items()}
        meta: Dict[str, Any] = {"arch": self._arch_tag()}
        if opt_state is not None:
            tree.update({"opt/" + n: a for n, a in
                         adamw_state_to_numpy(params, opt_state).items()})
            meta["opt_tree"] = _optax_adamw_treedef(self.cfg)
        # over a group: the state is replicated, rank 0 writes it
        CheckpointManager(LocalDirStorage(path), keep_n=keep).save(
            step, tree, meta=meta, group=self.group)

    def _load_host(self, path: str):
        """-> ``(host params, host optimizer leaves or None, opt_tree or
        None, step)`` from the newest complete checkpoint under *path*.  A
        corrupt one falls back to the previous; an architecture, name,
        shape or dtype mismatch raises ``ValueError`` at once."""
        from ..storage.localdir import LocalDirStorage
        from . import checkpoint as ckpt

        storage = LocalDirStorage(path)
        steps = ckpt.list_steps(storage)
        skipped = 0
        for step in reversed(steps):
            try:
                manifest = ckpt.load_manifest(storage, "", step)
                got = (manifest.get("meta") or {}).get("arch")
                if got != self._arch_tag():
                    raise ValueError(
                        f"checkpoint params do not match this config: "
                        f"checkpoint arch {got}, trainer "
                        f"{self._arch_tag()}")
                out = self._host_from_manifest(storage, manifest)
            except ckpt.CheckpointCorruptError:
                ckpt.note_restore("corrupt")
                skipped += 1
                continue
            ckpt.note_restore("ok", step, fell_past=skipped)
            return out
        raise ckpt.CheckpointError(
            f"no complete checkpoint found ({len(steps)} candidates)")

    def _host_from_manifest(self, storage, manifest):
        from . import checkpoint as ckpt

        leaves = manifest["leaves"]
        host = {n[len("params/"):]: e for n, e in leaves.items()
                if n.startswith("params/")}
        want = param_shapes(self.cfg)
        if set(want) != set(host):
            raise ValueError("checkpoint params do not match this config: "
                             f"{set(want) ^ set(host)}")
        bad = [n for n, shape in want.items()
               if tuple(host[n]["shape"]) != shape
               or np.dtype(host[n]["dtype"]) != np.float32]
        if bad:
            raise ValueError(
                "checkpoint params do not match this config (shape/dtype): "
                + ", ".join(f"{n} {tuple(host[n]['shape'])}/"
                            f"{host[n]['dtype']} vs {want[n]}/float32"
                            for n in bad))
        params = {n: ckpt.assemble_leaf(storage, "params/" + n, host[n])
                  for n in want}
        opt = {n[len("opt/"):]: ckpt.assemble_leaf(storage, n, e)
               for n, e in leaves.items() if n.startswith("opt/")} or None
        opt_tree = (manifest.get("meta") or {}).get("opt_tree")
        return params, opt, opt_tree, int(manifest["step"])

    def load(self, path: str) -> Tuple[Transformer, int]:
        """``(params, step)`` from the newest complete checkpoint; the
        optimizer state, if saved, is ignored (:meth:`load_state`)."""
        host, _, _, step = self._load_host(path)
        return self._place_params(host), step

    def load_state(self, path: str):
        """Optimizer-path restore: -> ``(params, opt_state, step)``.  A
        checkpoint saved without optimizer state resumes with fresh
        moments; one whose ``opt_tree`` is another optimizer's raises."""
        self._need_tx()
        host, opt_host, saved_tree, step = self._load_host(path)
        params = self._place_params(host)
        opt = self._opt_init(params)
        if opt_host is None:
            return params, opt, step
        want = _optax_adamw_treedef(self.cfg)
        if saved_tree is not None and saved_tree != want:
            raise ValueError(
                "checkpoint optimizer state does not match this "
                f"trainer's optimizer: saved {saved_tree}, expected {want}")
        adamw_state_from_numpy(params, opt, opt_host)
        return params, opt, step
