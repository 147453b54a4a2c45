"""Pipeline parallelism: GPipe-style microbatch pipelining (port of
``models/pipeline.py``), on one device.

The JAX package shards S identical ``[H, H]`` tanh blocks one a rank
over the mesh's ``model`` axis and streams M microbatches through them
on a ``lax.scan`` over M+S-1 ticks, the activations hopping one stage a
tick with ``ppermute``; the batch is data-parallel over ``data``.  Here
the S stages (and the ``n_data`` batch shards) are leading axes of
tensors on one device, and the schedule is the JAX one: at tick ``t``
stage 0 takes microbatch ``min(t, M-1)`` of the input projection, stage
``s > 0`` takes what stage ``s-1`` produced at tick ``t-1`` (a shift, no
wrap), every stage runs as ONE batched product over the stage axis
(``[S, n_data*Bm, H] @ [S, H, H]``), and the last stage's outputs from
tick S-1 on are the microbatches' results in order.  The backward pass
is autograd through the ticks, as JAX's is ``jax.grad`` of the scan.

A tick runs all S stages whether or not a stage holds a real microbatch
(the JAX ranks do too): of the (M+S-1)*S stage blocks, M*S carry a
microbatch, so the bubble is (S-1)/(M+S-1) of the stage work (7/23 at
S = 8, M = 16).

Model: an input projection, the S stage blocks, a classifier head;
products in ``cfg.dtype`` with an f32 carry, as in JAX.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import kernel_compat as kc

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class PipelineConfig:
    n_in: int = 64
    hidden: int = 64
    n_classes: int = 10
    microbatch: int = 8     # rows per microbatch
    dtype: torch.dtype = torch.bfloat16


def param_shapes(cfg: PipelineConfig,
                 n_stages: int) -> Dict[str, Tuple[int, ...]]:
    """The JAX parameter names and shapes, in its order."""
    H = cfg.hidden
    return OrderedDict(w_in=(cfg.n_in, H), w_stage=(n_stages, H, H),
                       b_stage=(n_stages, H), w_out=(H, cfg.n_classes))


def init_pipeline_params(cfg: PipelineConfig, n_stages: int,
                         generator: torch.Generator) -> Params:
    """f32 CPU parameters with the JAX shapes and scales (unit normals
    over sqrt(fan_in); zero stage biases), drawn from *generator* in the
    JAX order.  The draws are torch's, not ``jax.random``'s."""
    H = cfg.hidden

    def norm(shape, fan_in):
        return torch.randn(shape, generator=generator) / math.sqrt(fan_in)

    w_in = norm((cfg.n_in, H), cfg.n_in)
    w_stage = norm((n_stages, H, H), H)
    w_out = norm((H, cfg.n_classes), H)
    return {"w_in": w_in, "w_stage": w_stage,
            "b_stage": torch.zeros((n_stages, H)), "w_out": w_out}


def _stage_block(h, w, b, dtype):
    """``tanh(h @ w + b)`` in *dtype*, back to f32; a leading stage axis
    on all three runs every stage in one batched product."""
    return torch.tanh(torch.matmul(h.to(dtype), w.to(dtype))
                      + b.to(dtype)).float()


def _head(h, params, cfg):
    logits = torch.matmul(h.to(cfg.dtype), params["w_out"].to(cfg.dtype))
    return F.log_softmax(logits.float(), dim=-1)


def pipeline_forward_local(params: Params, x: torch.Tensor,
                           cfg: PipelineConfig,
                           n_data: int = 1) -> torch.Tensor:
    """``x`` [N, n_in] -> [N, n_classes] log-probabilities through the
    pipelined schedule (module docstring).  The batch splits into
    *n_data* shards of N/n_data rows, each a whole number of
    microbatches (else ``ValueError``); a shard's M microbatches pass the
    S stages in M+S-1 ticks."""
    S = params["w_stage"].shape[0]
    Bm, H, dt = cfg.microbatch, cfg.hidden, cfg.dtype
    N = x.shape[0]
    if N % n_data:
        raise ValueError(f"batch {N} does not split over n_data={n_data}")
    n_local = N // n_data
    if n_local % Bm != 0 or n_local == 0:
        raise ValueError(f"batch {n_local} not a multiple of microbatch "
                         f"{Bm}")
    M = n_local // Bm
    w = params["w_stage"]
    b = params["b_stage"][:, None, :]
    # stage 0's injected stream: the input projection of each microbatch
    inj = torch.matmul(x.to(dt), params["w_in"].to(dt)).float()
    inj = inj.reshape(n_data, M, Bm, H)
    buf = inj.new_zeros((S - 1, n_data, Bm, H))
    outs = []
    for t in range(M + S - 1):
        h_in = torch.cat([inj[None, :, min(t, M - 1)], buf])
        y = _stage_block(h_in.reshape(S, n_data * Bm, H), w, b, dt)
        y = y.reshape(S, n_data, Bm, H)
        # the last stage's output for microbatch t - (S-1) is ready now
        if t >= S - 1:
            outs.append(y[S - 1])
        buf = y[:S - 1]
    return _head(torch.stack(outs, dim=1).reshape(N, H), params, cfg)


def sequential_forward(params: Params, x: torch.Tensor,
                       cfg: PipelineConfig) -> torch.Tensor:
    """The unpipelined model: the stage blocks one after another, same
    dtype discipline (differentiable; :func:`pipeline_reference` returns
    it as numpy)."""
    dt = cfg.dtype
    h = torch.matmul(x.to(dt), params["w_in"].to(dt)).float()
    for s in range(params["w_stage"].shape[0]):
        h = _stage_block(h, params["w_stage"][s], params["b_stage"][s], dt)
    return _head(h, params, cfg)


def pipeline_reference(params, x, cfg: PipelineConfig) -> np.ndarray:
    """Unpipelined oracle (numpy log-probabilities) on *params*' device;
    *params* and *x* may be tensors or numpy arrays."""
    dev = torch.as_tensor(params["w_in"]).device
    p = {n: torch.as_tensor(a, device=dev) for n, a in params.items()}
    with torch.no_grad():
        out = sequential_forward(p, torch.as_tensor(x, device=dev), cfg)
    return out.cpu().numpy()


def pipeline_loss(params: Params, x: torch.Tensor, y: torch.Tensor,
                  cfg: PipelineConfig, n_data: int = 1) -> torch.Tensor:
    """Mean over the *n_data* shards of each shard's mean nll of the
    pipelined forward (the JAX ``pmean``)."""
    logp = pipeline_forward_local(params, x, cfg, n_data)
    nll = -logp.gather(1, y[:, None])[:, 0]
    return nll.reshape(n_data, -1).mean(dim=1).mean()


class PipelinedTrainer:
    """SGD over the pipelined classifier: ``n_stages`` pipeline stages
    (the JAX mesh's ``model`` axis) and ``n_data`` batch shards (its
    ``data`` axis) on one device.  ``device=None`` means ``"cuda"`` and
    raises without it."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(),
                 learning_rate: float = 1e-2, seed: int = 0,
                 n_stages: int = 1, n_data: int = 1, device=None) -> None:
        self.device = kc.resolve_device(device)
        if n_stages < 1 or n_data < 1:
            raise ValueError(f"n_stages and n_data must be at least 1, got "
                             f"{n_stages}, {n_data}")
        self.cfg, self.lr, self.seed = cfg, learning_rate, seed
        self.n_stages, self.n_data = n_stages, n_data

    def init_params(self) -> Params:
        """Fresh parameters from ``torch.Generator().manual_seed(seed)``."""
        g = torch.Generator().manual_seed(self.seed)
        return self.place_params(init_pipeline_params(self.cfg,
                                                      self.n_stages, g))

    def place_params(self, host) -> Params:
        """f32 parameters on this device from a flat dict (tensors or
        numpy arrays), shapes checked against the config."""
        want = param_shapes(self.cfg, self.n_stages)
        if set(host) != set(want):
            raise ValueError(f"pipeline params do not match the config: "
                             f"{sorted(set(host) ^ set(want))}")
        out = {}
        for n, shape in want.items():
            t = torch.as_tensor(host[n], dtype=torch.float32)
            if tuple(t.shape) != shape:
                raise ValueError(f"pipeline param {n}: shape "
                                 f"{tuple(t.shape)}, want {shape}")
            out[n] = t.to(self.device).clone()
        return out

    def place_batch(self, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.as_tensor(np.asarray(x), dtype=torch.float32
                                ).to(self.device),
                torch.as_tensor(np.asarray(y), dtype=torch.int64
                                ).to(self.device))

    def loss(self, params: Params, x, y) -> torch.Tensor:
        xd, yd = self.place_batch(x, y)
        with torch.no_grad():
            return pipeline_loss(params, xd, yd, self.cfg, self.n_data)

    def step(self, params: Params, x, y) -> Tuple[Params, torch.Tensor]:
        """One SGD step (``p - learning_rate * g``, in place); returns
        ``(params, loss)``."""
        xd, yd = self.place_batch(x, y)
        names = list(params)
        for n in names:
            params[n].requires_grad_(True)
        loss = pipeline_loss(params, xd, yd, self.cfg, self.n_data)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        with torch.no_grad():
            for n, g in zip(names, grads):
                params[n].requires_grad_(False)
                params[n].sub_(g * self.lr)
        return params, loss.detach()
