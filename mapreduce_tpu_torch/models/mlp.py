"""MLP model family (port of ``mapreduce_tpu/models/mlp.py``; the
reference's only model architecture).

Parity target: APRIL-ANN's ``"256 inputs 128 tanh 10 log_softmax"``
(examples/APRIL-ANN/init.lua:12) with class-NLL loss; sizes are
configurable.  Parameters are a flat dict of named f32 tensors
(``w0/b0, w1/b1, ...``, the JAX names), so the trainer, the checkpoints
and the job-board example address them by name.

The cast points are the JAX package's: the input, each weight and each
bias are cast to ``cfg.dtype``, ``h @ w + b`` and the hidden ``tanh`` run
in that type, and ``log_softmax`` runs in f32.  The dense products stay
``torch.matmul``: the JAX package leaves them to XLA, outside any Pallas
kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class MLPConfig:
    """Layer sizes input->hidden...->classes; dtype is the compute dtype
    (parameters stay f32)."""

    sizes: Tuple[int, ...] = (256, 128, 10)
    dtype: torch.dtype = torch.bfloat16


def param_shapes(cfg: MLPConfig) -> Dict[str, Tuple[int, ...]]:
    """The flat parameter names and shapes, in the JAX init order."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    for i, (n_in, n_out) in enumerate(zip(cfg.sizes[:-1], cfg.sizes[1:])):
        shapes[f"w{i}"] = (n_in, n_out)
        shapes[f"b{i}"] = (n_out,)
    return shapes


def init_params(cfg: MLPConfig, generator: torch.Generator,
                device="cpu") -> Params:
    """Glorot-ish init, f32 (unit normals times ``sqrt(2 / (n_in +
    n_out))``, zero biases), drawn on the CPU from *generator* in the JAX
    order and moved to *device*.  The draws are torch's, not
    ``jax.random``'s: carry JAX parameters across with
    ``convert.mlp_params_from_numpy``."""
    params: Params = {}
    for name, shape in param_shapes(cfg).items():
        if name[0] == "w":
            scale = (2.0 / (shape[0] + shape[1])) ** 0.5
            t = torch.randn(shape, generator=generator) * scale
        else:
            t = torch.zeros(shape)
        params[name] = t.to(device)
    return params


def forward(params: Params, x: torch.Tensor,
            cfg: MLPConfig = MLPConfig()) -> torch.Tensor:
    """[B, in] -> [B, classes] f32 log-probabilities (tanh hidden layers +
    log_softmax head, matching the reference model string)."""
    n_layers = len(cfg.sizes) - 1
    h = x.to(cfg.dtype)
    for i in range(n_layers):
        h = h @ params[f"w{i}"].to(cfg.dtype) + params[f"b{i}"].to(cfg.dtype)
        if i < n_layers - 1:
            h = torch.tanh(h)
    return torch.log_softmax(h.float(), dim=-1)


def _nll(logp: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -torch.gather(logp, 1, y.long()[:, None]).mean()


def nll_loss(params: Params, x: torch.Tensor, y: torch.Tensor,
             cfg: MLPConfig = MLPConfig()) -> torch.Tensor:
    """Mean class-negative-log-likelihood over the (global) batch."""
    return _nll(forward(params, x, cfg), y)


def loss_and_accuracy(params: Params, x: torch.Tensor, y: torch.Tensor,
                      cfg: MLPConfig = MLPConfig()):
    """``(loss, accuracy)`` as f32 scalar tensors."""
    logp = forward(params, x, cfg)
    acc = (logp.argmax(dim=-1) == y.long()).float().mean()
    return _nll(logp, y), acc
