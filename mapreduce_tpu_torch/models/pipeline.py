"""Pipeline parallelism: GPipe-style microbatch pipelining (port of
``models/pipeline.py``), on one device or over a process group.

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

Over a process group (``group=``, gloo) the grid of S stages and
``n_data`` batch shards lies over the ranks as ``make_mesh`` lays the
JAX ``(model, data)`` mesh over a ``jax.distributed`` job's devices
(:func:`..parallel.mesh.pipeline_layout`): when the world size W divides
S, rank ``r`` runs stages ``[r*S/W, (r+1)*S/W)`` of every shard, and
when S is 1 and W divides ``n_data``, the rank runs the one stage of its
shards.  Across stages, each tick runs the rank's own stages as one
batched product, as above, and the output of its last stage goes to the
next rank (:class:`..parallel.ring._Hop`: the bytes through pinned host
memory, the cotangent back in the backward pass), the first rank
receiving zeros, as the JAX ``ppermute`` without a wrap gives it.  Every
rank hops at every tick, so a step has M+S-1 hops forward and as many
back at each rank boundary.  The last rank's outputs then go to every
rank (one broadcast, the JAX ``psum`` over the stage axis), so the head
and the loss are the same on every rank.  The parameters keep the JAX
names and shapes on every rank; a rank reads and updates only its own
blocks of ``w_stage`` and ``b_stage``.
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
from ..parallel.mesh import PipelineLayout, all_reduce_sum, pipeline_layout
from ..parallel.ring import _Hop, _Ring, _Sink
from ..parallel.shuffle import _host_stage

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


class _FromLast(torch.autograd.Function):
    """The last stage's outputs, on the last rank, to every rank of the
    group (one broadcast through host memory): the JAX ``psum`` over the
    stage axis, where only the last stage holds outputs.  Every rank then
    computes the same head and loss, so the last rank's own cotangent is
    the outputs' whole cotangent and the backward pass moves nothing."""

    @staticmethod
    def forward(ctx, outs, like, group, src):
        import torch.distributed as dist

        ctx.own = outs is not None
        if ctx.own:
            buf = _host_stage(outs.detach())
        else:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              pin_memory=like.device.type == "cuda")
        dist.broadcast(buf, src=src, group=group)
        if ctx.own:
            return outs.view_as(outs)
        return buf.to(like.device, non_blocking=True)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.own else None), None, None, None


def _pipeline_hops(layout: PipelineLayout, n_stages: int, group):
    """``(ring, src)``: the transfers to the next and from the previous
    stage rank and the global rank of the last one, or ``(None, None)``
    when one rank holds every stage.  The chain's ends neither send (the
    last rank) nor receive (the first), so the ring never wraps."""
    if len(layout.stages) == n_stages:
        return None, None
    import torch.distributed as dist

    return (_Ring(group, layout.world, layout.rank),
            dist.get_global_rank(group, layout.world - 1))


def pipeline_forward_local(params: Params, x: torch.Tensor,
                           cfg: PipelineConfig,
                           n_data: int = 1, group=None) -> torch.Tensor:
    """``x`` [N, n_in] -> [N, n_classes] log-probabilities through the
    pipelined schedule (module docstring).  The batch splits into
    *n_data* shards of N/n_data rows, each a whole number of
    microbatches (else ``ValueError``); a shard's M microbatches pass the
    S stages in M+S-1 ticks.

    With *group*, *n_data* stays the global shard count and *x* holds
    the rows of this rank's shards (:func:`..parallel.mesh.
    pipeline_layout`: every shard when the stages span the ranks); the
    result is theirs, on every rank that holds them."""
    S = params["w_stage"].shape[0]
    Bm, H, dt = cfg.microbatch, cfg.hidden, cfg.dtype
    layout = pipeline_layout(group, S, n_data)
    D, stages = len(layout.data), layout.stages
    N = x.shape[0]
    if N % D:
        raise ValueError(f"batch {N} does not split over n_data={n_data}")
    n_local = N // D
    if n_local % Bm != 0 or n_local == 0:
        raise ValueError(f"batch {n_local} not a multiple of microbatch "
                         f"{Bm}")
    M = n_local // Bm
    SL = len(stages)
    first, last = stages.start == 0, stages.stop == S
    ring, src = _pipeline_hops(layout, S, group)
    w = params["w_stage"][stages.start:stages.stop]
    b = params["b_stage"][stages.start:stages.stop, None, :]
    if first:
        # stage 0's injected stream: the input projection of each
        # microbatch
        inj = torch.matmul(x.to(dt), params["w_in"].to(dt)).float()
        inj = inj.reshape(D, M, Bm, H)
    like = x.new_empty((D, Bm, H), dtype=torch.float32)
    buf = like.new_zeros((SL - 1, D, Bm, H))
    # got: the block that crossed into this rank's first stage; token:
    # the hops' chain, which starts on the parameters' path so that
    # every hop's backward runs (``parallel.ring._Hop``)
    got, token = like.new_zeros(like.shape), w
    outs = []
    for t in range(M + S - 1):
        head = inj[:, min(t, M - 1)] if first else got
        h_in = torch.cat([head[None], buf])
        y = _stage_block(h_in.reshape(SL, D * Bm, H), w, b, dt)
        y = y.reshape(SL, D, Bm, H)
        # the last stage's output for microbatch t - (S-1) is ready now
        if last and t >= S - 1:
            outs.append(y[SL - 1])
        buf = y[:SL - 1]
        if ring is not None:
            token = got = _Hop.apply(None if last else y[SL - 1], token,
                                     ring, like, not last, not first)
    out = torch.stack(outs, dim=1).reshape(N, H) if last else None
    if ring is not None:
        out = _FromLast.apply(out, like.new_empty((N, H)), group, src)
        if token.requires_grad:
            out = _Sink.apply(out, token)
    return _head(out, params, cfg)


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
                  cfg: PipelineConfig, n_data: int = 1,
                  group=None) -> torch.Tensor:
    """Mean over the *n_data* shards of each shard's mean nll of the
    pipelined forward (the JAX ``pmean``).  With *group*, *x* and *y*
    hold this rank's shards' rows and the mean is over those shards: the
    whole batch's when the stages span the ranks (the same on every
    rank), else this rank's part of it."""
    shards = len(pipeline_layout(group, params["w_stage"].shape[0],
                                 n_data).data)
    logp = pipeline_forward_local(params, x, cfg, n_data, group)
    nll = -logp.gather(1, y[:, None])[:, 0]
    return nll.reshape(shards, -1).mean(dim=1).mean()


class PipelinedTrainer:
    """SGD over the pipelined classifier: ``n_stages`` pipeline stages
    (the JAX mesh's ``model`` axis) and ``n_data`` batch shards (its
    ``data`` axis) on one device.  ``device=None`` means ``"cuda"`` and
    raises without it.

    With *group* (gloo), the stages or the shards span the group's
    ranks (:func:`..parallel.mesh.pipeline_layout`; another layout
    raises ``ValueError``, another backend ``NotImplementedError``).
    Every rank calls :meth:`step` and :meth:`loss` with the whole batch
    and keeps the JAX names and shapes of every parameter.  Across
    stages, the loss is the same on every rank, ``w_in``'s gradient (only
    the first rank's is not zero) is summed over the ranks, a rank
    updates only its own ``w_stage`` and ``b_stage`` blocks, and
    ``w_out``, whose gradient every rank computes alike, is not summed.
    Across shards, the loss and every gradient are averaged over the
    ranks."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(),
                 learning_rate: float = 1e-2, seed: int = 0,
                 n_stages: int = 1, n_data: int = 1, device=None,
                 group=None) -> None:
        self.device = kc.resolve_device(device)
        if n_stages < 1 or n_data < 1:
            raise ValueError(f"n_stages and n_data must be at least 1, got "
                             f"{n_stages}, {n_data}")
        self.cfg, self.lr, self.seed = cfg, learning_rate, seed
        self.n_stages, self.n_data = n_stages, n_data
        self.group = group
        self.layout = pipeline_layout(group, n_stages, n_data)

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

    def _rows(self, xd, yd):
        """This rank's shards' rows of the whole batch (all of it when
        the stages span the ranks)."""
        data = self.layout.data
        if len(data) == self.n_data:
            return xd, yd
        per = xd.shape[0] // self.n_data
        rows = slice(data.start * per, data.stop * per)
        return xd[rows], yd[rows]

    def _data_split(self) -> bool:
        return len(self.layout.data) < self.n_data

    def loss(self, params: Params, x, y) -> torch.Tensor:
        xd, yd = self._rows(*self.place_batch(x, y))
        with torch.no_grad():
            loss = pipeline_loss(params, xd, yd, self.cfg, self.n_data,
                                 self.group)
        if self._data_split():
            all_reduce_sum([loss], self.group)
            loss /= self.layout.world
        return loss

    def step(self, params: Params, x, y) -> Tuple[Params, torch.Tensor]:
        """One SGD step (``p - learning_rate * g``, in place); returns
        ``(params, loss)``."""
        xd, yd = self._rows(*self.place_batch(x, y))
        names = list(params)
        for n in names:
            params[n].requires_grad_(True)
        loss = pipeline_loss(params, xd, yd, self.cfg, self.n_data,
                             self.group)
        # a rank without the first stage never reads w_in
        grads = [torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, torch.autograd.grad(
                     loss, [params[n] for n in names], allow_unused=True))]
        loss = loss.detach()
        if self._data_split():
            all_reduce_sum(grads + [loss], self.group)
            for g in grads + [loss]:
                g /= self.layout.world
        elif self.layout.world > 1:
            all_reduce_sum([grads[names.index("w_in")]], self.group)
        with torch.no_grad():
            for n, g in zip(names, grads):
                # the stage blocks a rank does not own have a zero
                # gradient (its forward reads only its own), so they
                # stay as placed
                params[n].requires_grad_(False)
                params[n].sub_(g * self.lr)
        return params, loss
