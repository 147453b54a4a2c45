"""The fused trainer: weights on the card, one dispatch per epoch (port of
``mapreduce_tpu/models/trainer.py``).

The reference's distributed SGD moves the entire serialized model
through GridFS for every minibatch gradient and every optimizer step
(SURVEY.md §3.5); here the parameters never leave device memory:

  * **data parallelism is logical**, as :class:`..parallel.mesh.
    Partitions` is: the JAX global batch is ``bunch_size * n_data`` rows
    over the mesh's ``data`` axis, the loss is its mean and XLA's psum
    sums the shards' gradients.  One card computes the same step on the
    whole global batch, at any ``n_data``; ``1/sqrt(n_data)`` gradient
    smoothing (common.lua:163-166) is kept.  Over a ``torch.distributed``
    process group (``group=``, gloo; the JAX trainer's multi-process
    mesh) each of the ``W`` ranks holds ``n_data / W`` shards of the
    global batch, scales its local mean loss by its share of the batch,
    and the gradients and the loss are all-reduced (sum) before the
    update, so every rank applies the same update;
  * SGD + momentum + weight decay as optax's ``chain(
    add_decayed_weights(wd), sgd(lr, momentum))``, written out per leaf:
    ``t = (g + wd * p) + momentum * t_prev``, then ``p = p - lr * t``;
  * **the fused epoch** (the JAX ``lax.scan`` of the step, one dispatch
    per epoch): on the card the S steps of an epoch are captured whole
    into one CUDA graph, reading step i's batch from fixed ``[S,
    global_batch, in]`` / ``[S, global_batch]`` slots, with the
    gradients and momentum buffers allocated before the capture and the
    S losses read once an epoch; each epoch copies its stacked batch
    into the slots and replays the graph.  On the CPU the epoch is a
    loop over :meth:`DistributedTrainer.step`;
  * holdout early stopping (common.lua:172-189), per-epoch
    manifest-committed checkpoints (``models/checkpoint.py``, retention
    keep-N + best) with resume-on-start, and an optional trainer lease
    (``coord/lease.py``) so a preempted trainer FENCES at its next
    epoch boundary while a successor restores the latest complete
    checkpoint; the per-epoch permutation is seeded ``seed + epoch``,
    so the successor's lineage equals an uninterrupted run's.

The checkpointed state is flat, under the JAX package's leaf names
(``params/w0``, ``opt/1/0/trace/w0``), with the JAX spelling of each
leaf's partition spec (:data:`TRAINER_PARTITION_RULES`): either package
restores the other's checkpoints.  Each epoch samples the device's
memory into ``obs/memory``'s gauges, as the JAX trainer does: the CUDA
allocator's counters on the card, the state and batch bytes this trainer
holds on the CPU (labelled analytic).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..coord.lease import TrainerFencedError, TrainerLease
from ..obs import memory as _memory_obs
from ..obs import metrics as _metrics
from ..ops import kernel_compat as kc
from ..parallel.mesh import group_shape
from ..parallel.partition import resolve_spec
from .checkpoint import CheckpointError, CheckpointManager
from .mlp import (MLPConfig, init_params, loss_and_accuracy, nll_loss,
                  param_shapes)

Params = Dict[str, torch.Tensor]
#: the momentum trace, one buffer a parameter, by parameter name
OptState = Dict[str, torch.Tensor]

#: Megatron-alternating layout as ONE regex table: even layers
#: column-split, odd layers row-split.  Anchored on the TRAILING leaf
#: name, so the same table resolves the momentum mirrors
#: (``…/trace/w0``); scalar leaves pass through replicated.
TRAINER_PARTITION_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"w\d*[02468]$", (None, "model")),
    (r"w\d*[13579]$", ("model", None)),
    (r"b\d*[02468]$", ("model",)),
    (r"b\d*[13579]$", ()),
)

#: the state tree's leaf-name prefixes: optax's chain state is
#: ``(EmptyState, (TraceState(trace), EmptyState))``, so the trace of
#: ``w0`` is ``opt/1/0/trace/w0``
PARAMS_PREFIX = "params/"
TRACE_PREFIX = "opt/1/0/trace/"

_RECOVERY_S = _metrics.gauge(
    "mrtpu_trainer_recovery_seconds",
    "seconds from fit() entry to the end of the first epoch after "
    "restoring a checkpoint (the successor's step-recovery time)")
_EPOCHS = _metrics.counter(
    "mrtpu_trainer_epochs_total",
    "optimizer epochs applied by this process "
    "(labels: outcome=applied|fenced)")


@dataclass(frozen=True)
class TrainConfig:
    """Reference hyperparameters (examples/APRIL-ANN/init.lua:10-20) as
    defaults: lr .01, momentum .02, weight decay 1e-4, bunch (per-shard
    batch) 128, 20-40 epochs."""

    learning_rate: float = 0.01
    momentum: float = 0.02
    weight_decay: float = 1e-4
    bunch_size: int = 128
    max_epochs: int = 40
    min_epochs: int = 5
    patience: int = 8           # epochs without val improvement -> stop
    smoothing: bool = False     # grads *= 1/sqrt(n_data) (common.lua:163-166)
    seed: int = 1234


#: the TrainConfig fields that determine the training LINEAGE: a resume
#: must run the same values.  The global batch (bunch * n_data) is not
#: attested: resuming at another n_data is the reshard feature.
LINEAGE_FIELDS: Tuple[str, ...] = (
    "seed", "learning_rate", "momentum", "weight_decay",
    "bunch_size", "smoothing", "min_epochs", "patience")


def lineage_config(cfg: TrainConfig) -> Dict[str, Any]:
    """The manifest-stamped attestation of *cfg*'s lineage fields."""
    return {f: getattr(cfg, f) for f in LINEAGE_FIELDS}


def state_tree(params: Params, opt_state: OptState) -> Dict[str, Any]:
    """The flat checkpoint tree under the JAX leaf names."""
    tree = {PARAMS_PREFIX + n: t for n, t in params.items()}
    tree.update({TRACE_PREFIX + n: t for n, t in opt_state.items()})
    return tree


def split_state(tree: Dict[str, Any]) -> Tuple[Dict[str, Any],
                                               Dict[str, Any]]:
    """``(params, opt_state)`` by parameter name from a flat tree; any
    other leaf raises ``ValueError``."""
    params, trace = {}, {}
    for name, leaf in tree.items():
        if name.startswith(PARAMS_PREFIX):
            params[name[len(PARAMS_PREFIX):]] = leaf
        elif name.startswith(TRACE_PREFIX):
            trace[name[len(TRACE_PREFIX):]] = leaf
        else:
            raise ValueError(f"unexpected trainer state leaf {name!r}")
    return params, trace


class DistributedTrainer:
    """Train the MLP family on one device; ``n_data`` is the JAX mesh's
    ``data`` axis size, kept as a logical width (global batch and
    smoothing).  ``device=None`` means ``"cuda"`` and raises without
    it; the tests pass ``device="cpu"``.

    With *group* (a gloo ``torch.distributed`` process group whose world
    size ``W`` divides ``n_data``) this process is one rank of a
    multi-process data axis: :meth:`place_batch` keeps its ``n_data /
    W`` shards of the global batch, and :meth:`step` all-reduces the
    gradients and the loss before the update.  The captured epoch
    (:meth:`_train_epoch`, hence :meth:`fit`) stays single-process and
    raises over a group."""

    def __init__(self, mlp_cfg: MLPConfig = MLPConfig(),
                 cfg: TrainConfig = TrainConfig(), n_data: int = 1,
                 device=None, group=None) -> None:
        if n_data < 1:
            raise ValueError(f"n_data must be >= 1, got {n_data}")
        self.device = kc.resolve_device(device)
        self.mlp_cfg, self.cfg, self.n_data = mlp_cfg, cfg, int(n_data)
        self.grad_scale = (1.0 / np.sqrt(self.n_data)) if cfg.smoothing \
            else 1.0
        self._graph: Optional[kc.StepsGraph] = None
        self.group = group
        self.world, self.rank = group_shape(
            group, self.n_data, f"DistributedTrainer(n_data={self.n_data})")

    # -- state ------------------------------------------------------------

    def abstract_state(self) -> Dict[str, np.ndarray]:
        """The flat state tree as empty host arrays (shapes and dtypes
        only): the restore template."""
        empty = {n: np.empty(s, np.float32)
                 for n, s in param_shapes(self.mlp_cfg).items()}
        return state_tree(empty, empty)

    def _place(self, leaves: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """f32 copies on this trainer's device."""
        out = {}
        for n, a in leaves.items():
            t = a.detach() if isinstance(a, torch.Tensor) \
                else torch.from_numpy(np.asarray(a))
            out[n] = t.to(self.device, torch.float32).clone()
        return out

    def place_state(self, params: Dict[str, Any], opt_state: Dict[str, Any]
                    ) -> Tuple[Params, OptState]:
        """Host (numpy) or tensor state onto this trainer's device: the
        parameters as leaf tensors that require grad, the momentum
        buffers beside them."""
        ps = {n: t.requires_grad_() for n, t in self._place(params).items()}
        return ps, self._place(opt_state)

    def init_state(self) -> Tuple[Params, OptState]:
        """Fresh parameters from ``torch.Generator().manual_seed(seed)``
        (torch's draws, not ``jax.random``'s) and a zero momentum
        trace."""
        params = init_params(self.mlp_cfg,
                             torch.Generator().manual_seed(self.cfg.seed))
        return self.place_state(
            params, {n: torch.zeros_like(t) for n, t in params.items()})

    def place_batch(self, x: np.ndarray, y: np.ndarray
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The global batch on this trainer's device; over a process
        group, this rank's contiguous ``1/W`` of its rows (its
        ``n_data / W`` shards, as the JAX mesh places them)."""
        x, y = np.asarray(x), np.asarray(y)
        if self.group is not None:
            if x.shape[0] % self.world:
                raise ValueError(
                    f"global batch of {x.shape[0]} rows does not split "
                    f"over {self.world} ranks")
            per = x.shape[0] // self.world
            lo = self.rank * per
            x, y = x[lo:lo + per], y[lo:lo + per]
        return (torch.as_tensor(x, dtype=torch.float32).to(self.device),
                torch.as_tensor(y, dtype=torch.int64).to(self.device))

    # -- the step ---------------------------------------------------------

    def _step_impl(self, params: Params, opt_state: OptState,
                   x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One step in place: forward, backward into the preallocated
        gradients, the optax update.  Reads nothing back to the host, so
        it captures into a CUDA graph."""
        ps = list(params.values())
        for p in ps:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch._foreach_zero_([p.grad for p in ps])
        loss = nll_loss(params, x, y, self.mlp_cfg)
        if self.group is not None:
            # the local mean weighted by this rank's share of the global
            # batch: the ranks' sum is the global mean
            loss = loss / self.world
        loss.backward()
        loss = loss.detach()
        if self.group is not None:
            loss = self._all_reduce([p.grad for p in ps], loss)
        self._apply_update(params, opt_state)
        return loss

    def _all_reduce(self, grads: List[torch.Tensor],
                    loss: torch.Tensor) -> torch.Tensor:
        """Sum *grads* (in place) and *loss* over the group: one
        ``all_reduce`` of a flat host buffer (gloo moves CPU tensors);
        returns the summed loss on this trainer's device."""
        import torch.distributed as dist

        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.reshape(1)]).cpu()
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        flat = flat.to(self.device)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return flat[at].clone()

    @torch.no_grad()
    def _apply_update(self, params: Params, opt_state: OptState) -> None:
        """optax's ``chain(add_decayed_weights(wd), sgd(lr, momentum))``
        on the parameters' ``.grad`` (after the smoothing scale), in
        place."""
        cfg = self.cfg
        ps = list(params.values())
        grads = [p.grad for p in ps]
        if self.grad_scale != 1.0:
            torch._foreach_mul_(grads, self.grad_scale)
        # add_decayed_weights: u = g + wd * p
        upd = torch._foreach_add(grads, ps, alpha=cfg.weight_decay)
        # trace: t = u + momentum * t_prev
        trace = [opt_state[n] for n in params]
        torch._foreach_mul_(trace, cfg.momentum)
        torch._foreach_add_(trace, upd)
        # scale_by_learning_rate + apply_updates: p = p - lr * t
        torch._foreach_add_(ps, trace, alpha=-cfg.learning_rate)

    def step(self, params: Params, opt_state: OptState, x: torch.Tensor,
             y: torch.Tensor) -> Tuple[Params, OptState, torch.Tensor]:
        """One eager step on a placed global batch; returns ``(params,
        opt_state, loss)``.  The update is in place (JAX donates the
        state instead)."""
        loss = self._step_impl(params, opt_state, x, y)
        return params, opt_state, loss

    def _train_epoch(self, params: Params, opt_state: OptState,
                     xs, ys) -> Tuple[Params, OptState, torch.Tensor]:
        """S steps over a stacked ``[S, global_batch, in]`` /
        ``[S, global_batch]`` batch (host arrays or tensors); returns
        ``(params, opt_state, losses [S])``, the state updated in place.
        On the card: one CUDA graph replay, captured on the first call
        and again for other state dicts or another S.  Single-process:
        over a process group it raises ``NotImplementedError``."""
        if self.group is not None:
            raise NotImplementedError(
                "the fused epoch (_train_epoch, and fit through it) runs "
                "in one process; over a process group call step()")
        xs = torch.as_tensor(xs, dtype=torch.float32)
        ys = torch.as_tensor(ys).long()
        if self.device.type != "cuda":
            losses = [self._step_impl(params, opt_state,
                                      xs[i].to(self.device),
                                      ys[i].to(self.device))
                      for i in range(xs.shape[0])]
            return params, opt_state, torch.stack(losses)
        xs = xs.to(self.device)
        ys = ys.to(self.device)
        g = self._graph
        if g is None or not g.fits((params, opt_state), xs):
            self._graph = None
            self._graph = g = kc.StepsGraph(
                lambda x, y: self._step_impl(params, opt_state, x, y),
                xs, ys, list(params.values()) + list(opt_state.values()),
                owners=(params, opt_state), program="mlp_epoch")
        return params, opt_state, g.run(xs, ys)

    def _eval(self, params: Params, x: torch.Tensor, y: torch.Tensor):
        with torch.no_grad():
            return loss_and_accuracy(params, x, y, self.mlp_cfg)

    # -- the training loop (reference server_final loop, fused) ----------

    def fit(self, x_tr: np.ndarray, y_tr: np.ndarray,
            x_va: np.ndarray, y_va: np.ndarray,
            log: Optional[Callable[[str], None]] = None,
            manager: Optional[CheckpointManager] = None,
            lease: Optional[TrainerLease] = None,
            resume: bool = True,
            on_epoch: Optional[Callable[[Dict[str, Any]], None]] = None,
            ) -> Dict[str, Any]:
        """Run epochs until the holdout stops improving (the reference's
        stopping criterion, common.lua:193-201); returns the history and
        the final state.

        * *manager* commits a checkpoint EVERY epoch and tags the
          best-holdout one; with *resume* (default) fit first restores
          the latest complete checkpoint (either package's) and continues
          from the next epoch with the same early-stopping state; a
          checkpoint stamped with other lineage fields raises
          :class:`CheckpointError`;
        * *lease* fences: each epoch starts (and each checkpoint
          commits) only after an affirmative heartbeat;
          :class:`TrainerFencedError` propagates with nothing committed
          for the fenced epoch;
        * the epoch's permutation is ``default_rng(seed + epoch)``, so a
          successor's lineage equals an uninterrupted run's.
        """
        cfg = self.cfg
        t_start = time.monotonic()
        global_batch = cfg.bunch_size * self.n_data
        n = x_tr.shape[0]
        steps = max(n // global_batch, 1)
        x_va_d, y_va_d = self.place_batch(x_va, y_va)

        best_val = np.inf
        best_epoch = 0
        start_epoch = 1
        restored = False
        params = opt_state = None
        if manager is not None and resume:
            got = manager.restore_latest(self.abstract_state())
            if got is not None:
                state, manifest = got
                params, opt_state = self.place_state(*split_state(state))
                meta = manifest.get("meta") or {}
                stamped = meta.get("train_config")
                if stamped:
                    ours = lineage_config(cfg)
                    bad = [f for f in LINEAGE_FIELDS if f in stamped
                           and stamped[f] != ours[f]]
                    if bad:
                        raise CheckpointError(
                            "resume config mismatch vs checkpoint step "
                            f"{manifest['step']}: " + ", ".join(
                                f"{f}={ours[f]!r} (checkpoint has "
                                f"{stamped[f]!r})" for f in bad))
                start_epoch = int(manifest["step"]) + 1
                best_val = float(meta.get("best_val", np.inf))
                best_epoch = int(meta.get("best_epoch", 0))
                restored = True
                if log:
                    log(f"restored checkpoint step {manifest['step']} "
                        f"(best_val {best_val:.4f} @ {best_epoch})")
        if params is None:
            params, opt_state = self.init_state()

        history: List[Dict[str, float]] = []
        last_epoch = cfg.max_epochs
        if restored and (start_epoch - 1 >= cfg.min_epochs
                         and (start_epoch - 1) - best_epoch
                         >= cfg.patience):
            # the restored lineage had already stopped: resuming must not
            # train past it
            last_epoch = start_epoch - 1
        for epoch in range(start_epoch, last_epoch + 1):
            if lease is not None:
                # fence gate: stop BEFORE this epoch's steps are applied
                try:
                    lease.ensure_owned()
                except TrainerFencedError:
                    _EPOCHS.inc(outcome="fenced")
                    raise
            perm = np.random.default_rng(cfg.seed + epoch).permutation(n)
            need = steps * global_batch
            if need > n:  # static shapes: wrap around (dataset may be
                # smaller than even one global batch)
                perm = np.tile(perm, -(-need // n))
            sel = perm[:need]
            xs = x_tr[sel].reshape(steps, global_batch, x_tr.shape[1])
            ys = y_tr[sel].reshape(steps, global_batch)
            params, opt_state, losses = self._train_epoch(
                params, opt_state, xs, ys)
            val_loss, val_acc = self._eval(params, x_va_d, y_va_d)
            val_loss = float(val_loss)
            # per-epoch device-memory gauges: the allocator's counters on
            # the card, else the state and batch bytes held, analytic
            _memory_obs.sample_device_memory(
                [self.device], analytic_bytes_in_use=sum(
                    t.numel() * t.element_size()
                    for t in (*params.values(), *opt_state.values()))
                + xs.nbytes + ys.nbytes)
            rec = {"epoch": epoch,
                   "train_loss": float(losses.mean()),
                   "val_loss": val_loss,
                   "val_acc": float(val_acc)}
            history.append(rec)
            improved = val_loss < best_val - 1e-6
            if improved:
                best_val, best_epoch = val_loss, epoch
            if manager is not None:
                # commit gates: checked before the shard writes and again
                # as the save's precommit hook, right before the manifest
                try:
                    if lease is not None:
                        lease.ensure_owned()
                    manager.save(
                        epoch, state_tree(params, opt_state),
                        spec=lambda name, arr: resolve_spec(
                            TRAINER_PARTITION_RULES, name, arr),
                        meta={"epoch": epoch, "val_loss": val_loss,
                              "best_val": float(best_val),
                              "best_epoch": best_epoch,
                              "train_config": lineage_config(cfg),
                              "generation": (lease.generation
                                             if lease is not None
                                             else None)},
                        precommit=(lease.ensure_owned
                                   if lease is not None else None))
                except TrainerFencedError:
                    _EPOCHS.inc(outcome="fenced")
                    raise
                if improved:
                    manager.mark_best(epoch)
            _EPOCHS.inc(outcome="applied")
            if restored and epoch == start_epoch:
                _RECOVERY_S.set(time.monotonic() - t_start)
            if log:
                log(f"epoch {epoch}: train {rec['train_loss']:.4f} "
                    f"val {val_loss:.4f} acc {rec['val_acc']:.3f}")
            if on_epoch:
                on_epoch(rec)
            if (epoch >= cfg.min_epochs
                    and epoch - best_epoch >= cfg.patience):
                break
        return {"params": params, "opt_state": opt_state,
                "history": history,
                "best_val_loss": best_val, "best_epoch": best_epoch,
                "epochs_run": len(history), "start_epoch": start_epoch,
                "restored": restored}
