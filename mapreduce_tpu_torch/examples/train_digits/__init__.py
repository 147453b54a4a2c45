"""Distributed SGD *through the MapReduce job board* (port of
``mapreduce_tpu/examples/train_digits``) — structural parity with the
reference's APRIL-ANN example (examples/APRIL-ANN/common.lua):

  * taskfn emits data shards (common.lua:79-83);
  * mapfn loads the current model from shared storage, computes minibatch
    gradients for its shard with the port's MLP on ``_conf["device"]``
    (None: the card), and emits one record per weight matrix
    ``(name, [grads, count])`` plus a loss record (common.lua:85-104);
  * partitionfn is the byte-sum hash of the weight name (common.lua:106-109);
  * reducefn accumulates gradients elementwise in float64 numpy
    (common.lua:112-137);
  * finalfn applies the SGD+momentum+weight-decay step in float64 numpy,
    validates on the holdout with the port's MLP, writes the model back,
    and returns ``"loop"`` until the stopping criterion
    (common.lua:144-202).

The model state crosses iterations through the task's storage backend
as a record blob (:data:`MODEL_BLOB`, the JAX example's records: either
package reads the other's).  The fast way to train is
``models/trainer.py``; this one pays the serialize-everything cost the
reference pays every iteration, on purpose.

``_conf``, :data:`HISTORY` and ``_data_cache`` are module state: workers
in one process share them, and a caller that runs the example twice in
one process resets them between runs.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ...utils.hashing import byte_sum_hash
from ...utils.serialization import parse_record, serialize_record
from ... import storage as storage_mod

MODEL_BLOB = "train_digits.model"

_conf: Dict[str, Any] = {
    "storage": None,          # DSL string, REQUIRED (shared with workers)
    "n_shards": 4,            # reference: 4 shards (init.lua:65-70)
    "bunch_size": 128,        # init.lua:13
    "learning_rate": 0.01,    # init.lua:14
    "momentum": 0.02,         # init.lua:15
    "weight_decay": 1e-4,     # init.lua:16
    "max_iterations": 3,
    "target_val_loss": 0.0,
    "smoothing": False,       # 1/sqrt(N) option (common.lua:163-166)
    "sizes": (256, 128, 10),
    "seed": 7,
    "device": None,           # where mapfn and finalfn run the MLP
}
#: finalfn drops per-iteration metrics here for in-process callers
HISTORY: List[Dict[str, float]] = []

associative_reducer = True
commutative_reducer = True
idempotent_reducer = True

_data_cache: Dict[str, Any] = {}


def init(args: Any) -> None:
    if args:
        _conf.update(args)


def _storage():
    if not _conf["storage"]:
        raise ValueError("train_digits needs init_args['storage']")
    return storage_mod.router(_conf["storage"])


def _dataset():
    if "data" not in _data_cache:
        from ...models.digits import make_digits
        _data_cache["data"] = make_digits(seed=_conf["seed"])
    return _data_cache["data"]


def _load_model():
    store = _storage()
    if not store.exists(MODEL_BLOB):
        return None
    state: Dict[str, Any] = {}
    for line in store.open_lines(MODEL_BLOB):
        k, v = parse_record(line)
        state[k] = v
    return state


def _save_model(state: Dict[str, Any]) -> None:
    b = _storage().builder()
    for k, v in state.items():
        b.write_record_line(serialize_record(k, v))
    b.build(MODEL_BLOB)


def _init_model() -> Dict[str, Any]:
    rng = np.random.default_rng(_conf["seed"])
    sizes = _conf["sizes"]
    state: Dict[str, Any] = {"iteration": 0}
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        scale = float(np.sqrt(2.0 / (n_in + n_out)))
        state[f"w{i}"] = (rng.standard_normal((n_in, n_out)) * scale).tolist()
        state[f"b{i}"] = np.zeros((n_out,)).tolist()
        state[f"vel_w{i}"] = np.zeros((n_in, n_out)).tolist()
        state[f"vel_b{i}"] = np.zeros((n_out,)).tolist()
    return state


def _device():
    from ...ops.kernel_compat import resolve_device
    return resolve_device(_conf["device"])


def _params_of(state, requires_grad: bool = False):
    import torch

    dev = _device()
    return {k: torch.tensor(np.array(v, dtype=np.float32), device=dev,
                            requires_grad=requires_grad)
            for k, v in state.items()
            if k[0] in "wb" and not k.startswith("vel")}


def _mlp_config():
    from ...models.mlp import MLPConfig
    return MLPConfig(sizes=tuple(_conf["sizes"]))


# --- roles -----------------------------------------------------------------

def taskfn(emit) -> None:
    if _load_model() is None:  # first iteration bootstraps the model blob
        _save_model(_init_model())
    for shard in range(_conf["n_shards"]):
        emit(shard, {"shard": shard})


def mapfn(key: Any, value: Dict[str, Any], emit) -> None:
    """Per-shard minibatch gradients (common.lua:85-104): deserialize the
    model, draw a random bunch from this shard's rows, emit grads."""
    import torch
    from ...models.mlp import nll_loss

    state = _load_model()
    params = _params_of(state, requires_grad=True)
    x_tr, y_tr, _, _ = _dataset()
    n_shards = _conf["n_shards"]
    shard = value["shard"]
    rows = np.arange(shard, len(x_tr), n_shards)  # interleaved shards
    rng = np.random.default_rng(_conf["seed"] + 1000 * state["iteration"]
                                + shard)
    sel = rng.choice(rows, size=min(_conf["bunch_size"], len(rows)),
                     replace=False)
    dev = _device()
    loss = nll_loss(params, torch.from_numpy(x_tr[sel]).to(dev),
                    torch.from_numpy(y_tr[sel]).to(dev), _mlp_config())
    names = sorted(params)  # the JAX example's (pytree) order
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    count = int(len(sel))
    for name, g in zip(names, grads):
        emit(name, [g.cpu().numpy().tolist(), count])
    emit("TR_LOSS", [float(loss.detach()), count])


def partitionfn(key: str) -> int:
    return byte_sum_hash(key, 10)  # 10 reducers (init.lua:6)


def reducefn(key: str, values: List[Any]) -> Any:
    """Gradient accumulation (the reference's gradient:axpy loop,
    common.lua:112-137); also sums the loss records."""
    if key == "TR_LOSS":
        total = sum(v[0] * v[1] for v in values)
        count = sum(v[1] for v in values)
        return [total / max(count, 1), count]
    acc = np.array(values[0][0], dtype=np.float64)
    count = values[0][1]
    for g, c in values[1:]:
        acc += np.array(g, dtype=np.float64)
        count += c
    return [acc.tolist(), count]


def finalfn(pairs) -> Any:
    """Optimizer step + holdout validation + loop decision
    (common.lua:144-202)."""
    import torch
    from ...models.mlp import loss_and_accuracy

    state = _load_model()
    grads: Dict[str, np.ndarray] = {}
    counts: Dict[str, int] = {}
    train_loss = None
    for key, values in pairs:
        red = values[0]
        if key == "TR_LOSS":
            train_loss = red[0]
        else:
            grads[key] = np.array(red[0], dtype=np.float64)
            counts[key] = red[1]

    lr, mom, wd = (_conf["learning_rate"], _conf["momentum"],
                   _conf["weight_decay"])
    for name, g in grads.items():
        w = np.array(state[name], dtype=np.float64)
        g = g / max(counts[name], 1)  # mean over contributions
        if _conf["smoothing"]:
            g = g / np.sqrt(_conf["n_shards"])
        v = np.array(state[f"vel_{name}"], dtype=np.float64)
        v = mom * v - lr * (g + wd * w)
        w = w + v
        state[name] = w.tolist()
        state[f"vel_{name}"] = v.tolist()
    state["iteration"] = state["iteration"] + 1

    _, _, x_va, y_va = _dataset()
    dev = _device()
    with torch.no_grad():
        val_loss, val_acc = loss_and_accuracy(
            _params_of(state), torch.from_numpy(x_va).to(dev),
            torch.from_numpy(y_va).to(dev), _mlp_config())
    HISTORY.append({"iteration": state["iteration"],
                    "train_loss": float(train_loss or 0.0),
                    "val_loss": float(val_loss),
                    "val_acc": float(val_acc)})
    _save_model(state)

    if (state["iteration"] < _conf["max_iterations"]
            and float(val_loss) > _conf["target_val_loss"]):
        return "loop"
    return True
