"""Carry state across from the JAX package.

The word count has no weights: its state is the engine configuration and
the per-partition result (the accumulator a run leaves).  The transformer
has a configuration and a flat dict of f32 parameters.  All of it crosses
as plain Python values and numpy arrays, so this module needs nothing of
the JAX package:

* :func:`engine_config_from_jax` takes ``dataclasses.asdict`` of a JAX
  ``EngineConfig`` (with a string ``reduce_op``);
* :func:`device_result_from_numpy` turns a JAX ``DeviceResult``'s numpy
  arrays into the port's tensors (uint32 key lanes as int32 bit
  patterns), and :func:`device_result_to_numpy` goes back;
* :func:`partition_map_from_numpy` takes a JAX engine's bucket->partition
  table (``DeviceEngine.partition_map()``), checked against the bucket
  and partition counts, and :func:`partition_map_to_numpy` goes back;
* :func:`transformer_config_from_jax` takes ``dataclasses.asdict`` of a
  JAX ``TransformerConfig`` with ``dtype`` as a string (``"bfloat16"``,
  ``"float32"``); :func:`transformer_params_from_numpy` turns the JAX
  flat parameter dict (``L{i}.wqkv`` ...) into a state dict of the port's
  :class:`~.models.transformer.Transformer` (``layers.{i}.wqkv`` ...),
  checking names, shapes and dtypes, and
  :func:`transformer_params_to_numpy` goes back.

* :func:`pipeline_params_from_numpy` / :func:`pipeline_params_to_numpy`
  carry the pipelined classifier's flat ``w_in/w_stage/b_stage/w_out``
  dict (``models/pipeline.py``);

* :func:`mlp_params_from_numpy` / :func:`mlp_params_to_numpy` carry the
  MLP's flat ``w0/b0/...`` dict, and :func:`trainer_state_from_numpy` /
  :func:`trainer_state_to_numpy` the digits trainer's whole state (its
  parameters and momentum trace) under the JAX leaf names
  (``params/w0``, ``opt/1/0/trace/w0``);
* :func:`adamw_state_from_numpy` / :func:`adamw_state_to_numpy` (from
  ``models/transformer.py``, where the checkpoints use them) carry the
  transformer's optax ``adamw`` state (``0/count``, ``0/mu/...``,
  ``0/nu/...``) into and out of the port's ``torch.optim.AdamW``.

Every field of the JAX ``EngineConfig`` carries over, ``sort_impl=
'radix'``, the tiered sort policies and ``partition_map`` included.
``jax.random``'s initialisation cannot be reproduced in torch (the
port's inits draw from a ``torch.Generator``), so the tests carry JAX
weights and optimizer state across with these functions and compare
the same computation.
"""

from __future__ import annotations

import dataclasses

from typing import Dict, Union

import numpy as np
import torch

from .engine.device_engine import (
    DeviceResult, EngineConfig, validate_partition_map)
from .models import mlp as _mlp
from .models import pipeline as _pipeline
from .models import trainer as _trainer
from .models.transformer import (  # noqa: F401 (adamw: re-exported)
    Transformer, TransformerConfig, adamw_state_from_numpy,
    adamw_state_to_numpy, jax_name, module_name, param_shapes)

#: the JAX compute dtypes the transformer config carries over, by name
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def engine_config_from_jax(fields: dict) -> EngineConfig:
    """The port's :class:`EngineConfig` from a JAX config's fields."""
    known = {f.name for f in dataclasses.fields(EngineConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown EngineConfig fields {unknown}")
    if not isinstance(fields.get("reduce_op", "sum"), str):
        raise ValueError("only a string reduce_op carries over; a callable "
                         "monoid has to be written for torch")
    return EngineConfig(**fields)


def device_result_from_numpy(keys, values, payload, valid,
                             overflow) -> DeviceResult:
    """A JAX ``DeviceResult``'s arrays (keys uint32 ``[P, W, 2]``) as the
    port's ``DeviceResult`` of CPU tensors."""
    k = np.ascontiguousarray(keys, dtype=np.uint32).view(np.int32)
    return DeviceResult(
        keys=torch.from_numpy(k.copy()),
        values=torch.from_numpy(np.array(values, dtype=np.int32)),
        payload=torch.from_numpy(np.array(payload, dtype=np.int32)),
        valid=torch.from_numpy(np.array(valid, dtype=bool)),
        overflow=int(overflow))


def device_result_to_numpy(result: DeviceResult):
    """``(keys uint32, values, payload, valid, overflow)`` numpy arrays in
    the JAX package's layout."""
    return (result.keys.cpu().numpy().view(np.uint32),
            result.values.cpu().numpy(), result.payload.cpu().numpy(),
            result.valid.cpu().numpy(), int(result.overflow))


def partition_map_from_numpy(pmap, buckets: int,
                             n_parts: int) -> torch.Tensor:
    """A bucket->partition table (``[buckets]`` ints in ``[0, n_parts)``)
    as an int32 CPU tensor; raises on a malformed table."""
    return torch.from_numpy(
        validate_partition_map(pmap, buckets, n_parts).copy())


def partition_map_to_numpy(pmap: torch.Tensor) -> np.ndarray:
    """The table as the int32 numpy array the JAX engine takes."""
    return pmap.cpu().numpy().astype(np.int32)


def transformer_config_from_jax(fields: dict) -> TransformerConfig:
    """The port's :class:`TransformerConfig` from a JAX config's fields,
    ``dtype`` given by name."""
    known = {f.name for f in dataclasses.fields(TransformerConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown TransformerConfig fields {unknown}")
    out = dict(fields)
    if "dtype" in out:
        name = str(out["dtype"])
        if name not in _DTYPES:
            raise ValueError(f"dtype {name!r}: one of {sorted(_DTYPES)} "
                             "carries over")
        out["dtype"] = _DTYPES[name]
    return TransformerConfig(**out)


def _f32_tensors(arrays: dict, shapes: dict, what: str
                 ) -> Dict[str, torch.Tensor]:
    """CPU f32 tensor copies of *arrays*, checked against *shapes*."""
    missing, extra = sorted(set(shapes) - set(arrays)), \
        sorted(set(arrays) - set(shapes))
    if missing or extra:
        raise ValueError(f"{what} do not match the config: missing "
                         f"{missing}, extra {extra}")
    out = {}
    for name, shape in shapes.items():
        a = np.asarray(arrays[name])
        if a.shape != tuple(shape) or a.dtype != np.float32:
            raise ValueError(f"{what} {name}: want {tuple(shape)} float32, "
                             f"got {a.shape} {a.dtype}")
        out[name] = torch.from_numpy(a.copy())
    return out


def transformer_params_from_numpy(params: dict, cfg: TransformerConfig
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX flat parameter dict (numpy arrays, f32) as a state dict of
    :class:`Transformer` (CPU tensors, copies).  Raises ``ValueError`` on
    a missing or extra name, a wrong shape or a dtype other than f32."""
    return {module_name(n): t for n, t in _f32_tensors(
        params, param_shapes(cfg), "transformer params").items()}


def transformer_params_to_numpy(
        params: Union[Transformer, Dict[str, torch.Tensor]]
) -> Dict[str, np.ndarray]:
    """A :class:`Transformer` (or its state dict) as the JAX flat dict of
    f32 numpy arrays."""
    sd = params.state_dict() if isinstance(params, torch.nn.Module) \
        else params
    return {jax_name(n): t.detach().cpu().numpy().astype(np.float32)
            for n, t in sd.items()}


def pipeline_params_from_numpy(params: dict, cfg: "_pipeline.PipelineConfig",
                                n_stages: int) -> Dict[str, torch.Tensor]:
    """The JAX pipeline's flat parameter dict (numpy f32) as CPU tensors,
    names and shapes checked against *cfg* and *n_stages*."""
    return _f32_tensors(params, _pipeline.param_shapes(cfg, n_stages),
                        "pipeline params")


def pipeline_params_to_numpy(params: Dict[str, torch.Tensor]
                             ) -> Dict[str, np.ndarray]:
    """The port's pipeline parameters as the JAX flat dict of f32
    arrays."""
    return {n: t.detach().cpu().numpy().astype(np.float32)
            for n, t in params.items()}


def mlp_params_from_numpy(params: dict, cfg: "_mlp.MLPConfig"
                          ) -> Dict[str, torch.Tensor]:
    """The JAX MLP's flat parameter dict (numpy f32) as CPU tensors,
    names and shapes checked against *cfg*."""
    return _f32_tensors(params, _mlp.param_shapes(cfg), "MLP params")


def mlp_params_to_numpy(params: Dict[str, torch.Tensor]
                        ) -> Dict[str, np.ndarray]:
    """The port's MLP parameters as the JAX flat dict of f32 arrays."""
    return {n: t.detach().cpu().numpy().astype(np.float32)
            for n, t in params.items()}


def trainer_state_from_numpy(state: dict, cfg: "_mlp.MLPConfig"):
    """The digits trainer's flat state under the JAX leaf names
    (``params/<n>`` and ``opt/1/0/trace/<n>``, numpy f32) as ``(params,
    opt_state)`` dicts of CPU tensors by parameter name; pass them to
    ``DistributedTrainer.place_state``."""
    params, trace = _trainer.split_state(state)
    shapes = _mlp.param_shapes(cfg)
    return (_f32_tensors(params, shapes, "trainer params"),
            _f32_tensors(trace, shapes, "momentum trace"))


def trainer_state_to_numpy(params: Dict[str, torch.Tensor],
                           opt_state: Dict[str, torch.Tensor]
                           ) -> Dict[str, np.ndarray]:
    """The trainer's state as the JAX flat leaves (numpy f32)."""
    return {n: t.detach().cpu().numpy().astype(np.float32)
            for n, t in _trainer.state_tree(params, opt_state).items()}
