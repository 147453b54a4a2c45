"""Carry state across from the JAX package.

This system has no weights: its state is the engine configuration and the
per-partition result (the accumulator a run leaves).  Both cross as plain
Python values and numpy arrays, so this module needs nothing of the JAX
package:

* :func:`engine_config_from_jax` takes ``dataclasses.asdict`` of a JAX
  ``EngineConfig`` (with a string ``reduce_op``);
* :func:`device_result_from_numpy` turns a JAX ``DeviceResult``'s numpy
  arrays into the port's tensors (uint32 key lanes as int32 bit
  patterns), and :func:`device_result_to_numpy` goes back;
* :func:`partition_map_from_numpy` takes a JAX engine's bucket->partition
  table (``DeviceEngine.partition_map()``), checked against the bucket
  and partition counts, and :func:`partition_map_to_numpy` goes back.

Every field of the JAX ``EngineConfig`` carries over, ``sort_impl=
'radix'`` and ``partition_map`` included; the port's engine refuses only
the tiered sort policies, which it has not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engine.device_engine import (
    DeviceResult, EngineConfig, validate_partition_map)


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
