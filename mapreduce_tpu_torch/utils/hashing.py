"""Key hashing / default partitioners on the host (port of
``mapreduce_tpu/utils/hashing.py``).

The reference partitions its keyspace with user Lua hash functions: an
FNV-1-style rolling byte hash in the WordCount example
(examples/WordCount/partitionfn.lua:2-15, init.lua:2-33, using ``bit32``)
and a plain byte-sum in the APRIL-ANN example
(examples/APRIL-ANN/common.lua:106-109).  The canonical hash is FNV-1a
32-bit, here in two forms with identical outputs:

  * ``fnv1a32``            -- pure Python over bytes (host general path)
  * ``fnv1a32_np``         -- vectorized numpy over a [N, W] uint8 matrix

The JAX package's third, traceable form (``fnv1a32_jnp``) has no caller
on the port's paths and is not ported (ROADMAP A.4).

All arithmetic is modulo 2**32 (the reference relies on bit32 semantics,
tuple.lua:121-140 uses a Jenkins-style variant for interning).
"""

from __future__ import annotations

from typing import Any

import numpy as np

FNV_OFFSET = np.uint32(2166136261)
FNV_PRIME = np.uint32(16777619)


def fnv1a32(data: bytes) -> int:
    """FNV-1a over a byte string; returns uint32 as Python int."""
    h = 2166136261
    for b in data:
        h ^= b
        h = (h * 16777619) & 0xFFFFFFFF
    return h


def fnv1a32_np(tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized FNV-1a over rows of a ``[N, W] uint8`` matrix.

    ``lengths[i]`` gives the live byte count of row *i*; padding bytes are
    ignored (matching ``fnv1a32(row[:length])``).
    """
    n, w = tokens.shape
    h = np.full((n,), FNV_OFFSET, dtype=np.uint32)
    prime = FNV_PRIME
    col = np.arange(w)
    with np.errstate(over="ignore"):
        for j in range(w):
            live = col[j] < lengths
            hj = (h ^ tokens[:, j].astype(np.uint32)) * prime
            h = np.where(live, hj, h)
    return h


def key_bytes(key: Any) -> bytes:
    """Canonical byte encoding of an arbitrary record key for hashing."""
    if isinstance(key, bytes):
        return key
    if isinstance(key, str):
        return key.encode("utf-8")
    return repr(key).encode("utf-8")


def default_partitioner(key: Any, num_partitions: int) -> int:
    """Framework-default partition fn (reference requires the user to supply
    one, e.g. partitionfn.lua:2-15; we default to FNV-1a mod P)."""
    return fnv1a32(key_bytes(key)) % num_partitions


def byte_sum_hash(key: Any, num_partitions: int) -> int:
    """APRIL-ANN's partitioner: sum of bytes mod P (common.lua:106-109)."""
    return sum(key_bytes(key)) % num_partitions
