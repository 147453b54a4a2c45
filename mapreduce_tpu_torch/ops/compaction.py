"""Tile-local record compaction (port of ``ops/compaction.py``).

Dense record extraction from per-position masks: positions split into
tiles of width ``tile``; a tile's masked rows go, in order, to slots
``[t*K, t*K + count_t)`` of the output, and rows past ``K`` per tile are
dropped but counted (``overflow``) so the engine can retry with a larger
``K``.  The JAX package does this as a one-hot bf16 matmul (the TPU's
systolic array has no fast scatter); here it is a per-tile ``cumsum``
rank and one indexed write, which gives the same slots bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class TileCompacted(NamedTuple):
    arrays: Tuple[torch.Tensor, ...]  # each [n_tiles * K], input dtype
    valid: torch.Tensor               # [n_tiles * K] bool
    overflow: torch.Tensor            # [] int32 — rows dropped for K


def tile_compact(mask: torch.Tensor, tile: int, capacity: int,
                 *arrays: torch.Tensor) -> TileCompacted:
    """Compact the rows of 1-D *arrays* where *mask* is set, tile-locally.

    ``mask``: [L] bool, ``arrays``: [L] each, ``L % tile == 0``.  Output
    arrays are [L // tile * capacity] (zeros in unused slots) with a
    matching valid mask; rows of tile t occupy slots
    ``[t*capacity, t*capacity + count_t)``."""
    L = mask.shape[0]
    if L % tile != 0:
        raise ValueError(f"L={L} not a multiple of tile={tile}")
    T, K = L // tile, capacity
    m2 = mask.reshape(T, tile)
    rank = torch.cumsum(m2, dim=1, dtype=torch.int32) - 1
    counts = rank[:, -1] + 1
    overflow = (counts - K).clamp(min=0).sum().to(torch.int32)
    keep = (m2 & (rank < K)).reshape(-1)
    tiles = torch.arange(T, dtype=torch.int64, device=mask.device)
    slot = (tiles[:, None] * K + rank).reshape(-1)[keep]
    outs = []
    for a in arrays:
        out = torch.zeros(T * K, dtype=a.dtype, device=a.device)
        out[slot] = a[keep]
        outs.append(out)
    valid = (torch.arange(K, device=mask.device)[None, :]
             < counts.clamp(max=K)[:, None]).reshape(T * K)
    return TileCompacted(tuple(outs), valid, overflow)
