"""The partition axis (port of ``parallel/mesh.py``'s ``data`` axis).

The JAX engine runs one program per device over a mesh's ``data`` axis:
device ``p`` maps its share of the chunks and owns reduce partition
``p``.  Here :class:`Partitions` stands for that axis: ``n`` logical
partitions held as a leading axis of tensors on ONE device, so the
exchange between them is a transpose.  Any ``n`` runs on one H100: 1
(the exchange is a copy) or 8, the JAX package's 8-way ``data`` axis and
the CPU tests' mesh size, where the 8 x 8 traffic matrix is real.
"""

from __future__ import annotations

import torch

from ..ops.kernel_compat import resolve_device


class Partitions:
    """``n`` reduce partitions on *device* (``None`` means ``"cuda"``;
    raises ``RuntimeError`` if CUDA is absent)."""

    def __init__(self, n: int = 1, device=None) -> None:
        if n < 1:
            raise ValueError(f"need at least one partition, got {n}")
        self.n = int(n)
        self.device: torch.device = resolve_device(device)
