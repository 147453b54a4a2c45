"""The partition axis (port of ``parallel/mesh.py``'s ``data`` axis) and
the link classes the exchange's traffic crosses.

The JAX engine runs one program per device over a mesh's ``data`` axis:
device ``p`` maps its share of the chunks and owns reduce partition
``p``.  Here :class:`Partitions` stands for that axis: ``n`` logical
partitions held as a leading axis of tensors on ONE device, so the
exchange between them is a transpose.  Any ``n`` runs on one H100: 1
(the exchange is a copy) or 8, the JAX package's 8-way ``data`` axis and
the CPU tests' mesh size, where the 8 x 8 traffic matrix is real.

A mesh that spans processes (the JAX package's ``jax.distributed``
multi-controller mesh) is ``Partitions(n, device, group=G)`` over a
``torch.distributed`` process group the caller initialised: rank ``r``
of ``W`` owns partitions ``[r*n/W, (r+1)*n/W)`` on its own *device*, and
the exchange's bytes between ranks go through the group (see
:func:`..shuffle.partition_exchange`).  Only gloo groups are taken:
gloo moves the bytes through host memory, which lets two ranks share
one card; NCCL cannot put two ranks on one device, and NCCL across
cards needs a second card.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import torch

from ..ops.kernel_compat import resolve_device


def group_shape(group, n: int, what: str) -> Tuple[int, int]:
    """``(world, rank)`` of this process in *group* (``(1, 0)`` for
    None), whose world size must divide the count *n*; *what* names the
    caller in the errors.  Only gloo groups are supported: another
    backend raises ``NotImplementedError`` (NCCL cannot put two ranks on
    one card, and NCCL across cards waits for a second card)."""
    if group is None:
        return 1, 0
    import torch.distributed as dist

    backend = str(dist.get_backend(group))
    if backend != "gloo":
        raise NotImplementedError(
            f"{what} over a {backend!r} process group: only gloo groups "
            "are supported (NCCL cannot put two ranks on one card, and "
            "NCCL across cards waits for a second card)")
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % world:
        raise ValueError(
            f"{what} over a process group of world size {world}: the "
            f"world size must divide {n}")
    return world, rank


class Partitions:
    """``n`` reduce partitions on *device* (``None`` means ``"cuda"``;
    raises ``RuntimeError`` if CUDA is absent).

    With *group* (a ``torch.distributed`` process group of world size
    ``W``, gloo only), ``n`` stays the GLOBAL partition count and this
    process owns the ``n_local = n / W`` partitions from ``lo = rank *
    n_local``; ``W`` must divide ``n``.  A group of another backend
    raises ``NotImplementedError``."""

    def __init__(self, n: int = 1, device=None, group=None) -> None:
        if n < 1:
            raise ValueError(f"need at least one partition, got {n}")
        self.n = int(n)
        self.device: torch.device = resolve_device(device)
        self.group = group
        self.world, self.rank = group_shape(group, self.n,
                                            f"Partitions(n={self.n})")
        #: the partitions this process owns: [lo, lo + n_local)
        self.n_local = self.n // self.world
        self.lo = self.rank * self.n_local


# -- topology model: link classes + per-class peak bandwidth ------------------
#
# The comms observability layer (obs/comms) rolls the exchange traffic
# matrix up by the KIND of wire each (src, dst) partition pair talks
# over (the JAX package's self / ici / dcn / host, for this card):
#
#   * ``self``   — both partitions on one CUDA device: the exchange is a
#     transpose in HBM, so every pair, diagonal or not, is an HBM copy;
#     on the CPU only the diagonal (src is dst);
#   * ``nvlink`` — partitions on two CUDA devices that can reach each
#     other's memory (``torch.cuda.can_device_access_peer``);
#   * ``pcie``   — two CUDA devices without peer access: the bytes go
#     over PCIe through the host;
#   * ``host``   — CPU partitions (the tests' plain runs): bytes move
#     through host memory, the JAX CPU mesh's class off the diagonal;
#     and any pair whose partitions two processes of a gloo group own
#     (their bytes are staged through host memory for gloo).
#
# No configuration puts partitions on two cards yet, so the nvlink and
# pcie classes are untested.  Like obs/profile's FLOPs peaks, the
# bandwidths are datasheet denominators for a roofline ratio, not
# measurements: the table says so via ``peak_source`` and every figure
# derived from it is labelled ``source="analytic"``.

#: link classes, in locality order
LINK_CLASSES: Tuple[str, ...] = ("self", "nvlink", "pcie", "host")

#: default per-link-class peak bandwidth (bytes/s per partition pair),
#: H100 SXM datasheet figures
_DEFAULT_LINK_PEAKS: Dict[str, float] = {
    "self": 3.35e12,  # HBM3 bandwidth (H100 SXM datasheet)
    "nvlink": 450e9,  # NVLink 4: 900 GB/s both ways -> 450 GB/s a way
    "pcie": 64e9,     # PCIe Gen5 x16, one direction
    "host": 10e9,     # host-memory staging (the JAX table's figure)
}

#: env override names, checked by :func:`link_peaks` (the JAX names)
_LINK_PEAK_ENV = {
    cls: f"MAPREDUCE_TPU_PEAK_{cls.upper()}_BYTES_PER_S"
    for cls in LINK_CLASSES}


class PartitionDevice(NamedTuple):
    """One partition, the torch device that holds it and the rank of the
    process that owns it (0 without a process group)."""

    partition: int
    device: Any
    process: int = 0


def partition_devices(n: int, device: Any,
                      world: int = 1) -> List[PartitionDevice]:
    """*n* partitions on *device*, in partition order, split evenly over
    *world* processes (each process's partitions on its own *device*)."""
    dev = torch.device(device)
    per = int(n) // max(1, int(world))
    return [PartitionDevice(p, dev, p // per) for p in range(int(n))]


def link_peaks() -> Dict[str, Any]:
    """The per-link-class peak-bandwidth table (bytes/s), each class
    individually overridable via ``MAPREDUCE_TPU_PEAK_<CLASS>_BYTES_PER_S``;
    ``peak_source`` records which figures came from the environment so
    the numbers stay honest about their provenance."""
    out: Dict[str, Any] = {}
    overridden: List[str] = []
    for cls in LINK_CLASSES:
        env = os.environ.get(_LINK_PEAK_ENV[cls])
        if env:
            out[cls] = float(env)
            overridden.append(cls)
        else:
            out[cls] = _DEFAULT_LINK_PEAKS[cls]
    out["peak_source"] = ("env:" + ",".join(overridden) if overridden
                          else "datasheet")
    return out


def link_class(src: PartitionDevice, dst: PartitionDevice) -> str:
    """Classify the wire between two partitions (``(partition, torch
    device)`` pairs) as ``self`` / ``nvlink`` / ``pcie`` / ``host``;
    partitions of two processes of a gloo group talk over ``host``."""
    if src.process != dst.process:
        return "host"  # gloo stages the bytes through host memory
    s_dev, d_dev = torch.device(src.device), torch.device(dst.device)
    if s_dev.type == "cuda" and d_dev.type == "cuda":
        s_idx = 0 if s_dev.index is None else s_dev.index
        d_idx = 0 if d_dev.index is None else d_dev.index
        if s_idx == d_idx:
            return "self"  # one card: the exchange is a transpose in HBM
        return ("nvlink" if torch.cuda.can_device_access_peer(s_idx, d_idx)
                else "pcie")
    if src.partition == dst.partition and s_dev == d_dev:
        return "self"
    return "host"  # no accelerator interconnect: host-memory copies


def device_link_matrix(devices: Sequence[PartitionDevice],
                       ) -> List[List[str]]:
    """``[n, n]`` link-class names for every (src, dst) partition pair,
    in the partition order the exchange traffic matrix uses."""
    return [[link_class(s, d) for d in devices] for s in devices]
