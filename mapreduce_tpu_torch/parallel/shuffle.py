"""The shuffle: hash-partition + capacity-bounded exchange (port of
``parallel/shuffle.py``).

A record's partition is ``key_hi mod P``, or ``pmap[key_hi mod B]``
under a partition map.  Every source partition packs its records into a
``[P_dst, C, ...]`` send buffer (rank within the destination, rows past
``C`` dropped and counted) and the exchange moves slot ``d`` of every
source's buffer to partition ``d``.  With the ``P`` partitions held as a
leading axis on one device (:class:`..mesh.Partitions`) the JAX
package's ``all_to_all`` is the transpose ``[P_src, P_dst, C] -> [P_dst,
P_src * C]``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.kernel_compat import u32
from ..ops.radix_sort import radix_partition_plan


class Exchanged(NamedTuple):
    keys: torch.Tensor       # [P, (A+)P*C, 2] int32 bits — received rows
    values: torch.Tensor     # [P, (A+)P*C, ...]
    payload: torch.Tensor    # [P, (A+)P*C, Q] int32
    valid: torch.Tensor      # [P, (A+)P*C] bool
    overflow: torch.Tensor   # [P] int32 — rows each source dropped
    max_count: torch.Tensor  # [P] int32 — each source's largest
    #                          per-destination row count before capping
    counts: torch.Tensor     # [P, P] int32 — valid rows each source
    #                          routed to each destination (the src x dst
    #                          traffic matrix of this exchange)


def partition_exchange(keys: torch.Tensor, values: torch.Tensor,
                       payload: torch.Tensor, valid: torch.Tensor,
                       capacity: int, carry: Optional[Tuple] = None,
                       pmap: Optional[torch.Tensor] = None,
                       impl: str = "lax") -> Exchanged:
    """Exchange records so partition ``p`` ends up with every record
    whose ``key_hi % P == p``.  Inputs carry the source partition as a
    leading axis: ``keys [P, n, 2]``, ``values [P, n, ...]``, ``payload
    [P, n, Q]``, ``valid [P, n]``; ``capacity`` bounds rows per
    (source, destination) pair.

    ``carry`` is ``(keys [P, A, 2], values [P, A, ...], payload
    [P, A, Q], valid [P, A])`` of rows already in each partition (the
    running accumulator), prepended to the received rows — before them,
    so a stable sort downstream keeps the fold order ``acc ⊕ wave``.

    ``pmap`` (``[B]`` int32, values in ``[0, P)``) routes bucket
    ``key_hi % B`` to partition ``pmap[bucket]``; the identity table
    ``b % P`` (with ``P | B``) routes as ``key_hi % P`` does.

    ``impl`` is the routing plan: ``"lax"``, a one-hot cumsum over the
    destinations, or ``"radix"``, :func:`..ops.radix_sort.
    radix_partition_plan` (one histogram pass gives the ranks and the
    traffic-matrix row; one launch per kernel for all sources).  Both
    give the same bits in every field."""
    if impl not in ("lax", "radix"):
        raise ValueError(f"exchange impl must be 'lax' or 'radix', "
                         f"got {impl!r}")
    P, n = valid.shape
    dev = valid.device
    if pmap is None:
        dest = u32(keys[..., 0]) % P
    else:
        pmap = torch.as_tensor(pmap, device=dev)
        dest = pmap[u32(keys[..., 0]) % pmap.shape[0]].to(torch.int64)
    dest = torch.where(valid, dest, P)  # invalid -> out of range, dropped

    if impl == "radix":
        rank, counts = radix_partition_plan(dest.to(torch.int32), P)
    else:
        # rank of each row within its destination: #{j < i : dest[j] ==
        # dest[i]}, by a one-hot cumsum over the (small) partition count
        onehot = (dest[..., None] == torch.arange(P, device=dev)).to(
            torch.int32)
        csum = torch.cumsum(onehot, dim=1, dtype=torch.int32)
        rank = torch.gather(csum, 2,
                            dest.clamp(max=P - 1)[..., None])[..., 0] - 1
        counts = onehot.sum(dim=1, dtype=torch.int32)
    overflow = (counts - capacity).clamp(min=0).sum(
        dim=1, dtype=torch.int32)

    keep = (dest < P) & (rank < capacity)
    src = torch.arange(P, device=dev)[:, None].expand(P, n)[keep]
    dst = dest[keep]
    slot = rank[keep].to(torch.int64)

    def exchange(arr):
        buf = torch.zeros((P, P, capacity) + tuple(arr.shape[2:]),
                          dtype=arr.dtype, device=dev)
        buf[src, dst, slot] = arr[keep]
        # slot [d] of source s's buffer goes to partition d
        return buf.transpose(0, 1).reshape(
            (P, P * capacity) + tuple(arr.shape[2:]))

    out_keys = exchange(keys)
    out_vals = exchange(values)
    out_pay = exchange(payload)
    out_valid = exchange(valid)
    if carry is not None:
        ck, cv, cp, cvalid = carry
        out_keys = torch.cat([ck, out_keys], dim=1)
        out_vals = torch.cat([cv, out_vals], dim=1)
        out_pay = torch.cat([cp, out_pay], dim=1)
        out_valid = torch.cat([cvalid, out_valid], dim=1)
    return Exchanged(keys=out_keys, values=out_vals, payload=out_pay,
                     valid=out_valid, overflow=overflow,
                     max_count=counts.max(dim=1).values, counts=counts)
