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

Over a process group (``Partitions(n, device, group=G)``) each rank
holds only its own ``P_local`` source partitions: it builds ``[P_local,
P, C]`` for them, packs every row's lanes into one byte row, and sends
each destination rank its slab with one ``all_to_all_single`` (equal
splits: the capacity is fixed); the ``[P_local, P]`` count rows are
all-gathered, so the traffic matrix, the overflow and the per-source
maxima are the global ones on every rank.  Gloo moves CPU tensors, so
on the card the send and receive slabs are staged through pinned host
memory; the kernels stay on the card.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

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
    # Over a process group the first four hold this rank's P_local
    # destination partitions; overflow, max_count and counts are global.


def _byte_rows(t: torch.Tensor) -> torch.Tensor:
    """``[a, b, ...]`` as ``[a, b, bytes]`` uint8: each row's lanes as
    raw bytes (a view where the layout allows)."""
    t = t.reshape(t.shape[0], t.shape[1], -1).contiguous()
    return t.view(torch.uint8)


def _from_byte_rows(rows: torch.Tensor, like: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """Split ``[a, b, bytes]`` uint8 back into tensors shaped like each of
    *like* past their first two axes, with their dtypes."""
    out, at = [], 0
    for t in like:
        tail = tuple(t.shape[2:])
        width = t.element_size() * math.prod(tail)
        part = rows[..., at:at + width].contiguous().view(t.dtype)
        out.append(part.reshape(tuple(rows.shape[:2]) + tail))
        at += width
    return out


def _host_stage(t: torch.Tensor) -> torch.Tensor:
    """*t* on the CPU for gloo: itself there, else a pinned host copy."""
    if t.device.type == "cpu":
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_gather_rows(tensors: Sequence[torch.Tensor], group
                    ) -> List[torch.Tensor]:
    """Each of *tensors* (``[a, b, ...]``, the same ``b`` across ranks)
    concatenated over the group's ranks along axis 0, on the CPU: one
    ``all_gather`` of their packed byte rows."""
    import torch.distributed as dist

    rows = _host_stage(torch.cat([_byte_rows(t) for t in tensors], dim=2))
    parts = [torch.empty_like(rows)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, rows, group=group)
    return _from_byte_rows(torch.cat(parts), tensors)


def _exchange_group(buf: torch.Tensor, group) -> torch.Tensor:
    """``[P_local(src), P, C, bytes]`` send slabs -> ``[P_local(dst),
    P * C, bytes]`` received rows, sources in global order, through one
    ``all_to_all_single``."""
    import torch.distributed as dist

    W = dist.get_world_size(group)
    PL, P, C, B = buf.shape
    send = _host_stage(buf.transpose(0, 1))     # [P(dst), PL(src), C, B]
    recv = torch.empty_like(send)               # [W(src rank), PL, PL, C, B]
    dist.all_to_all_single(recv, send, group=group)
    recv = recv.reshape(W, PL, PL, C, B).transpose(0, 1)
    return recv.reshape(PL, P * C, B).to(buf.device)


def partition_exchange(keys: torch.Tensor, values: torch.Tensor,
                       payload: torch.Tensor, valid: torch.Tensor,
                       capacity: int, carry: Optional[Tuple] = None,
                       pmap: Optional[torch.Tensor] = None,
                       impl: str = "lax", group=None) -> Exchanged:
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
    give the same bits in every field.

    With *group* the leading axis holds this rank's ``P_local`` sources
    of ``P = P_local * world size`` in all, and the rows cross the group
    (module docstring)."""
    if impl not in ("lax", "radix"):
        raise ValueError(f"exchange impl must be 'lax' or 'radix', "
                         f"got {impl!r}")
    PL, n = valid.shape
    P = PL
    if group is not None:
        import torch.distributed as dist

        P = PL * dist.get_world_size(group)
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

    keep = (dest < P) & (rank < capacity)
    src = torch.arange(PL, device=dev)[:, None].expand(PL, n)[keep]
    dst = dest[keep]
    slot = rank[keep].to(torch.int64)

    if group is not None:
        # the global [P, P] count rows on every rank; the rows themselves
        # cross the group packed as bytes, one collective for all lanes
        (counts,) = all_gather_rows([counts[:, :, None]], group)
        counts = counts[..., 0].to(dev)
        rows = torch.cat([_byte_rows(t) for t in
                          (keys, values, payload, valid)], dim=2)
        buf = torch.zeros((PL, P, capacity, rows.shape[2]),
                          dtype=torch.uint8, device=dev)
        buf[src, dst, slot] = rows[keep]
        out_keys, out_vals, out_pay, out_valid = _from_byte_rows(
            _exchange_group(buf, group), (keys, values, payload, valid))
    else:
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
    overflow = (counts - capacity).clamp(min=0).sum(
        dim=1, dtype=torch.int32)
    if carry is not None:
        ck, cv, cp, cvalid = carry
        out_keys = torch.cat([ck, out_keys], dim=1)
        out_vals = torch.cat([cv, out_vals], dim=1)
        out_pay = torch.cat([cp, out_pay], dim=1)
        out_valid = torch.cat([cvalid, out_valid], dim=1)
    return Exchanged(keys=out_keys, values=out_vals, payload=out_pay,
                     valid=out_valid, overflow=overflow,
                     max_count=counts.max(dim=1).values, counts=counts)
