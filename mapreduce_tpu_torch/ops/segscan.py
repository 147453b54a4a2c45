"""Sorted-run reduction for large record batches (port of ``ops/segscan.py``).

The aggregation core of the engine: one stable sort groups equal 64-bit
keys into runs, a segmented reduce combines each run, and the run ends
are compacted by ``searchsorted`` over the running count of run ends.

Key lanes are uint32 values carried as int32 bit patterns; the sentinel
pair ``(0xFFFFFFFF, 0xFFFFFFFF)`` (int32 ``-1, -1``) marks invalid rows,
which sort last.  A real key equal to the sentinel pair is remapped to
``(0, 0)`` first, as the JAX package does.

The sort is ``torch.sort`` (``sort_impl`` 'variadic' or 'argsort') or
the port's radix kernels ('radix', :mod:`.radix_sort`).
The segmented reduce follows :mod:`.kernel_compat`'s one rule: sorted
lanes on a CUDA device launch the hand-written kernel
(``csrc/segreduce.cu``, the port of ``_segreduce_kernel``); lanes on the
CPU run :func:`_segment_reduce_plain`.  The kernel takes one op per value
lane from {sum, min, max} over int32, or counts run lengths
(``unit_values``); a Python callable monoid runs only on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Sequence, Tuple, Union

import torch

from . import kernel_compat as kc
from .radix_sort import radix_sort_pairs

#: sentinel key lane value marking invalid rows, as an int32 bit pattern
SENTINEL = -1

_OP_CODES = {"sum": 0, "min": 1, "max": 2}
_INT32_MIN = -(2 ** 31)

ReduceOp = Union[str, Tuple[str, ...], Callable]


class SortedUnique(NamedTuple):
    keys: torch.Tensor      # [capacity, 2] int32 bits, ascending as uint32
    values: torch.Tensor    # [capacity] or [capacity, D] run reductions
    payload: torch.Tensor   # [capacity, Q] representative payload (run end)
    valid: torch.Tensor     # [capacity] bool
    n_unique: torch.Tensor  # [] int32 (may exceed capacity: overflow)


def _lane_ops(op: ReduceOp, n_lanes: int):
    """Per-lane op names for a string or tuple *op*; None for a callable."""
    if callable(op):
        return None
    ops = (op,) * n_lanes if isinstance(op, str) else tuple(op)
    if len(ops) != n_lanes:
        raise ValueError(f"reduce op {op!r} names {len(ops)} lanes, the "
                         f"values have {n_lanes}")
    for o in ops:
        if o not in _OP_CODES:
            raise ValueError(f"unknown reduce op {o!r}")
    return ops


def _run_flags(k1s: torch.Tensor, k2s: torch.Tensor):
    """``(valid, is_start, is_end)`` of sorted key lanes: a valid row
    heads a run when it is row 0 or its key differs from the previous
    row's, and ends one when it is the last row, the next row is invalid
    or the next key differs."""
    valid = ~((k1s == SENTINEL) & (k2s == SENTINEL))
    differs = (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])
    yes = torch.ones(1, dtype=torch.bool, device=k1s.device)
    is_start = valid & torch.cat([yes, differs])
    is_end = valid & torch.cat([differs | ~valid[1:], yes])
    return valid, is_start, is_end


def _segmented_ladder(op: Callable, starts: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of *v* ([N] or [N, D]) under an arbitrary
    associative callable *op*, restarting at each set bit of *starts*."""
    N = starts.shape[0]
    f = starts
    d = 1
    while d < N:
        f_l = torch.cat([torch.ones(d, dtype=torch.bool, device=f.device),
                         f[:-d]])
        v_l = torch.cat([v[:d], v[:-d]], dim=0)
        take = f.reshape((-1,) + (1,) * (v.dim() - 1))
        v = torch.where(take, v, op(v_l, v))
        f = f | f_l
        d *= 2
    return v


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound."""
    return (((x & kc.MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _segment_lane(op: str, seg: torch.Tensor, v: torch.Tensor):
    """One value lane's inclusive segmented scan (sequential semantics,
    int32 wraparound for sum).  *seg* is the run index of each row."""
    if op == "sum":
        cs = torch.cumsum(v.to(torch.int64), dim=0)
        # subtract the cumsum before each run's head
        head_idx = torch.searchsorted(seg, seg, side="left")
        before = torch.where(head_idx > 0, cs[(head_idx - 1).clamp(min=0)],
                             0)
        return _wrap_i32(cs - before)
    # min/max: a cummax over (run index, value) packed into one int64;
    # runs are ascending, so a row never sees an earlier run's value
    off = v.to(torch.int64) - _INT32_MIN
    if op == "min":
        off = (2 ** 32 - 1) - off
    packed = seg.to(torch.int64) * (2 ** 32) + off
    low = torch.cummax(packed, dim=0).values & kc.MASK32
    if op == "min":
        low = (2 ** 32 - 1) - low
    return (low + _INT32_MIN).to(torch.int32)


def _segment_reduce_plain(k1s: torch.Tensor, k2s: torch.Tensor,
                          vals_s: Sequence[torch.Tensor], op: ReduceOp,
                          unit_values: bool):
    """The plain PyTorch version of the kernel: ``(reduced_lanes,
    end_csum)`` over sorted lanes, with the sequential scan's values at
    every run end and the run-end count everywhere."""
    N = k1s.shape[0]
    _, is_start, is_end = _run_flags(k1s, k2s)
    end_csum = torch.cumsum(is_end.to(torch.int32), dim=0,
                            dtype=torch.int32)
    idx = torch.arange(N, dtype=torch.int32, device=k1s.device)
    if unit_values:
        run_start = torch.cummax(torch.where(is_start, idx, -1),
                                 dim=0).values
        return [idx - run_start + 1], end_csum
    ops = _lane_ops(op, len(vals_s))
    if ops is None:
        stacked = (torch.stack(list(vals_s), dim=-1) if len(vals_s) > 1
                   else vals_s[0])
        scanned = _segmented_ladder(op, is_start, stacked)
        return ([scanned[..., i] for i in range(len(vals_s))]
                if len(vals_s) > 1 else [scanned]), end_csum
    # rows before the first head (only invalid rows) join run 0
    seg = torch.cumsum(is_start.to(torch.int64), dim=0)
    return [_segment_lane(o, seg, v) for o, v in zip(ops, vals_s)], end_csum


_SIGNATURES = {
    "mr_segreduce_scratch_bytes": (ctypes.c_longlong,
                                   [ctypes.c_int, ctypes.c_int]),
    "mr_segreduce": (ctypes.c_int,
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p] * 4),
}


def _segment_reduce_cuda(k1s: torch.Tensor, k2s: torch.Tensor,
                         vals_s: Sequence[torch.Tensor], op: ReduceOp,
                         unit_values: bool):
    """Launch ``csrc/segreduce.cu`` (the port of ``_segreduce_kernel``)."""
    dev = k1s.device
    N = k1s.shape[0]
    kc.require(k1s, "segreduce", "k1", torch.int32, dev)
    kc.require(k2s, "segreduce", "k2", torch.int32, dev)
    if unit_values:
        D, codes, vals = 1, [0, 0, 0], None
    else:
        ops = _lane_ops(op, len(vals_s))
        if ops is None:
            raise NotImplementedError(
                "segreduce: a Python callable reduce_op has no CUDA kernel; "
                "pass 'sum'/'min'/'max' or a tuple of them per lane")
        D = len(ops)
        if not 1 <= D <= 3:
            raise ValueError(f"segreduce kernel takes 1-3 value lanes, "
                             f"got {D}")
        for v in vals_s:
            if v.dtype != torch.int32:
                raise ValueError(f"segreduce kernel takes int32 values, "
                                 f"got {v.dtype}")
        vals = torch.stack(list(vals_s), dim=-1).contiguous()
        codes = [_OP_CODES[o] for o in ops] + [0] * (3 - D)
    reduced = torch.empty((N, D), dtype=torch.int32, device=dev)
    end_csum = torch.empty(N, dtype=torch.int32, device=dev)
    lib = kc.library("segreduce", _SIGNATURES)
    scratch = torch.empty(lib.mr_segreduce_scratch_bytes(N, D),
                          dtype=torch.uint8, device=dev)
    err = lib.mr_segreduce(
        kc.ptr(k1s), kc.ptr(k2s), kc.ptr(vals) if vals is not None else None,
        N, D, int(unit_values), *codes, kc.ptr(reduced), kc.ptr(end_csum),
        kc.ptr(scratch), kc.stream(dev))
    kc.check("segreduce", err)
    kc.count_launch("segreduce")
    return [reduced[:, i] for i in range(D)], end_csum


def segment_reduce(k1s: torch.Tensor, k2s: torch.Tensor,
                   vals_s: Sequence[torch.Tensor], op: ReduceOp,
                   unit_values: bool):
    """``(reduced_lanes, end_csum)`` of sorted lanes — the kernel on CUDA,
    the plain version on the CPU.  The result that counts is the reduced
    lanes at run-end rows and ``end_csum`` everywhere."""
    if kc.use_kernel(k1s, "segreduce"):
        return _segment_reduce_cuda(k1s, k2s, vals_s, op, unit_values)
    return _segment_reduce_plain(k1s, k2s, vals_s, op, unit_values)


def _sort_perm(k1: torch.Tensor, k2: torch.Tensor,
               sort_impl: str) -> torch.Tensor:
    """The stable permutation that sorts rows by ``(k1, k2)`` as uint32
    — exactly the permutation of ``lax.sort((k1, k2, iota),
    num_keys=2)``."""
    if sort_impl == "argsort":
        # two stable 1-key sorts: by k2, then stably by k1
        p1 = torch.sort(kc.u32(k2), stable=True).indices
        p2 = torch.sort(kc.u32(k1)[p1], stable=True).indices
        return p1[p2]
    # one stable sort of the packed 64-bit key (k1 biased into int64's
    # signed range, so int64 order is (k1, k2) order as uint32)
    packed = (kc.u32(k1) - 2 ** 31) * (2 ** 32) + kc.u32(k2)
    return torch.sort(packed, stable=True).indices


def sorted_unique_reduce(keys: torch.Tensor, values, payload: torch.Tensor,
                         valid: torch.Tensor, capacity: int, op: ReduceOp,
                         unit_values: bool = False,
                         sort_impl: str = "variadic") -> SortedUnique:
    """Group-by-key reduction: one stable sort by 64-bit key, the
    segmented reduce, and searchsorted compaction of the run ends.

    ``keys`` [N, 2] int32 bits, ``values`` [N] or [N, D] (ignored with
    ``unit_values``, where each key's result is its occurrence count),
    ``payload`` [N, Q] int32, ``valid`` [N] bool.  ``op`` is "sum" /
    "min" / "max", a tuple of those (one per value lane), or an
    associative callable (CPU only).

    ``sort_impl`` is ``"variadic"`` (one sort of the packed key),
    ``"argsort"`` (two stable 1-key sorts) or ``"radix"`` (the radix
    kernels, :func:`.radix_sort.radix_sort_pairs`); all three give
    ``lax.sort``'s permutation.  The segmented reduce (and the radix
    passes) are chosen by the keys' device: the kernels on CUDA, the
    plain versions on the CPU."""
    if sort_impl not in ("variadic", "argsort", "radix"):
        raise ValueError(f"sort_impl must be 'variadic', 'argsort' or "
                         f"'radix', got {sort_impl!r}")
    N = keys.shape[0]
    dev = keys.device
    # remap a real sentinel pair, then mark invalid rows with it
    is_sent = (keys[:, 0] == SENTINEL) & (keys[:, 1] == SENTINEL)
    k1 = torch.where(is_sent, 0, keys[:, 0])
    k2 = torch.where(is_sent, 0, keys[:, 1])
    k1 = torch.where(valid, k1, SENTINEL)
    k2 = torch.where(valid, k2, SENTINEL)

    if sort_impl == "radix":
        # the radix kernels (ops/radix_sort); values and payload ride the
        # permutation, as in the JAX package
        k1s, k2s, perm = radix_sort_pairs(k1, k2)
        perm = perm.to(torch.int64)
    else:
        perm = _sort_perm(k1, k2, sort_impl)
        k1s, k2s = k1[perm], k2[perm]
    if unit_values:
        vals_s = []
    else:
        v2 = values if values.dim() == 2 else values[:, None]
        v2s = v2[perm]
        vals_s = [v2s[:, i] for i in range(v2.shape[1])]
    pay_s = payload[perm]

    reduced, end_csum = segment_reduce(k1s, k2s, vals_s, op, unit_values)

    # compact run ends by gather: the j-th run end is the first row whose
    # end count reaches j
    n_unique = end_csum[-1]
    targets = torch.arange(1, capacity + 1, dtype=torch.int32, device=dev)
    out_idx = torch.searchsorted(end_csum, targets, side="left")
    out_idx = out_idx.clamp(0, N - 1)
    out_valid = targets <= n_unique
    out_keys = torch.stack([k1s[out_idx], k2s[out_idx]], dim=-1)
    out_vals = [r[out_idx] for r in reduced]
    out_vals = (torch.stack(out_vals, dim=-1) if len(out_vals) > 1
                else out_vals[0])
    out_pay = pay_s[out_idx]
    vmask = out_valid.reshape((-1,) + (1,) * (out_vals.dim() - 1))
    out_vals = torch.where(vmask, out_vals, 0)
    out_keys = torch.where(out_valid[:, None], out_keys, 0)
    out_pay = torch.where(out_valid[:, None], out_pay, 0)
    return SortedUnique(out_keys, out_vals, out_pay, out_valid,
                        n_unique.to(torch.int32))
