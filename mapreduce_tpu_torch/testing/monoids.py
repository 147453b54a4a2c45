"""Callable reduce monoids on torch tensors that the tests and
``chip_smoke.py`` hold the monoid kernel to (``ops/monoid.py``,
``csrc/segreduce.cuh``).

Each is associative in int32 arithmetic with wraparound, so any
association order gives the sequential fold's bits:

* :func:`span` — ``[sum, min, max]``: the span and collision-verify
  monoid (``examples/wordspan``, ``DeviceWordCount(verify_collisions=
  True)``);
* :func:`sum_min_or` — ``[sum, min, bitwise_or]``: the JAX package's
  custom engine monoid (``tests/test_fused_engine.py:45-50``);
* :func:`max_add` — ``[max, add]`` (``tests/test_segscan.py:51-53``);
* :func:`xor` — lane-wise ``bitwise_xor``, one lane or any;
* :func:`argmin_count` — 5 lanes ``[a0*b0, a1&b1, a2^b2, min(a3, b3),
  count of that min]``: lane 4 reads lane 3 through ``where``, which no
  code tuple expresses;
* :func:`affine` — 2 lanes, the composition of affine maps ``(m, c) .
  (m', c') = (m*m', c*m' + c')``: associative, not commutative;
* :func:`bits` — 8 lanes that reach the node kinds the others leave
  out: shifts, int and bool constants, unary ``-``, ``~`` on int32 and
  on bool, ``-``, every comparison, bool ``& | ^`` and ``where`` with a
  constant branch.

:data:`MONOIDS` lists them with their lane counts, and :data:`CODES`
the per-lane op tuple of those that have one.  :data:`NODE_CASES` are
callables, not all associative, that reach the lowering's other forms
(lane-wise ops, methods, whole values read as lanes): on runs of at
most two rows, where a run's result is one ``op(x, y)``, the kernel
must give their bits too.
"""

from __future__ import annotations

import torch


def span(a, b):
    return torch.stack([a[..., 0] + b[..., 0],
                        torch.minimum(a[..., 1], b[..., 1]),
                        torch.maximum(a[..., 2], b[..., 2])], dim=-1)


def sum_min_or(a, b):
    return torch.stack([a[..., 0] + b[..., 0],
                        torch.minimum(a[..., 1], b[..., 1]),
                        torch.bitwise_or(a[..., 2], b[..., 2])], dim=-1)


def max_add(a, b):
    return torch.stack([torch.maximum(a[..., 0], b[..., 0]),
                        a[..., 1] + b[..., 1]], dim=-1)


xor = torch.bitwise_xor


def argmin_count(a, b):
    a3, b3 = a[..., 3], b[..., 3]
    count = torch.where(a3 < b3, a[..., 4],
                        torch.where(b3 < a3, b[..., 4],
                                    a[..., 4] + b[..., 4]))
    return torch.stack([a[..., 0] * b[..., 0], a[..., 1] & b[..., 1],
                        a[..., 2] ^ b[..., 2], torch.minimum(a3, b3),
                        count], dim=-1)


def affine(a, b):
    return torch.stack([a[..., 0] * b[..., 0],
                        a[..., 1] * b[..., 0] + b[..., 1]], dim=-1)


def bits(a, b):
    """Each lane an associative op written through other nodes: 0
    ``max(x >> 4, y >> 4) << 4``, 1 ``~(~x & ~y) & 0x7FFFFFF0`` (an or),
    2 ``1`` if either is non-zero else ``0``, 3 ``-1`` if one of the two
    is negative (the parity of the negatives), 4 ``-8`` if either is
    negative, 5 a min through ``<=``, 6 a sum through unary ``-`` and
    ``-``, 7 a max through ``==`` and ``>``.  Lanes 2-4 map every value
    onto one of two, and each keeps its meaning when folded again."""
    x = [a[..., i] for i in range(8)]
    y = [b[..., i] for i in range(8)]
    return torch.stack([
        torch.maximum(x[0] >> 4, y[0] >> 4) << 4,
        ~(~x[1] & ~y[1]) & 0x7FFFFFF0,
        torch.where((x[2] != 0) | (y[2] != 0), 1, x[2]),
        torch.where((x[3] < 0) ^ (y[3] < 0), -1, x[3] & 0),
        torch.where(~((x[4] >= 0) & (y[4] >= 0)), -8, x[4] & 0),
        torch.where(x[5] <= y[5], x[5], y[5]),
        -((-x[6]) - y[6]),
        torch.where(x[7] == y[7], x[7], torch.where(x[7] > y[7], x[7],
                                                    y[7]))], dim=-1)


#: name -> (monoid, value lanes)
MONOIDS = {"span": (span, 3), "sum_min_or": (sum_min_or, 3),
           "max_add": (max_add, 2), "xor": (xor, 1),
           "argmin_count": (argmin_count, 5), "affine": (affine, 2),
           "bits": (bits, 8)}
#: name -> the same monoid as per-lane op codes, where it has them
CODES = {"span": ("sum", "min", "max"), "max_add": ("max", "sum")}


def shifty(a, b):
    """Whole values added, then read as lanes; shifts, ``~``, unary
    ``-`` and bool ops (not associative)."""
    s = a + b
    keep = (a[..., 0] > 7) & ~(b[..., 1] == -3) | (s[..., 2] <= 0)
    return torch.stack([s[..., 0] << 31, (5 - s[..., 1]) >> 3,
                        torch.where(keep, -a[..., 2], 2 ** 31 - 1),
                        torch.bitwise_not(b[..., 0]) ^ -(2 ** 31)], dim=-1)


#: node forms beyond the named monoids: name -> (op, value lanes)
NODE_CASES = {
    "lane-wise add, 4 lanes": (torch.add, 4),
    "lane-wise lambda, 1 lane": (lambda a, b: a * b - (a & 15), 1),
    "whole values, then lanes": (shifty, 4),
    "the right operand": (lambda a, b: b, 2),
    "methods": (lambda a, b: a.maximum(b).bitwise_xor(a.sub(b)), 3)}
