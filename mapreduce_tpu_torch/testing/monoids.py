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

Typed monoids (float32 lanes, or int32 lanes outside the full-range
draw), each with the domain its rows are drawn from
(:func:`typed_rows`) and a float64 reference of each run
(:func:`run_reference`):

* :func:`fsum_min_max` — float ``[sum, min, max]``, the codes
  ``("sum", "min", "max")`` (:data:`TYPED_CODES`);
* :func:`welford` — ``(count, mean, M2)``: Welford's / Chan's merge of
  counts, means and sums of squared deviations (a row is ``(1, x, 0)``);
* :func:`weighted_mean` — ``(w, mean)`` (a row is ``(w > 0, x)``);
* :func:`logsumexp` — ``(m, s)``, the log-sum-exp ``m + log(s)`` kept
  as a running max and a scaled sum (a row is ``(x, 1)``);
* :func:`modsum` — int32 ``(a + b) % 1_000_003`` over lanes in
  ``[0, 1_000_003)``;
* :func:`cast_sum` — int32 lanes reduced as float32 sums (``a.float() +
  b.float()``: the kernel casts the lanes up front).

:func:`run_reference` also gives each lane's bound against the float64
fold, from ``gamma_n = n u / (1 - n u)`` (``u = 2**-24``) and a few ulp
a combine.

:data:`TYPED_NODE_CASES` reach the remaining nodes (``//``, ``fmod``,
``clamp``, ``abs``, ``sqrt``, float constants, casts) on runs of at
most two rows.
"""

from __future__ import annotations

import numpy as np
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


# -- typed monoids -----------------------------------------------------------------

def fsum_min_max(a, b):
    return torch.stack([a[..., 0] + b[..., 0],
                        torch.minimum(a[..., 1], b[..., 1]),
                        torch.maximum(a[..., 2], b[..., 2])], dim=-1)


def welford(a, b):
    """``(count, mean, M2)`` of two spans merged (Chan et al.)."""
    na, ma, qa = a[..., 0], a[..., 1], a[..., 2]
    nb, mb, qb = b[..., 0], b[..., 1], b[..., 2]
    n = na + nb
    d = mb - ma
    return torch.stack([n, ma + d * (nb / n),
                        qa + qb + d * d * (na * nb / n)], dim=-1)


def weighted_mean(a, b):
    """``(w, mean)``: total weight and weighted mean."""
    w = a[..., 0] + b[..., 0]
    return torch.stack([w, a[..., 1] + (b[..., 1] - a[..., 1])
                        * (b[..., 0] / w)], dim=-1)


def logsumexp(a, b):
    """``(m, s)`` with ``log(sum exp(x)) = m + log(s)``."""
    m = torch.maximum(a[..., 0], b[..., 0])
    return torch.stack([m, a[..., 1] * torch.exp(a[..., 0] - m)
                        + b[..., 1] * torch.exp(b[..., 0] - m)], dim=-1)


#: modsum's modulus: (a + b) stays below 2**31 for lanes in [0, M)
MOD = 1_000_003


def modsum(a, b):
    return (a + b) % MOD


def cast_sum(a, b):
    return a.float() + b.float()


#: name -> (monoid, value lanes, the lanes' dtype as drawn)
TYPED_MONOIDS = {
    "fsum_min_max": (fsum_min_max, 3, torch.float32),
    "welford": (welford, 3, torch.float32),
    "weighted_mean": (weighted_mean, 2, torch.float32),
    "logsumexp": (logsumexp, 2, torch.float32),
    "modsum": (modsum, 1, torch.int32),
    "cast_sum": (cast_sum, 1, torch.int32)}
#: name -> the same monoid as per-lane op codes
TYPED_CODES = {"fsum_min_max": ("sum", "min", "max")}


def typed_rows(name: str, rng: np.random.Generator, n: int) -> np.ndarray:
    """``[n, lanes]`` rows of monoid *name*'s domain (float32 or int32),
    from numpy generator *rng*."""
    x = rng.standard_normal(n).astype(np.float32) * np.float32(37.5)
    if name == "fsum_min_max":
        return np.stack([x, x[::-1].copy(), x * np.float32(-0.5)], axis=-1)
    if name == "welford":
        return np.stack([np.ones(n, np.float32), x, np.zeros(n, np.float32)],
                        axis=-1)
    if name == "weighted_mean":
        w = rng.uniform(0.25, 4.0, n).astype(np.float32)
        return np.stack([w, x], axis=-1)
    if name == "logsumexp":
        return np.stack([x * np.float32(0.4), np.ones(n, np.float32)],
                        axis=-1)
    if name == "modsum":
        return rng.integers(0, MOD, (n, 1)).astype(np.int32)
    if name == "cast_sum":
        return rng.integers(-2 ** 20, 2 ** 20, (n, 1)).astype(np.int32)
    raise KeyError(name)


def typed_lanes(name: str, n: int, key_range: int, seed: int,
                specials: bool = False):
    """Sorted key lanes (one row in ten invalid) and typed monoid
    *name*'s value lanes (:func:`typed_rows`), as CPU tensors made from
    numpy seed *seed*.  With *specials* (float lanes), the rows of some
    keys are NaN or, for others, only -0.0 and +0.0 (so a min, a max and
    a sum of zeros decide a sign)."""
    from ..ops.segscan import _sort_perm

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_range, size=(n, 2)).astype(np.uint32)
    valid = torch.from_numpy(rng.random(n) >= 0.1)
    rows = typed_rows(name, rng, n)
    if specials:
        zero = (keys[:, 0] % 7 == 3)[:, None]
        rows = np.where(zero, np.where(rng.random(rows.shape) < 0.5,
                                       np.float32(-0.0), np.float32(0.0)),
                        rows)
        rows[(keys[:, 0] % 11 == 5) & (rng.random(n) < 0.3)] = np.nan
    k = torch.from_numpy(keys.view(np.int32).copy())
    k1 = torch.where(valid, k[:, 0], -1)
    k2 = torch.where(valid, k[:, 1], -1)
    perm = _sort_perm(k1, k2, "variadic")
    v = torch.from_numpy(np.ascontiguousarray(rows))[perm]
    return (k1[perm].contiguous(), k2[perm].contiguous(),
            [v[:, i].contiguous() for i in range(v.shape[1])])


U = 2.0 ** -24


def gamma(n):
    """``gamma_n``: a float32 sum of n terms lies within ``gamma_n *
    sum|v|`` of the exact sum, in any association (*n* a number or a
    tensor of run lengths)."""
    return n * U / (1 - n * U)


#: the typed monoids whose lanes are independent ops, and each lane's op
_LANE_OPS = {"fsum_min_max": ("sum", "min", "max"), "cast_sum": ("sum",)}


def run_reference(name, rows: torch.Tensor, run: torch.Tensor, runs: int):
    """Monoid *name* (a typed monoid's name, or a tuple of per-lane ops
    from "sum", "min" and "max") over each run of *rows* (``[N, lanes]``,
    float32 or int32, on any device; *run* ``[N]`` int64 the run of each
    row, in ``[0, runs)``), in float64 (int64 for ``modsum``): ``(ref,
    tol)``, each ``[runs, lanes]``, *tol* each lane's absolute bound of a
    float32 result: the sums' ``gamma_n * sum|v|``; the means (a convex
    combination a combine) ``(4 gamma_n + 6 (n - 1) u) * max|x|``; M2 (a
    sum of non-negative terms) ``10 n u`` of its value plus ``2 * mean
    bound * sum|x - mean|``; ``s`` of log-sum-exp ``(6 (n - 1) u +
    gamma_n) * s`` (its terms are positive, each combine's ``exp``
    within 2 ulp); min, max, counts and ``modsum`` exact."""
    dev, R = rows.device, int(runs)
    r = rows.to(torch.float64)

    def add(x):
        return torch.zeros(R, dtype=x.dtype, device=dev).index_add_(0, run, x)

    def pick(x, how):
        return torch.zeros(R, dtype=x.dtype, device=dev).scatter_reduce_(
            0, run, x, how, include_self=False)

    n = add(torch.ones_like(r[:, 0]))
    g = gamma(n)
    zero = torch.zeros_like(n)
    lane_ops = (_LANE_OPS.get(name) if isinstance(name, str)
                else tuple(name))
    if lane_ops is not None:
        ref, tol = [], []
        for d, o in enumerate(lane_ops):
            if o == "sum":
                ref.append(add(r[:, d]))
                tol.append(g * add(r[:, d].abs()))
            else:
                ref.append(pick(r[:, d], {"min": "amin", "max": "amax"}[o]))
                tol.append(zero)
    elif name in ("welford", "weighted_mean"):
        x = r[:, 1]
        w = torch.ones_like(x) if name == "welford" else r[:, 0]
        mean = add(w * x) / add(w)
        mean_tol = (4 * g + 6 * (n - 1) * U) * pick(x.abs(), "amax")
        if name == "weighted_mean":
            ref, tol = [add(w), mean], [g * add(w), mean_tol]
        else:
            dev_ = x - mean[run]
            m2 = add(dev_ * dev_)
            ref = [n, mean, m2]
            tol = [zero, mean_tol,
                   10 * n * U * m2 + 2 * mean_tol * add(dev_.abs())]
    elif name == "logsumexp":
        m = pick(r[:, 0], "amax")
        s_ = add(r[:, 1] * torch.exp(r[:, 0] - m[run]))
        ref, tol = [m, s_], [zero, (6 * (n - 1) * U + g) * s_]
    elif name == "modsum":
        ref = [add(rows[:, 0].to(torch.int64)) % MOD]
        tol = [zero]
    else:
        raise KeyError(name)
    return torch.stack(ref, dim=-1), torch.stack(tol, dim=-1)


def hold(name, k1s: torch.Tensor, k2s: torch.Tensor, vals, got,
         plain) -> float:
    """Hold the reduced lanes *got* (a kernel's) and *plain* (the plain
    version's) of *name* (as :func:`run_reference` takes it) over sorted
    lanes (*k1s*, *k2s*, value lanes *vals*; all on one device) at each
    run's end row:
    lanes that :func:`run_reference` gives exactly (min, max, counts,
    ``modsum``) bit-equal to each other, any NaN equal to any NaN; the
    others within its bound of the float64 fold, both of them, NaN where
    a run holds one, and a sum of zeros of the same sign in both (IEEE
    gives it in any association: -0.0 only when every term is).  Returns
    the largest ``|got - plain|`` over the run ends; raises
    ``AssertionError`` naming the lane."""
    from ..ops.segscan import _run_flags

    valid, is_start, is_end = _run_flags(k1s, k2s)
    run = (torch.cumsum(is_start.to(torch.int64), 0) - 1)[valid]
    rows = torch.stack(list(vals), dim=-1)[valid]
    ref, tol = run_reference(name, rows, run, int(is_start.sum()))
    err = 0.0
    for d, (g, p) in enumerate(zip(got, plain)):
        g, p = g[is_end], p[is_end]
        nan = torch.isnan(ref[:, d])
        if g.dtype != torch.float32:
            assert torch.equal(g, p), f"{name} lane {d}: not bit-equal"
            err = max(err, float((g.to(torch.int64) - p.to(torch.int64))
                                 .abs().max()) if g.numel() else 0.0)
            continue
        for x, who in ((g, "kernel"), (p, "plain")):
            assert torch.equal(torch.isnan(x), nan), \
                f"{name} lane {d}: the {who}'s NaN runs"
        g64, p64 = g[~nan].double(), p[~nan].double()
        if bool((tol[~nan, d] == 0).all()):
            assert torch.equal(g[~nan].view(torch.int32),
                               p[~nan].view(torch.int32)), \
                f"{name} lane {d}: not bit-equal"
        for x, who in ((g64, "kernel"), (p64, "plain")):
            off = (x - ref[~nan, d]).abs() - tol[~nan, d]
            assert bool((off <= 0).all()), \
                f"{name} lane {d}: the {who} is {float(off.max())} past " \
                "its bound"
        zero = (g64 == 0) & (p64 == 0)
        assert torch.equal(torch.signbit(g[~nan][zero]),
                           torch.signbit(p[~nan][zero])), \
            f"{name} lane {d}: a zero's sign"
        if g64.numel():
            err = max(err, float((g64 - p64).abs().max()))
    return err


def _fdiv(a, b):
    """Lane-wise: float division, a float constant, and ``sqrt`` of
    ``abs`` (not associative)."""
    return torch.sqrt(torch.abs(a / (b + 0.5))) - a * 0.25


def int_nodes(a, b):
    """int32 ``//``, ``%``, ``fmod``, truncating division, ``clamp`` and
    ``abs``, by divisors that are never 0 (torch's CPU raises there) and
    never -1 where the dividend may be ``INT32_MIN`` (it traps)."""
    d = (b[..., 1] & 15) + 1
    return torch.stack([
        a[..., 0] // d, a[..., 1] % -(d + 1), torch.fmod(a[..., 2], -d),
        torch.div(a[..., 3], d, rounding_mode="trunc"),
        torch.clamp(a[..., 0], -1000, 70000) + torch.abs(b[..., 2]),
        torch.div(a[..., 1], -(d + 1), rounding_mode="floor")], dim=-1)


def casts(a, b):
    """Casts both ways, promotion of an int32 lane by a float constant
    and by a float lane, float comparisons and ``where`` on floats."""
    i = (a[..., 0] * 0.5).int()
    f = b[..., 1].float() + a[..., 1]
    return torch.stack([
        (i + b[..., 0].int()).float(),
        torch.where(a[..., 1] < b[..., 1], f, torch.clamp(f, max=3.5)),
        torch.exp(a[..., 2] * 0.01) + torch.log(torch.abs(b[..., 2]) + 1.0),
        torch.clamp(a[..., 0], min=2.0) - torch.clamp(b[..., 0], max=-1.5)],
        dim=-1)


#: node forms of the typed lowering: name -> (op, value lanes, dtype)
TYPED_NODE_CASES = {
    "float lane-wise division, sqrt, abs": (_fdiv, 2, torch.float32),
    "int32 division, clamp, abs": (int_nodes, 6, torch.int32),
    "casts and float constants": (casts, 4, torch.float32)}
