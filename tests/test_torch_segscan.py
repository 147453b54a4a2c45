"""The port's sorted-run reduction (mapreduce_tpu_torch/ops/segscan.py)
against the JAX package's, bit for bit.

* the plain segmented reduce against the JAX Pallas kernel
  (``_segment_reduce_pallas``, interpret mode) on the kernel's
  equivalence surface: reduced lanes at run-end rows, ``end_csum``
  everywhere;
* ``sorted_unique_reduce`` end to end for unit/sum/min/max and the
  stacked (sum, min, max) monoid, with both sort formulations, the
  sentinel pair, (0, 0) keys and overflow (n_unique > capacity);
* the stable sort permutation against ``lax.sort``;
* ``sort_impl='radix'`` on the plain radix versions (the radix family
  itself is pinned in ``test_torch_radix.py``).

Inputs are numpy arrays from fixed seeds; every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapreduce_tpu.ops import segscan as jseg
from mapreduce_tpu_torch.ops import kernel_compat as kc
from mapreduce_tpu_torch.ops import segscan as tseg

#: one shape family: a non-block-multiple N over a 2-step kernel grid
N = 384
BLOCK = 256


def _jvop(x, y):
    return jnp.stack([x[..., 0] + y[..., 0],
                      jnp.minimum(x[..., 1], y[..., 1]),
                      jnp.maximum(x[..., 2], y[..., 2])], axis=-1)


def _tvop(x, y):
    return torch.stack([x[..., 0] + y[..., 0],
                        torch.minimum(x[..., 1], y[..., 1]),
                        torch.maximum(x[..., 2], y[..., 2])], dim=-1)


#: op name -> (JAX op, port op, value lanes)
OPS = {
    "sum": (jnp.add, "sum", 1),
    "min": (jnp.minimum, "min", 1),
    "max": (jnp.maximum, "max", 1),
    "stacked": (_jvop, ("sum", "min", "max"), 3),
}


def _case(seed, key_range=40, lanes=1, valid_frac=0.8):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_range, size=(N, 2)).astype(np.uint32)
    keys[rng.random(N) < 0.3, 0] |= np.uint32(0x80000000)  # sign-bit edge
    vals = rng.integers(-2 ** 31, 2 ** 31 - 1,
                        size=(N, lanes)).astype(np.int32)
    pay = np.arange(N, dtype=np.int32)[:, None]
    valid = rng.random(N) < valid_frac
    return keys, (vals if lanes > 1 else vals[:, 0]), pay, valid


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                             else a).copy())


def _sorted(keys, valid, vals):
    """Sorted lanes as both packages see them (sentinel on invalid)."""
    k1 = np.where(valid, keys[:, 0], np.uint32(0xFFFFFFFF))
    k2 = np.where(valid, keys[:, 1], np.uint32(0xFFFFFFFF))
    perm = np.lexsort((k2, k1))
    v = vals[perm]
    lanes = [v] if v.ndim == 1 else [v[:, i] for i in range(v.shape[1])]
    return k1[perm], k2[perm], lanes


@pytest.mark.parametrize("op", ["unit", "sum", "min", "max", "stacked"])
def test_segment_reduce_plain_matches_pallas_kernel(op):
    unit = op == "unit"
    jop, top, lanes = OPS["sum" if unit else op]
    keys, vals, _, valid = _case(3, lanes=lanes)
    k1, k2, vl = _sorted(keys, valid, vals)
    vl = [] if unit else vl
    j_red, j_csum = jseg._segment_reduce_pallas(
        jnp.asarray(k1), jnp.asarray(k2), [jnp.asarray(v) for v in vl], jop,
        unit, BLOCK, True)
    t_red, t_csum = tseg.segment_reduce(_t(k1), _t(k2), [_t(v) for v in vl],
                                        top, unit)
    assert np.array_equal(t_csum.numpy(), np.asarray(j_csum))
    _, _, is_end = tseg._run_flags(_t(k1), _t(k2))
    ends = is_end.numpy()
    assert ends.any()
    assert len(t_red) == len(j_red)
    for t, j in zip(t_red, j_red):
        assert np.array_equal(t.numpy()[ends], np.asarray(j)[ends])


def _pin(port, ref, ctx):
    assert np.array_equal(port.keys.numpy().view(np.uint32),
                          np.asarray(ref.keys)), ctx
    for f in ("values", "payload", "valid"):
        assert np.array_equal(getattr(port, f).numpy(),
                              np.asarray(getattr(ref, f))), (f, ctx)
    assert int(port.n_unique) == int(ref.n_unique), ctx


@pytest.mark.parametrize("sort_impl", ["variadic", "argsort"])
@pytest.mark.parametrize("op", ["unit", "sum", "min", "max", "stacked"])
def test_sorted_unique_reduce_matches_jax(op, sort_impl):
    unit = op == "unit"
    jop, top, lanes = OPS["sum" if unit else op]
    for seed, cap in ((1, 128), (2, 16)):  # 16 < n_unique: overflow
        keys, vals, pay, valid = _case(seed, lanes=lanes)
        keys[::11] = np.uint32(0xFFFFFFFF)  # real sentinel pairs
        keys[5::13] = 0                     # real (0, 0) keys
        ref = jseg.sorted_unique_reduce(
            jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(pay),
            jnp.asarray(valid), cap, jop, unit_values=unit,
            sort_impl=sort_impl)
        port = tseg.sorted_unique_reduce(
            _t(keys), _t(vals), _t(pay), _t(valid), cap, top,
            unit_values=unit, sort_impl=sort_impl)
        _pin(port, ref, (op, sort_impl, seed))
        if cap == 16:
            assert int(port.n_unique) > cap


def test_callable_monoid_runs_on_cpu():
    """A Python callable reduce_op takes the plain version's generic
    ladder on the CPU and agrees with the per-lane op tuple."""
    keys, vals, pay, valid = _case(4, key_range=12, lanes=3)
    a = tseg.sorted_unique_reduce(_t(keys), _t(vals), _t(pay), _t(valid),
                                  64, _tvop)
    b = tseg.sorted_unique_reduce(_t(keys), _t(vals), _t(pay), _t(valid),
                                  64, ("sum", "min", "max"))
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_all_invalid_and_single_run():
    keys = np.full((N, 2), 7, dtype=np.uint32)
    vals = np.ones(N, dtype=np.int32)
    pay = np.zeros((N, 1), dtype=np.int32)
    for valid in (np.zeros(N, dtype=bool), np.ones(N, dtype=bool)):
        ref = jseg.sorted_unique_reduce(
            jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(pay),
            jnp.asarray(valid), 8, "sum")
        port = tseg.sorted_unique_reduce(_t(keys), _t(vals), _t(pay),
                                         _t(valid), 8, "sum")
        _pin(port, ref, int(valid.sum()))


@pytest.mark.parametrize("seed", [0, 1])
def test_stable_sort_permutation_matches_lax_sort(seed):
    rng = np.random.default_rng(seed)
    n = 2000
    k1 = rng.integers(0, 30, n).astype(np.uint32)
    k2 = rng.integers(0, 30, n).astype(np.uint32)
    k1[rng.random(n) < 0.3] |= np.uint32(0x80000000)
    k2[rng.random(n) < 0.3] = np.uint32(0xFFFFFFFF)
    k1[::17] = np.uint32(0xFFFFFFFF)
    _, _, perm = jax.lax.sort(
        (jnp.asarray(k1), jnp.asarray(k2), jnp.arange(n, dtype=jnp.int32)),
        num_keys=2)
    for impl in ("variadic", "argsort"):
        got = tseg._sort_perm(_t(k1), _t(k2), impl)
        assert np.array_equal(got.numpy(), np.asarray(perm)), impl


def test_radix_sort_not_ported_yet_and_plain_counted():
    """Once refused, ``sort_impl='radix'`` now runs (the radix family is
    ported): on the CPU it gives the variadic result through the plain
    radix versions, each counted, and an unknown sort_impl still
    raises."""
    keys, vals, pay, valid = _case(5)
    args = (_t(keys), _t(vals), _t(pay), _t(valid), 16, "sum")
    kc.reset_counts()
    got = tseg.sorted_unique_reduce(*args, sort_impl="radix")
    assert kc.PLAIN_CALLS["radix_upfront"] == 1
    assert kc.PLAIN_CALLS["radix_onesweep"] == 8
    assert kc.PLAIN_CALLS["segreduce"] == 1
    assert kc.LAUNCHES["segreduce"] == 0
    want = tseg.sorted_unique_reduce(*args)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="sort_impl"):
        tseg.sorted_unique_reduce(*args, sort_impl="bitonic")
