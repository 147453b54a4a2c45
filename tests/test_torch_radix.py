"""The port's radix family (mapreduce_tpu_torch/ops/radix_sort.py) and what
it serves, against the JAX package's, bit for bit.

* the plain ``radix_sort_pairs`` (8-bit digits, 8 passes) against the
  JAX ``radix_sort_pairs`` (4-bit digits, 16 passes) in interpret mode,
  and against ``lax.sort((k1, k2, iota), num_keys=2)`` at ~50,000 rows:
  duplicates, all-equal keys, sentinel rows, the uint32 sign-bit edges;
* the plain ``radix_partition_plan`` against the JAX one (every row's
  rank, the dropped bucket's included, and the counts);
* ``sorted_unique_reduce(sort_impl='radix')`` against ``'variadic'``;
* ``partition_exchange(impl='radix')`` against ``impl='lax'`` and the
  JAX exchange under ``shard_map``, with and without carry and a
  partition map;
* ``plan_rebalance`` against the JAX planner;
* the CPU radix path runs the plain versions, counted, and no
  ``torch.sort``.

Inputs are numpy arrays from fixed seeds; there is no tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS

from mapreduce_tpu.engine.autotune import plan_rebalance as j_plan_rebalance
from mapreduce_tpu.ops import radix_sort as jrs
from mapreduce_tpu.ops import segscan as jseg
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu.parallel.shuffle import partition_exchange as j_exchange
from mapreduce_tpu_torch.engine.autotune import plan_rebalance
from mapreduce_tpu_torch.ops import kernel_compat as kc
from mapreduce_tpu_torch.ops import radix_sort as rs
from mapreduce_tpu_torch.ops import segscan as tseg
from mapreduce_tpu_torch.parallel.shuffle import partition_exchange

#: the JAX kernels' tile in these tests: several grid steps per call
JBLOCK = 512
#: zero, the signed-positive max, the sign bit, and the sentinel
EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 dtype=np.uint32)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                             else a).copy())


def _keys(case, n, seed):
    rng = np.random.default_rng(seed)
    if case == "dup":
        return (rng.integers(0, 7, n).astype(np.uint32),
                rng.integers(0, 3, n).astype(np.uint32))
    if case == "all-equal":
        return (np.full(n, 0x80000000, np.uint32),
                np.full(n, 5, np.uint32))
    if case == "sentinel":  # engine layout: invalid rows are (-1, -1)
        k1 = rng.integers(0, 50, n).astype(np.uint32)
        k2 = rng.integers(0, 50, n).astype(np.uint32)
        dead = rng.random(n) < 0.3
        k1[dead] = k2[dead] = np.uint32(0xFFFFFFFF)
        return k1, k2
    k1 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    k2 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    k1[: n // 2] = rng.choice(EDGES, n // 2)
    k2[n // 3:] = rng.choice(EDGES, n - n // 3)
    return k1, k2


def _pin_sorted(got, want, ctx):
    for g, w, lane in zip(got, want, ("k1", "k2", "perm")):
        g = g.numpy()
        g = g.view(np.uint32) if lane != "perm" else g
        assert np.array_equal(g, np.asarray(w)), (ctx, lane)


@pytest.mark.parametrize("case,n", [("dup", 1), ("dup", 37),
                                    ("dup", 3 * JBLOCK + 99),
                                    ("all-equal", 700), ("sentinel", 1200),
                                    ("edges", 2 * JBLOCK + 17)])
def test_plain_sort_matches_jax_radix(case, n):
    k1, k2 = _keys(case, n, seed=n)
    want = jrs.radix_sort_pairs(jnp.asarray(k1), jnp.asarray(k2),
                                block=JBLOCK, interpret=True)
    _pin_sorted(rs.radix_sort_pairs(_t(k1), _t(k2)), want, (case, n))


@pytest.mark.parametrize("case", ["dup", "sentinel", "edges"])
def test_plain_sort_matches_lax_sort_over_many_tiles(case):
    n = 50_003  # 13 tiles of 4096, the last one ragged
    k1, k2 = _keys(case, n, seed=7)
    want = jax.lax.sort((jnp.asarray(k1), jnp.asarray(k2),
                         jnp.arange(n, dtype=jnp.int32)), num_keys=2)
    _pin_sorted(rs.radix_sort_pairs(_t(k1), _t(k2)), want, case)


#: rows of the pass-level cases: 13 JAX tiles of 512, and 2 sort tiles
#: of the port (the last one ragged)
PASS_N = 13 * JBLOCK


@pytest.mark.parametrize("case", ["dup", "sentinel", "edges"])
def test_upfront_table_matches_jax_tile_hist(case):
    """Each row of the plain upfront table is the JAX histogram kernel's
    per-tile counts of that pass's 8-bit digit (256 buckets), summed
    over the tiles."""
    k1, k2 = _keys(case, PASS_N, seed=11)
    table = rs._radix_upfront_plain(_t(k1), _t(k2))
    assert table.shape == (rs.RADIX_PASSES, rs.RADIX)
    assert table.dtype == torch.int32
    for p, (lane, shift) in enumerate(rs.PASSES):
        src = k2 if lane else k1
        d2 = ((src >> np.uint32(shift)) & np.uint32(0xFF)).astype(
            np.int32).reshape(-1, JBLOCK)
        want = np.asarray(jrs._tile_hist(jnp.asarray(d2), rs.RADIX,
                                         True)).sum(axis=0)
        assert np.array_equal(table[p].numpy(), want), (case, p)


@pytest.mark.parametrize("lane,shift", [(1, 0), (1, 24), (0, 8), (0, 24)])
def test_onesweep_pass_matches_two_jax_radix_passes(lane, shift):
    """One plain 8-bit pass at *shift* against two stable JAX 4-bit passes
    (the Pallas hist and scatter kernels, interpreted) at *shift* and
    *shift* + 4, with a non-identity perm: two stable 4-bit passes are
    exactly one stable 8-bit pass."""
    k1, k2 = _keys("edges", PASS_N, seed=shift + lane)
    # few distinct digits: long equal runs, so stability shows in perm
    k1[::3] &= np.uint32(0x0F0F0F0F)
    perm = np.random.default_rng(lane).permutation(PASS_N).astype(np.int32)
    a = (jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(perm))
    tiles = PASS_N // JBLOCK
    for s4 in (shift, shift + 4):
        digits = ((a[lane] >> s4) & 0xF).astype(jnp.int32)
        a = jrs._radix_pass(digits, *a, tiles, JBLOCK, True)
    table = rs._radix_upfront_plain(_t(k1), _t(k2))
    out = tuple(torch.empty(PASS_N, dtype=torch.int32) for _ in range(3))
    rs._radix_onesweep_plain(_t(k1), _t(k2), _t(perm), lane, shift,
                             table[rs.PASSES.index((lane, shift))], out)
    _pin_sorted(out, a, (lane, shift))


def test_sort_of_nothing():
    e = torch.zeros(0, dtype=torch.int32)
    k1s, k2s, perm = rs.radix_sort_pairs(e, e)
    assert k1s.numel() == k2s.numel() == perm.numel() == 0
    assert perm.dtype == torch.int32


#: the port's plan tile
PTILE = rs.RADIX_TILE


def _plan_dest(case, P, b, n, seed):
    """``[b, n]`` int32 destinations in ``[0, P]`` for a plan case."""
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, P + 1, (b, n)).astype(np.int32)
    if case == "row-dropped":  # a whole batch row in the dropped bucket
        dest[b // 2] = P
    elif case == "one-bucket-head":  # the early tiles hold one bucket
        dest[:, : 2 * PTILE + 7] = P // 2
    return dest


#: (case, P, batch, n): n around the port's tile, several tiles with a
#: dropped row or a one-bucket head (look-back chains on the card), the
#: partition limits, batch 1 and 8
PLAN_CASES = [("uniform", 3, 1, 1), ("uniform", 8, 1, PTILE - 1),
              ("uniform", 8, 1, PTILE), ("uniform", 8, 8, PTILE + 1),
              ("uniform", 1, 1, 2 * JBLOCK + 31),
              ("row-dropped", 8, 8, 3 * PTILE + 5),
              ("one-bucket-head", 8, 1, 4 * PTILE - 3),
              ("uniform", 1, 8, 2 * PTILE + 1),
              ("uniform", rs.MAX_PARTITIONS, 1, PTILE + 100),
              ("one-bucket-head", rs.MAX_PARTITIONS, 8, 3 * PTILE)]


@pytest.mark.parametrize("case,P,b,n", PLAN_CASES)
def test_plain_plan_matches_jax_plan(case, P, b, n):
    """The plain plan (the kernel's arithmetic) against the JAX plan, one
    JAX call a batch row: every row's rank, the dropped bucket P's
    included, and the counts, bit for bit."""
    dest = _plan_dest(case, P, b, n, seed=P + b + n)
    rank, counts = rs.radix_partition_plan(_t(dest), P)
    assert rank.shape == (b, n) and counts.shape == (b, P)
    assert rank.dtype == counts.dtype == torch.int32
    p_rank, p_totals = rs._radix_plan_plain(_t(dest), P + 1)
    assert torch.equal(p_rank, rank) and torch.equal(p_totals[:, :P], counts)
    for row in range(b):
        j_rank, j_counts = jrs.radix_partition_plan(
            jnp.asarray(dest[row]), P, block=JBLOCK, interpret=True)
        assert np.array_equal(rank[row].numpy(), np.asarray(j_rank)), row
        assert np.array_equal(counts[row].numpy(), np.asarray(j_counts)), row


def test_batched_plan_is_one_plan_per_row():
    rng = np.random.default_rng(3)
    P, n = 8, 9000  # 3 tiles per row
    dest = rng.integers(0, P + 1, (P, n)).astype(np.int32)
    rank, counts = rs.radix_partition_plan(_t(dest), P)
    assert rank.shape == (P, n) and counts.shape == (P, P)
    for b in range(P):
        r1, c1 = rs.radix_partition_plan(_t(dest[b]), P)
        assert torch.equal(rank[b], r1) and torch.equal(counts[b], c1)


def test_plan_partition_limits():
    d = torch.zeros(10, dtype=torch.int32)
    rank, counts = rs.radix_partition_plan(d, rs.MAX_PARTITIONS)
    assert counts.shape == (255,) and int(counts[0]) == 10
    assert torch.equal(rank, torch.arange(10, dtype=torch.int32))
    for P in (0, rs.MAX_PARTITIONS + 1):
        with pytest.raises(ValueError, match="partitions"):
            rs.radix_partition_plan(d, P)


def _jvop(x, y):
    """The JAX (sum, min, max) monoid over stacked value lanes."""
    return jnp.stack([x[..., 0] + y[..., 0],
                      jnp.minimum(x[..., 1], y[..., 1]),
                      jnp.maximum(x[..., 2], y[..., 2])], axis=-1)


def _case(seed, n=384, lanes=1):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 40, size=(n, 2)).astype(np.uint32)
    keys[rng.random(n) < 0.3, 0] |= np.uint32(0x80000000)
    keys[::11] = np.uint32(0xFFFFFFFF)  # real sentinel pairs
    vals = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(n, lanes)).astype(
        np.int32)
    pay = np.arange(n, dtype=np.int32)[:, None]
    valid = rng.random(n) < 0.8
    return keys, (vals if lanes > 1 else vals[:, 0]), pay, valid


@pytest.mark.parametrize("op", ["unit", "sum", "stacked"])
def test_sorted_unique_reduce_radix_matches_variadic(op):
    lanes = 3 if op == "stacked" else 1
    top = ("sum", "min", "max") if op == "stacked" else "sum"
    for seed, cap in ((1, 128), (2, 16)):  # 16 < n_unique: overflow
        keys, vals, pay, valid = _case(seed, lanes=lanes)
        args = (_t(keys), _t(vals), _t(pay), _t(valid), cap, top)
        want = tseg.sorted_unique_reduce(*args, unit_values=op == "unit")
        got = tseg.sorted_unique_reduce(*args, unit_values=op == "unit",
                                        sort_impl="radix")
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (op, f)
        # and the JAX package's variadic path on the same rows
        ref = jseg.sorted_unique_reduce(
            *(jnp.asarray(a) for a in (keys, vals, pay, valid)), cap,
            _jvop if op == "stacked" else "sum", unit_values=op == "unit")
        assert np.array_equal(got.keys.numpy().view(np.uint32),
                              np.asarray(ref.keys))
        for f in ("values", "payload", "valid"):
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(ref, f))), (op, f)


def _exchange_inputs(seed, P=8, n=48, A=10, B=32):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 ** 32, (P, n, 2), dtype=np.uint64).astype(
        np.uint32)
    vals = rng.integers(-100, 100, (P, n)).astype(np.int32)
    pay = rng.integers(0, 1000, (P, n, 1)).astype(np.int32)
    valid = rng.random((P, n)) < 0.85
    carry = (rng.integers(0, 2 ** 32, (P, A, 2), dtype=np.uint64).astype(
                 np.uint32),
             rng.integers(0, 50, (P, A)).astype(np.int32),
             rng.integers(0, 50, (P, A, 1)).astype(np.int32),
             rng.random((P, A)) < 0.5)
    # a skewed table: most buckets pile onto partition 2
    pmap = np.where(rng.random(B) < 0.6, 2,
                    rng.integers(0, P, B)).astype(np.int32)
    return keys, vals, pay, valid, carry, pmap


def _jax_exchange(mesh, cap, keys, vals, pay, valid, carry, pmap):
    """The JAX exchange under shard_map (the table replicated); every
    field with a leading per-device axis, as numpy."""
    n_in = 4 + (4 if carry is not None else 0)

    def body(*args):
        k, v, p, m = args[:4]
        c = tuple(args[4:n_in]) if carry is not None else None
        pm = args[n_in] if pmap is not None else None
        e = j_exchange(k, v, p, m, "data", cap, carry=c, pmap=pm)
        return (e.keys[None], e.values[None], e.payload[None],
                e.valid[None], e.overflow[None], e.max_count[None],
                e.counts[None])

    specs = (PS("data"),) * n_in + ((PS(),) if pmap is not None else ())
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs,
                               out_specs=(PS("data"),) * 7))
    flat = lambda a: a.reshape((-1,) + a.shape[2:])  # [P, n, ...] -> rows
    args = [flat(a) for a in (keys, vals, pay, valid)]
    if carry is not None:
        args += [flat(a) for a in carry]
    if pmap is not None:
        args.append(pmap)
    return [np.asarray(o) for o in fn(*args)]


def _fields(e):
    return [e.keys.numpy().view(np.uint32), e.values.numpy(),
            e.payload.numpy(), e.valid.numpy(), e.overflow.numpy(),
            e.max_count.numpy(), e.counts.numpy()]


@pytest.mark.parametrize("with_pmap", [False, True])
@pytest.mark.parametrize("with_carry", [False, True])
def test_radix_exchange_matches_lax_and_jax(with_carry, with_pmap):
    keys, vals, pay, valid, carry, pmap = _exchange_inputs(
        2 * with_carry + with_pmap)
    carry = carry if with_carry else None
    pmap = pmap if with_pmap else None
    cap = 6  # below some per-destination counts: overflow
    args = (_t(keys), _t(vals), _t(pay), _t(valid), cap)
    kw = dict(carry=None if carry is None else tuple(_t(c) for c in carry),
              pmap=None if pmap is None else _t(pmap))
    lax_ex = partition_exchange(*args, impl="lax", **kw)
    radix_ex = partition_exchange(*args, impl="radix", **kw)
    ref = _jax_exchange(make_mesh(), cap, keys, vals, pay, valid, carry,
                        pmap)
    P = keys.shape[0]
    for name, a, b, r in zip(lax_ex._fields, _fields(lax_ex),
                             _fields(radix_ex), ref):
        assert np.array_equal(a, b), name
        assert np.array_equal(b, r.reshape(b.shape)), name
    assert int(radix_ex.overflow.sum()) > 0
    if with_pmap:  # the skewed table really moved the traffic
        assert int(radix_ex.counts[:, 2].sum()) > radix_ex.counts.sum() // P


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_rebalance_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B = [8, 64, 33][seed]
    w = rng.zipf(1.5, B).astype(np.int64)
    w[: B // 4] = w[0]  # ties break on bucket index
    for n_dev in (1, 3, 8):
        got = plan_rebalance(w, n_dev)
        assert got.dtype == np.int32
        assert np.array_equal(got, j_plan_rebalance(w, n_dev))


def test_cpu_radix_path_runs_plain_versions_and_no_torch_sort(monkeypatch):
    def no_sort(*a, **k):
        raise AssertionError("torch.sort ran on the radix path")

    monkeypatch.setattr(torch, "sort", no_sort)
    monkeypatch.setattr(torch.Tensor, "sort", no_sort)
    monkeypatch.setattr(torch, "argsort", no_sort)
    kc.reset_counts()
    keys, vals, pay, valid = _case(5)
    tseg.sorted_unique_reduce(_t(keys), _t(vals), _t(pay), _t(valid), 64,
                              "sum", sort_impl="radix")
    assert kc.PLAIN_CALLS["radix_upfront"] == 1
    assert kc.PLAIN_CALLS["radix_onesweep"] == rs.RADIX_PASSES
    assert kc.PLAIN_CALLS["radix_plan"] == 0
    keys, vals, pay, valid, _, _ = _exchange_inputs(9)
    partition_exchange(_t(keys), _t(vals), _t(pay), _t(valid), 6,
                       impl="radix")
    assert kc.PLAIN_CALLS["radix_plan"] == 1
    assert all(v == 0 for v in kc.LAUNCHES.values())
