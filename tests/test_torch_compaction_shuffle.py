"""The port's tile compaction and partition exchange against the JAX
package's, bit for bit.

``tile_compact`` (a cumsum rank + indexed write in the port, a one-hot
bf16 matmul in JAX) must give the same slots, valid mask and overflow.
``partition_exchange`` over ``Partitions(8, "cpu")`` (the partitions as a
leading axis) must give every ``Exchanged`` field of the JAX version run
under ``shard_map`` on the 8-device virtual CPU mesh, with and without
the accumulator carry.  Inputs are numpy arrays from fixed seeds.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as PS

from mapreduce_tpu.ops.compaction import tile_compact as j_tile_compact
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu.parallel.shuffle import (
    partition_exchange as j_exchange)
from mapreduce_tpu_torch.ops.compaction import tile_compact
from mapreduce_tpu_torch.parallel.mesh import Partitions
from mapreduce_tpu_torch.parallel.shuffle import partition_exchange


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                             else a).copy())


@pytest.mark.parametrize("capacity,density", [(16, 0.02), (8, 0.5),
                                              (64, 0.9)])
def test_tile_compact_matches_jax(capacity, density):
    rng = np.random.default_rng(capacity)
    L, tile = 2048, 256
    mask = rng.random(L) < density
    a = rng.integers(0, 2 ** 32, L, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(-2 ** 31, 2 ** 31 - 1, L).astype(np.int32)
    ref = j_tile_compact(jax.numpy.asarray(mask), tile, capacity,
                         jax.numpy.asarray(a), jax.numpy.asarray(b))
    got = tile_compact(torch.from_numpy(mask), tile, capacity, _t(a), _t(b))
    assert np.array_equal(got.arrays[0].numpy().view(np.uint32),
                          np.asarray(ref.arrays[0]))
    assert np.array_equal(got.arrays[1].numpy(), np.asarray(ref.arrays[1]))
    assert np.array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert int(got.overflow) == int(ref.overflow)
    if capacity == 8:
        assert int(got.overflow) > 0


def _jax_exchange(mesh, cap, keys, vals, pay, valid, carry):
    """The JAX exchange under shard_map; every field with a leading
    per-device axis, as numpy."""
    n_in = 8 if carry is not None else 4

    def body(*args):
        k, v, p, m = args[:4]
        c = tuple(a for a in args[4:]) if carry is not None else None
        e = j_exchange(k, v, p, m, "data", cap, carry=c)
        return (e.keys[None], e.values[None], e.payload[None],
                e.valid[None], e.overflow[None], e.max_count[None],
                e.counts[None])

    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=(PS("data"),) * n_in,
                               out_specs=(PS("data"),) * 7))
    flat = lambda a: a.reshape((-1,) + a.shape[2:])  # [P, n, ...] -> rows
    args = [flat(a) for a in (keys, vals, pay, valid)]
    if carry is not None:
        args += [flat(a) for a in carry]
    return [np.asarray(o) for o in fn(*args)]


@pytest.mark.parametrize("with_carry", [False, True])
def test_partition_exchange_matches_jax_shard_map(with_carry):
    mesh = make_mesh()
    P = mesh.shape["data"]
    assert P == 8
    n, cap, A = 48, 6, 10  # cap < some per-destination counts: overflow
    rng = np.random.default_rng(int(with_carry))
    keys = rng.integers(0, 2 ** 32, (P, n, 2), dtype=np.uint64).astype(
        np.uint32)
    vals = rng.integers(-100, 100, (P, n)).astype(np.int32)
    pay = rng.integers(0, 1000, (P, n, 1)).astype(np.int32)
    valid = rng.random((P, n)) < 0.85
    carry = None
    if with_carry:
        carry = (rng.integers(0, 2 ** 32, (P, A, 2),
                              dtype=np.uint64).astype(np.uint32),
                 rng.integers(0, 50, (P, A)).astype(np.int32),
                 rng.integers(0, 50, (P, A, 1)).astype(np.int32),
                 rng.random((P, A)) < 0.5)
    ref = _jax_exchange(mesh, cap, keys, vals, pay, valid, carry)
    parts = Partitions(8, "cpu")
    got = partition_exchange(
        _t(keys).to(parts.device), _t(vals), _t(pay), _t(valid), cap,
        carry=None if carry is None else tuple(_t(c) for c in carry))
    assert np.array_equal(got.keys.numpy().view(np.uint32), ref[0])
    assert np.array_equal(got.values.numpy(), ref[1])
    assert np.array_equal(got.payload.numpy(), ref[2])
    assert np.array_equal(got.valid.numpy(), ref[3])
    assert np.array_equal(got.overflow.numpy(), ref[4].reshape(P))
    assert np.array_equal(got.max_count.numpy(), ref[5].reshape(P))
    assert np.array_equal(got.counts.numpy(), ref[6].reshape(P, P))
    assert int(got.overflow.sum()) > 0


def test_partition_exchange_leftovers_raise():
    """The radix plan and partition maps, once refused, now run (here on
    one partition, where every valid row stays home); an unknown plan
    still raises."""
    k = torch.tensor([[[5, 1], [7, 2], [9, 3], [4, 4]]], dtype=torch.int32)
    v = torch.arange(4, dtype=torch.int32)[None]
    m = torch.tensor([[True, False, True, True]])
    lax_ex = partition_exchange(k, v, v[..., None], m, 4)
    table = torch.zeros(8, dtype=torch.int32)
    for kw in (dict(impl="radix"), dict(pmap=table),
               dict(impl="radix", pmap=table)):
        got = partition_exchange(k, v, v[..., None], m, 4, **kw)
        for f in lax_ex._fields:
            assert torch.equal(getattr(got, f), getattr(lax_ex, f)), (kw, f)
    assert lax_ex.counts.tolist() == [[3]]
    with pytest.raises(ValueError, match="impl"):
        partition_exchange(k, v, v[..., None], m, 4, impl="onehot")
