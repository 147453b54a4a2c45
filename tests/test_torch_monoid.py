"""The port's callable monoids (``mapreduce_tpu_torch/ops/monoid.py``)
against the callables themselves and the JAX package, bit for bit.

* the lowering: ``evaluate(lower(op))`` gives ``op``'s bits on random
  int32 with ``INT32_MIN``/``INT32_MAX`` and wraparound, for every
  monoid of ``testing/monoids.py`` and a few more node kinds; the C++
  text and the hash are deterministic, two bodies give two hashes and
  one body under two names one; an unsupported node raises
  ``NotImplementedError`` naming it (the float32 nodes, division and
  casts are held in ``test_torch_float_lanes.py``);
* op level: the port's ``segment_reduce`` and ``sorted_unique_reduce``
  with each torch callable against ``_segment_reduce_pallas`` (interpret
  mode) and ``_segment_reduce_lax`` with its ``jnp`` twin (the affine
  monoid, which does not commute, included);
* engine level, at P = 1 and P = 8: ``DeviceEngine`` and
  ``EngineSession`` with ``(sum, min, bitwise_or)`` against the JAX lax
  engine (``segment_impl='lax'``, ``sort_impl='variadic'``), and a host
  oracle;
* the verify path and wordspan's device map, now callables, against
  the JAX modules, and the per-lane codes still;
* the build plane: ``sources_for`` names a callable config's monoid
  library, keyed by the IR's hash and the headers' bytes, and its
  ledger outcomes (with ``nvcc`` and the loader faked on the CPU).

Inputs are numpy arrays from fixed seeds; every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapreduce_tpu.engine import device_engine as jde
from mapreduce_tpu.engine import session as jsession
from mapreduce_tpu.engine import wordcount as jwc
from mapreduce_tpu.examples import wordspan as jws
from mapreduce_tpu.ops import segscan as jseg
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.engine import device_engine as tde
from mapreduce_tpu_torch.engine import session as tsession
from mapreduce_tpu_torch.engine import wordcount as twc
from mapreduce_tpu_torch.examples import wordspan as tws
from mapreduce_tpu_torch.obs import compile as tcompile
from mapreduce_tpu_torch.ops import kernel_compat as kc
from mapreduce_tpu_torch.ops import monoid
from mapreduce_tpu_torch.ops import segscan as tseg
from mapreduce_tpu_torch.ops.tokenize import shard_text
from mapreduce_tpu_torch.parallel.mesh import Partitions
from mapreduce_tpu_torch.testing import monoids
from mapreduce_tpu_torch.utils import compile_cache
from tests.test_torch_segscan import BLOCK, N, _case, _pin, _sorted, _t
from tests.test_torch_wordcount import CHUNK, DATA

_I32 = (-2 ** 31, 2 ** 31 - 1)


def _jspan(a, b):
    return jnp.stack([a[..., 0] + b[..., 0], jnp.minimum(a[..., 1], b[..., 1]),
                      jnp.maximum(a[..., 2], b[..., 2])], axis=-1)


def _jsum_min_or(a, b):  # tests/test_fused_engine.py's _stack_op
    return jnp.stack([a[..., 0] + b[..., 0], jnp.minimum(a[..., 1], b[..., 1]),
                      jnp.bitwise_or(a[..., 2], b[..., 2])], axis=-1)


def _jmax_add(a, b):  # tests/test_segscan.py's 2-lane op
    return jnp.stack([jnp.maximum(a[..., 0], b[..., 0]),
                      a[..., 1] + b[..., 1]], axis=-1)


def _jargmin_count(a, b):
    a3, b3 = a[..., 3], b[..., 3]
    count = jnp.where(a3 < b3, a[..., 4],
                      jnp.where(b3 < a3, b[..., 4], a[..., 4] + b[..., 4]))
    return jnp.stack([a[..., 0] * b[..., 0], a[..., 1] & b[..., 1],
                      a[..., 2] ^ b[..., 2], jnp.minimum(a3, b3), count],
                     axis=-1)


def _jaffine(a, b):
    return jnp.stack([a[..., 0] * b[..., 0],
                      a[..., 1] * b[..., 0] + b[..., 1]], axis=-1)


def _jbits(a, b):
    x = [a[..., i] for i in range(8)]
    y = [b[..., i] for i in range(8)]
    return jnp.stack([
        jnp.maximum(x[0] >> 4, y[0] >> 4) << 4,
        ~(~x[1] & ~y[1]) & 0x7FFFFFF0,
        jnp.where((x[2] != 0) | (y[2] != 0), 1, x[2]),
        jnp.where((x[3] < 0) ^ (y[3] < 0), -1, x[3] & 0),
        jnp.where(~((x[4] >= 0) & (y[4] >= 0)), -8, x[4] & 0),
        jnp.where(x[5] <= y[5], x[5], y[5]),
        -((-x[6]) - y[6]),
        jnp.where(x[7] == y[7], x[7], jnp.where(x[7] > y[7], x[7], y[7]))],
        axis=-1)


#: name -> the JAX twin of monoids.MONOIDS[name]
JAX_TWINS = {"span": _jspan, "sum_min_or": _jsum_min_or,
             "max_add": _jmax_add, "xor": jnp.bitwise_xor,
             "argmin_count": _jargmin_count, "affine": _jaffine,
             "bits": _jbits}


#: node kinds beyond the named monoids: (op, lanes)
EXTRA = monoids.NODE_CASES


#: the monoids that never read a lane: one program for every lane
LANE_WISE = {"xor", "lane-wise add, 4 lanes", "lane-wise lambda, 1 lane",
             "the right operand", "methods"}


def _ints(rng, shape):
    x = rng.integers(*_I32, size=shape, endpoint=True).astype(np.int32)
    flat = x.reshape(-1)
    flat[:6] = [_I32[0], _I32[1], _I32[0], -1, 0, _I32[1]]
    return torch.from_numpy(x)


@pytest.mark.parametrize("name", sorted(monoids.MONOIDS) + sorted(EXTRA))
def test_evaluate_equals_the_callable_bit_for_bit(name):
    op, lanes = (monoids.MONOIDS.get(name) or EXTRA[name])
    rng = np.random.default_rng(len(name))
    shape = (4096,) if lanes == 1 else (4096, lanes)
    a, b = _ints(rng, shape), _ints(rng, shape)
    ir = monoid.lower(op)
    assert ir.lanes == (None if name in LANE_WISE else lanes)
    got, want = monoid.evaluate(ir, a, b), op(a, b)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    assert monoid.lower(op) is ir  # cached per callable


def test_emit_cuda_is_deterministic_and_keyed_by_the_body():
    texts = {n: monoid.emit_cuda(monoid.lower(op))
             for n, (op, _) in monoids.MONOIDS.items()}
    hashes = {n: monoid.ir_hash(monoid.lower(op))
              for n, (op, _) in monoids.MONOIDS.items()}
    assert len(set(hashes.values())) == len(hashes)  # two bodies, two keys
    for n, (op, _) in monoids.MONOIDS.items():
        fresh = monoid._Lowering(op, monoid._trace(op)).run()
        assert monoid.emit_cuda(fresh) == texts[n]
        assert monoid.ir_hash(fresh) == hashes[n]
    # one body under two names (two lambdas, the engine's and wordspan's)
    one = lambda a, b: a + b  # noqa: E731
    two = lambda a, b: a + b  # noqa: E731
    assert monoid.ir_hash(monoid.lower(one)) == \
        monoid.ir_hash(monoid.lower(two))
    assert kc.monoid_library(monoid.lower(tws.SPAN_REDUCE_OP)) == \
        kc.monoid_library(monoid.lower(twc.VERIFY_REDUCE_OP)) == \
        kc.monoid_library(monoid.lower(monoids.span))
    text = texts["argmin_count"]
    assert "static_cast<uint32_t>" in text and "kLanes = 5" in text
    assert "kLanes = 0" in texts["xor"]  # lane-wise: every lane count


@pytest.mark.parametrize("op,what", [
    (lambda a, b: torch.gcd(a, b), "gcd"),
    (lambda a, b: a.sum(-1), "sum"),
    (lambda a, b: a.to(torch.float64), "float64"),
    (lambda a, b: a.to(torch.int64), "outside the lowering"),
    (lambda a, b: a << 32, "shift by 32"),
    (lambda a, b: a if bool((a > b).all()) else b, "control flow"),
    (lambda a, b: torch.where(a < b, 1, 2), "where over"),
    (lambda a, b: a < b, "bool, not int32"),
    (lambda a, b: a + b[..., 0], "whole value combined"),
    (lambda a, b: a[..., 0] + b[..., 0], "result of one lane"),
    (lambda a, b: torch.stack([a[..., 0]], dim=-1), "stack of one lane"),
    (lambda a, b: a + 2 ** 31, "outside int32"),
    (lambda a, b: torch.stack([a[..., i] for i in range(9)], dim=-1),
     "at most 8"),
])
def test_unsupported_node_raises_naming_it(op, what):
    with pytest.raises(NotImplementedError, match=what) as err:
        monoid.lower(op)
    assert "test_torch_monoid.py" in str(err.value) or "at most" in what


def test_lane_counts_are_checked():
    monoid.check_lanes(monoid.lower(torch.bitwise_xor), 8)
    with pytest.raises(NotImplementedError, match="1 to 8"):
        monoid.check_lanes(monoid.lower(torch.bitwise_xor), 9)
    with pytest.raises(ValueError, match="returns 3 lanes"):
        monoid.check_lanes(monoid.lower(monoids.span), 2)


# -- op level against the JAX package -----------------------------------------

def _lanes_of(vals):
    return [vals] if vals.ndim == 1 else [vals[:, i]
                                          for i in range(vals.shape[1])]


@pytest.mark.parametrize("name", sorted(monoids.MONOIDS))
def test_segment_reduce_matches_pallas_and_lax(name):
    op, lanes = monoids.MONOIDS[name]
    keys, vals, _, valid = _case(21 + lanes, key_range=9, lanes=lanes)
    k1, k2, vl = _sorted(keys, valid, vals)
    jl = [jnp.asarray(v) for v in vl]
    refs = [jseg._segment_reduce_pallas(jnp.asarray(k1), jnp.asarray(k2),
                                        jl, JAX_TWINS[name], False, BLOCK,
                                        True),
            jseg._segment_reduce_lax(jnp.asarray(k1), jnp.asarray(k2), jl,
                                     JAX_TWINS[name], False)]
    kc.reset_counts()
    t_red, t_csum = tseg.segment_reduce(_t(k1), _t(k2), [_t(v) for v in vl],
                                        op, False)
    assert kc.PLAIN_CALLS["segreduce_monoid"] == 1
    assert kc.PLAIN_CALLS["segreduce"] == 0
    ends = tseg._run_flags(_t(k1), _t(k2))[2].numpy()
    assert ends.any()
    for j_red, j_csum in refs:
        assert np.array_equal(t_csum.numpy(), np.asarray(j_csum))
        assert len(t_red) == len(j_red) == lanes
        for t, j in zip(t_red, j_red):
            assert np.array_equal(t.numpy()[ends], np.asarray(j)[ends])


@pytest.mark.parametrize("impl", ["pallas", "lax"])
@pytest.mark.parametrize("name", sorted(monoids.MONOIDS))
def test_sorted_unique_reduce_matches_jax(name, impl):
    op, lanes = monoids.MONOIDS[name]
    for seed, cap in ((31, 512), (32, 16)):
        keys, vals, pay, valid = _case(seed, key_range=40, lanes=lanes)
        ref = jseg.sorted_unique_reduce(
            jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(pay),
            jnp.asarray(valid), cap, JAX_TWINS[name], segment_impl=impl,
            segment_block=BLOCK, interpret=True)
        port = tseg.sorted_unique_reduce(_t(keys), _t(vals), _t(pay),
                                         _t(valid), cap, op)
        _pin(port, ref, (name, impl, seed))


@pytest.mark.parametrize("name", sorted(monoids.CODES))
def test_callable_equals_its_codes(name):
    op, lanes = monoids.MONOIDS[name]
    keys, vals, pay, valid = _case(41, key_range=30, lanes=lanes)
    a = tseg.sorted_unique_reduce(_t(keys), _t(vals), _t(pay), _t(valid),
                                  N, op)
    b = tseg.sorted_unique_reduce(_t(keys), _t(vals), _t(pay), _t(valid),
                                  N, monoids.CODES[name])
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# -- engine and session level ---------------------------------------------------

def _three_lane_map_jax(chunk, chunk_index, cfg):
    """Records from the chunk's values only: keys (c % 23, c % 5), three
    value lanes for (sum, min, bitwise_or), payload a function of the
    key."""
    k1 = (chunk % 23).astype(jnp.uint32)
    k2 = (chunk % 5).astype(jnp.uint32)
    vals = jnp.stack([chunk % 101 + 1, chunk * 7919 - 40_000,
                      chunk & 0x5A5], axis=-1).astype(jnp.int32)
    pay = (k1 * 7 + k2).astype(jnp.int32)[:, None]
    return (jnp.stack([k1, k2], axis=-1), vals, pay, (chunk % 7) != 0,
            jnp.int32(0))


def _three_lane_map(chunk, chunk_index, cfg):
    """The torch twin of :func:`_three_lane_map_jax`."""
    c = chunk.to(torch.int64)
    k1 = (c % 23).to(torch.int32)
    k2 = (c % 5).to(torch.int32)
    vals = torch.stack([c % 101 + 1, c * 7919 - 40_000, c & 0x5A5],
                       dim=-1).to(torch.int32)
    return (torch.stack([k1, k2], dim=-1), vals, (k1 * 7 + k2)[:, None],
            (c % 7) != 0, torch.zeros((), dtype=torch.int32))


def _host_oracle(chunks):
    out = {}
    for c in chunks.reshape(-1).tolist():
        if c % 7 == 0:
            continue
        key = (c % 23, c % 5)
        v = [c % 101 + 1, c * 7919 - 40_000, c & 0x5A5]
        if key in out:
            o = out[key]
            v = [o[0] + v[0], min(o[1], v[1]), o[2] | v[2]]
        out[key] = v
    return out


def _as_dict(res):
    keys, vals, _, valid, _ = convert.device_result_to_numpy(res)
    return {(int(k[0]), int(k[1])): [int(x) for x in v]
            for k, v, ok in zip(keys.reshape(-1, 2), vals.reshape(-1, 3),
                                valid.reshape(-1)) if ok}


def _pin_result(port, jax_res):
    ref = convert.device_result_from_numpy(*jax_res)
    for f in ("keys", "values", "payload", "valid"):
        assert torch.equal(getattr(port, f), getattr(ref, f)), f
    assert port.overflow == ref.overflow


JCFG = jde.EngineConfig(local_capacity=64, exchange_capacity=32,
                        out_capacity=64, tile=64, tile_records=64,
                        reduce_op=_jsum_min_or)


def _port_cfg(jcfg, **over):
    fields = dataclasses.asdict(dataclasses.replace(jcfg, reduce_op="sum"))
    return dataclasses.replace(convert.engine_config_from_jax(fields),
                               reduce_op=monoids.sum_min_or, **over)


def _chunks(seed, s, r=32):
    return np.random.default_rng(seed).integers(
        0, 1 << 14, size=(s, r)).astype(np.int32)


@pytest.mark.parametrize("combine", [False, True])
@pytest.mark.parametrize("P", [1, 8])
def test_engine_matches_the_jax_lax_engine(P, combine):
    """A run with absurd capacities that retries, with and without the
    in-scan combiner, equals the JAX lax engine's bits and the host."""
    chunks = _chunks(5, 4 * P)
    jcfg = dataclasses.replace(JCFG, combine_in_scan=combine,
                               local_capacity=8, exchange_capacity=4,
                               out_capacity=8)
    jres = jde.DeviceEngine(make_mesh(n_data=P), _three_lane_map_jax,
                            jcfg).run(chunks, waves=2)
    kc.reset_counts()
    tm = {}
    res = tde.DeviceEngine(Partitions(P, "cpu"), _three_lane_map,
                           _port_cfg(jcfg)).run(chunks, waves=2, timings=tm)
    _pin_result(res, jres)
    assert _as_dict(res) == _host_oracle(chunks)
    assert tm["retries"] >= 1
    assert kc.PLAIN_CALLS["segreduce_monoid"] > 0


@pytest.mark.parametrize("P", [1, 8])
def test_session_matches_the_jax_lax_session(P):
    """Two tenants fed in turn: after each feed the fed tenant's snapshot
    is the JAX session's and the host reduction of its records."""
    jcfg = dataclasses.replace(JCFG, local_capacity=256,
                               exchange_capacity=128, out_capacity=256)
    js = jsession.EngineSession(make_mesh(n_data=P), _three_lane_map_jax,
                                jcfg, k=2)
    ts = tsession.EngineSession(Partitions(P, "cpu"), _three_lane_map,
                                _port_cfg(jcfg), k=2)
    streams = {t: _chunks(10 + i, 6 * P) for i, t in enumerate("ab")}
    for lo, hi in ((0, 2 * P + 1), (2 * P + 1, 6 * P)):
        for t, stream in streams.items():
            fed = stream[lo:hi]
            assert ts.feed(fed, task=t) == js.feed(fed, task=t) == 0
            snap = ts.snapshot(t)
            _pin_result(snap, js.snapshot(t))
            assert _as_dict(snap) == _host_oracle(stream[:hi])


def _outside(a, b):
    """A monoid the lowering does not take (``torch.gcd``, the binary
    ``torch.max``, a bool ``logical_or`` cast back): the CPU runs it
    through the plain ladder all the same."""
    return torch.stack([
        torch.gcd(a[..., 0], b[..., 0]), torch.max(a[..., 1], b[..., 1]),
        torch.logical_or(a[..., 2] != 0, b[..., 2] != 0).to(torch.int32)],
        dim=-1)


def _joutside(a, b):
    return jnp.stack([
        jnp.gcd(a[..., 0], b[..., 0]), jnp.maximum(a[..., 1], b[..., 1]),
        jnp.logical_or(a[..., 2] != 0, b[..., 2] != 0).astype(jnp.int32)],
        axis=-1)


def _outside_oracle(chunks):
    import math

    out = {}
    for c in chunks.reshape(-1).tolist():
        if c % 7 == 0:
            continue
        key = (c % 23, c % 5)
        v = [c % 101 + 1, c * 7919 - 40_000, c & 0x5A5]
        if key in out:
            o = out[key]
            v = [math.gcd(o[0], v[0]), max(o[1], v[1]),
                 int(o[2] != 0 or v[2] != 0)]
        out[key] = v
    return out


def test_outside_monoid_is_refused_by_the_lowering():
    with pytest.raises(NotImplementedError, match="gcd"):
        monoid.lower(_outside)


@pytest.mark.parametrize("sort_impl", ["variadic", "tiered"])
@pytest.mark.parametrize("P", [1, 8])
def test_engine_on_the_cpu_runs_a_monoid_outside_the_lowering(P, sort_impl):
    """A CPU engine names no monoid library, so a callable the lowering
    does not take builds, precompiles and runs through the plain ladder,
    equal to the JAX lax engine and the host."""
    chunks = _chunks(6, 4 * P)
    jcfg = dataclasses.replace(JCFG, reduce_op=_joutside, local_capacity=8,
                               exchange_capacity=4, out_capacity=8)
    jres = jde.DeviceEngine(make_mesh(n_data=P), _three_lane_map_jax,
                            jcfg).run(chunks, waves=2)
    cfg = dataclasses.replace(_port_cfg(jcfg), reduce_op=_outside,
                              sort_impl=sort_impl)
    assert kc.sources_for(cfg, "cpu")[:2] == ("tokenize", "segreduce")
    eng = tde.DeviceEngine(Partitions(P, "cpu"), _three_lane_map, cfg)
    assert eng._libraries(cfg) == ("tokenize", "segreduce")
    eng.precompile(chunks.shape[1:], chunks.dtype)
    kc.reset_counts()
    tm = {}
    res = eng.run(chunks, waves=2, timings=tm)
    _pin_result(res, jres)
    assert _as_dict(res) == _outside_oracle(chunks)
    assert tm["retries"] >= 1
    assert kc.PLAIN_CALLS["segreduce_monoid"] > 0


@pytest.mark.parametrize("P", [1, 8])
def test_session_on_the_cpu_runs_a_monoid_outside_the_lowering(P):
    jcfg = dataclasses.replace(JCFG, reduce_op=_joutside,
                               local_capacity=256, exchange_capacity=128,
                               out_capacity=256)
    js = jsession.EngineSession(make_mesh(n_data=P), _three_lane_map_jax,
                                jcfg, k=2)
    ts = tsession.EngineSession(
        Partitions(P, "cpu"), _three_lane_map,
        dataclasses.replace(_port_cfg(jcfg), reduce_op=_outside), k=2)
    stream = _chunks(12, 4 * P)
    for lo, hi in ((0, P + 1), (P + 1, 4 * P)):
        assert ts.feed(stream[lo:hi], task="t") == \
            js.feed(stream[lo:hi], task="t") == 0
        snap = ts.snapshot("t")
        _pin_result(snap, js.snapshot("t"))
        assert _as_dict(snap) == _outside_oracle(stream[:hi])


# -- the verify path and wordspan ------------------------------------------------

def test_verify_path_matches_jax_with_the_callable_and_the_codes():
    cfg = jde.EngineConfig(local_capacity=1 << 12, exchange_capacity=1 << 10,
                           out_capacity=1 << 12, combine_in_scan=True)
    jw = jwc.DeviceWordCount(make_mesh(), chunk_len=CHUNK, config=cfg,
                             verify_collisions=True)
    chunks, L = jw._to_chunks(DATA)
    jres = jw._engine_for(L).run(chunks, waves=3)
    tcfg = convert.engine_config_from_jax(dataclasses.asdict(cfg))
    for op in (twc.VERIFY_REDUCE_OP, ("sum", "min", "max")):
        tw = twc.DeviceWordCount(Partitions(8, "cpu"), chunk_len=CHUNK,
                                 config=tcfg, verify_collisions=True)
        assert tw.config.reduce_op is twc.VERIFY_REDUCE_OP
        tw.config = dataclasses.replace(tw.config, reduce_op=op)
        tchunks, _ = tw._to_chunks(DATA)
        assert np.array_equal(tchunks, chunks)
        _pin_result(tw._engine_for(L).run(tchunks, waves=3), jres)


def test_wordspan_device_map_matches_jax_with_the_callable_and_the_codes():
    """wordspan's map and monoid through both engines at P = 8, at small
    capacities (so both retry)."""
    data = DATA.replace(b"\n", b" ")
    chunks, _ = shard_text(data, 8, pad_multiple=512)
    caps = dict(local_capacity=128, exchange_capacity=64, out_capacity=128)
    jcfg = dataclasses.replace(jws.device_config(), **caps)
    jres = jde.DeviceEngine(make_mesh(), jws.device_map, jcfg).run(
        chunks, waves=1)
    tcfg = dataclasses.replace(tws.device_config(), **caps)
    assert tcfg.reduce_op is tws.SPAN_REDUCE_OP
    for op in (tws.SPAN_REDUCE_OP, ("sum", "min", "max")):
        res = tde.DeviceEngine(Partitions(8, "cpu"), tws.device_map,
                               dataclasses.replace(tcfg, reduce_op=op)).run(
            chunks, waves=1)
        _pin_result(res, jres)


# -- the build plane ---------------------------------------------------------------

def test_sources_for_names_the_monoid_library():
    cfg = tde.EngineConfig(reduce_op=monoids.sum_min_or)
    name = kc.monoid_library(monoid.lower(monoids.sum_min_or))
    i32 = torch.int32  # the map's value dtype types the library
    assert name.startswith("segreduce_monoid-")
    assert kc.sources_for(cfg, None, i32) == ("tokenize", "segreduce", name)
    assert kc.sources_for(dataclasses.replace(cfg, sort_impl="radix"),
                          None, i32) == ("tokenize", "segreduce", name,
                                         "radix")
    # unit values never use the op; codes need no library of their own
    assert kc.sources_for(dataclasses.replace(cfg, unit_values=True),
                          None, i32) == ("tokenize", "segreduce")
    assert kc.sources_for(dataclasses.replace(
        cfg, reduce_op=("sum", "min", "or")), None, i32) == (
        "tokenize", "segreduce")
    assert kc.sources_for(cfg, torch.device("cuda"), i32) == \
        kc.sources_for(cfg, "cuda:0", i32) == kc.sources_for(cfg, None, i32)
    # with no value dtype yet, the typed library is not named
    assert kc.sources_for(cfg) == ("tokenize", "segreduce")
    # the CPU launches no library: the callable is not lowered there
    assert kc.sources_for(cfg, "cpu", i32) == ("tokenize", "segreduce")
    eng = tde.DeviceEngine(Partitions(1, "cpu"), _three_lane_map,
                           dataclasses.replace(cfg, sort_impl="tiered"))
    assert eng._libraries(eng.config) == ("tokenize", "segreduce")
    with pytest.raises(NotImplementedError, match="gcd"):
        kc.sources_for(dataclasses.replace(cfg, reduce_op=torch.gcd), None,
                       i32)
    with pytest.raises(NotImplementedError, match="gcd"):
        monoid.check_lowers(torch.gcd)
    assert kc.sources_for(dataclasses.replace(
        cfg, reduce_op=torch.gcd), "cpu", i32) == ("tokenize", "segreduce")


def test_monoid_library_is_keyed_by_the_ir_and_the_headers(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(compile_cache, "build_dir", lambda: str(tmp_path))
    name = kc.monoid_library(monoid.lower(monoids.affine))
    path = kc._lib_path(name)
    assert path.name.startswith(name) and path.parent == tmp_path
    assert kc._lib_path(kc.monoid_library(monoid.lower(
        lambda a, b: torch.stack([a[..., 0] * b[..., 0],
                                  a[..., 1] * b[..., 0] + b[..., 1]],
                                 dim=-1)))) == path
    src = kc.monoid_source(monoid.lower(monoids.affine))
    assert '#include "segreduce.cuh"' in src
    assert "MR_MONOID_ENTRIES(MrUserCombine)" in src
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in kc.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kc, "CSRC", csrc)
    assert kc._lib_path(name) == path
    with open(csrc / "segreduce.cuh", "a") as f:
        f.write("// an edited template\n")
    assert kc._lib_path(name) != path  # an edited template rebuilds
    with pytest.raises(KeyError, match="monoid_library names"):
        kc._source_bytes("segreduce_monoid-0000000000000000")


def test_monoid_build_is_its_own_ledger_program(monkeypatch, tmp_path):
    """A monoid library's first load is ``compiled``; in a process that
    finds its ``.so`` it is a ``persistent_hit`` (nvcc and the loader
    faked here: the card builds them)."""
    ledger = tcompile.CompileLedger()
    monkeypatch.setattr(kc, "LEDGER", ledger)
    monkeypatch.setattr(compile_cache, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(kc, "_LIBS", {})
    monkeypatch.setattr(kc, "BUILD_SECONDS", {})
    name = kc.monoid_library(monoid.lower(monoids.argmin_count))

    def start(n, defines=()):
        return "proc"

    def finish(n, proc, defines=()):
        kc.BUILD_SECONDS[n] = 1.5
        kc._lib_path(n).write_bytes(b"")

    class FakeLib:
        def __init__(self, path):
            self.mr_segreduce_monoid = lambda *a: 0
            self.mr_segreduce_monoid_scratch_bytes = lambda *a: 0

    monkeypatch.setattr(kc, "_start_build", start)
    monkeypatch.setattr(kc, "_finish_build", finish)
    monkeypatch.setattr(kc.ctypes, "CDLL", FakeLib)
    kc.load([name])
    program = ledger.snapshot()["programs"][f"nvcc:{name}"]
    assert program.get("compiled") == 1
    # a second process: nothing loaded, nothing built by it
    monkeypatch.setattr(kc, "_LIBS", {})
    monkeypatch.setattr(kc, "BUILD_SECONDS", {})
    monkeypatch.setattr(kc, "_finish_build", lambda n, p, d=(): None)
    assert kc.is_built(name)
    kc.load([name])
    program = ledger.snapshot()["programs"][f"nvcc:{name}"]
    assert program.get("persistent_hit") == 1 and program["compiled"] == 1
