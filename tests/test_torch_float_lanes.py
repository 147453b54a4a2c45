"""Float32 value lanes through the port's segmented reduce, held against
the JAX package.

* the fault repro: float32 lanes under "sum" / "min" / "max" (and the
  per-lane codes) through ``DeviceEngine`` at P = 1 and 8, with and
  without the in-scan combiner and through a capacity retry, against
  the JAX lax engine (the port once reduced every named-op lane through
  int64 and wrapped it to int32);
* op level: every float monoid of ``testing/monoids.py`` and the float
  codes through ``segment_reduce`` / ``sorted_unique_reduce`` against
  ``jseg._segment_reduce_lax`` and ``_segment_reduce_pallas`` (interpret
  mode), and against float64 host references;
* the typed lowering: ``evaluate(lower(op, dtype))`` against the
  callable, the promotion rules, the division and cast rules (the plain
  ladder follows them, so a division by zero in rows no run reads does
  not raise), and a typed ``ir_hash``;
* an ``EngineSession`` with float lanes against the JAX lax session
  after every feed, and a float spill restored across both packages.

Tolerances: min, max, int32 lanes, int32 ``//`` and ``%`` and casts of
in-range values are bit-equal.  The plain float sum is the JAX lax
ladder step for step, so it is held bit-equal to it too; against a
float64 sum a run of n rows is held to ``gamma_n * sum|v|``, ``gamma_n =
n u / (1 - n u)``, ``u = 2**-24``.  ``welford``, ``weighted_mean`` and
``logsumexp`` are held to float64 host references within the bound of
their sums plus a few ulp a combine (``monoids.run_reference``).
Inputs are numpy arrays from fixed seeds.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapreduce_tpu.engine import device_engine as jde
from mapreduce_tpu.engine import session as jsession
from mapreduce_tpu.engine import spill as jspill
from mapreduce_tpu.ops import segscan as jseg
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu.storage.router import router as jopen
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.engine import device_engine as tde
from mapreduce_tpu_torch.engine import session as tsession
from mapreduce_tpu_torch.engine import spill as tspill
from mapreduce_tpu_torch.ops import kernel_compat as kc
from mapreduce_tpu_torch.ops import monoid
from mapreduce_tpu_torch.ops import segscan as tseg
from mapreduce_tpu_torch.parallel.mesh import Partitions
from mapreduce_tpu_torch.storage.router import router as topen
from mapreduce_tpu_torch.testing import monoids
from tests.test_torch_segscan import BLOCK, N, _sorted, _t
from tests.test_torch_session import assert_snap_equal, jax_cfg, port_cfg

CODES = ("sum", "min", "max")


def _jfsum_min_max(a, b):
    return jnp.stack([a[..., 0] + b[..., 0], jnp.minimum(a[..., 1], b[..., 1]),
                      jnp.maximum(a[..., 2], b[..., 2])], axis=-1)


# -- engine level: the fault repro -------------------------------------------

def _float_map_jax(chunk, chunk_index, cfg):
    """Records from the chunk's values: keys (c % 23, c % 5), three
    float32 lanes with full mantissas and both signs, payload a function
    of the key.  Each lane is one rounding of an integer's product by a
    constant: nothing for XLA to contract into a fused multiply-add in
    the jitted map, so it gives the eager bits."""
    c = chunk
    k1 = (c % 23).astype(jnp.uint32)
    k2 = (c % 5).astype(jnp.uint32)
    a = ((c * 7919) % 100003 - 50000).astype(jnp.float32) * jnp.float32(1e-3)
    b = (c % 1000).astype(jnp.float32) * jnp.float32(-0.37)
    e = ((c * 104729) % 65521 - 30000).astype(jnp.float32) * jnp.float32(
        0.0123)
    vals = jnp.stack([a, b, e], axis=-1)
    pay = (k1 * 7 + k2).astype(jnp.int32)[:, None]
    return (jnp.stack([k1, k2], axis=-1), vals, pay, (c % 7) != 0,
            jnp.int32(0))


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _float_map(chunk, chunk_index, cfg):
    """The torch twin of :func:`_float_map_jax` (constants as float32
    tensors, as JAX's are)."""
    c = chunk.to(torch.int64)
    k1 = (c % 23).to(torch.int32)
    k2 = (c % 5).to(torch.int32)
    a = ((c * 7919) % 100003 - 50000).to(torch.float32) * _f32(1e-3)
    b = (c % 1000).to(torch.float32) * _f32(-0.37)
    e = ((c * 104729) % 65521 - 30000).to(torch.float32) * _f32(0.0123)
    vals = torch.stack([a, b, e], dim=-1)
    return (torch.stack([k1, k2], dim=-1), vals, (k1 * 7 + k2)[:, None],
            (c % 7) != 0, torch.zeros((), dtype=torch.int32))


def _float_host(chunks, op):
    """``{(k1, k2): (float64 [3] results, float64 [3] sums of |v|, rows)}``
    of the map's records under *op* (a name or the codes), in float64."""
    c = chunks.reshape(-1).astype(np.int64)
    c = c[c % 7 != 0]
    a = ((c * 7919) % 100003 - 50000).astype(np.float32) * np.float32(1e-3)
    b = (c % 1000).astype(np.float32) * np.float32(-0.37)
    e = ((c * 104729) % 65521 - 30000).astype(np.float32) * np.float32(0.0123)
    vals = np.stack([a, b, e], axis=-1).astype(np.float64)
    ops = (op,) * 3 if isinstance(op, str) else op
    fold = {"sum": np.add, "min": np.minimum, "max": np.maximum}
    out = {}
    for key, v in zip(zip((c % 23).tolist(), (c % 5).tolist()), vals):
        if key in out:
            o, m, n = out[key]
            out[key] = (np.array([fold[f](x, y) for f, x, y in
                                  zip(ops, o, v)]), m + np.abs(v), n + 1)
        else:
            out[key] = (v, np.abs(v), 1)
    return out


def _assert_host(port, chunks, op):
    """Sums within ``gamma_n * sum|v|`` of the float64 sum; min and max
    exactly the float32 host values."""
    got, want = _as_lists(port), _float_host(chunks, op)
    assert sorted(got) == sorted(want)
    ops = (op,) * 3 if isinstance(op, str) else op
    for key, (w, mag, n) in want.items():
        for f, g, x, m in zip(ops, got[key], w, mag):
            if f == "sum":
                assert abs(float(g) - x) <= monoids.gamma(n) * m, (key, g, x)
            else:
                assert float(g) == x, (key, f, g, x)


def _as_lists(res):
    keys, vals, _, valid, _ = convert.device_result_to_numpy(res)
    d = vals.shape[-1]
    return {(int(k[0]), int(k[1])): v for k, v, ok in zip(
        keys.reshape(-1, 2), vals.reshape(-1, d), valid.reshape(-1)) if ok}


def _assert_result_bits(port, jax_res, lanes):
    """Every field of the port's ``DeviceResult`` equal to the JAX one's
    arrays, the float values of *lanes* bit for bit (dtype included)."""
    keys, vals, pay, valid, oflow = jax_res
    assert port.values.dtype == torch.float32
    assert np.array_equal(port.keys.numpy().view(np.uint32), np.asarray(keys))
    jv = np.asarray(vals)
    assert jv.dtype == np.float32 and len(lanes) > 0
    assert np.array_equal(port.values.numpy()[..., lanes].view(np.int32),
                          jv[..., lanes].view(np.int32))
    assert np.array_equal(port.payload.numpy(), np.asarray(pay))
    assert np.array_equal(port.valid.numpy(), np.asarray(valid))
    assert port.overflow == int(oflow)


def _chunks(seed, s, r=32):
    return np.random.default_rng(seed).integers(
        0, 1 << 14, size=(s, r)).astype(np.int32)


JCFG = jde.EngineConfig(local_capacity=8, exchange_capacity=4,
                        out_capacity=8, tile=64, tile_records=64,
                        reduce_op="sum")


@functools.lru_cache(maxsize=None)
def _jax_engine(P, combine):
    """``(config, retries, result)`` of the JAX lax engine over
    ``_chunks(25, 4 * P)`` in two waves, under the codes' twin ``[sum,
    min, max]``: one run of each width, shared by the cases (each lane
    is reduced alone, so a lane's bits are those of its op named for
    every lane).  :data:`JCFG`'s capacities force a retry at P = 8;
    at P = 1 they fit."""
    jcfg = dataclasses.replace(JCFG, reduce_op=_jfsum_min_max,
                               combine_in_scan=combine)
    if P == 1:
        jcfg = dataclasses.replace(jcfg, local_capacity=256,
                                   exchange_capacity=128, out_capacity=512)
    tm = {}
    res = jde.DeviceEngine(make_mesh(n_data=P), _float_map_jax, jcfg).run(
        _chunks(25, 4 * P), waves=2, timings=tm)
    return jcfg, tm["retries"], res


#: (port op, P, combine_in_scan): each named op and the codes, at both
#: widths, the combiner off at P = 1 and on at P = 8
ENGINE_CASES = [("sum", 1, False), ("min", 8, True), ("max", 1, False),
                (CODES, 8, True)]


@pytest.mark.parametrize("op,P,combine", ENGINE_CASES)
def test_engine_float_lanes_match_the_jax_lax_engine(op, P, combine):
    """The port's float32 results (a capacity retry at P = 8, as JAX's)
    are the JAX lax engine's bit for bit (float32 values, not int32) in
    each lane the two reduce under one op, and within ``gamma_n *
    sum|v|`` of the float64 host sums (min and max: the host's) in
    every lane."""
    chunks = _chunks(25, 4 * P)
    jcfg, retries, jres = _jax_engine(P, combine)
    fields = dataclasses.asdict(dataclasses.replace(jcfg, reduce_op="sum"))
    cfg = dataclasses.replace(convert.engine_config_from_jax(fields),
                              reduce_op=op)
    kc.reset_counts()
    tm = {}
    res = tde.DeviceEngine(Partitions(P, "cpu"), _float_map, cfg).run(
        chunks, waves=2, timings=tm)
    assert tm["retries"] == retries and (retries >= 1) == (P == 8)
    ops = (op,) * 3 if isinstance(op, str) else op
    _assert_result_bits(res, jres, [d for d in range(3)
                                    if ops[d] == CODES[d]])
    _assert_host(res, chunks, op)
    assert kc.PLAIN_CALLS["segreduce"] > 0


# -- sessions and spills --------------------------------------------------------


def test_session_float_lanes_match_jax_and_spills_cross_both_ways(tmp_path):
    """A float32 "sum" stream (P = 8, k = 1) in the port's session and
    the JAX lax session: bit-equal after every feed (two uneven feeds).
    Then each package spills its half-stream, the other restores it and
    feeds the second half: the two restored streams are bit-equal to each
    other and to the port's stream that was fed alike and never
    stopped, and within
    ``gamma_n * sum|v|`` of the float64 host sums."""
    P, half = 8, 16
    chunks = _chunks(26, 2 * half)
    jcfg = jax_cfg()
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    mesh = make_mesh(n_data=P)

    def port(where=None):
        store = where and tspill.SessionSpillStore(topen(f"shared:{where}"))
        return tsession.EngineSession(Partitions(P, "cpu"), _float_map,
                                      port_cfg(jcfg), k=1, spill=store)

    def jax(where):
        return jsession.EngineSession(
            mesh, _float_map_jax, jcfg, k=1,
            spill=jspill.SessionSpillStore(jopen(f"shared:{where}")))

    js, ts = jax(jdir), port(tdir)
    for lo, hi in ((0, P + 3), (P + 3, half)):
        assert ts.feed(chunks[lo:hi]) == js.feed(chunks[lo:hi]) == 0
        snap = ts.snapshot()
        assert snap.values.dtype == torch.float32
        assert_snap_equal(snap, js.snapshot())
    assert js.evict() == ts.evict() == 2  # the spill step: two feeds
    js.close(drop_spill=False)
    ts.close(drop_spill=False)
    t2, j2 = port(jdir), jax(tdir)  # each restores the other's spill
    t2.feed(chunks[half:])
    j2.feed(chunks[half:])
    whole = port()  # the same feeds: float sums fold wave by wave
    for lo, hi in ((0, P + 3), (P + 3, half), (half, 2 * half)):
        whole.feed(chunks[lo:hi])
    got, ref = t2.snapshot(), whole.snapshot()
    assert_snap_equal(got, j2.snapshot())
    assert torch.equal(got.values.view(torch.int32),
                       ref.values.view(torch.int32))
    _assert_host(got, chunks, "sum")


# -- op level against the JAX package -------------------------------------------


def _jwelford(a, b):
    na, ma, qa = a[..., 0], a[..., 1], a[..., 2]
    nb, mb, qb = b[..., 0], b[..., 1], b[..., 2]
    n = na + nb
    d = mb - ma
    return jnp.stack([n, ma + d * (nb / n), qa + qb + d * d * (na * nb / n)],
                     axis=-1)


def _jweighted_mean(a, b):
    w = a[..., 0] + b[..., 0]
    return jnp.stack([w, a[..., 1] + (b[..., 1] - a[..., 1])
                      * (b[..., 0] / w)], axis=-1)


def _jlogsumexp(a, b):
    m = jnp.maximum(a[..., 0], b[..., 0])
    return jnp.stack([m, a[..., 1] * jnp.exp(a[..., 0] - m)
                      + b[..., 1] * jnp.exp(b[..., 0] - m)], axis=-1)


#: name -> the JAX twin of monoids.TYPED_MONOIDS[name]
JAX_TWINS = {"fsum_min_max": _jfsum_min_max, "welford": _jwelford,
             "weighted_mean": _jweighted_mean, "logsumexp": _jlogsumexp,
             "modsum": lambda a, b: (a + b) % monoids.MOD,
             "cast_sum": lambda a, b: (a.astype(jnp.float32)
                                       + b.astype(jnp.float32))}
#: the monoids whose port ladder gives the JAX lax ladder's bits on the
#: CPU (log-sum-exp's ``exp`` is torch's in one and XLA's in the other)
LAX_BIT_EQUAL = {"fsum_min_max", "welford", "weighted_mean", "modsum",
                 "cast_sum"}


def _typed_case(name, seed, key_range=9):
    """Sorted lanes of N rows (about N / key_range rows a run, a fifth
    invalid): k1, k2 as uint32 numpy and the value lanes."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_range, size=(N, 2)).astype(np.uint32)
    valid = rng.random(N) < 0.8
    rows = monoids.typed_rows(name, rng, N)
    k1, k2, lanes = _sorted(keys, valid, rows)
    return k1, k2, lanes


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _runs(k1, k2):
    """Each run's ``(first, end)`` rows (end inclusive) of sorted lanes."""
    _, is_start, is_end = tseg._run_flags(_t(k1), _t(k2))
    return list(zip(np.flatnonzero(is_start.numpy()),
                    np.flatnonzero(is_end.numpy())))


def _reference(name, k1, k2, lanes):
    """``monoids.run_reference`` of sorted lanes: each run's float64 fold
    and bound, as numpy ``[runs, lanes]``."""
    valid, is_start, _ = tseg._run_flags(_t(k1), _t(k2))
    run = (torch.cumsum(is_start.to(torch.int64), 0) - 1)[valid]
    rows = torch.from_numpy(np.stack(lanes, axis=-1))[valid]
    ref, tol = monoids.run_reference(name, rows, run, int(is_start.sum()))
    return ref.numpy(), tol.numpy()


@pytest.mark.parametrize("name", sorted(monoids.TYPED_MONOIDS))
def test_typed_monoid_matches_jax_lax_pallas_and_the_host(name):
    """Each typed monoid's plain ladder against the JAX lax ladder (bit
    for bit where both compute the same functions) and the float64 host
    fold, within the bounds of :func:`monoids.run_reference`; where the
    lax ladder is not held to bits (``logsumexp``), against the Pallas
    kernel in interpret mode too (its sums associate otherwise).  The
    lax ladder that gives the port's bits stands for both JAX paths
    elsewhere: the Pallas kernel's agreement with it is the JAX
    package's own test."""
    op, lanes_n, _ = monoids.TYPED_MONOIDS[name]
    k1, k2, lanes = _typed_case(name, 40 + lanes_n)
    jl = [jnp.asarray(v) for v in lanes]
    jk1, jk2 = jnp.asarray(k1), jnp.asarray(k2)
    paths = [jseg._segment_reduce_lax(jk1, jk2, jl, JAX_TWINS[name], False)]
    if name not in LAX_BIT_EQUAL:
        paths.append(jseg._segment_reduce_pallas(
            jk1, jk2, jl, JAX_TWINS[name], False, BLOCK, True))
    t_red, t_csum = tseg.segment_reduce(_t(k1), _t(k2),
                                        [_t(v) for v in lanes], op, False)
    for _, j_csum in paths:
        assert np.array_equal(t_csum.numpy(), np.asarray(j_csum))
    ends = np.array([e for _, e in _runs(k1, k2)])
    ref, tol = _reference(name, k1, k2, lanes)
    for lane, t in enumerate(t_red):
        t = t.numpy()[ends]
        js = [np.asarray(red[lane])[ends] for red, _ in paths]
        assert all(t.dtype == j.dtype for j in js)
        if name in LAX_BIT_EQUAL:
            assert np.array_equal(_bits(t), _bits(js[0])), (name, lane)
        for got in [t] + js:
            err = np.abs(got.astype(np.float64) - ref[:, lane])
            assert (err <= tol[:, lane]).all(), (name, lane, err.max())


def _float_lanes(seed, lanes, specials=True):
    """Sorted keys (about 9 rows a run) and float32 lanes with both
    signs; with *specials*, some runs hold NaN, and some only -0.0 and
    +0.0 (so a min, a max and a sum of zeros decide a sign)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 40, size=(N, 2)).astype(np.uint32)
    valid = rng.random(N) < 0.8
    vals = (rng.standard_normal((N, lanes)) * 1e3).astype(np.float32)
    if specials:
        zero = (keys[:, 0] % 7 == 3)[:, None]
        vals = np.where(zero, np.where(rng.random((N, lanes)) < 0.5,
                                       np.float32(-0.0), np.float32(0.0)),
                        vals)
        vals[(keys[:, 0] % 11 == 5) & (rng.random(N) < 0.3)] = np.nan
    return _sorted(keys, valid, vals if lanes > 1 else vals[:, 0])


def _same(a, b):
    """Bit-equal, except that any NaN equals any NaN (a sum's NaN takes
    another payload on another machine)."""
    a, b = np.asarray(a), np.asarray(b)
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) and np.array_equal(
        a[~nan].view(np.int32), b[~nan].view(np.int32))


@pytest.mark.parametrize("op", ["sum", "min", "max", CODES])
def test_float_codes_match_jax_with_nan_and_signed_zeros(op):
    """Float32 named ops: the plain version is the JAX lax ladder's bits
    (NaN propagating, -0.0 below +0.0 for min and max, a run of zeros
    summing to -0.0 only when all are -0.0); under the codes (each op
    on a lane), the Pallas kernel's min and max too, its sums within
    ``gamma_n * sum|v|``."""
    lanes = 3 if isinstance(op, tuple) else 1
    k1, k2, vl = _float_lanes(50 + lanes, lanes)
    jop = {"sum": jnp.add, "min": jnp.minimum, "max": jnp.maximum}.get(
        op, _jfsum_min_max)
    jl = [jnp.asarray(v) for v in vl]
    jk1, jk2 = jnp.asarray(k1), jnp.asarray(k2)
    lax_red, _ = jseg._segment_reduce_lax(jk1, jk2, jl, jop, False)
    pal_red = (jseg._segment_reduce_pallas(jk1, jk2, jl, jop, False, BLOCK,
                                           True)[0]
               if lanes == 3 else [None])
    t_red, _ = tseg.segment_reduce(_t(k1), _t(k2), [_t(v) for v in vl], op,
                                   False)
    runs = _runs(k1, k2)
    ends = np.array([e for _, e in runs])
    ops = (op,) * lanes if isinstance(op, str) else op
    seen = {"nan": 0, "-0": 0, "+0": 0}
    for f, v, t, jl_, jp in zip(ops, vl, t_red, lax_red, pal_red):
        t = t.numpy()[ends]
        assert t.dtype == np.float32
        assert _same(t, np.asarray(jl_)[ends]), f
        got = [t]
        if jp is not None:
            got.append(np.asarray(jp)[ends])
            if f != "sum":
                assert _same(t, got[1]), f
        for i, (first, end) in enumerate(runs):
            run = v[first:end + 1].astype(np.float64)
            if np.isnan(run).any():
                assert all(np.isnan(g[i]) for g in got)
                seen["nan"] += 1
                continue
            if f == "sum":
                want, tol = run.sum(), monoids.gamma(len(run)) * np.abs(
                    run).sum()
                assert all(abs(float(g[i]) - want) <= tol for g in got)
            if not run.any():  # zeros alone: the sign is decided
                neg = np.signbit(run)
                want_neg = {"sum": neg.all(), "min": neg.any(),
                            "max": neg.all()}[f]
                assert np.signbit(t[i]) == want_neg, (f, run)
                seen["-0" if want_neg else "+0"] += 1
    assert all(seen.values()), seen


def test_named_ops_split_into_groups_the_codes_kernel_takes(monkeypatch):
    """More lanes than one launch of the codes kernel takes: groups of
    at most 3 lanes, ``end_csum`` from the first, the lanes equal to the
    plain version's (the launch faked by the plain version on the CPU,
    the wrapper's own grouping under test)."""
    k1, k2, vl = _float_lanes(61, 7, specials=False)
    k1, k2, vl = _t(k1), _t(k2), [_t(v) for v in vl]
    ops = ("sum", "min", "max", "max", "sum", "min", "sum")
    launches = []

    def fake(k1s, k2s, vals, codes, unit):
        launches.append((vals.shape[1], list(codes), vals.dtype))
        names = [{c: n for n, c in tseg._OP_CODES.items()}[c] for c in codes]
        return tseg._segment_reduce_plain(
            k1s, k2s, [vals[:, i] for i in range(vals.shape[1])],
            tuple(names), unit)

    monkeypatch.setattr(tseg, "_segment_reduce_codes", fake)
    got = tseg._segment_reduce_cuda(k1, k2, vl, ops, False)
    want = tseg._segment_reduce_plain(k1, k2, vl, ops, False)
    assert launches == [(3, [0, 1, 2], torch.float32),
                        (3, [2, 0, 1], torch.float32),
                        (1, [0], torch.float32)]
    assert torch.equal(got[1], want[1])
    ends = tseg._run_flags(k1, k2)[2]
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g[ends], w[ends])


@pytest.mark.parametrize("dtype", [torch.float64, torch.int64,
                                   torch.bfloat16])
def test_other_lane_dtypes_raise_by_name_before_any_launch(dtype):
    """The kernels' wrappers refuse a lane dtype they do not take before
    a library is loaded (here on CPU tensors: the check comes first), and
    the plain named ops refuse it too instead of wrapping it to int32."""
    k = torch.zeros(4, dtype=torch.int32)
    v = torch.zeros(4, dtype=dtype)
    kc.reset_counts()
    name = str(dtype).split(".")[-1]
    for op in ("sum", CODES[:1], monoids.fsum_min_max):
        with pytest.raises(ValueError, match=name):
            tseg._segment_reduce_cuda(k, k, [v] * (3 if callable(op)
                                                   else 1), op, False)
    with pytest.raises(ValueError, match=name):
        tseg._segment_reduce_plain(k, k, [v], "sum", False)
    with pytest.raises(ValueError, match=name):
        monoid.lower(monoids.fsum_min_max, dtype)
    assert not any(kc.LAUNCHES.values())


def test_int_lanes_under_a_float_monoid_are_cast_up_front():
    """int32 lanes under ``a.float() + b.float()``: reduced as float32 on
    every path (the JAX Pallas wrapper casts up front, the lax ladder
    promotes at its first step), bit-equal to JAX lax and within
    ``gamma_n`` of the host; the kernel IR is the float32 one."""
    k1, k2, lanes = _typed_case("cast_sum", 71)
    ir = monoid.lower(monoids.cast_sum, torch.int32)
    assert ir.dtype == "f" and monoid.torch_dtype(ir) == torch.float32
    assert ir is monoid.lower(monoids.cast_sum, torch.float32)
    t_red, _ = tseg.segment_reduce(_t(k1), _t(k2), [_t(lanes[0])],
                                   monoids.cast_sum, False)
    assert t_red[0].dtype == torch.float32
    j_red, _ = jseg._segment_reduce_lax(jnp.asarray(k1), jnp.asarray(k2),
                                        [jnp.asarray(lanes[0])],
                                        JAX_TWINS["cast_sum"], False)
    ends = np.array([e for _, e in _runs(k1, k2)])
    assert _same(t_red[0].numpy()[ends], np.asarray(j_red[0])[ends])


def test_plain_ladder_never_raises_on_rows_no_run_reads():
    """An int32 ``a // b`` over runs of one or two rows, then invalid
    rows of zeros: the ladder's discarded combines and the trailing rows
    divide by zero, where torch's CPU raises; the plain version follows
    XLA's rules there (the op's IR), and each run's result is its one
    row, or ``x // y`` for a run of two."""
    rng = np.random.default_rng(9)
    head = rng.random(40) < 0.6
    head[0] = True
    head[1:] |= ~head[:-1]
    k1 = np.concatenate([np.cumsum(head) - 1, [0xFFFFFFFF] * 8]).astype(
        np.uint32)
    k2 = np.where(k1 == 0xFFFFFFFF, k1, 7).astype(np.uint32)
    v = np.concatenate([rng.integers(1, 1000, 40) * rng.choice([-1, 1], 40),
                        np.zeros(8)]).astype(np.int32)
    op = lambda a, b: a // b  # noqa: E731
    with pytest.raises(RuntimeError, match="ZeroDivision"):
        op(_t(v), _t(v))
    got, _ = tseg._segment_reduce_plain(_t(k1), _t(k2), [_t(v)], op, False)
    runs = _runs(k1, k2)
    want = [v[i] if i == e else v[i] // v[e] for i, e in runs]
    assert np.array_equal(got[0].numpy()[[e for _, e in runs]], want)


@pytest.mark.parametrize("name", ["fsum_min_max", "welford"])
def test_sorted_unique_reduce_float_matches_jax(name):
    """Through the sort and the compaction (``fsum_min_max``'s capacity
    below the key count: overflow; ``welford``'s above it), float lanes
    and an invalid row's zeros as JAX's."""
    op, lanes_n, _ = monoids.TYPED_MONOIDS[name]
    rng = np.random.default_rng(81)
    keys = rng.integers(0, 40, size=(N, 2)).astype(np.uint32)
    vals = monoids.typed_rows(name, rng, N)
    pay = np.arange(N, dtype=np.int32)[:, None]
    valid = rng.random(N) < 0.8
    for cap in (16,) if name == "fsum_min_max" else (512,):
        ref = jseg.sorted_unique_reduce(
            jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(pay),
            jnp.asarray(valid), cap, JAX_TWINS[name], segment_impl="lax")
        port = tseg.sorted_unique_reduce(_t(keys), _t(vals), _t(pay),
                                         _t(valid), cap, op)
        assert port.values.dtype == torch.float32
        assert _same(port.values.numpy(), np.asarray(ref.values))
        assert np.array_equal(port.keys.numpy().view(np.uint32),
                              np.asarray(ref.keys))
        assert int(port.n_unique) == int(ref.n_unique)


# -- the typed lowering ----------------------------------------------------------

def _draw(rng, shape, dtype):
    if dtype == torch.int32:
        x = rng.integers(-2 ** 31, 2 ** 31 - 1, size=shape, endpoint=True)
        return torch.from_numpy(x.astype(np.int32))
    return torch.from_numpy((rng.standard_normal(shape) * 50)
                            .astype(np.float32))


def _with_sqrt_rn(monkeypatch, op, a, b):
    """``op(a, b)`` with ``torch.sqrt`` the correctly rounded one, as
    :func:`monoid.evaluate`'s (and the kernel's) is."""
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", monoid.sqrt_rn)
        return op(a, b)


def test_plain_sqrt_is_correctly_rounded():
    """The IR's ``sqrt`` is IEEE's correctly rounded float32 root (the
    kernel's ``__fsqrt_rn``): numpy's bits on 2**20 float32 values, from
    the smallest subnormal to the largest finite.  Prints how many of
    them torch's own CPU ``sqrt`` gives otherwise (1 ulp off)."""
    rng = np.random.default_rng(12)
    x = rng.integers(1, 0x7F800000, size=1 << 20, dtype=np.int64).astype(
        np.uint32).view(np.float32)
    ir = monoid.lower(lambda a, b: torch.sqrt(a), torch.float32)
    t = torch.from_numpy(x)
    got = monoid.evaluate(ir, t, t).numpy()
    assert np.array_equal(got.view(np.int32), np.sqrt(x).view(np.int32))
    off = int((torch.sqrt(t).numpy().view(np.int32)
               != got.view(np.int32)).sum())
    print(f"torch.sqrt on the CPU: {off} of {x.size} float32 roots not "
          "correctly rounded")


@pytest.mark.parametrize("name", sorted(monoids.TYPED_MONOIDS)
                         + sorted(monoids.TYPED_NODE_CASES))
def test_typed_evaluate_equals_the_callable_bit_for_bit(name, monkeypatch):
    """``evaluate(lower(op, dtype))`` gives ``op``'s bits (and dtype) on
    the lanes' domain, the IR's dtype in and out (``sqrt`` the correctly
    rounded one)."""
    rng = np.random.default_rng(len(name))
    if name in monoids.TYPED_MONOIDS:
        op, lanes, dtype = monoids.TYPED_MONOIDS[name]
        a, b = (torch.from_numpy(monoids.typed_rows(name, rng, 4096))
                for _ in range(2))
        if lanes == 1:
            a, b = a[:, 0], b[:, 0]
    else:
        op, lanes, dtype = monoids.TYPED_NODE_CASES[name]
        shape = (4096,) if name.startswith("float lane-wise") else (
            4096, lanes)
        a, b = _draw(rng, shape, dtype), _draw(rng, shape, dtype)
    ir = monoid.lower(op, dtype)
    cast = monoid.torch_dtype(ir)
    want = _with_sqrt_rn(monkeypatch, op, a.to(cast), b.to(cast))
    got = monoid.evaluate(ir, a, b)
    assert got.dtype == want.dtype == cast
    assert _same(got, want) if cast == torch.float32 else torch.equal(
        got, want)
    assert monoid.lower(op, dtype) is ir  # cached per callable and dtype


#: refused before this lowering took division and float constants: each
#: lowers now, with the IR type torch gives it
FORMER_REFUSALS = {
    "floordiv": (lambda a, b: a // ((b & 7) + 1), "i", "floordiv"),
    "truediv": (lambda a, b: a / b, "f", "div"),
    "0.5": (lambda a, b: a * 0.5, "f", "fconst")}


@pytest.mark.parametrize("what", sorted(FORMER_REFUSALS))
def test_division_and_float_constants_lower(what):
    op, typ, node = FORMER_REFUSALS[what]
    ir = monoid.lower(op, torch.int32)
    assert ir.dtype == typ and node in {n[0] for n in ir.nodes}
    a, b = (_draw(np.random.default_rng(3), (4096,), torch.int32)
            for _ in range(2))
    want = op(a, b)
    a, b = a.to(want.dtype), b.to(want.dtype)
    if typ == "f":  # the kernel's lanes are float32 from the start
        want = op(a, b)
    assert _same(monoid.evaluate(ir, a, b), want) if typ == "f" else \
        torch.equal(monoid.evaluate(ir, a, b), want)


@pytest.mark.parametrize("expr", [
    "a + b", "a * 0.5", "a + 1", "a / b", "a - 2.25", "-a",
    "torch.abs(a)", "torch.exp(a * 1e-3)", "torch.sqrt(torch.abs(a))",
    "torch.clamp(a, -3, 4)", "torch.clamp(a, max=2.5)",
    "torch.where(a < b, a, 0.5)", "torch.where(a < 0.5, a, b)",
    "(a > 1.5).float()", "(a * 0.25).int()", "a.to(torch.float32) + b"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_promotion_follows_torch(expr, dtype, monkeypatch):
    """The IR's result type is the dtype torch computes (an int32 lane
    times 0.5 is float32, plus 1 stays int32), and its values are
    torch's bits (on in-range values: a cast of a float beyond int32 is
    XLA's saturation in the IR; ``sqrt`` the correctly rounded one)."""
    op = eval(f"lambda a, b: {expr}")
    rng = np.random.default_rng(5)
    a, b = (_draw(rng, (2048,), dtype) for _ in range(2))
    if dtype == torch.int32:
        a, b = a >> 8, b >> 8  # in range of the float32 casts
    ir = monoid.lower(op, dtype)
    want = _with_sqrt_rn(monkeypatch, op, a, b)
    assert monoid.torch_dtype(ir) == want.dtype or ir.dtype != _TYPE[dtype]
    # an int32 op that returns float32 runs as float32 from the start
    if monoid.torch_dtype(ir) != dtype:
        a, b = a.to(want.dtype), b.to(want.dtype)
        want = _with_sqrt_rn(monkeypatch, op, a, b)
    got = monoid.evaluate(ir, a, b)
    assert got.dtype == want.dtype
    assert _same(got, want) if got.dtype == torch.float32 else torch.equal(
        got, want)


_TYPE = {torch.int32: "i", torch.float32: "f"}


def test_division_by_zero_and_casts_follow_xla():
    """Where torch's CPU raises or traps (integer division by 0,
    INT32_MIN // -1) or leaves the value open (a float beyond int32 cast
    to int32), the IR (and the kernel) give what the op's JAX twin
    gives."""
    from jax import lax

    a = np.array([5, -5, 0, -2 ** 31, 2 ** 31 - 1, -2 ** 31, 7, -9],
                 np.int32)
    b = np.array([0, 0, 0, 0, 0, -1, -1, 4], np.int32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    cases = {
        lambda x, y: x // y: ja // jb,
        lambda x, y: x % y: ja % jb,
        lambda x, y: torch.fmod(x, y): jnp.fmod(ja, jb),
        lambda x, y: torch.div(x, y, rounding_mode="trunc"): lax.div(ja, jb),
        lambda x, y: torch.div(x, y, rounding_mode="floor"): ja // jb}
    for op, want in cases.items():
        got = monoid.evaluate(monoid.lower(op, torch.int32), ta, tb)
        assert np.array_equal(got.numpy(), np.asarray(want))
    f = np.array([3e9, -3e9, np.nan, 2.5, -2.5, np.inf, -np.inf, 2 ** 31],
                 np.float32)
    ir = monoid.lower(lambda x, y: x.int().float(), torch.float32)
    assert "toi" in {n[0] for n in ir.nodes}
    got = monoid.evaluate(ir, torch.from_numpy(f), torch.from_numpy(f))
    assert np.array_equal(got.numpy(), np.asarray(
        jnp.asarray(f).astype(jnp.int32).astype(jnp.float32)))


def test_float_ops_outside_the_lowering_raise_naming_them():
    for op, what in [(lambda a, b: a.float() // b.float(), "floordiv"),
                     (lambda a, b: torch.fmod(a.float(), b), "fmod"),
                     (lambda a, b: a.to(torch.bfloat16), "bfloat16"),
                     (lambda a, b: a.double(), "double"),
                     (lambda a, b: torch.gcd(a, b), "gcd"),
                     (lambda a, b: a & b, "and")]:
        with pytest.raises(NotImplementedError, match=what):
            monoid.lower(op, torch.float32)


def test_ir_hash_is_typed():
    """One body over int32 and over float32 lanes: two IRs, two hashes,
    two libraries; the same body twice: one."""
    add = lambda a, b: a + b  # noqa: E731
    add2 = lambda a, b: a + b  # noqa: E731
    i32, f32 = monoid.lower(add, torch.int32), monoid.lower(add,
                                                            torch.float32)
    assert i32.nodes == f32.nodes and i32.types != f32.types
    assert monoid.ir_hash(i32) != monoid.ir_hash(f32)
    assert kc.monoid_library(i32) != kc.monoid_library(f32)
    assert monoid.ir_hash(monoid.lower(add2, torch.float32)) == \
        monoid.ir_hash(f32)
    assert "using T = float;" in monoid.emit_cuda(f32)
    assert "__fadd_rn" in monoid.emit_cuda(f32)
    assert "using T = int32_t;" in monoid.emit_cuda(i32)
    src = kc.monoid_source(monoid.lower(monoids.welford, torch.float32))
    assert "__fdiv_rn" in src and "using namespace mr_segreduce_kernels" \
        in src
    # the library an engine config names follows the value dtype
    cfg = tde.EngineConfig(reduce_op=monoids.fsum_min_max)
    assert kc.sources_for(cfg, None, torch.float32)[-1] == \
        kc.monoid_library(monoid.lower(monoids.fsum_min_max, torch.float32))
    assert kc.sources_for(cfg, None, torch.int32)[-1] == kc.monoid_library(
        monoid.lower(monoids.span))


def test_device_result_from_numpy_keeps_the_value_dtype():
    keys = np.zeros((1, 2, 2), np.uint32)
    valid = np.ones((1, 2), bool)
    pay = np.zeros((1, 2, 1), np.int32)
    for vals in (np.array([[1.5, -0.0]], np.float32),
                 np.array([[3, 4]], np.int32)):
        res = convert.device_result_from_numpy(keys, vals, pay, valid, 0)
        assert res.values.numpy().dtype == vals.dtype
        assert np.array_equal(res.values.numpy().view(np.int32),
                              vals.view(np.int32))
        back = convert.device_result_to_numpy(res)[1]
        assert back.dtype == vals.dtype
