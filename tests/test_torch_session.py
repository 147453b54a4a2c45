"""The port's resident session against the JAX package's, bit for bit.

The same numpy-seeded chunk stream goes through the JAX
``EngineSession`` (8-device CPU mesh, the lax formulations: the default
``segment_impl='lax'``, ``sort_impl='variadic'``) and the port's over
``Partitions(8, "cpu")``; three tenants are fed in turn and every
tenant's snapshot is held against the JAX one after every feed
(tolerance: none: keys, values, payload and valid bit-equal) and against
a host reduction, for sum, min and max.  Also here: tenants never mix,
the row shape is latched, overflow raises and counts, a feed that dies
mid-feed poisons its stream, ``max_pending_feeds`` refuses with
``SessionBusyError``, ``stats`` has the JAX keys, a mid-stream
``rebalance`` equals a run under the new table from the start (and the
JAX session's rebalance), the port's radix and tier-policy sessions
equal its variadic one and ``Counter``, and a session without CUDA
raises.
"""

import dataclasses
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from mapreduce_tpu.engine import device_engine as jde
from mapreduce_tpu.engine import session as jsession
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.engine import device_engine as tde
from mapreduce_tpu_torch.engine import session as tsession
from mapreduce_tpu_torch.engine import wordcount as twc
from mapreduce_tpu_torch.engine.autotune import plan_rebalance
from mapreduce_tpu_torch.ops import kernel_compat as kc
from mapreduce_tpu_torch.ops.tokenize import shard_text
from mapreduce_tpu_torch.parallel.mesh import Partitions
from tests.test_fused_engine import (
    _dict_oracle, _records_map_fn, _result_dict)
from tests.test_torch_wordcount import _corpus

P = 8
K = 2
TENANTS = ("t0", "t1", "t2")


def records_map_fn(chunk, chunk_index, cfg):
    """The torch twin of ``tests.test_fused_engine._records_map_fn``:
    records from the chunk's values only, payload a function of the
    key."""
    c = chunk.to(torch.int64)
    k1 = (c % 23).to(torch.int32)
    k2 = (c % 5).to(torch.int32)
    keys = torch.stack([k1, k2], dim=-1)
    vals = (c % 101).to(torch.int32) + 1
    pay = (k1 * 7 + k2)[:, None]
    valid = (c % 7) != 0
    return keys, vals, pay, valid, torch.zeros((), dtype=torch.int32)


def jax_cfg(op="sum", **over):
    """The small config of ``tests/test_session.py``."""
    return jde.EngineConfig(local_capacity=256, exchange_capacity=128,
                            out_capacity=256, tile=64, tile_records=64,
                            reduce_op=op, **over)


def port_cfg(jcfg, **over):
    return dataclasses.replace(
        convert.engine_config_from_jax(dataclasses.asdict(jcfg)), **over)


def chunk_stream(seed, s, r=32):
    return np.random.default_rng(seed).integers(
        0, 1 << 14, size=(s, r)).astype(np.int32)


def assert_snap_equal(port_snap, jax_snap):
    """Every field bit-equal (both sides slice to their own live
    maximum, so equal results have equal widths)."""
    ref = convert.device_result_from_numpy(*jax_snap)
    for f in ("keys", "values", "payload", "valid"):
        assert torch.equal(getattr(port_snap, f), getattr(ref, f)), f
    assert port_snap.overflow == ref.overflow


def as_dict(snap):
    return _result_dict(
        jde.DeviceResult(*convert.device_result_to_numpy(snap)))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_tenant_snapshots_bit_equal_jax_session(mesh, op):
    """Three tenants, two uneven feeds each, interleaved: after every
    feed the fed tenant's snapshot is the JAX session's, bit for bit,
    and the host reduction of exactly that tenant's records."""
    streams = {t: chunk_stream(10 + i, 5 * K * P) for i, t in
               enumerate(TENANTS)}
    cuts = [0, 2 * K * P - 3, 5 * K * P]
    js = jsession.EngineSession(mesh, _records_map_fn, jax_cfg(op), k=K)
    ts = tsession.EngineSession(Partitions(P, "cpu"), records_map_fn,
                                port_cfg(jax_cfg(op)), k=K)
    for lo, hi in zip(cuts, cuts[1:]):
        for t in TENANTS:
            fed = streams[t][lo:hi]
            assert ts.feed(fed, task=t) == js.feed(fed, task=t) == 0
            snap = ts.snapshot(t)
            assert_snap_equal(snap, js.snapshot(t))
            assert as_dict(snap) == _dict_oracle(streams[t][:hi], op)
            assert ts.stats(t) == js.stats(t)
    assert ts.tasks() == js.tasks() == list(TENANTS)
    # a stream that never folded a wave reads as the JAX one does
    ts.feed(streams["t0"][:0], task="empty")
    js.feed(streams["t0"][:0], task="empty")
    assert_snap_equal(ts.snapshot("empty"), js.snapshot("empty"))


def test_tenants_multiplex_without_mixing():
    """Tenants interleave over one session: each snapshot holds exactly
    its own records, and a closed tenant is gone."""
    ca, cb = chunk_stream(1, 2 * P), chunk_stream(2, 2 * P)
    s = tsession.EngineSession(Partitions(P, "cpu"), records_map_fn,
                               port_cfg(jax_cfg()), k=1)
    s.feed(ca[:P], task="a")
    s.feed(cb[:P], task="b")
    s.feed(ca[P:], task="a")
    s.feed(cb[P:], task="b")
    assert as_dict(s.snapshot("a")) == _dict_oracle(ca, "sum")
    assert as_dict(s.snapshot("b")) == _dict_oracle(cb, "sum")
    assert s.stats("a") == {"chunks": 2 * P, "waves": 2, "feeds": 2,
                            "overflow": 0}
    s.close("a")
    assert s.tasks() == ["b"]
    with pytest.raises(KeyError):
        s.snapshot("a")


def test_row_shape_is_latched():
    s = tsession.EngineSession(Partitions(P, "cpu"), records_map_fn,
                               port_cfg(jax_cfg()), k=1)
    s.feed(chunk_stream(3, P), task="t")
    with pytest.raises(ValueError, match="fixed at shape"):
        s.feed(chunk_stream(3, P, r=64), task="t")
    with pytest.raises(ValueError, match="fixed at shape"):
        s.feed(chunk_stream(3, P).astype(np.int64), task="t")


def test_overflow_raises_and_counts(mesh):
    """No replay: an overflowing feed raises; with ``on_overflow=
    'count'`` the stream goes on and the loss is the JAX session's, and
    shows in the snapshot."""
    tiny = jde.EngineConfig(local_capacity=8, exchange_capacity=4,
                            out_capacity=8, tile=64, tile_records=64,
                            reduce_op="sum")
    chunks = chunk_stream(11, P, r=256)
    s = tsession.EngineSession(Partitions(P, "cpu"), records_map_fn,
                               port_cfg(tiny), k=1)
    with pytest.raises(tsession.SessionOverflowError, match="overflowed"):
        s.feed(chunks, task="t")
    assert s.stats("t")["overflow"] > 0
    lost = s.feed(chunks, task="t2", on_overflow="count")
    js = jsession.EngineSession(mesh, _records_map_fn, tiny, k=1)
    assert lost == js.feed(chunks, task="t2", on_overflow="count") > 0
    assert s.snapshot("t2").overflow == lost
    assert_snap_equal(s.snapshot("t2"), js.snapshot("t2"))
    with pytest.raises(ValueError, match="on_overflow"):
        s.feed(chunks, task="t3", on_overflow="ignore")


def test_feed_dying_mid_feed_poisons_the_stream(monkeypatch):
    """A wave that fails on the second wave of a feed leaves the first
    folded and pos unmoved: the stream is poisoned (feed and snapshot
    raise, nothing is folded twice), other streams go on, and a closed
    stream restarts clean."""
    chunks = chunk_stream(13, 3 * P)
    s = tsession.EngineSession(Partitions(P, "cpu"), records_map_fn,
                               port_cfg(jax_cfg()), k=1)
    s.feed(chunks[:P], task="t")
    real_wave = s.engine._wave
    calls = [0]

    def dying(*args):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("injected wave failure")
        return real_wave(*args)

    monkeypatch.setattr(s.engine, "_wave", dying)
    with pytest.raises(RuntimeError, match="injected"):
        s.feed(chunks[P:], task="t")
    monkeypatch.setattr(s.engine, "_wave", real_wave)
    with pytest.raises(tsession.SessionStreamBroken, match="close"):
        s.feed(chunks[P:], task="t")
    with pytest.raises(tsession.SessionStreamBroken):
        s.snapshot("t")
    assert s.stats("t")["chunks"] == P  # pos never moved
    assert s.traffic_matrix("t") is None
    s.feed(chunks, task="fresh")
    assert as_dict(s.snapshot("fresh")) == _dict_oracle(chunks, "sum")
    s.close("t")
    s.feed(chunks, task="t")
    assert as_dict(s.snapshot("t")) == _dict_oracle(chunks, "sum")


def test_max_pending_feeds_refuses_with_busy():
    """The bounded queue admits one waiter; the next is refused with
    ``SessionBusyError``, and the admitted waiter runs once the lock is
    free."""
    chunks = chunk_stream(14, 2 * P)
    s = tsession.EngineSession(Partitions(P, "cpu"), records_map_fn,
                               port_cfg(jax_cfg()), k=1,
                               max_pending_feeds=1)
    s.feed(chunks, task="t")
    with s._lock:  # the device is "busy"
        waiter = threading.Thread(target=s.feed, args=(chunks,),
                                  kwargs={"task": "t"})
        waiter.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not s._pending.get("t"):
            time.sleep(0.005)
        assert s._pending.get("t") == 1
        with pytest.raises(tsession.SessionBusyError, match="pending"):
            s.feed(chunks, task="t")
    waiter.join(timeout=60)
    assert not waiter.is_alive()
    assert s.stats("t")["feeds"] == 2 and not s._pending


@pytest.mark.parametrize("over", [
    {}, {"partition_map": True}, {"sort_impl": "radix"},
    {"sort_impl": "tiered", "segment_impl": "pallas"}])
def test_stats_keys_match_jax(mesh, over):
    """The key set of ``stats`` is the JAX session's for the same
    config (a stream put in place by hand on the JAX side: the keys
    depend on the config alone)."""
    jcfg = jax_cfg(**over)
    js = jsession.EngineSession(mesh, _records_map_fn, jcfg, k=1)
    js._streams["t"] = jsession._Stream(None)
    s = tsession.EngineSession(Partitions(P, "cpu"), records_map_fn,
                               port_cfg(jcfg), k=1)
    s.feed(chunk_stream(15, P), task="t")
    assert set(s.stats("t")) == set(js.stats("t"))
    assert s.stats("missing") == {} == js.stats("missing")


def test_rebalance_equals_a_run_under_the_new_table(mesh):
    """Feed half, rebalance to a ``plan_rebalance`` table of the
    stream's own bucket histogram, feed the rest: the snapshot equals a
    batch run under that table from the start and the JAX session's
    rebalanced stream, and the traffic matrix is the JAX one."""
    jcfg = jax_cfg(partition_map=True)
    chunks = chunk_stream(16, 4 * K * P)
    half = 2 * K * P
    s = tsession.EngineSession(Partitions(P, "cpu"), records_map_fn,
                               port_cfg(jcfg), k=K)
    js = jsession.EngineSession(mesh, _records_map_fn, jcfg, k=K)
    s.feed(chunks[:half], task="t")
    js.feed(chunks[:half], task="t")
    hist = s.bucket_histogram("t")
    assert np.array_equal(hist, js.bucket_histogram("t"))
    assert np.array_equal(s.partition_map("t"), js.partition_map("t"))
    table = plan_rebalance(np.arange(hist.size) % 5 + hist, P)
    assert not np.array_equal(table, s.partition_map("t"))
    s.rebalance("t", table)
    js.rebalance("t", table)
    assert np.array_equal(s.partition_map("t"), table)
    assert_snap_equal(s.snapshot("t"), js.snapshot("t"))
    s.feed(chunks[half:], task="t")
    js.feed(chunks[half:], task="t")
    snap = s.snapshot("t")
    assert_snap_equal(snap, js.snapshot("t"))
    assert np.array_equal(s.traffic_matrix("t"), js.traffic_matrix("t"))
    assert s.stats("t")["rebalances"] == 1
    eng = tde.DeviceEngine(Partitions(P, "cpu"), records_map_fn,
                           port_cfg(jcfg))
    eng.set_partition_map(table)
    batch = eng.run(chunks, waves=4)
    for f in ("keys", "values", "payload", "valid"):
        assert torch.equal(getattr(snap, f), getattr(batch, f)), f
    tiny = tsession.EngineSession(
        Partitions(P, "cpu"), records_map_fn,
        port_cfg(jcfg, out_capacity=32), k=K)
    tiny.feed(chunks[:K * P], task="t")
    before = tiny.snapshot("t")
    with pytest.raises(tsession.SessionRestoreError, match="out_capacity"):
        tiny.rebalance("t", np.zeros(hist.size, dtype=np.int32))
    assert_snap_equal(tiny.snapshot("t"),
                      convert.device_result_to_numpy(before))


WC_CHUNK = 512


def _wordcount_session(sort_impl):
    cfg = tde.EngineConfig(local_capacity=1 << 11,
                           exchange_capacity=1 << 9, out_capacity=1 << 12,
                           combine_in_scan=True, combine_capacity=1 << 9,
                           unit_values=True, reduce_op="sum",
                           sort_impl=sort_impl)
    return tsession.EngineSession(Partitions(P, "cpu"),
                                  twc._wordcount_map_fn, cfg, k=1)


@pytest.mark.parametrize("sort_impl", ["radix", "tiered-radix",
                                       "argsort"])
def test_sort_impl_sessions_equal_variadic_and_counter(sort_impl):
    """The word count as a session: the radix kernels' plain versions,
    the tier policy and the argsort tier fold the same bits as the
    variadic session after each feed, and ``Counter`` of the bytes fed
    (the payload offsets stay stream-global across feeds)."""
    data = _corpus(seed=3, n_words=2500)
    chunks, L = shard_text(data, 2 * P, pad_multiple=512,
                           pad_to=WC_CHUNK + 512)
    ref = _wordcount_session("variadic")
    s = _wordcount_session(sort_impl)
    kc.reset_counts()
    for lo, hi in ((0, P + 3), (P + 3, 2 * P)):
        ref.feed(chunks[lo:hi], task="w")
        s.feed(chunks[lo:hi], task="w")
        snap = s.snapshot("w")
        assert_snap_equal(snap, convert.device_result_to_numpy(
            ref.snapshot("w")))
        want = Counter(b"".join(bytes(r) for r in chunks[:hi]).split())
        assert twc.materialize_counts(chunks[:hi], snap) == want
    if sort_impl != "argsort":
        assert kc.PLAIN_CALLS["radix_onesweep"] > 0
        assert kc.PLAIN_CALLS["radix_plan"] >= s.stats("w")["waves"]
    assert s.stats("w")["sort_impl"] == sort_impl


def test_session_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsession.EngineSession(Partitions(1), records_map_fn)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsession.EngineSession(Partitions(8, "cuda"), records_map_fn)
