"""The port's spill plane against the JAX package's: one checkpoint
format, read and written by both.

A stream spilled by the JAX ``EngineSession`` (8-device CPU mesh, lax
formulations) into a ``shared:`` directory restores into the port's
session and keeps feeding, bit-equal (tolerance: none) to the JAX stream
that was never interrupted, and the reverse; both packages' manifests
of one stream state carry the same meta, shapes, dtypes and specs.  A
spill at P = 8 restored at P = 1 re-bins through ``repartition_rows``
(bit-equal to the JAX function) to the uninterrupted P = 1 stream.  Also
here: ``_cfg_token`` is one string in both packages, a corrupt shard
falls back to the older step, an overflowing re-bin is loud, ``close``
drops the spill, a poisoned stream rolls back with no double fold, a
config or row-shape mismatch raises, a handed-off stream refuses, the
spill policy picks the JAX package's victims, and the checkpoint
manager's files cross between the packages.
"""

import dataclasses

import numpy as np
import pytest

from mapreduce_tpu.engine import device_engine as jde
from mapreduce_tpu.engine import session as jsession
from mapreduce_tpu.engine import spill as jspill
from mapreduce_tpu.models import checkpoint as jckpt
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu.storage.router import router as jopen
from mapreduce_tpu_torch.engine import device_engine as tde
from mapreduce_tpu_torch.engine import session as tsession
from mapreduce_tpu_torch.engine import spill as tspill
from mapreduce_tpu_torch.engine.wordcount import bench_engine_config
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.models import checkpoint as tckpt
from mapreduce_tpu_torch.parallel.mesh import Partitions
from mapreduce_tpu_torch.storage import MemoryStorage
from mapreduce_tpu_torch.storage.router import router as topen
from tests.test_fused_engine import _dict_oracle, _records_map_fn
from tests.test_torch_session import (
    as_dict, assert_snap_equal, chunk_stream, jax_cfg, port_cfg,
    records_map_fn)

P = 8
CFG = jax_cfg()
#: 48 chunks at k = 1 on 8 partitions: six waves, three a half
CHUNKS = chunk_stream(7, 48)
HALF = 24


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


@pytest.fixture(scope="module")
def jax_whole(mesh):
    """The JAX stream fed both halves without a break."""
    js = jsession.EngineSession(mesh, _records_map_fn, CFG, k=1)
    js.feed(CHUNKS[:HALF])
    js.feed(CHUNKS[HALF:])
    return js.snapshot()


def _port(store=None, n=P, cfg=CFG, **kw):
    return tsession.EngineSession(Partitions(n, "cpu"), records_map_fn,
                                  port_cfg(cfg), k=1, spill=store, **kw)


def _jax(mesh, store=None, cfg=CFG, **kw):
    return jsession.EngineSession(mesh, _records_map_fn, cfg, k=1,
                                  spill=store, **kw)


def _manifest(storage, task="-"):
    names = [n for n in storage.list(r"MANIFEST\.json$")
             if f"/{task}/" in n]
    assert len(names) == 1, names
    return jckpt.json.loads(storage.read(names[0]))


def test_jax_spill_restores_into_port_and_keeps_feeding(mesh, jax_whole,
                                                        tmp_path):
    """JAX spills half a stream to ``shared:``; a port session over the
    same directory restores it lazily on its next feed (the same
    layout at P = 8) and ends bit-equal to the JAX stream that never
    stopped.  The manifest the port writes for the same state is the
    JAX one, field for field."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    js = _jax(mesh, jspill.SessionSpillStore(
        jopen(f"shared:{jdir}")))
    js.feed(CHUNKS[:HALF])
    assert js.evict() == 1
    js.close(drop_spill=False)
    store = tspill.SessionSpillStore(topen(f"shared:{jdir}"))
    assert store.tasks() == ["-"]
    ts = _port(store)
    assert ts.tasks() == []
    ts.feed(CHUNKS[HALF:])  # lazy restore, then the second half
    assert ts.stats() == {"chunks": 48, "waves": 6, "feeds": 2,
                          "overflow": 0}
    assert_snap_equal(ts.snapshot(), jax_whole)
    # the port's spill of the first half, beside the JAX one
    tp = _port(tspill.SessionSpillStore(topen(f"shared:{tdir}")))
    tp.feed(CHUNKS[:HALF])
    tp.evict()
    jm = _manifest(jopen(f"shared:{jdir}"))
    tm = _manifest(jopen(f"shared:{tdir}"))
    assert tm["meta"] == jm["meta"] and tm["format"] == jm["format"]
    assert sorted(tm["leaves"]) == sorted(jm["leaves"]) == sorted(
        tspill.LANES)
    for name, entry in tm["leaves"].items():
        want = jm["leaves"][name]
        assert ((entry["shape"], entry["dtype"], entry["spec"])
                == (want["shape"], want["dtype"], want["spec"])), name
        assert len(entry["shards"]) == 1 and len(want["shards"]) == P


def test_port_spill_restores_into_jax_and_keeps_feeding(mesh, jax_whole,
                                                        tmp_path):
    """The reverse: the port spills (one shard a lane), the JAX session
    restores and feeds on, bit-equal to its own uninterrupted stream;
    its traffic matrix carries over too."""
    ts = _port(tspill.SessionSpillStore(
        topen(f"shared:{tmp_path}")))
    ts.feed(CHUNKS[:HALF])
    traffic = ts.traffic_matrix()
    ts.evict()
    js = _jax(mesh, jspill.SessionSpillStore(
        jopen(f"shared:{tmp_path}")))
    js.feed(CHUNKS[HALF:])
    assert_snap_equal(_port_whole(), js.snapshot())
    assert_snap_equal(_port_whole(), jax_whole)
    whole = _port()
    whole.feed(CHUNKS[:HALF])
    assert np.array_equal(whole.traffic_matrix(), traffic)
    whole.feed(CHUNKS[HALF:])
    assert np.array_equal(js.traffic_matrix(), whole.traffic_matrix())


def _port_whole(n=P):
    s = _port(n=n)
    s.feed(CHUNKS[:HALF])
    s.feed(CHUNKS[HALF:])
    return s.snapshot()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spill_at_8_restores_at_1_through_repartition(mesh, tmp_path,
                                                      writer):
    """A P = 8 spill (either package's) restored by a port session at
    P = 1 takes the re-binning path and ends equal to an uninterrupted
    P = 1 stream (the traffic lane restarts)."""
    if writer == "jax":
        src = _jax(mesh, jspill.SessionSpillStore(
            jopen(f"shared:{tmp_path}")))
    else:
        src = _port(tspill.SessionSpillStore(
            topen(f"shared:{tmp_path}")))
    src.feed(CHUNKS[:HALF])
    src.evict()
    one = _port(tspill.SessionSpillStore(
        topen(f"shared:{tmp_path}")), n=1)
    one.snapshot()  # lazy restore, re-binned onto one partition
    assert one.traffic_matrix().tolist() == [[0]]
    one.feed(CHUNKS[HALF:])
    snap = one.snapshot()
    assert_snap_equal(snap, _to_numpy(_port_whole(n=1)))
    assert as_dict(snap) == _dict_oracle(CHUNKS, "sum")


def _to_numpy(snap):
    return convert.device_result_to_numpy(snap)


@pytest.mark.parametrize("cfg", [
    tde.EngineConfig(),
    tde.EngineConfig(reduce_op=("sum", "min", "max"), unit_values=False),
    tde.EngineConfig(partition_map=True, partition_buckets=64,
                     exchange_stats=False),
    tde.EngineConfig(sort_impl="radix", combine_in_scan=True,
                     combine_capacity=1 << 9),
    tde.EngineConfig(sort_impl="tiered-radix", rank_sort=False),
    bench_engine_config()])
def test_cfg_token_equal_across_packages(cfg):
    """The spill's config fingerprint: one string in both packages (the
    tier policies spell their steady tier)."""
    jcfg = jde.EngineConfig(**dataclasses.asdict(cfg))
    assert cfg.cache_key() == jcfg.cache_key()
    assert tde._cfg_token(cfg) == jde._cfg_token(jcfg)
    assert (tde._cfg_token(tde._steady_cfg(cfg))
            == jde._cfg_token(jde._steady_cfg(jcfg)))


def _random_lanes(rng, n_dev, C, live):
    keys = rng.integers(0, 1 << 32, size=(n_dev, C, 2), dtype=np.uint64)
    keys = keys.astype(np.uint32)
    valid = np.zeros((n_dev, C), bool)
    valid[:, :live] = True
    return {"keys": keys,
            "vals": rng.integers(-50, 50, size=(n_dev, C, 3)).astype(
                np.int32),
            "pay": rng.integers(0, 1 << 20, size=(n_dev, C, 1)).astype(
                np.int32),
            "valid": valid}


@pytest.mark.parametrize("table", [False, True])
def test_repartition_rows_bit_equal_jax(table):
    """The host re-bin is the JAX function's bit for bit (keys with the
    top bit set included), with and without a bucket table; an
    overflowing partition raises in both."""
    rng = np.random.default_rng(5)
    lanes = _random_lanes(rng, 8, 32, 20)
    pmap = (rng.integers(0, 3, size=24).astype(np.int32) if table
            else None)
    got = tspill.repartition_rows(lanes, 3, 128, pmap=pmap)
    want = jspill.repartition_rows(lanes, 3, 128, pmap=pmap)
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert np.array_equal(got[name], want[name]), name
    with pytest.raises(tspill.SessionRestoreError, match="out_capacity"):
        tspill.repartition_rows(lanes, 1, 100, task="t")
    with pytest.raises(jspill.SessionRestoreError, match="out_capacity"):
        jspill.repartition_rows(lanes, 1, 100, task="t")


def test_overflowing_restore_is_loud():
    """Eight partitions' rows that do not fit one partition's
    ``out_capacity``: the P = 1 restore raises, naming the capacity, and
    the spill stays for a session that can hold it."""
    small = dataclasses.replace(CFG, out_capacity=64)
    store = tspill.SessionSpillStore(MemoryStorage())
    src = _port(store, cfg=small)
    src.feed(CHUNKS)
    ref = _to_numpy(src.snapshot())
    assert int(ref[3].sum()) > 64  # more live rows than one partition
    src.evict()
    with pytest.raises(tspill.SessionRestoreError, match="out_capacity"):
        _port(store, n=1, cfg=small).snapshot()
    assert store.has("-")
    assert_snap_equal(_port(store, cfg=small).snapshot(), ref)


def test_corrupt_shard_falls_back_to_the_older_step(tmp_path):
    """Two spills of one stream; a garbled shard of the newer makes the
    restore take the older, whose position the stream resumes from."""
    storage = topen(f"shared:{tmp_path}")
    store = tspill.SessionSpillStore(storage)
    s = _port(store)
    s.feed(CHUNKS[:HALF])
    assert s.spill_stream() == 1
    s.feed(CHUNKS[HALF:])
    assert s.evict() == 2
    newest = [n for n in storage.list(r"ckpt-00000002/.*\.npy$")]
    storage.write_bytes(newest[0], b"garbage")
    s2 = _port(store)
    st = s2.restore()
    assert st.pos == HALF and s2.stats()["feeds"] == 1
    s2.feed(CHUNKS[HALF:])
    assert_snap_equal(s2.snapshot(), _to_numpy(_port_whole()))
    for shard in storage.list(r"ckpt-00000001/.*\.npy$"):
        storage.write_bytes(shard, b"garbage")
    with pytest.raises(tspill.SessionRestoreError, match="all corrupt"):
        _port(store).snapshot()


def test_close_drops_the_spill():
    """Closing a named task ends its stream: the spill goes too, so a
    re-fed source starts fresh instead of resuming and folding twice;
    ``drop_spill=False`` keeps it for a hand-off."""
    store = tspill.SessionSpillStore(MemoryStorage())
    s = _port(store)
    s.feed(CHUNKS[:HALF], task="t")
    s.spill_stream("t")
    s.close("t", drop_spill=False)
    assert store.tasks() == ["t"]
    s.close("t")
    assert not store.has("t") and store.tasks() == []
    s.feed(CHUNKS, task="t")
    assert s.stats("t")["chunks"] == len(CHUNKS)
    assert_snap_equal(s.snapshot("t"), _to_numpy(_port_whole()))


def test_poisoned_stream_rolls_back_with_no_double_fold(monkeypatch):
    """A feed dies on its second wave after a spill: the stream refuses
    feeds and snapshots (naming ``restore``), ``restore`` rolls back to
    the spill's position, and re-feeding from there ends bit-equal to
    the stream that never broke."""
    store = tspill.SessionSpillStore(MemoryStorage())
    s = _port(store)
    s.feed(CHUNKS[:HALF])
    s.spill_stream()
    fed_to = s.stats()["chunks"]
    real = s.engine._wave
    calls = [0]

    def dying(*args):
        calls[0] += 1
        if calls[0] >= 2:
            raise RuntimeError("device died mid-feed")
        return real(*args)

    monkeypatch.setattr(s.engine, "_wave", dying)
    with pytest.raises(RuntimeError, match="mid-feed"):
        s.feed(CHUNKS[HALF:])
    monkeypatch.setattr(s.engine, "_wave", real)
    with pytest.raises(tsession.SessionStreamBroken, match="restore"):
        s.feed(CHUNKS[HALF:])
    with pytest.raises(tsession.SessionStreamBroken, match="restore"):
        s.snapshot()
    with pytest.raises(tsession.SessionStreamBroken):
        s.spill_stream()
    assert s.restore().pos == fed_to
    s.feed(CHUNKS[fed_to:])
    assert_snap_equal(s.snapshot(), _to_numpy(_port_whole()))


def test_config_and_row_shape_mismatch_raise(mesh, tmp_path):
    """A spill restores only under its own config (the JAX spill into a
    port session of another capacity too) and row shape."""
    js = _jax(mesh, jspill.SessionSpillStore(
        jopen(f"shared:{tmp_path}")))
    js.feed(CHUNKS[:HALF])
    js.evict()
    store = tspill.SessionSpillStore(topen(f"shared:{tmp_path}"))
    other = _port(store, cfg=dataclasses.replace(CFG, out_capacity=512))
    with pytest.raises(tspill.SessionRestoreError, match="config"):
        other.snapshot()
    wide = _port(store)
    wide.feed(chunk_stream(3, P, r=64), task="other")
    with pytest.raises(tspill.SessionRestoreError, match="row shape"):
        wide.snapshot()


def test_handed_off_stream_refuses_until_adopted():
    store = tspill.SessionSpillStore(MemoryStorage())
    s = _port(store)
    s.feed(CHUNKS[:HALF])
    s.migrate_out()
    assert s.tasks() == [] and store.has("-")
    with pytest.raises(tsession.SessionBusyError, match="migrated"):
        s.feed(CHUNKS[HALF:])
    with pytest.raises(tsession.SessionBusyError):
        s.snapshot()
    assert s.migrate_out() == 0  # already durable
    s.adopt()
    s.feed(CHUNKS[HALF:])
    assert_snap_equal(s.snapshot(), _to_numpy(_port_whole()))
    with pytest.raises(KeyError):
        s.migrate_out("nobody")


@pytest.mark.parametrize("policy", [
    dict(max_idle_s=0.5), dict(max_resident=2), dict(max_resident=0),
    dict(max_idle_s=2.0, max_resident=1), dict(hbm_frac=0.5)])
def test_victims_match_jax(policy):
    """The same ages give the same victims, in the same order."""
    rng = np.random.default_rng(3)
    for pressed in (False, True):
        for _ in range(20):
            ages = {f"t{i}": float(rng.uniform(0, 3))
                    for i in range(int(rng.integers(0, 6)))}
            assert (tspill.SpillPolicy(**policy).victims(ages, pressed)
                    == jspill.SpillPolicy(**policy).victims(ages,
                                                            pressed))


def test_resident_cap_and_idle_eviction_restore_intact():
    """The policy evicts at feed ends: the cap of one spills the colder
    tenant, an idle limit of zero spills the idle one; the evicted
    aggregates come back intact.  The device-memory clause never fires
    on the CPU."""
    store = tspill.SessionSpillStore(MemoryStorage())
    s = _port(store, spill_policy=tspill.SpillPolicy(max_resident=1))
    s.feed(CHUNKS[:HALF], task="a")
    ref_a = _to_numpy(s.snapshot("a"))
    s.feed(CHUNKS[HALF:], task="b")
    assert s.tasks() == ["b"] and store.has("a")
    assert s.coldest_task() == "b"
    assert_snap_equal(s.snapshot("a"), ref_a)  # lazy restore
    s2 = _port(store, spill_policy=tspill.SpillPolicy(max_idle_s=0.0))
    s2.feed(CHUNKS[:HALF], task="x")
    s2.feed(CHUNKS[:HALF], task="y")
    assert "x" not in s2.tasks()
    assert not tspill.SpillPolicy(hbm_frac=0.0).hbm_pressed(
        s2.device)


def test_evict_restore_into_a_fresh_session():
    """A fresh session over the same store answers from the spill: the
    row shape, the wave split and the counters come back from its
    meta."""
    store = tspill.SessionSpillStore(MemoryStorage())
    s = _port(store)
    s.feed(CHUNKS)
    ref = _to_numpy(s.snapshot())
    stats = s.stats()
    s.spill_stream()
    s.close(drop_spill=False)
    fresh = tsession.EngineSession(Partitions(P, "cpu"), records_map_fn,
                                   port_cfg(CFG), spill=store)
    assert_snap_equal(fresh.snapshot(), ref)
    assert fresh.stats() == stats and fresh.k == 1


def test_checkpoint_manager_files_cross_packages(tmp_path):
    """The checkpoint module alone: the port's manager saves, keeps the
    newest two plus the best, and restores the newest complete step;
    the JAX manager reads the port's files and the port reads the
    JAX's."""
    storage = topen(f"shared:{tmp_path}")
    mgr = tckpt.CheckpointManager(storage, prefix="run/", keep_n=2)
    rng = np.random.default_rng(0)
    trees = {s: {"w": rng.standard_normal((4, 3)).astype(np.float32),
                 "b": np.arange(s, s + 3, dtype=np.int64),
                 "scalar": np.float32(s)} for s in (1, 2, 3, 4)}
    mgr.save(1, trees[1])
    mgr.mark_best(1)
    for s in (2, 3, 4):
        mgr.save(s, trees[s], meta={"step": s})
    assert mgr.steps() == [1, 3, 4] and mgr.best_step() == 1
    leaves, manifest = mgr.restore_latest(template=trees[4])
    assert manifest["meta"] == {"step": 4}
    for name, arr in trees[4].items():
        assert np.array_equal(leaves[name], arr)
        assert leaves[name].dtype == np.asarray(arr).dtype
    with pytest.raises(tckpt.CheckpointError, match="missing"):
        mgr.restore_latest(template=dict(trees[4], extra=np.zeros(1)))
    jstore = jopen(f"shared:{tmp_path}")
    jtree, _ = jckpt.CheckpointManager(
        jstore, prefix="run/").restore_latest(trees[4])
    for name, arr in trees[4].items():
        assert np.array_equal(np.asarray(jtree[name]), arr)
    jckpt.CheckpointManager(jstore, prefix="jax/").save(
        7, {"w": trees[2]["w"]})
    got, _ = tckpt.restore_latest(storage, prefix="jax/")
    assert np.array_equal(got["w"], trees[2]["w"])
    assert tckpt.restore_latest(storage, prefix="none/") is None


def test_storage_planes_match_the_jax_ones(tmp_path):
    """The port's ``mem:`` and ``shared:`` planes: the DSL (``local`` is
    ``shared``; ``http`` wants its ``HOST:PORT``), text and byte blobs,
    regex listing, and a directory the JAX plane reads name for name."""
    from mapreduce_tpu_torch.storage.router import get_storage_from

    assert get_storage_from(f"local:{tmp_path}") == ("shared",
                                                     str(tmp_path))
    assert get_storage_from("mem") == ("mem", "default")
    assert get_storage_from("http:host:1") == ("http", "host:1")
    with pytest.raises(ValueError, match="HOST:PORT"):
        get_storage_from("http")
    with pytest.raises(ValueError, match="unknown"):
        get_storage_from("gridfs:x")
    assert topen("mem:plane-a") is topen("mem:plane-a")
    for plane in (topen("mem:plane-b"), topen(f"shared:{tmp_path}")):
        plane.write("dir/a.txt", "one\ntwo\n")
        plane.write_bytes("dir/b.npy", b"\x00\xffbytes")
        b = plane.builder()
        b.append("x")
        b.append("y")
        b.build("dir/c")
        assert plane.list(r"^dir/") == ["dir/a.txt", "dir/b.npy", "dir/c"]
        assert plane.read("dir/c") == "xy"
        assert plane.read_bytes("dir/b.npy") == b"\x00\xffbytes"
        assert plane.read_bytes("dir/a.txt") == b"one\ntwo\n"
        with pytest.raises(FileNotFoundError):
            plane.read_bytes("dir/zz")
        plane.remove_many(["dir/c", "dir/zz"])
        assert plane.list("c$") == []
    jplane = jopen(f"shared:{tmp_path}")
    assert jplane.list() == topen(f"shared:{tmp_path}").list()
    assert jplane.read_bytes("dir/b.npy") == b"\x00\xffbytes"
    assert jplane.read("dir/a.txt") == "one\ntwo\n"
