"""The port's engine controllers against the JAX package's, decision for
decision.

The same numpy-seeded chunks go through the JAX engine and session
(8-device CPU mesh, the lax formulations: ``segment_impl='lax'``,
``sort_impl='variadic'``) with a JAX ``AutoTuner`` attached, and through
the port's over ``Partitions(8, "cpu")`` with the port's, each with its
own ``ControlLedger``.  Held equal (tolerance: none): per-window recv
imbalance, every ledger decision but its clock fields (controller,
task, evidence, action, outcome, outcome evidence, notes), partition
maps, stream stats and snapshots bit for bit, retries, learned
capacities and batch results.  The cases are the JAX package's own
(``tests/test_control.py``): a skewed stream converging within three
windows, a rebalance refused for ``out_capacity`` (the stream untouched,
one refused row), a mis-tuned capacity converging across two runs and
pre-sizing a session at its door.  Also here: a spill taken after a
controller rebalance restores in the other package with the same map
and bit-equal rows, both ways; an errored rebalance is recorded and
never raised; a run or session without controllers records nothing in
either package; and the engine's learning key.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mapreduce_tpu.engine import autotune as jauto
from mapreduce_tpu.engine import device_engine as jde
from mapreduce_tpu.engine import session as jsession
from mapreduce_tpu.engine import spill as jspill
from mapreduce_tpu.obs import compile as jcompile
from mapreduce_tpu.obs import control as jcontrol
from mapreduce_tpu.obs.comms import matrix_stats as jmatrix_stats
from mapreduce_tpu.obs.metrics import REGISTRY as JREG
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu.storage.router import router as jopen
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.engine import autotune as tauto
from mapreduce_tpu_torch.engine import device_engine as tde
from mapreduce_tpu_torch.engine import session as tsession
from mapreduce_tpu_torch.engine import spill as tspill
from mapreduce_tpu_torch.obs import control as tcontrol
from mapreduce_tpu_torch.obs.comms import matrix_stats
from mapreduce_tpu_torch.obs.metrics import REGISTRY as TREG
from mapreduce_tpu_torch.parallel.mesh import Partitions
from mapreduce_tpu_torch.storage.router import router as topen
from tests.test_control import PMAP_CFG, many_keys_map_fn, skew_map_fn
from tests.test_fused_engine import _chunks
from tests.test_torch_session import assert_snap_equal

P = 8
#: the JAX tests' mis-tuned config: capacity 64 on ~1600 uniques
BAD_CFG = jde.EngineConfig(local_capacity=64, exchange_capacity=64,
                           out_capacity=64, tile=64, tile_records=32)
#: the clock fields of a decision: the only ones allowed to differ
CLOCK = ("time", "monotonic", "age_s")


def skew_map_fn_t(chunk, chunk_index, cfg):
    """Torch twin of ``tests.test_control.skew_map_fn``: every key
    congruent to partition 5 under the identity map, spread over the
    hash buckets."""
    c = chunk.to(torch.int64)
    k1 = (c % 8) * 8 + 5
    k2 = c % 5
    keys = torch.stack([k1, k2], dim=-1).to(torch.int32)
    vals = torch.ones(c.shape, dtype=torch.int32)
    pay = k1.to(torch.int32)[:, None]
    valid = torch.ones(c.shape, dtype=torch.bool)
    return keys, vals, pay, valid, torch.zeros((), dtype=torch.int32)


def many_keys_map_fn_t(chunk, chunk_index, cfg):
    """Torch twin of ``tests.test_control.many_keys_map_fn``."""
    c = chunk.to(torch.int64)
    keys = torch.stack([c, c % 13], dim=-1).to(torch.int32)
    vals = torch.ones(c.shape, dtype=torch.int32)
    pay = (c % 7).to(torch.int32)[:, None]
    valid = torch.ones(c.shape, dtype=torch.bool)
    return keys, vals, pay, valid, torch.zeros((), dtype=torch.int32)


def pcfg(jcfg):
    return convert.engine_config_from_jax(dataclasses.asdict(jcfg))


def decisions(ledger, controller=None):
    """A ledger's decisions without their clock fields."""
    return [{k: v for k, v in d.items() if k not in CLOCK}
            for d in ledger.decisions(controller)]


def assert_result_equal(port_res, jax_res):
    ref = convert.device_result_from_numpy(
        *(np.asarray(getattr(jax_res, f))
          for f in ("keys", "values", "payload", "valid")),
        int(jax_res.overflow))
    for f in ("keys", "values", "payload", "valid"):
        assert torch.equal(getattr(port_res, f), getattr(ref, f)), f


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


@pytest.fixture(autouse=True)
def no_shape_registry(monkeypatch):
    """The JAX capacity controller also reads the compile ledger's
    on-disk shape registry, which the port has no twin of: both learn
    from retry forensics alone here."""
    monkeypatch.setattr(jcompile.LEDGER, "disk_buckets",
                        lambda dir=None: {})


def skewed_pair(mesh, min_records=64):
    jl, tl = jcontrol.ControlLedger(), tcontrol.ControlLedger()
    js = jsession.EngineSession(
        mesh, skew_map_fn, PMAP_CFG, k=2,
        autotune=jauto.AutoTuner(ledger=jl, min_records=min_records))
    ts = tsession.EngineSession(
        Partitions(P, "cpu"), skew_map_fn_t, pcfg(PMAP_CFG), k=2,
        autotune=tauto.AutoTuner(ledger=tl, min_records=min_records))
    return js, ts, jl, tl


def test_skewed_stream_converges_as_jax_does(mesh):
    """The acceptance loop of both packages: 8x recv imbalance on the
    identity map, rebalanced after the first window, under 1.5x in the
    last; the same windows, decisions, maps, stats and snapshots."""
    js, ts, jl, tl = skewed_pair(mesh)
    chunks = _chunks(np.random.default_rng(3), 48)
    windows = {"jax": [], "port": []}
    last = {"jax": None, "port": None}
    for _ in range(3):
        for name, s in (("jax", js), ("port", ts)):
            s.feed(chunks, task="zipf")
            cur = np.asarray(s.traffic_matrix("zipf"), dtype=np.int64)
            delta = cur if last[name] is None else cur - last[name]
            windows[name].append(
                matrix_stats(delta.tolist())["imbalance_recv"])
            last[name] = cur
        assert np.array_equal(ts.partition_map("zipf"),
                              js.partition_map("zipf"))
        assert ts.stats("zipf") == js.stats("zipf")
        assert_snap_equal(ts.snapshot("zipf"), js.snapshot("zipf"))
    assert windows["port"] == windows["jax"]
    assert windows["port"][0] == pytest.approx(8.0)
    assert windows["port"][-1] < 1.5, windows
    assert decisions(tl) == decisions(jl)
    d = tl.decisions("repartition")[0]
    assert d["outcome"] == "improved"
    assert d["evidence"]["source"] == "exchange_matrix"
    assert "rebalanced P00005 off device 5" in d["note"]
    assert ts.stats("zipf")["rebalances"] >= 1


def test_noise_floor_and_one_decision_in_flight(mesh):
    """Below min_records no window is judged: a small skewed feed
    leaves the stream alone in both packages, and the first real
    window then decides once."""
    js, ts, jl, tl = skewed_pair(mesh, min_records=2048)
    chunks = _chunks(np.random.default_rng(11), 48)
    for s in (js, ts):
        s.feed(chunks[:16], task="t")
    assert decisions(tl) == decisions(jl) == []
    for s in (js, ts):
        s.feed(chunks, task="t")
        s.feed(chunks, task="t")
    assert decisions(tl) == decisions(jl)
    assert np.array_equal(ts.partition_map("t"), js.partition_map("t"))
    assert_snap_equal(ts.snapshot("t"), js.snapshot("t"))


def _refusal_run(session, rebalance_error, auto_mod, ledger_cls):
    """The JAX refusal script on one package's session: a direct
    overflowing rebalance raises; the controller, forced to propose it,
    records ONE refused row over two feeds' epilogues."""
    rng = np.random.default_rng(4)
    chunks = rng.integers(0, 400, size=(32, 32)).astype(np.int32)
    session.feed(chunks, task="t")
    session.feed(rng.integers(400, 900, size=(32, 32)).astype(np.int32),
                 task="t")
    before = session.snapshot("t")
    all_to_zero = np.zeros(session.engine.partition_buckets, np.int32)
    with pytest.raises(rebalance_error):
        session.rebalance("t", all_to_zero)
    led = ledger_cls()
    ctl = auto_mod.RepartitionController(led, imbalance_threshold=1.0,
                                         min_records=1)
    orig = auto_mod.plan_rebalance
    auto_mod.plan_rebalance = lambda weights, n_dev: all_to_zero
    try:
        ctl.after_feed(session, "t")
        ctl.after_feed(session, "t")
    finally:
        auto_mod.plan_rebalance = orig
    return led, before, chunks


def test_refused_rebalance_matches_jax(mesh):
    jl, jbefore, chunks = _refusal_run(
        jsession.EngineSession(mesh, many_keys_map_fn, PMAP_CFG, k=2),
        jspill.SessionRestoreError, jauto, jcontrol.ControlLedger)
    ts = tsession.EngineSession(Partitions(P, "cpu"), many_keys_map_fn_t,
                                pcfg(PMAP_CFG), k=2)
    tl, tbefore, _ = _refusal_run(ts, tspill.SessionRestoreError, tauto,
                                  tcontrol.ControlLedger)
    assert_snap_equal(tbefore, jbefore)
    assert decisions(tl) == decisions(jl)
    refused = [d for d in tl.decisions("repartition")
               if d["outcome"] == "refused"]
    assert len(refused) == 1 and "refused" in refused[0]["action"]
    # the stream is untouched: same rows, identity map, still feedable
    after = ts.snapshot("t")
    for f in ("keys", "values", "payload", "valid"):
        assert torch.equal(getattr(after, f), getattr(tbefore, f)), f
    assert ts.stats("t")["rebalances"] == 0
    assert np.array_equal(ts.partition_map("t"),
                          tde.identity_pmap(ts.engine.partition_buckets, P))
    ts.feed(chunks[:4], task="t")


def test_errored_rebalance_is_recorded_never_raised():
    """A stream closed between the evidence read and the install: the
    controller records outcome=error and the feed's caller sees no
    exception."""
    led = tcontrol.ControlLedger()
    ts = tsession.EngineSession(Partitions(P, "cpu"), skew_map_fn_t,
                                pcfg(PMAP_CFG), k=2)
    ts.feed(_chunks(np.random.default_rng(3), 48), task="z")
    ctl = tauto.RepartitionController(led, min_records=64)
    real = ts.rebalance

    def closed_first(task, pmap):
        ts.close(task)
        return real(task, pmap)

    ts.rebalance = closed_first
    assert ctl.after_feed(ts, "z") is not None
    d = led.decisions("repartition")[-1]
    assert d["outcome"] == "error" and "error" in d["action"]


def test_mistuned_capacity_converges_as_jax_does(mesh):
    """Run 1 retries and teaches the controller; run 2 starts
    right-sized with zero retries and resolves the decision improved:
    the same retries, decision and results in both packages."""
    chunks = np.random.default_rng(5).integers(
        0, 1 << 12, size=(32, 32)).astype(np.int32)
    jl, tl = jcontrol.ControlLedger(), tcontrol.ControlLedger()
    jt, tt = jauto.AutoTuner(ledger=jl), tauto.AutoTuner(ledger=tl)
    out = {}
    for run in (1, 2):
        jtm, ttm = {}, {}
        jr = jde.DeviceEngine(mesh, many_keys_map_fn, BAD_CFG,
                              autotune=jt).run(chunks, timings=jtm,
                                               waves=2)
        tr = tde.DeviceEngine(Partitions(P, "cpu"), many_keys_map_fn_t,
                              pcfg(BAD_CFG), autotune=tt).run(
            chunks, timings=ttm, waves=2)
        assert ttm["retries"] == jtm["retries"]
        assert tr.overflow == jr.overflow == 0
        assert_result_equal(tr, jr)
        out[run] = (ttm["retries"], tr)
    assert out[1][0] >= 1 and out[2][0] == 0
    assert decisions(tl) == decisions(jl)
    d = tl.decisions("capacity")[-1]
    assert d["outcome"] == "improved"
    assert d["evidence"]["capacity_retries_observed"] >= 1
    assert d["action"]["changes"]["out_capacity"]["old"] == 64
    for f in ("keys", "values", "payload", "valid"):
        assert torch.equal(getattr(out[1][1], f), getattr(out[2][1], f))


def test_session_presized_at_the_door_as_jax_does(mesh):
    """A tuner taught by a retrying batch run hands the session learned
    capacities before its first wave; the first feed is overflow-free
    and resolves the decision improved, in both packages."""
    chunks = np.random.default_rng(5).integers(
        0, 1 << 12, size=(32, 32)).astype(np.int32)
    jl, tl = jcontrol.ControlLedger(), tcontrol.ControlLedger()
    jt, tt = jauto.AutoTuner(ledger=jl), tauto.AutoTuner(ledger=tl)
    jde.DeviceEngine(mesh, many_keys_map_fn, BAD_CFG,
                     autotune=jt).run(chunks, waves=2)
    tm = {}
    tde.DeviceEngine(Partitions(P, "cpu"), many_keys_map_fn_t,
                     pcfg(BAD_CFG), autotune=tt).run(chunks, timings=tm,
                                                      waves=2)
    assert tm["retries"] >= 1
    js = jsession.EngineSession(mesh, many_keys_map_fn, BAD_CFG, k=2,
                                autotune=jt)
    ts = tsession.EngineSession(Partitions(P, "cpu"), many_keys_map_fn_t,
                                pcfg(BAD_CFG), k=2, autotune=tt)
    assert ts.config.out_capacity == js.config.out_capacity > 64
    assert ts.engine.config == ts.config
    assert ts.feed(chunks) == js.feed(chunks) == 0
    assert_snap_equal(ts.snapshot(), js.snapshot())
    assert decisions(tl) == decisions(jl)
    d = tl.decisions("capacity")[-1]
    assert d["outcome"] == "improved"
    assert d["outcome_evidence"]["overflow_rows_after"] == 0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_spill_after_controller_rebalance_crosses(mesh, tmp_path, writer):
    """A stream rebalanced by its controller spills; the other package
    restores it with the same partition map and bit-equal rows, and
    both streams go on feeding equal."""
    js, ts, _, _ = skewed_pair(mesh)
    chunks = _chunks(np.random.default_rng(3), 48)
    src, src_store = ((ts, tspill.SessionSpillStore(
        topen(f"shared:{tmp_path}"))) if writer == "port" else
        (js, jspill.SessionSpillStore(jopen(f"shared:{tmp_path}"))))
    src.spill = src_store
    for s in (js, ts):
        s.feed(chunks, task="z")
        s.feed(chunks, task="z")
    assert src.stats("z")["rebalances"] >= 1
    pmap = src.partition_map("z")
    assert not np.array_equal(pmap, tde.identity_pmap(len(pmap), P))
    src.evict("z")
    if writer == "port":
        dst = jsession.EngineSession(
            mesh, skew_map_fn, PMAP_CFG, k=2,
            spill=jspill.SessionSpillStore(jopen(f"shared:{tmp_path}")))
        port, jax = src, dst
    else:
        dst = tsession.EngineSession(
            Partitions(P, "cpu"), skew_map_fn_t, pcfg(PMAP_CFG), k=2,
            spill=tspill.SessionSpillStore(topen(f"shared:{tmp_path}")))
        port, jax = dst, src
    # the writer restores its own spill lazily, the other package the
    # same checkpoint
    assert_snap_equal(port.snapshot("z"), jax.snapshot("z"))
    assert np.array_equal(dst.partition_map("z"), pmap)
    for s in (port, jax):
        s.feed(chunks[:16], task="z")
    assert_snap_equal(port.snapshot("z"), jax.snapshot("z"))
    assert np.array_equal(port.partition_map("z"), jax.partition_map("z"))


def test_nothing_attached_records_nothing(mesh):
    """The embedder contract in both packages: engines and sessions
    with no controller record no decision, and the global ledgers stay
    empty."""
    jcontrol.LEDGER.reset()
    tcontrol.LEDGER.reset()
    j0 = JREG.sum("mrtpu_control_decisions_total")
    t0 = TREG.sum("mrtpu_control_decisions_total")
    chunks = np.random.default_rng(6).integers(
        0, 400, size=(16, 32)).astype(np.int32)
    jr = jde.DeviceEngine(mesh, many_keys_map_fn, PMAP_CFG).run(
        chunks, waves=1)
    teng = tde.DeviceEngine(Partitions(P, "cpu"), many_keys_map_fn_t,
                            pcfg(PMAP_CFG))
    assert teng.autotune is None and teng.task_label == "-"
    tr = teng.run(chunks, waves=1)
    assert_result_equal(tr, jr)
    ts = tsession.EngineSession(Partitions(P, "cpu"), skew_map_fn_t,
                                pcfg(PMAP_CFG), k=2)
    ts.feed(_chunks(np.random.default_rng(3), 48))
    assert ts.autotune is None and ts.stats()["rebalances"] == 0
    assert JREG.sum("mrtpu_control_decisions_total") == j0
    assert TREG.sum("mrtpu_control_decisions_total") == t0
    assert jcontrol.LEDGER.snapshot() == tcontrol.LEDGER.snapshot() == {}


def test_autotune_key_ignores_capacities():
    """A run and a session of one program family share a key whatever
    their capacities (or nothing is ever learned); the key spells the
    JAX package's fields."""
    parts = Partitions(P, "cpu")
    a = tde.DeviceEngine(parts, many_keys_map_fn_t, pcfg(BAD_CFG))
    b = tde.DeviceEngine(parts, many_keys_map_fn_t,
                         dataclasses.replace(pcfg(BAD_CFG),
                                             out_capacity=4096,
                                             exchange_capacity=1024))
    s = tsession.EngineSession(parts, many_keys_map_fn_t, pcfg(BAD_CFG))
    assert a.autotune_key() == b.autotune_key() == \
        s.engine.autotune_key()
    assert a.autotune_key() == (
        f"{__name__}:many_keys_map_fn_t|sum|False|False|variadic|64|8")
    assert tde.DeviceEngine(Partitions(1, "cpu"), many_keys_map_fn_t,
                            pcfg(BAD_CFG)).autotune_key() != \
        a.autotune_key()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matrix_stats_equal_jax(seed):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 1000, size=(P, P))
    m[:, seed % P] *= 5  # a hot destination
    assert matrix_stats(m.tolist()) == jmatrix_stats(m.tolist())
    empty = np.zeros((P, P), np.int64).tolist()
    assert matrix_stats(empty) == jmatrix_stats(empty)
