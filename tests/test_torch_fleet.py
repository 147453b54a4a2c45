"""The port's engine-host fleet against the JAX package's, step for step.

Each case of ``tests/test_fleet.py`` runs here as one scenario through
both packages in the same process: ``coord/fleet`` (membership, drain,
reap and fence, guarded routes, advisor sync, ``rehome_routes``,
``fleet_snapshot``), ``engine/migrate``, the ``FleetRebalancer``, the
scheduler's ``recovery_sweep``, the ``/statusz`` fleet section and its
rendering, and ``diagnose``.  The JAX side runs its sessions on the
8-device CPU mesh with ``tests.test_fused_engine._records_map_fn``; the
port's on ``Partitions(8, "cpu")`` with its torch twin.  The same
sequence of operations must give equal host and route documents (the
wall stamps aside), equal moves, equal control-ledger decisions (ids,
clocks and the measured ``spill_s`` aside) and snapshots bit-equal to
each other (tolerance: none).  Last, fleet documents written by either
package are read by the other's registry on ``dir://`` and ``http://``.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from mapreduce_tpu import cli as jcli
from mapreduce_tpu.coord import docserver as jdocserver
from mapreduce_tpu.coord import docstore as jdocstore
from mapreduce_tpu.coord import fleet as jfleet
from mapreduce_tpu.engine import autotune as jautotune
from mapreduce_tpu.engine import device_engine as jde
from mapreduce_tpu.engine import migrate as jmigrate
from mapreduce_tpu.engine import session as jsession
from mapreduce_tpu.engine import spill as jspill
from mapreduce_tpu.obs import analysis as janalysis
from mapreduce_tpu.obs import control as jcontrol
from mapreduce_tpu.obs import metrics as jmetrics
from mapreduce_tpu.obs import statusz as jstatusz
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu.sched import scheduler as jscheduler
from mapreduce_tpu.storage.memory import MemoryStorage as JMemoryStorage
from mapreduce_tpu_torch import cli as tcli
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.coord import docserver as tdocserver
from mapreduce_tpu_torch.coord import docstore as tdocstore
from mapreduce_tpu_torch.coord import fleet as tfleet
from mapreduce_tpu_torch.engine import autotune as tautotune
from mapreduce_tpu_torch.engine import device_engine as tde
from mapreduce_tpu_torch.engine import migrate as tmigrate
from mapreduce_tpu_torch.engine import session as tsession
from mapreduce_tpu_torch.engine import spill as tspill
from mapreduce_tpu_torch.obs import analysis as tanalysis
from mapreduce_tpu_torch.obs import control as tcontrol
from mapreduce_tpu_torch.obs import metrics as tmetrics
from mapreduce_tpu_torch.obs import statusz as tstatusz
from mapreduce_tpu_torch.parallel.mesh import Partitions
from mapreduce_tpu_torch.sched import scheduler as tscheduler
from mapreduce_tpu_torch.storage import MemoryStorage as TMemoryStorage
from tests.test_fused_engine import _chunks as _rec_chunks
from tests.test_fused_engine import _records_map_fn
from tests.test_torch_session import port_cfg, records_map_fn

P = 8

JCFG = jde.EngineConfig(local_capacity=256, exchange_capacity=128,
                        out_capacity=256, tile=64, tile_records=64,
                        reduce_op="sum")
JPMCFG = jde.EngineConfig(local_capacity=256, exchange_capacity=64,
                          out_capacity=256, reduce_op="sum",
                          partition_map=True)

#: host-doc and route-doc fields that are wall stamps (board clock) or
#: the lease's random holder token
STAMPS = ("lease_expires", "facts_time", "drain_time", "reaped_time",
          "moved_time", "tmpname")
#: the host lease of a host a scenario keeps alive: it outlives the
#: scenario however loaded the machine is (under the whole suite's load
#: more than the default 5 s passed between a join and the sweep)
LIVE_LEASE = 600.0


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def _pkgs(mesh):
    """The two packages' modules and session makers, by name."""
    jax = SimpleNamespace(
        name="jax", docstore=jdocstore, fleet=jfleet, autotune=jautotune,
        migrate=jmigrate.migrate, session=jsession, spill=jspill,
        control=jcontrol, REGISTRY=jmetrics.REGISTRY,
        scheduler=jscheduler, statusz=jstatusz, cli=jcli,
        analysis=janalysis, identity_pmap=jde.identity_pmap,
        n_dev=mesh.shape["data"],
        store=lambda: jspill.SessionSpillStore(JMemoryStorage()),
        session_of=lambda cfg, **kw: jsession.EngineSession(
            mesh, _records_map_fn, cfg, **kw))
    port = SimpleNamespace(
        name="port", docstore=tdocstore, fleet=tfleet, autotune=tautotune,
        migrate=tmigrate.migrate, session=tsession, spill=tspill,
        control=tcontrol, REGISTRY=tmetrics.REGISTRY,
        scheduler=tscheduler, statusz=tstatusz, cli=tcli,
        analysis=tanalysis, identity_pmap=tde.identity_pmap, n_dev=P,
        store=lambda: tspill.SessionSpillStore(TMemoryStorage()),
        session_of=lambda cfg, **kw: tsession.EngineSession(
            Partitions(P, "cpu"), records_map_fn, port_cfg(cfg), **kw))
    return jax, port


def _both(mesh, scenario):
    """Run *scenario(pk)* through both packages; returns the two
    results after checking they are equal."""
    jax, port = _pkgs(mesh)
    got_j, got_t = scenario(jax), scenario(port)
    _assert_same(got_j, got_t)
    return got_j, got_t


def _assert_same(a, b, path="result"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, np.asarray(b)), path
    else:
        assert a == b, (path, a, b)


def _strip(doc):
    """A fleet document without its wall stamps."""
    return {k: v for k, v in (doc or {}).items() if k not in STAMPS}


def _hosts(reg):
    return sorted((_strip(d) for d in reg.hosts()),
                  key=lambda d: str(d["_id"]))


def _decision(dec):
    """A ledger decision without its id, clocks and measured seconds."""
    out = {k: v for k, v in dec.items()
           if k not in ("id", "monotonic", "time")}
    out["evidence"] = {k: v for k, v in dec["evidence"].items()
                       if k != "spill_s"}
    return out


def _snap(pk, snap):
    """A snapshot as numpy arrays in the JAX package's dtypes."""
    if pk.name == "port":
        return tuple(convert.device_result_to_numpy(snap))[:4]
    return tuple(np.asarray(getattr(snap, f))
                 for f in ("keys", "values", "payload", "valid"))


def _chunks(s=32, seed=7):
    return _rec_chunks(np.random.default_rng(seed), s)


def _board(pk, name):
    return pk.docstore.connect(f"mem://{pk.name}-{name}")


# -- membership --------------------------------------------------------------


def test_membership_lifecycle_drain_reap_and_fence(mesh):
    def scenario(pk):
        board = _board(pk, "fleet-lifecycle")
        a = pk.fleet.FleetMember(board, host_id="hostA", lease=0.4)
        b = pk.fleet.FleetMember(board, host_id="hostB")
        gen_a = a.join(timeout=2.0, warm_programs=["wc"], hbm_frac=0.3)
        b.join(timeout=2.0)
        reg = pk.fleet.FleetRegistry(board)
        now = pk.docstore.now()
        out = {"states": {str(d["_id"]): pk.fleet.host_state(d, now)
                          for d in reg.hosts()}}
        assert reg.request_drain("hostA")
        doc = a.heartbeat(warm_programs=["wc"], hbm_frac=0.3)
        out["drain_doc"] = _strip(doc)
        out["draining"] = pk.fleet.host_state(doc, pk.docstore.now())
        out["live"] = sorted(str(d["_id"]) for d in reg.live_hosts())
        assert b.leave()
        doc_b = next(d for d in reg.hosts() if d["_id"] == "hostB")
        out["left"] = pk.fleet.host_state(doc_b, pk.docstore.now())
        time.sleep(0.5)                     # hostA misses its beats
        expired = reg.expired_hosts()
        out["expired"] = [d["_id"] for d in expired]
        out["reaps"] = [reg.reap(expired[0]), reg.reap(expired[0])]
        out["zombie"] = a.heartbeat()
        with pytest.raises(pk.fleet.HostFencedError):
            a.ensure_member()
        out["rejoin_newer"] = a.join(timeout=2.0) > gen_a
        out["hosts"] = _hosts(reg)
        return out

    got, _ = _both(mesh, scenario)
    assert got["states"] == {"hostA": "live", "hostB": "live"}
    assert got["drain_doc"]["drain"] is True
    assert got["draining"] == "draining" and got["left"] == "left"
    assert got["live"] == ["hostA", "hostB"]
    assert got["expired"] == ["hostA"] and got["reaps"] == [True, False]
    assert got["zombie"] is None and got["rejoin_newer"]


def test_routes_are_guarded(mesh):
    def scenario(pk):
        reg = pk.fleet.FleetRegistry(_board(pk, "fleet-routes"))
        reg.assign("t", "hostA", program="wc")
        out = {"wrong_src": reg.reroute("t", "hostB", expect_src="hostC"),
               "after_wrong": _strip(reg.route("t")),
               "right_src": reg.reroute("t", "hostB", expect_src="hostA"),
               "after_right": _strip(reg.route("t"))}
        reg.drop_route("t")
        out["dropped"] = reg.route("t")
        return out

    got, _ = _both(mesh, scenario)
    assert not got["wrong_src"] and got["right_src"]
    assert got["after_wrong"]["host"] == "hostA"
    assert got["after_right"] == {"_id": "t", "host": "hostB",
                                  "program": "wc", "reason": "place"}
    assert got["dropped"] is None


def test_advisor_sync_mirrors_fleet_membership(mesh):
    def scenario(pk):
        board = _board(pk, "fleet-advisor")
        a = pk.fleet.FleetMember(board, host_id="hostA", lease=0.4)
        a.join(timeout=2.0, warm_programs=["wc"], hbm_frac=0.3)
        reg = pk.fleet.FleetRegistry(board)
        adv = pk.autotune.AdmissionAdvisor()
        adv.register_mesh("embedder", warm_programs=["x"], hbm_frac=None)
        reg.sync_advisor(adv)
        out = {"synced": {m: dict(e) for m, e in adv._meshes.items()}}
        time.sleep(0.5)
        reg.reap(reg.expired_hosts()[0])
        reg.sync_advisor(adv)
        out["after_reap"] = sorted(adv._meshes)
        return out

    got, _ = _both(mesh, scenario)
    assert set(got["synced"]) == {"embedder", "hostA"}
    assert got["after_reap"] == ["embedder"]


def test_default_host_id_is_process_unique():
    hid = tfleet.default_host_id()
    assert ":" in hid and hid.rsplit(":", 1)[1].isdigit()
    assert hid == jfleet.default_host_id()  # one spelling, one process


# -- live migration ----------------------------------------------------------


def test_migration_bit_identical_and_registry_routed(mesh):
    chunks = _chunks()
    half = len(chunks) // 2

    def scenario(pk):
        ref_s = pk.session_of(JCFG, task="ref", k=1)
        ref_s.feed(chunks[:half])
        ref_s.feed(chunks[half:])
        ref = _snap(pk, ref_s.snapshot())
        board = _board(pk, "fleet-migrate")
        for h in ("hostA", "hostB"):
            pk.fleet.FleetMember(board, host_id=h).join(timeout=2.0)
        reg = pk.fleet.FleetRegistry(board)
        reg.assign("t", "hostA", program="p")
        store = pk.store()
        src = pk.session_of(JCFG, task="t", k=1, spill=store)
        dst = pk.session_of(JCFG, task="t", k=1, spill=store)
        src.feed(chunks[:half])
        ledger = pk.control.ControlLedger()
        m0 = pk.REGISTRY.sum("mrtpu_session_migrations_total", task="t",
                             reason="explicit")
        res = pk.migrate("t", src, dst, registry=reg, src_host="hostA",
                         dst_host="hostB", reason="explicit",
                         ledger=ledger)
        out = {"routed": res["routed"], "step": res["step"],
               "reason": res["reason"],
               "route": _strip(reg.route("t")),
               "counted": pk.REGISTRY.sum(
                   "mrtpu_session_migrations_total", task="t",
                   reason="explicit") - m0,
               "decisions": [_decision(d) for d in ledger.decisions(
                   controller="fleet")]}
        with pytest.raises(pk.session.SessionBusyError):
            src.feed(chunks[half:])
        with pytest.raises(pk.session.SessionBusyError):
            src.snapshot("t")
        dst.feed(chunks[half:])
        out["dst"] = _snap(pk, dst.snapshot())
        _assert_same(out["dst"], ref)
        ref_s.close(), src.close(), dst.close()
        return out

    got, _ = _both(mesh, scenario)
    assert got["routed"] and got["step"] is not None
    assert got["route"]["host"] == "hostB" and got["counted"] == 1
    (dec,) = got["decisions"]
    assert "hostA -> hostB" in dec["note"] and dec["outcome"] == "applied"
    assert dec["action"] == {"dst": "hostB", "reason": "explicit",
                             "routed": True}


def test_migrate_back_lifts_the_handoff_refusal(mesh):
    chunks = _chunks(16)

    def scenario(pk):
        ref_s = pk.session_of(JCFG, task="ref", k=1)
        ref_s.feed(chunks)
        ref = _snap(pk, ref_s.snapshot())
        store = pk.store()
        sa = pk.session_of(JCFG, task="t", k=1, spill=store)
        sb = pk.session_of(JCFG, task="t", k=1, spill=store)
        sa.feed(chunks[:8])
        ledger = pk.control.ControlLedger()
        pk.migrate("t", sa, sb, ledger=ledger)
        sb.feed(chunks[8:])
        pk.migrate("t", sb, sa, ledger=ledger)
        out = {"back": _snap(pk, sa.snapshot()),
               "decisions": [_decision(d) for d in ledger.decisions()]}
        _assert_same(out["back"], ref)
        ref_s.close(), sa.close(), sb.close()
        return out

    got, _ = _both(mesh, scenario)
    assert [d["action"]["dst"] for d in got["decisions"]] == ["-", "-"]


def test_feed_racing_migration_gets_retry_after_not_broken(mesh):
    chunks = _chunks()
    half = len(chunks) // 2

    def scenario(pk):
        ref_s = pk.session_of(JCFG, task="ref", k=1)
        ref_s.feed(chunks[:half])
        ref_s.feed(chunks[half:])
        ref = _snap(pk, ref_s.snapshot())
        store = pk.store()
        s = pk.session_of(JCFG, task="t", k=1, spill=store)
        s.feed(chunks[:half])
        entered = threading.Event()
        orig = store.save_stream

        def slow_save(*a, **k):
            entered.set()
            time.sleep(0.2)                 # hold the evict open
            return orig(*a, **k)

        store.save_stream = slow_save
        b0 = pk.REGISTRY.sum("mrtpu_session_backpressure_total",
                             task="t", reason="migrating")
        t = threading.Thread(target=s.migrate_out, args=("t",))
        t.start()
        assert entered.wait(10)             # the evict is in flight NOW
        try:
            with pytest.raises(pk.session.SessionBusyError) as exc:
                s.feed(chunks[half:])
            assert not isinstance(exc.value,
                                  pk.session.SessionStreamBroken)
        finally:
            t.join(timeout=30)
            store.save_stream = orig
        out = {"refused": pk.REGISTRY.sum(
            "mrtpu_session_backpressure_total", task="t",
            reason="migrating") - b0}
        dst = pk.session_of(JCFG, task="t", k=1, spill=store)
        dst.feed(chunks[half:])             # lazy restore + the rest
        out["dst"] = _snap(pk, dst.snapshot())
        _assert_same(out["dst"], ref)
        ref_s.close(), s.close(), dst.close()
        return out

    got, _ = _both(mesh, scenario)
    assert got["refused"] == 1


def test_partition_map_survives_same_topology_migration(mesh):
    def scenario(pk):
        n_dev = pk.n_dev
        chunks = _rec_chunks(np.random.default_rng(37), 4 * n_dev)
        half = chunks.shape[0] // 2

        def mk(store=None):
            return pk.session_of(JPMCFG, task="t", k=2, spill=store)

        ref_s = mk()
        ref_s.feed(chunks[:0])              # latch the shape
        pm = (pk.identity_pmap(ref_s.engine.partition_buckets, n_dev)
              + 3) % n_dev                  # every bucket moves
        ref_s.rebalance("t", pm)
        ref_s.feed(chunks[:half])
        ref_s.feed(chunks[half:])
        ref = _snap(pk, ref_s.snapshot())
        store = pk.store()
        src = mk(store)
        src.feed(chunks[:0])
        src.rebalance("t", pm)
        src.feed(chunks[:half])
        dst = mk(store)
        pk.migrate("t", src, dst, ledger=pk.control.ControlLedger())
        dst.feed(chunks[half:])             # restore must carry the map
        out = {"rebalances": dst.stats("t")["rebalances"],
               "dst": _snap(pk, dst.snapshot())}
        _assert_same(out["dst"], ref)
        ref_s.close(), src.close(), dst.close()
        return out

    got, _ = _both(mesh, scenario)
    assert got["rebalances"] == 1


# -- failed-host recovery ----------------------------------------------------


def test_recovery_sweep_rehomes_dead_hosts_streams(mesh):
    chunks = _chunks(16)

    def scenario(pk):
        board = _board(pk, "fleet-recovery")
        a = pk.fleet.FleetMember(board, host_id="hostA", lease=0.4)
        b = pk.fleet.FleetMember(board, host_id="hostB", lease=LIVE_LEASE)
        a.join(timeout=2.0)
        b.join(timeout=2.0, warm_programs=[], hbm_frac=0.2)
        reg = pk.fleet.FleetRegistry(board)
        store = pk.store()
        sa = pk.session_of(JCFG, task="t1", k=1, spill=store)
        sa.feed(chunks, task="t1")
        sa.feed(chunks, task="t2")
        ref1 = _snap(pk, sa.snapshot("t1"))
        ref2 = _snap(pk, sa.snapshot("t2"))
        sa.spill_stream("t1")
        sa.spill_stream("t2")
        reg.assign("t1", "hostA")
        reg.assign("t2", "hostA")
        time.sleep(0.5)                     # hostA "dies": no more beats
        sched = pk.scheduler.Scheduler(
            board, use_lease=False, advisor=pk.autotune.AdmissionAdvisor(),
            fleet=reg)
        r0 = pk.REGISTRY.sum("mrtpu_fleet_recoveries_total", host="hostA")
        d0 = len(pk.control.LEDGER.decisions(controller="fleet"))
        moves = sched.recovery_sweep()
        out = {"moves": sorted(moves),
               "recovered": pk.REGISTRY.sum(
                   "mrtpu_fleet_recoveries_total", host="hostA") - r0,
               "decisions": [_decision(d) for d in
                             pk.control.LEDGER.decisions(
                                 controller="fleet")[d0:]],
               "hosts": _hosts(reg),
               "zombie": a.heartbeat(),
               "again": sched.recovery_sweep()}
        sb = pk.session_of(JCFG, task="t", k=1, spill=store)
        out["t1"] = _snap(pk, sb.snapshot("t1"))
        out["t2"] = _snap(pk, sb.snapshot("t2"))
        _assert_same((out["t1"], out["t2"]), (ref1, ref2))
        sa.close(drop_spill=False), sb.close()
        return out

    got, _ = _both(mesh, scenario)
    assert got["moves"] == [("t1", "hostB"), ("t2", "hostB")]
    assert got["recovered"] == 1 and got["zombie"] is None
    assert got["again"] == []
    assert next(h for h in got["hosts"] if h["_id"] == "hostA")[
        "holder"] is None                   # reaped
    assert [d["action"]["dst"] for d in got["decisions"]] == \
        ["hostB", "hostB"]


def test_recovery_defers_with_no_live_destination(mesh):
    def scenario(pk):
        board = _board(pk, "fleet-defer")
        a = pk.fleet.FleetMember(board, host_id="hostA", lease=0.3)
        a.join(timeout=2.0)
        reg = pk.fleet.FleetRegistry(board)
        reg.assign("t", "hostA")
        time.sleep(0.4)
        sched = pk.scheduler.Scheduler(board, use_lease=False, fleet=reg)
        d0 = len(pk.control.LEDGER.decisions(controller="fleet"))
        out = {"first": sched.recovery_sweep(),
               "route": reg.route("t")["host"],
               "expired": [d["_id"] for d in reg.expired_hosts()],
               "refusal": [_decision(d) for d in
                           pk.control.LEDGER.decisions(
                               controller="fleet")[d0:]]}
        pk.fleet.FleetMember(board, host_id="hostB").join(timeout=2.0)
        out["second"] = sched.recovery_sweep()
        out["hosts"] = _hosts(reg)
        return out

    got, _ = _both(mesh, scenario)
    assert got["first"] == [] and got["route"] == "hostA"
    assert got["expired"] == ["hostA"]
    (dec,) = got["refusal"]
    assert dec["outcome"] == "refused"
    assert got["second"] == [("t", "hostB")]


# -- the rebalance controller ------------------------------------------------


def test_rebalancer_moves_coldest_stream_off_hot_host(mesh):
    chunks = _chunks(16)

    def scenario(pk):
        board = _board(pk, "fleet-rebalance")
        pk.fleet.FleetMember(board, host_id="hostA", lease=LIVE_LEASE).join(
            timeout=2.0, warm_programs=[], hbm_frac=0.95)
        pk.fleet.FleetMember(board, host_id="hostB", lease=LIVE_LEASE).join(
            timeout=2.0, warm_programs=[], hbm_frac=0.10)
        reg = pk.fleet.FleetRegistry(board)
        store = pk.store()
        sa = pk.session_of(JCFG, task="cold", k=1, spill=store)
        sb = pk.session_of(JCFG, task="cold", k=1, spill=store)
        sa.feed(chunks, task="cold")
        ref_cold = _snap(pk, sa.snapshot("cold"))
        time.sleep(0.01)
        sa.feed(chunks, task="hot")         # newer touch: stays put
        reg.assign("cold", "hostA")
        reg.assign("hot", "hostA")
        ledger = pk.control.ControlLedger()
        rb = pk.autotune.FleetRebalancer(reg, ledger=ledger)
        out = {"moves": rb.step({"hostA": sa, "hostB": sb}),
               "cold": reg.route("cold")["host"],
               "hot": reg.route("hot")["host"],
               "decisions": [_decision(d) for d in ledger.decisions()]}
        with pytest.raises(pk.session.SessionBusyError):
            sa.feed(chunks, task="cold")    # handed off
        out["moved"] = _snap(pk, sb.snapshot("cold"))
        _assert_same(out["moved"], ref_cold)
        sa.close(), sb.close()
        return out

    got, _ = _both(mesh, scenario)
    assert got["moves"] == [("cold", "hostB")]
    assert (got["cold"], got["hot"]) == ("hostB", "hostA")
    (dec,) = got["decisions"]
    assert dec["evidence"]["hbm_frac"] == 0.95
    assert "candidates" in dec["evidence"]


def test_rebalancer_refusal_is_memoized_not_spam(mesh):
    chunks = _chunks(16)

    def scenario(pk):
        board = _board(pk, "fleet-refuse")
        pk.fleet.FleetMember(board, host_id="hostA").join(
            timeout=2.0, warm_programs=[], hbm_frac=0.9)
        reg = pk.fleet.FleetRegistry(board)
        sa = pk.session_of(JCFG, task="t", k=1, spill=pk.store())
        sa.feed(chunks)
        reg.assign("t", "hostA")
        ledger = pk.control.ControlLedger()
        rb = pk.autotune.FleetRebalancer(reg, ledger=ledger)
        out = {"steps": [rb.step({"hostA": sa}), rb.step({"hostA": sa})],
               "decisions": [_decision(d) for d in ledger.decisions()]}
        sa.close()
        return out

    got, _ = _both(mesh, scenario)
    assert got["steps"] == [[], []]
    (dec,) = got["decisions"]
    assert dec["outcome"] == "refused"


# -- surfaces: statusz, status render, diagnose ------------------------------


def test_statusz_fleet_section_and_render(mesh):
    def scenario(pk):
        board = _board(pk, "fleet-statusz")
        out = {"empty": "fleet" in pk.statusz.cluster_status(board)}
        pk.fleet.FleetMember(board, host_id="hostA").join(
            timeout=2.0, warm_programs=["wc"], hbm_frac=0.4)
        pk.fleet.FleetRegistry(board).assign("t", "hostA")
        fl = pk.statusz.cluster_status(board)["fleet"]
        lease = fl["hosts"]["hostA"].pop("lease_expires_in")
        assert 0 < lease <= pk.fleet.DEFAULT_HOST_LEASE
        out["fleet"] = fl
        out["gauge"] = pk.REGISTRY.sum("mrtpu_fleet_hosts",
                                       state="live") >= 1
        return out

    got, _ = _both(mesh, scenario)
    assert got["empty"] is False and got["gauge"]
    assert got["fleet"]["hosts"]["hostA"]["state"] == "live"
    assert got["fleet"]["hosts"]["hostA"]["streams"] == 1
    assert got["fleet"]["routes"] == 1
    # the two renderers give the same lines for the same section
    fl = dict(got["fleet"])
    fl["hosts"] = {"hostA": dict(fl["hosts"]["hostA"],
                                 lease_expires_in=4.2)}
    lines = tcli._render_fleet(fl)
    assert lines == jcli._render_fleet(fl)
    assert "hostA" in "\n".join(lines) and "LIVE" in "\n".join(lines)


def test_diagnose_surfaces_fleet_findings():
    doc = {"mrtpuCluster": {"metrics": [
        ["mrtpu_session_migrations_total",
         {"task": "t", "reason": "recovery"}, 2],
        ["mrtpu_session_migrations_total",
         {"task": "u", "reason": "rebalance"}, 1],
        ["mrtpu_fleet_recoveries_total", {"host": "hostA"}, 1],
        ["mrtpu_fleet_hosts", {"state": "live"}, 2],
        ["mrtpu_fleet_hosts", {"state": "expired"}, 1],
    ]}}
    report = tanalysis.diagnose(doc)
    jreport = janalysis.diagnose(doc)
    fl = report["fleet"]
    assert fl == jreport["fleet"]
    assert fl["migrations"] == {"recovery": 2, "rebalance": 1}
    assert fl["recovered_hosts"] == {"hostA": 1}
    assert fl["hosts"] == {"live": 2, "expired": 1}

    def fleet_notes(r):
        return [n for n in r["notes"] if n.startswith("fleet:")]

    assert fleet_notes(report) == fleet_notes(jreport)
    notes = "\n".join(report["notes"])
    assert "3 stream migration(s)" in notes
    assert "host hostA died" in notes and "expired lease" in notes
    text = tanalysis.render_diagnosis(report)
    assert "engine fleet:" in text and "recovered host hostA" in text


def test_rehome_prefers_warm_host_with_headroom(mesh):
    def scenario(pk):
        board = _board(pk, "fleet-score")
        for hid, warm, frac in (("cold", [], 0.1),
                                ("warm", ["wc"], 0.5),
                                ("hot", ["wc"], 0.95)):
            pk.fleet.FleetMember(board, host_id=hid).join(
                timeout=2.0, warm_programs=warm, hbm_frac=frac)
        reg = pk.fleet.FleetRegistry(board)
        reg.assign("t", "dead", program="wc")
        ledger = pk.control.ControlLedger()
        return {"moves": pk.fleet.rehome_routes(
                    reg, "dead", reason="recovery", ledger=ledger),
                "decisions": [_decision(d) for d in ledger.decisions()]}

    got, _ = _both(mesh, scenario)
    assert got["moves"] == [("t", "warm")]
    cands = got["decisions"][0]["evidence"]["candidates"]
    assert cands["hot"]["score"] < cands["cold"]["score"] < \
        cands["warm"]["score"]                  # pressure penalised


def test_default_host_lease_is_the_detection_window():
    assert 0 < tfleet.DEFAULT_HOST_LEASE <= 10.0
    assert (tfleet.DEFAULT_HOST_LEASE, tfleet.PRESSURE_FRAC,
            tfleet.HOSTS_COLL, tfleet.ROUTES_COLL) == (
        jfleet.DEFAULT_HOST_LEASE, jfleet.PRESSURE_FRAC,
        jfleet.HOSTS_COLL, jfleet.ROUTES_COLL)


# -- either package reads the other's fleet ----------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("board", ["dir", "http"])
def test_fleet_docs_read_across_packages(tmp_path, writer, board):
    """Host and route docs one package's members and registry wrote are
    read by the other's registry (``hosts``, ``route``, ``routes_for``,
    ``host_state``, ``fleet_snapshot``, ``rehome_routes``) as the
    writer's own reads them, on a ``dir://`` board and over ``http://``
    (the reader's package serves the board)."""
    wfleet, wstore = ((jfleet, jdocstore) if writer == "jax"
                      else (tfleet, tdocstore))
    rfleet, rstore = ((tfleet, tdocstore) if writer == "jax"
                      else (jfleet, jdocstore))
    server = None
    if board == "dir":
        connstr = f"dir://{tmp_path}"
    else:
        server = (tdocserver if writer == "jax"
                  else jdocserver).DocServer().start_background()
        connstr = f"http://{server.host}:{server.port}"
    try:
        w, r = wstore.connect(connstr), rstore.connect(connstr)
        a = wfleet.FleetMember(w, host_id="hostA")
        a.join(timeout=5.0, warm_programs=["wc"], hbm_frac=0.3)
        b = wfleet.FleetMember(w, host_id="hostB")
        b.join(timeout=5.0, warm_programs=[], hbm_frac=0.1)
        wreg = wfleet.FleetRegistry(w)
        wreg.assign("t", "hostA", program="wc")
        wreg.request_drain("hostA")
        rreg = rfleet.FleetRegistry(r)
        assert [_strip(d) for d in sorted(rreg.hosts(),
                                          key=lambda d: d["_id"])] == \
            [_strip(d) for d in sorted(wreg.hosts(),
                                       key=lambda d: d["_id"])]
        assert rreg.route("t") == wreg.route("t")
        assert rreg.routes_for("hostA") == wreg.routes_for("hostA")
        now = wstore.now()
        assert [rfleet.host_state(d, now) for d in rreg.hosts()] == \
            [wfleet.host_state(d, now) for d in wreg.hosts()]
        snap_r = rfleet.fleet_snapshot(r, now=now)
        snap_w = wfleet.fleet_snapshot(w, now=now)
        assert snap_r == snap_w
        assert snap_r["hosts"]["hostA"]["state"] == "draining"
        # the reader moves the writer's stream; the writer sees the move
        assert rfleet.rehome_routes(rreg, "hostA", reason="drain") == \
            [("t", "hostB")]
        assert wreg.route("t")["host"] == "hostB"
        # and the writer's member still beats its own doc
        assert a.heartbeat() is not None and b.leave()
        assert rfleet.host_state(
            next(d for d in rreg.hosts() if d["_id"] == "hostB"),
            rstore.now()) == "left"
    finally:
        if server is not None:
            server.shutdown()


def test_cluster_doc_carries_the_fleet_families():
    """The port's /clusterz carries the four fleet families (the JAX
    collector leaves them out), so ``diagnose`` over a live board names a
    drain another process made; ``mrtpu_fleet_hosts`` merges by MAX."""
    from mapreduce_tpu_torch.obs import collector as tcollector

    assert {"mrtpu_fleet_hosts", "mrtpu_fleet_heartbeats_total",
            "mrtpu_fleet_recoveries_total",
            "mrtpu_session_migrations_total"} <= tcollector.DIAG_FAMILIES
    reg = tfleet.FleetRegistry(tdocstore.connect("mem://port-fleet-diag"))
    for h in ("hostA", "hostB"):
        tfleet.FleetMember(reg.store, host_id=h).join(timeout=2.0)
    reg.assign("diag-t", "hostA")
    tfleet.rehome_routes(reg, "hostA", reason="drain",
                         ledger=tcontrol.ControlLedger())
    tfleet.fleet_snapshot(reg.store)
    doc = tcollector.Collector().cluster_doc()
    rows = {(n, tuple(sorted(lb.items()))): v
            for n, lb, v in doc["mrtpuCluster"]["metrics"]}
    assert rows[("mrtpu_session_migrations_total",
                 (("reason", "drain"), ("task", "diag-t")))] >= 1
    report = tanalysis.diagnose(doc)
    assert report["fleet"]["migrations"]["drain"] >= 1
    assert report["fleet"]["hosts"]["live"] >= 2
    assert any("stream migration" in n for n in report["notes"])
