"""Chaos cases of the port's always-on service: a ``FaultProxy``
partition between the board and the cross-tenant worker pool, worker
churn and a cancelled queued tenant (JAX ``tests/test_sched_chaos.py``),
and the runner riding a board failover (JAX
``tests/test_board_ha.py::test_task_runner_poll_survives_failover``).
Exactly-once per tenant is counted by witness modules defined here.
Every wait has a deadline; every lease is under a second.
"""

import sys
import threading
import time
import types
import uuid
from collections import Counter

import pytest

from mapreduce_tpu_torch.coord import docstore
from mapreduce_tpu_torch.coord.docserver import DocServer
from mapreduce_tpu_torch.parallel.mesh import Partitions
from mapreduce_tpu_torch.sched.scheduler import (
    ADMITTED, CANCELLED, DONE, QUEUED, RUNNING, Scheduler, SchedulerConfig)
from mapreduce_tpu_torch.sched.service import (
    ScheduledWorker, TaskRunner, wait_for_state)
from mapreduce_tpu_torch.testing.faults import FaultProxy
from mapreduce_tpu_torch.utils.hashing import fnv1a32
from mapreduce_tpu_torch.utils.httpclient import RetryPolicy

CHAOS_RETRY = RetryPolicy(max_attempts=8, base_delay=0.02, max_delay=0.3,
                          deadline=20.0, breaker_threshold=0)
TIMEOUT = 60
LEASE = 0.6

pytestmark = [pytest.mark.chaos, pytest.mark.telemetry]

#: per witness module: STARTED at map entry, COMPLETED after the last emit
WITNESS = {}


def _tenant(tmp_path, name, n_files, map_delay=0.0):
    """Task params of a fresh witness module for tenant *name*."""
    mod_name = f"torch_chaos_{name}_{uuid.uuid4().hex[:8]}"
    st = WITNESS[mod_name] = {"STARTED": Counter(), "COMPLETED": Counter(),
                              "RESULT": {}, "lock": threading.Lock()}
    files = []
    for i in range(n_files):
        p = tmp_path / f"{name}{i}.txt"
        p.write_text(f"alpha beta {name}{i} gamma alpha\n" * 4)
        files.append(str(p))
    mod = types.ModuleType(mod_name)

    def taskfn(emit):
        for i, path in enumerate(files):
            emit(i, path)

    def mapfn(key, value, emit):
        with st["lock"]:
            st["STARTED"][key] += 1
        if map_delay:
            time.sleep(map_delay)
        with open(value) as f:
            for line in f:
                for word in line.split():
                    emit(word, 1)
        with st["lock"]:
            st["COMPLETED"][key] += 1

    def partitionfn(key):
        return fnv1a32(key.encode()) % 3

    def reducefn(key, values):
        return sum(values)

    def finalfn(pairs):
        st["RESULT"].clear()
        for key, values in pairs:
            st["RESULT"][key] = values[0]
        return True

    for fn in (taskfn, mapfn, partitionfn, reducefn, finalfn):
        setattr(mod, fn.__name__, fn)
    mod.associative_reducer = mod.commutative_reducer = True
    mod.idempotent_reducer = True
    sys.modules[mod_name] = mod
    params = {r: mod_name for r in ("taskfn", "mapfn", "partitionfn",
                                    "reducefn", "finalfn")}
    params["storage"] = f"mem:{uuid.uuid4().hex}"
    return params, st


def _wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_exactly_once_per_tenant_under_partition_and_churn(tmp_path):
    """Two tenants served by one pool THROUGH a fault proxy: mid-run
    the proxy partitions (shorter than the job lease, so claims and
    heartbeats retry through under their rids) and one worker is
    replaced.  Both tenants finish with every map job run exactly once;
    a third tenant cancelled while QUEUED runs nothing."""
    board = DocServer().start_background()
    proxy = FaultProxy(board.host, board.port).start()
    runner = None
    workers = []
    try:
        direct = f"http://{board.host}:{board.port}"
        proxied = f"http://{proxy.address}"
        sch = Scheduler(board.store, config=SchedulerConfig(max_inflight=2))
        runner = TaskRunner(direct, sch, partitions=Partitions(1, "cpu"),
                            poll=0.02).start()
        workers = [ScheduledWorker(proxied, retry=CHAOS_RETRY,
                                   name=f"cw{i}").start() for i in range(2)]
        pa, sa = _tenant(tmp_path, "a", 4, map_delay=0.05)
        pb, sb = _tenant(tmp_path, "b", 3, map_delay=0.05)
        pc, sc = _tenant(tmp_path, "c", 2)
        da = sch.submit("alice", db="cha", params=pa, est_jobs=4)
        db = sch.submit("bob", db="chb", params=pb, est_jobs=3)
        dc = sch.submit("carol", db="chc", params=pc, est_jobs=2)
        assert _wait_until(lambda: all(
            sch.get(d["_id"])["state"] in (ADMITTED, RUNNING, DONE)
            for d in (da, db)))
        assert sch.get(dc["_id"])["state"] == QUEUED
        assert sch.cancel(dc["_id"])["state"] == CANCELLED
        workers[0].stop(timeout=TIMEOUT)
        workers.append(ScheduledWorker(proxied, retry=CHAOS_RETRY,
                                       name="cw2").start())
        proxy.partition(duration=0.5)
        wait_for_state(sch, da["_id"], DONE, timeout=TIMEOUT)
        wait_for_state(sch, db["_id"], DONE, timeout=TIMEOUT)
        for st, n in ((sa, 4), (sb, 3)):
            assert dict(st["STARTED"]) == {i: 1 for i in range(n)}
            assert dict(st["COMPLETED"]) == {i: 1 for i in range(n)}
            assert st["RESULT"]["alpha"] == 8 * n
        assert dict(sc["STARTED"]) == {}
        cdoc = sch.get(dc["_id"])
        assert cdoc["state"] == CANCELLED and "admitted_time" not in cdoc
        assert board.store.count("chc.map_jobs") == 0
        snap = sch.snapshot()
        assert snap["tenants"]["alice"]["served_cost"] == 4.0
        assert snap["tenants"]["bob"]["served_cost"] == 3.0
        assert snap["tenants"]["carol"]["served_cost"] == 0.0
    finally:
        if runner:
            runner.stop(timeout=TIMEOUT)
        for w in workers:
            w.stop(timeout=TIMEOUT)
        proxy.stop()
        board.shutdown()


def _kill(srv) -> None:
    """Dead to clients, lease unreleased (the silent-death path)."""
    srv.ha._stop.set()
    srv.ha._thread.join(timeout=10)
    srv.ha._valid_until = 0.0
    srv.httpd.shutdown()
    srv.httpd.server_close()


def _pair(tmp_path):
    d = str(tmp_path / "ha")
    a = DocServer(ha_dir=d, ha_lease=LEASE).start_background()
    b = DocServer(ha_dir=d, ha_lease=LEASE).start_background()
    assert _wait_until(lambda: a.ha.is_primary() or b.ha.is_primary(), 20)
    return (a, b) + ((a, b) if a.ha.is_primary() else (b, a))


def test_task_runner_poll_survives_failover(tmp_path):
    """The scheduler's polls ride the multi-endpoint store through a
    primary kill: the state survives on the successor and ticks go on."""
    a, b, prim, stby = _pair(tmp_path)
    try:
        store = docstore.connect(
            f"http://{a.host}:{a.port},{b.host}:{b.port}",
            retry=CHAOS_RETRY)
        sch = Scheduler(store)
        doc = sch.submit("t", db="ha_t1", est_jobs=1)
        assert [d["_id"] for d in sch.tick()] == [doc["_id"]]
        _kill(prim)
        assert stby.ha.wait_role("primary", timeout=10)
        assert {d["_id"]: d["state"] for d in sch.list_tasks()} == {
            doc["_id"]: ADMITTED}
        assert sch.tick() == []
        store.close()
    finally:
        for s in (a, b):
            try:
                s.shutdown()
            except Exception:
                pass


def test_two_tenants_finish_exactly_once_through_a_board_kill(tmp_path):
    """Runner and pool on the HA pair's multi-endpoint connstr; the
    primary dies while both tenants' tasks run.  Both reach DONE, every
    map job ran once, and a fresh replica's replay of the log equals
    the survivor's documents."""
    from mapreduce_tpu_torch.coord.ha import HaController

    a, b, prim, stby = _pair(tmp_path)
    connstr = f"http://{a.host}:{a.port},{b.host}:{b.port}"
    runner = None
    workers = []
    try:
        store = docstore.connect(connstr, retry=CHAOS_RETRY)
        sch = Scheduler(store, config=SchedulerConfig(max_inflight=2))
        runner = TaskRunner(connstr, sch, retry=CHAOS_RETRY,
                            partitions=Partitions(1, "cpu"),
                            poll=0.02).start()
        workers = [ScheduledWorker(connstr, retry=CHAOS_RETRY,
                                   name=f"hw{i}").start() for i in range(2)]
        pa, sa = _tenant(tmp_path, "a", 4, map_delay=0.1)
        pb, sb = _tenant(tmp_path, "b", 4, map_delay=0.1)
        da = sch.submit("alice", db="hka", params=pa, est_jobs=4)
        db = sch.submit("bob", db="hkb", params=pb, est_jobs=4)
        assert _wait_until(lambda: all(
            sch.get(d["_id"])["state"] == RUNNING for d in (da, db)))
        _kill(prim)
        for d in (da, db):
            wait_for_state(sch, d["_id"], DONE, timeout=TIMEOUT)
        assert stby.ha.is_primary() and stby.ha.promotions == 1
        for st in (sa, sb):
            assert dict(st["STARTED"]) == {i: 1 for i in range(4)}
            assert dict(st["COMPLETED"]) == {i: 1 for i in range(4)}
            assert st["RESULT"]["alpha"] == 32
        runner.stop(timeout=TIMEOUT)
        runner = None
        for w in workers:
            w.stop(timeout=TIMEOUT)
        workers = []
        fresh = HaController(str(tmp_path / "ha"), lease=LEASE)
        fresh._apply_new()
        live = stby.ha.store.inner
        for coll in live.collections():
            assert (sorted(fresh.store.inner.find(coll),
                           key=lambda d: d["_id"])
                    == sorted(live.find(coll), key=lambda d: d["_id"])), coll
        fresh.log.close()
        store.close()
    finally:
        if runner:
            runner.stop(timeout=TIMEOUT)
        for w in workers:
            w.stop(timeout=TIMEOUT)
        for s in (a, b):
            try:
                s.shutdown()
            except Exception:
                pass
