"""The port's multi-tenant scheduler and its serving loops
(``mapreduce_tpu_torch.sched``) against the JAX package's.

The same submit, tick, cancel and transition script on a JAX and a port
``Scheduler`` must give the same admissions (by db, in order), the same
rejection reasons, the same tenant documents and the same task
documents (timestamps aside).  The ``/tasks`` wire is the JAX one, so
either package's ``SchedulerClient`` drives either package's
``DocServer``.  The serving loops run two tenants at once: host-plane
tasks of witness modules defined here (STARTED / COMPLETED counts prove
every map job ran exactly once), and device tasks of the port's
``examples/wordcount`` on ``Partitions(8, "cpu")``, held against
``Counter`` and the JAX ``'lax'`` engine.  Every wait has a deadline.
"""

import json
import sys
import threading
import time
import types
import uuid
from collections import Counter

import pytest

from mapreduce_tpu import spec as jspec
from mapreduce_tpu.coord.docserver import DocServer as JDocServer
from mapreduce_tpu.coord.docstore import MemoryDocStore as JMemoryDocStore
from mapreduce_tpu.sched import scheduler as jsched
import mapreduce_tpu_torch.examples.wordcount as twc
from mapreduce_tpu_torch import spec as tspec
from mapreduce_tpu_torch.coord.docserver import DocServer
from mapreduce_tpu_torch.coord.docstore import MemoryDocStore
from mapreduce_tpu_torch.obs.metrics import REGISTRY
from mapreduce_tpu_torch.parallel.mesh import Partitions
from mapreduce_tpu_torch.sched import scheduler as tsched
from mapreduce_tpu_torch.sched.scheduler import (
    CANCELLED, DONE, QUEUED, QuotaExceededError, Scheduler,
    SchedulerConfig, SchedulerFencedError, TASKS_COLL)
from mapreduce_tpu_torch.sched.service import (
    ScheduledWorker, TaskRunner, spawn_scheduled_workers, wait_for_state)
from mapreduce_tpu_torch.utils.hashing import fnv1a32
from mapreduce_tpu_torch.utils.httpclient import KeepAliveClient

PKGS = {"port": (tsched, MemoryDocStore, DocServer),
        "jax": (jsched, JMemoryDocStore, JDocServer)}
#: timestamp fields of a task doc (wall clock: differ between runs)
STAMPS = ("submit_time", "admitted_time", "started_time", "done_time")
TIMEOUT = 60


# -- the same script on both schedulers ---------------------------------------


def _decisions(pkg):
    """Run the script on *pkg*'s scheduler; returns what it decided."""
    mod, mem, _ = PKGS[pkg]
    s = mod.Scheduler(mem(), config=mod.SchedulerConfig(
        max_inflight=2, tenant_max_queued_tasks=3,
        tenant_max_queued_jobs=10, tenant_max_queued_bytes=1000,
        keep_terminal_tasks=3))
    out = {"admitted": [], "rejected": [], "cancel": []}

    def submit(tenant, **kw):
        try:
            return s.submit(tenant, **kw)["_id"]
        except mod.QuotaExceededError as exc:
            out["rejected"].append((tenant, exc.reason))
            return None

    def tick():
        out["admitted"].append([d["db"] for d in s.tick()])

    ids = {}
    ids["a0"] = submit("a", est_jobs=2, weight=1.0)
    ids["a1"] = submit("a", est_jobs=3, priority=2)
    ids["a2"] = submit("a", est_jobs=4, est_bytes=500)
    submit("a", est_jobs=1)                       # queued_tasks
    ids["b0"] = submit("b", est_jobs=9, weight=3.0, db="shared")
    submit("b", est_jobs=2)                       # queued_jobs
    submit("c", db="shared")                      # db_active
    ids["b1"] = submit("b", est_bytes=1001 - 1)
    ids["c0"] = submit("c", est_jobs=1, est_bytes=1, kind="session")
    submit("c", est_bytes=1000)                   # queued_bytes
    tick()
    out["cancel"].append(s.cancel(ids["c0"])["state"])
    for _ in range(5):
        running = [d for d in s.list_tasks(state="ADMITTED")]
        for d in running:
            s.mark_running(d["_id"])
        tick()
        for i, d in enumerate(s.list_tasks(state="RUNNING")):
            if d["tenant"] == "b" and i == 0:
                s.mark_failed(d["_id"], reason="boom")
            else:
                s.mark_done(d["_id"], records=7 * (i + 1))
        tick()
    ids["a3"] = submit("a", db="shared")          # the db is free again
    tick()
    out["cancel"].append(s.cancel(ids["a3"])["state"])
    out["cancel"].append(s.cancel("nope"))
    s.note_served("a", 5)
    strip = [{k: v for k, v in d.items() if k not in STAMPS}
             for d in s.list_tasks()]
    out["tasks"] = strip
    out["tenants"] = sorted(s.store.find(mod.TENANTS_COLL),
                            key=lambda d: d["_id"])
    out["dbs"] = sorted(d["_id"] for d in s.store.find(mod.DBS_COLL))
    snap = s.snapshot()
    snap.pop("lease")
    for t in snap["tenants"].values():
        t.pop("oldest_queued_age_s", None)
    out["snapshot"] = snap
    s.release()
    return out


def test_same_script_same_decisions():
    port, jax = _decisions("port"), _decisions("jax")
    assert port["rejected"] == jax["rejected"]
    assert port["rejected"] and {r for _, r in port["rejected"]} == {
        "queued_tasks", "queued_jobs", "queued_bytes", "db_active"}
    assert port["admitted"] == jax["admitted"]
    assert port["cancel"] == jax["cancel"] == [CANCELLED, CANCELLED, None]
    assert port["tasks"] == jax["tasks"]
    assert port["tenants"] == jax["tenants"]
    assert port["dbs"] == jax["dbs"]
    assert port["snapshot"] == jax["snapshot"]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_weighted_fair_and_priority_order(pkg):
    """Weight 3 is admitted three times for weight 1's once; within a
    tenant, priority then submit order.  The same on both packages."""
    mod, mem, _ = PKGS[pkg]
    s = mod.Scheduler(mem(), config=mod.SchedulerConfig(max_inflight=1))
    for _ in range(4):
        s.submit("a", weight=1.0, est_jobs=1)
    for i in range(8):
        s.submit("b", weight=3.0, est_jobs=1, priority=int(i == 5))
    order = []
    for _ in range(12):
        (got,) = s.tick()
        order.append((got["tenant"], got["seq"]))
        s.mark_running(got["_id"])
        s.mark_done(got["_id"])
    assert [t for t, _ in order] == ["a", "b", "b", "b", "a", "b", "b",
                                     "b", "a", "b", "b", "a"]
    assert [q for t, q in order if t == "b"][:2] == [10, 5]


# -- quotas, the db guard, GC and the lease ------------------------------------


def test_quotas_free_up_on_admission():
    s = Scheduler(MemoryDocStore(), config=SchedulerConfig(
        tenant_max_queued_jobs=10, tenant_max_queued_bytes=100))
    s.submit("a", est_jobs=8, est_bytes=50)
    with pytest.raises(QuotaExceededError) as ei:
        s.submit("a", est_jobs=5)
    assert ei.value.reason == "queued_jobs"
    with pytest.raises(QuotaExceededError) as ei:
        s.submit("a", est_jobs=1, est_bytes=60)
    assert ei.value.reason == "queued_bytes"
    s.tick()
    s.submit("a", est_jobs=9)
    assert REGISTRY.value("mrtpu_sched_admission_total", tenant="a",
                          outcome="rejected", reason="queued_jobs") >= 1


def test_db_guard_holds_across_scheduler_instances():
    store = MemoryDocStore()
    s1, s2 = Scheduler(store), Scheduler(store)
    d1 = s1.submit("a", db="race")
    with pytest.raises(QuotaExceededError) as ei:
        s2.submit("b", db="race")
    assert ei.value.reason == "db_active"
    s1.tick()
    s1.mark_running(d1["_id"])
    # a RUNNING cancel leaves the reservation to the runner's exit path
    assert s1.cancel(d1["_id"])["state"] == CANCELLED
    with pytest.raises(QuotaExceededError):
        s2.submit("b", db="race")
    assert s1.mark_done(d1["_id"]) is None
    s1._release_db(d1)
    s2.submit("b", db="race")
    # a crashed submit's reservation: protected in the grace window,
    # stealable past it
    assert s1._reserve_db("leak", "ghost")
    assert not s2._reserve_db("leak", "t-3")
    store.update(tsched.DBS_COLL, {"_id": "leak"},
                 {"$set": {"reserved_time": 1.0}})
    assert s2._reserve_db("leak", "t-3")


def test_gc_prunes_terminal_docs_but_not_reservation_holders():
    s = Scheduler(MemoryDocStore(), config=SchedulerConfig(
        max_inflight=2, keep_terminal_tasks=3))
    drain = s.submit("a", db="gc-drain")
    s.tick()
    s.mark_running(drain["_id"])
    s.cancel(drain["_id"])
    done = []
    for _ in range(6):
        d = s.submit("b", est_jobs=1)
        s.tick()
        s.mark_running(d["_id"])
        s.mark_done(d["_id"], records=2)
        done.append(d["_id"])
    remaining = [d["_id"] for d in s.list_tasks()]
    assert drain["_id"] in remaining
    assert [i for i in done if i in remaining] == done[-3:]
    assert s.snapshot()["tenants"]["b"]["served_records"] == 12


def test_admission_lease_fences_a_deposed_scheduler():
    store = MemoryDocStore()
    a = Scheduler(store, lease=tsched.SchedulerLease(
        tsched._SchedCnn(store), lease=0.2))
    a.submit("t")
    assert len(a.tick()) == 1
    b = Scheduler(store)
    b.submit("t")
    assert b.tick() == []
    time.sleep(0.3)
    assert len(b.tick()) == 1
    a.submit("t")
    with pytest.raises(SchedulerFencedError):
        a.tick(strict=True)
    assert a.tick() == []
    assert REGISTRY.value("mrtpu_sched_fences_total") >= 1


def test_advisor_and_fleet_are_refused_by_name():
    """The advisor and the engine-host fleet, each once refused by name
    before the port had it, now attach."""
    from mapreduce_tpu_torch.coord.fleet import FleetRegistry

    advisor = object()
    assert Scheduler(MemoryDocStore(), advisor=advisor).advisor is advisor
    store = MemoryDocStore()
    reg = FleetRegistry(store)
    assert Scheduler(store, fleet=reg).fleet is reg


# -- the /tasks wire ------------------------------------------------------------


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_tasks_wire_pairings(client_pkg, server_pkg):
    cmod, _, _ = PKGS[client_pkg]
    smod, _, srv_cls = PKGS[server_pkg]
    srv = srv_cls(scheduler_config=smod.SchedulerConfig(
        tenant_max_queued_tasks=2)).start_background()
    try:
        c = cmod.SchedulerClient(f"{srv.host}:{srv.port}")
        doc = c.submit("alice", est_jobs=3, est_bytes=30)
        assert doc["state"] == QUEUED and doc["_id"] == "alice-000001"
        with pytest.raises(cmod.QuotaExceededError) as ei:
            c.submit("bob", db=doc["db"])
        assert ei.value.reason == "db_active"
        c.submit("alice")
        with pytest.raises(cmod.QuotaExceededError) as ei:
            c.submit("alice")
        assert ei.value.reason == "queued_tasks"
        listing = c.list()
        assert [t["_id"] for t in listing["tasks"]] == [
            "alice-000001", "alice-000003"]
        assert listing["sched"]["tenants"]["alice"]["queued_jobs"] == 3
        assert [d["_id"] for d in c.tick()] == ["alice-000001",
                                                "alice-000003"]
        assert c.cancel(doc["_id"])["state"] == CANCELLED
        assert c.cancel(doc["_id"]) is None
        c.close()
    finally:
        srv.shutdown()


def test_tasks_mutations_are_rid_deduped_and_auth_gated():
    srv = DocServer(auth_token="sekrit").start_background()
    try:
        cl = KeepAliveClient.from_address(f"{srv.host}:{srv.port}",
                                          what="test")
        status, _ = cl.request("GET", "/tasks")
        assert status == 401
        payload = json.dumps({"op": "submit", "tenant": "dup",
                              "rid": f"{uuid.uuid4().hex}:1"}).encode()
        status, _ = cl.request("POST", "/tasks", body=payload)
        assert status == 401
        assert srv.store.count(TASKS_COLL) == 0
        auth = {"Authorization": "Bearer sekrit",
                "Content-Type": "application/json"}
        bodies = []
        for _ in range(3):
            status, raw = cl.request("POST", "/tasks", body=payload,
                                     headers=auth)
            assert status == 200
            bodies.append(json.loads(raw))
        assert bodies[0] == bodies[1] == bodies[2]
        assert srv.store.count(TASKS_COLL, {"tenant": "dup"}) == 1
        assert REGISTRY.value("mrtpu_docserver_requests_total",
                              op="tasks:submit", outcome="replayed") >= 2
        status, raw = cl.request("POST", "/tasks", body=b'{"op": "x"}',
                                 headers=auth)
        assert status == 400
        cl.close()
    finally:
        srv.shutdown()


# -- the serving loops: two tenants of witness modules (host plane) ------------

#: witness state per tenant module: STARTED at map entry, COMPLETED
#: after the last emit, so exactly-once is counted, not inferred
WITNESS = {}


def _witness_module(name, files):
    """An importable module (registered in ``sys.modules``) exporting the
    word count's roles with per-module witness counters."""
    st = WITNESS[name] = {"STARTED": Counter(), "COMPLETED": Counter(),
                          "RESULT": {}, "lock": threading.Lock()}
    mod = types.ModuleType(name)

    def taskfn(emit):
        for i, path in enumerate(files):
            emit(i, path)

    def mapfn(key, value, emit):
        with st["lock"]:
            st["STARTED"][key] += 1
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
    sys.modules[name] = mod
    params = {r: name for r in ("taskfn", "mapfn", "partitionfn",
                                "reducefn", "finalfn")}
    params["storage"] = f"mem:{uuid.uuid4().hex}"
    return params


def _files(tmp_path, name, n):
    out = []
    for i in range(n):
        p = tmp_path / f"{name}{i}.txt"
        p.write_text(f"alpha beta {name}{i} gamma alpha\n" * 4)
        out.append(str(p))
    return out


def test_two_tenants_through_runner_and_scheduled_workers(tmp_path):
    connstr = f"mem://{uuid.uuid4().hex}"
    sch = Scheduler(MemoryDocStore.named(connstr[len("mem://"):]))
    runner = TaskRunner(connstr, sch, partitions=Partitions(1, "cpu"),
                        poll=0.02).start()
    pool = spawn_scheduled_workers(connstr, 2,
                                   conf={"max_sleep": 0.05})
    try:
        mods = {}
        for tenant, n in (("alice", 4), ("bob", 3)):
            name = f"torch_sched_witness_{tenant}_{uuid.uuid4().hex[:6]}"
            mods[tenant] = (name, n)
            sch.submit(tenant, db=f"w_{tenant}", est_jobs=n,
                       params=_witness_module(name, _files(tmp_path,
                                                          tenant, n)))
        for doc in sch.list_tasks():
            wait_for_state(sch, doc["_id"], DONE, timeout=TIMEOUT)
        for tenant, (name, n) in mods.items():
            st = WITNESS[name]
            assert dict(st["STARTED"]) == {i: 1 for i in range(n)}
            assert dict(st["COMPLETED"]) == {i: 1 for i in range(n)}
            assert st["RESULT"]["alpha"] == 8 * n
            assert st["RESULT"][f"{tenant}0"] == 4
        snap = sch.snapshot()
        assert snap["tenants"]["alice"]["done"] == 1
        assert snap["tenants"]["alice"]["served_cost"] == 4.0
        assert snap["tenants"]["bob"]["served_records"] > 0
        assert REGISTRY.value("mrtpu_slo_queue_wait_seconds",
                              tenant="alice") >= 1
        assert REGISTRY.value("mrtpu_slo_admit_to_running_seconds",
                              tenant="bob") >= 1
    finally:
        runner.stop(timeout=TIMEOUT)
        for w in pool:
            w.stop(timeout=TIMEOUT)


def test_scheduled_worker_skips_session_tasks():
    store = MemoryDocStore()
    s = Scheduler(store)
    s.submit("t", kind="session")
    s.tick()
    w = ScheduledWorker("mem://unused-board")
    w._store = store
    assert w._active_tasks() == []


def test_runner_without_a_card_refuses(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TaskRunner("mem://x", Scheduler(MemoryDocStore()))


# -- device tasks: two at once, against Counter and the JAX lax engine --------

JMOD = "mapreduce_tpu.examples.wordcount"
TMOD = "mapreduce_tpu_torch.examples.wordcount"


def _init_args(files, sort_impl):
    return {"files": files, "num_reducers": 4, "device_chunk_len": 2048,
            "device_local_capacity": 1 << 10,
            "device_exchange_capacity": 1 << 8,
            "device_out_capacity": 1 << 10,
            "device_sort_impl": sort_impl, "keep_results": True}


@pytest.fixture
def corpus(tmp_path):
    """Three files of whole lines: repeated words, unicode, punctuation
    glued to words, tabs and a blank line."""
    vocab = ["the", "fox", "über", "naïve", "日本", "a,b", "x" * 40,
             "it's"] + [f"w{i}" for i in range(40)]
    files = []
    for f in range(3):
        lines = [" \t"[f % 2].join(vocab[(7 * i + j * (f + 3)) % len(vocab)]
                                   for j in range(i % 11))
                 for i in range(40)]
        p = tmp_path / f"f{f}.txt"
        p.write_text("\n".join(lines) + "\n", encoding="utf-8")
        files.append(str(p))
    return files


def _jax_lax_result(files, tmp_path):
    """The JAX device plane (its default lax formulations, variadic
    sort) on the 8-device CPU mesh: the result partition's bytes."""
    import mapreduce_tpu.examples.wordcount as jwc
    from mapreduce_tpu.server import Server as JServer

    jspec.clear_caches()
    jwc._conf.clear()
    jwc._conf.update({"files": [], "num_reducers": 15})
    orig = jwc.finalfn
    jwc.finalfn = lambda pairs: (orig(pairs), None)[1]
    try:
        params = {r: JMOD for r in ("taskfn", "mapfn", "partitionfn",
                                    "reducefn", "finalfn")}
        params.update(combinerfn=JMOD, device=True,
                      storage=f"shared:{tmp_path / 'jax_st'}",
                      init_args=_init_args(files, "variadic"))
        server = JServer(f"mem://{uuid.uuid4().hex}", "jwc")
        server.configure(params)
        box = {}
        t = threading.Thread(target=lambda: box.update(s=server.loop()),
                             daemon=True)
        t.start()
        t.join(TIMEOUT)
        assert not t.is_alive(), "the JAX device loop ran over its time"
    finally:
        jwc.finalfn = orig
        jspec.clear_caches()
    return (tmp_path / "jax_st" / "jwc.result.P00000").read_bytes()


def test_two_device_tasks_in_one_runner(corpus, tmp_path):
    """Tenant a's task sorts by radix, tenant b's by the variadic sort,
    both of the one module, in flight at once in one runner over
    Partitions(8, "cpu"): each task reads its own init_args, and each
    result partition equals Counter and the JAX lax engine's bytes."""
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.utils.serialization import parse_record

    jbytes = _jax_lax_result(corpus, tmp_path)
    tspec.clear_caches()
    connstr = f"mem://{uuid.uuid4().hex}"
    sch = Scheduler(MemoryDocStore.named(connstr[len("mem://"):]))
    seen = []
    real_config = twc.device_config

    def device_config():
        cfg = real_config()
        seen.append(cfg.sort_impl)
        return cfg

    twc.device_config = device_config
    runner = TaskRunner(connstr, sch, partitions=Partitions(8, "cpu"),
                        poll=0.02)
    kc.reset_counts()
    try:
        docs = {}
        for tenant, impl in (("a", "radix"), ("b", "variadic")):
            params = {r: TMOD for r in ("taskfn", "mapfn", "partitionfn",
                                        "reducefn", "finalfn")}
            params.update(combinerfn=TMOD, device=True,
                          storage=f"shared:{tmp_path / tenant}",
                          init_args=_init_args(corpus, impl))
            docs[tenant] = sch.submit(tenant, db=f"dev_{tenant}",
                                      params=params, est_jobs=1)
        runner.start()
        for doc in docs.values():
            wait_for_state(sch, doc["_id"], DONE, timeout=TIMEOUT)
    finally:
        runner.stop(timeout=TIMEOUT)
        twc.device_config = real_config
        tspec.clear_caches()
    assert sorted(seen) == ["radix", "variadic"]
    assert kc.PLAIN_CALLS["radix_plan"] > 0
    want = Counter(w for f in corpus for w in open(f).read().split())
    for tenant in docs:
        got = (tmp_path / tenant / f"dev_{tenant}.result.P00000"
               ).read_bytes()
        assert got == jbytes, tenant
        counts = dict(parse_record(line)
                      for line in got.decode().splitlines())
        assert {k: v[0] for k, v in counts.items()} == want
    assert sum(kc.LAUNCHES.values()) == 0


def test_launch_counters_lose_nothing_across_threads():
    """The wrappers count through kernel_compat's lock: more threads
    than cores adding at once, switching every microsecond, lose no
    count (two engines in one runner rely on it)."""
    import os

    from mapreduce_tpu_torch.ops import kernel_compat as kc

    n_threads, n_adds = (os.cpu_count() or 4) + 2, 2000
    kc.reset_counts()

    def add():
        for _ in range(n_adds):
            kc.count_launch("tokenize")
            kc.count_plain("radix_onesweep", 8)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=add) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert kc.LAUNCHES["tokenize"] == n_threads * n_adds
    assert kc.PLAIN_CALLS["radix_onesweep"] == 8 * n_threads * n_adds
    kc.reset_counts()


def test_server_job_lease_and_worker_current_fence(tmp_path):
    """``Server(job_lease=)`` sets the task's lease (the device phase's
    job and the reaper use it), and a worker exposes the fence of the
    job it ran last, unset after a healthy run."""
    from mapreduce_tpu_torch.server import Server
    from mapreduce_tpu_torch.worker import Worker

    connstr = f"mem://{uuid.uuid4().hex}"
    name = f"torch_sched_lease_{uuid.uuid4().hex[:6]}"
    params = _witness_module(name, _files(tmp_path, "l", 2))
    server = Server(connstr, "jl", job_lease=5.0)
    assert server.task.job_lease == 5.0
    server.configure(params)
    w = Worker(connstr, "jl")
    w.configure({"max_iter": 200, "max_sleep": 0.05, "max_tasks": 1})
    assert w.current_fence is None
    t = threading.Thread(target=w.execute, daemon=True)
    t.start()
    box = {}
    s = threading.Thread(target=lambda: box.update(out=server.loop()),
                         daemon=True)
    s.start()
    s.join(TIMEOUT)
    t.join(TIMEOUT)
    assert not s.is_alive() and not t.is_alive()
    assert box["out"]["map"]["count"] == 2
    assert isinstance(w.current_fence, threading.Event)
    assert not w.current_fence.is_set()
    assert WITNESS[name]["RESULT"]["alpha"] == 16
