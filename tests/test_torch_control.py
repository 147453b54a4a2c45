"""The port's control ledger, admission advisor and speculative
re-claimer against the JAX package's, and the surfaces that attach them.

Each scripted case of the JAX package's ``tests/test_control.py`` runs
through both packages, each with its own ``ControlLedger`` (the global
ledger is one per process, and other files' decisions must not leak
in), and the decisions are held equal but for their clock fields
(tolerance: none): the ledger's record/resolve script, its counter
deltas and ring eviction, and each package's ``validate_control`` over
the other's snapshot; ``matrix_stats`` and the MAD helpers on seeded
inputs; the advisor's picks and the scheduler's routing; the
re-claimer's re-claims and resolutions (vanished, ``finish``, no
baseline) over equal job documents at one frozen board clock.  Also
here: the port's twin of the chaos acceptance test (a job pinned on a
straggler with a 60 s lease is re-claimed, the straggler fences, the
held key starts twice and every key completes once), the placement
facts of ``local_mesh_facts`` with the card's probes stubbed, the
collector's control family, and the CLI's controller switches, which
default on as in the JAX CLI.  Every poll and worker thread runs under
a deadline and fails on it.
"""

import sys
import threading
import time
import types
import uuid
from collections import Counter

import numpy as np
import pytest

from mapreduce_tpu.cli import main as jmain
from mapreduce_tpu.coord import docstore as jdocstore
from mapreduce_tpu.engine import autotune as jauto
from mapreduce_tpu.obs import analysis as janalysis
from mapreduce_tpu.obs import control as jcontrol
from mapreduce_tpu.obs.metrics import REGISTRY as JREG
from mapreduce_tpu.sched.scheduler import Scheduler as JScheduler
from mapreduce_tpu.server import Server as JServer
from mapreduce_tpu_torch import cli as tcli
from mapreduce_tpu_torch.coord import docstore as tdocstore
from mapreduce_tpu_torch.engine import autotune as tauto
from mapreduce_tpu_torch.obs import analysis as tanalysis
from mapreduce_tpu_torch.obs import control as tcontrol
from mapreduce_tpu_torch.obs.metrics import REGISTRY as TREG
from mapreduce_tpu_torch.obs.trace import Tracer
from mapreduce_tpu_torch.sched.scheduler import Scheduler as TScheduler
from mapreduce_tpu_torch.server import Server as TServer
from mapreduce_tpu_torch.utils.constants import STATUS
from mapreduce_tpu_torch.utils.hashing import fnv1a32

#: the clock fields of a decision: the only ones allowed to differ
CLOCK = ("time", "monotonic", "age_s")
#: the frozen board clock of the re-claimer cases
NOW = 1_700_000_000.0
#: seconds any poll, worker thread or wait of this file may take
DEADLINE = 30.0

PACKAGES = {
    "jax": (jcontrol, jauto, jdocstore, JREG),
    "port": (tcontrol, tauto, tdocstore, TREG),
}


def strip(rows):
    return [{k: v for k, v in d.items() if k not in CLOCK} for d in rows]


def counts(reg):
    return {(c, o): reg.sum("mrtpu_control_decisions_total",
                            controller=c, outcome=o)
            for c in tcontrol.CONTROLLERS
            for o in tcontrol.RECORD_OUTCOMES + tcontrol.RESOLVED_OUTCOMES}


def ledger_script(control):
    """The JAX ledger tests' record/resolve script on one package."""
    led = control.ControlLedger()
    did = led.record("repartition", "wc",
                     {"imbalance_recv": 3.4, "hot_dst": 5},
                     {"moved_buckets": 12}, note="rebalanced P00005")
    pending = [d["id"] for d in led.pending("repartition")]
    first = led.resolve(did, "improved", {"imbalance_recv_after": 1.2})
    second = led.resolve(did, "neutral")
    led.record("reclaim", "wc", {"worker": "w1"}, {"job": "3"},
               outcome="applied")
    cap = led.record("capacity", "wc", {"learned": {}}, {"changes": {}})
    led.resolve(cap, "neutral", note="no change")
    led.record("admission", "t9", {"tenant": "acme"}, {"mesh": "m"},
               outcome="refused", note="no placement")
    return led, (pending, first, second)


def test_ledger_script_matches_jax():
    out = {}
    for name, (control, _, _, reg) in PACKAGES.items():
        c0 = counts(reg)
        led, flags = ledger_script(control)
        c1 = counts(reg)
        out[name] = (strip(led.decisions()), flags,
                     {k: c1[k] - c0[k] for k in c0 if c1[k] != c0[k]},
                     [d["id"] for d in led.pending("capacity")],
                     strip(led.decisions("capacity", task="wc")))
    assert out["port"] == out["jax"]
    decs, (pending, first, second), delta = out["port"][:3]
    assert pending == [1] and first and not second
    assert delta[("repartition", "pending")] == 1
    assert delta[("repartition", "improved")] == 1
    assert decs[0]["outcome_evidence"] == {"imbalance_recv_after": 1.2}


@pytest.mark.parametrize("call", [
    lambda led: led.record("nonsense", "t", {}, {}),
    lambda led: led.record("capacity", "t", {}, {}, outcome="improved"),
    lambda led: led.resolve(1, "refused"),
])
def test_ledger_refuses_what_jax_refuses(call):
    for control, _, _, _ in PACKAGES.values():
        with pytest.raises(ValueError):
            call(control.ControlLedger())


def test_ledger_ring_evicts_as_jax_does():
    out = {}
    for name, (control, _, _, reg) in PACKAGES.items():
        e0 = reg.sum("mrtpu_control_evicted_total")
        led = control.ControlLedger(max_decisions=4)
        ids = [led.record("capacity", "t", {"i": i}, {}) for i in range(7)]
        out[name] = (strip(led.decisions()),
                     reg.sum("mrtpu_control_evicted_total") - e0,
                     led.resolve(ids[0], "improved"),
                     led.resolve(ids[-1], "improved"))
    assert out["port"] == out["jax"]
    decs, evicted, old, new = out["port"]
    assert len(decs) == 4 and evicted == 3 and not old and new


def test_snapshots_validate_across_packages():
    """Each package's strict validator accepts the other's snapshot,
    and the snapshots agree but for their ages."""
    snaps = {}
    for name, (control, _, _, _) in PACKAGES.items():
        led, _ = ledger_script(control)
        assert control.ControlLedger().snapshot() == {}
        snap = led.snapshot()
        assert all("age_s" in d and "monotonic" not in d
                   for d in snap["decisions"])
        snaps[name] = {"kind": "mrtpu-control", "version": 1,
                       "snapshot": snap}
    for validate in (jcontrol.validate_control, tcontrol.validate_control):
        for doc in snaps.values():
            validate(doc)
    assert (strip(snaps["port"]["snapshot"]["decisions"])
            == strip(snaps["jax"]["snapshot"]["decisions"]))
    assert (snaps["port"]["snapshot"]["counts"]
            == snaps["jax"]["snapshot"]["counts"])
    assert tcontrol.control_snapshot() == tcontrol.LEDGER.snapshot()


@pytest.mark.parametrize("corrupt", [
    {"kind": "wrong"},
    {"kind": "mrtpu-control", "snapshot": []},
    {"kind": "mrtpu-control", "snapshot": {"decisions": [], "counts": {}}},
    {"kind": "mrtpu-control",
     "snapshot": {"decisions": [{"controller": "bogus",
                                 "outcome": "pending", "evidence": {},
                                 "action": {}, "id": 1}], "counts": {}}},
    {"kind": "mrtpu-control",
     "snapshot": {"decisions": [{"controller": "capacity",
                                 "outcome": "pending",
                                 "evidence": "not-a-dict", "action": {},
                                 "id": 1}], "counts": {}}},
    {"kind": "mrtpu-control",
     "snapshot": {"decisions": [{"controller": "capacity",
                                 "outcome": "pending", "evidence": {},
                                 "action": {}, "id": 1}],
                  "counts": {"bogus": {}}}},
])
def test_corrupt_ledger_documents_refused_by_both(corrupt):
    for validate in (jcontrol.validate_control, tcontrol.validate_control):
        with pytest.raises(ValueError):
            validate(corrupt)


def test_decision_event_rides_the_tracer():
    """One zero-duration ``control_decision`` event per record and per
    resolve, carrying the decision."""
    tracer = Tracer()
    led = tcontrol.ControlLedger()
    did = led.record("capacity", "wc", {"learned": {"out_capacity": 8}},
                     {"changes": {}}, tracer=tracer)
    led.resolve(did, "improved", {"retries_after": 0}, tracer=tracer)
    events = [e for e in tracer.events() if e["name"] == "control_decision"]
    assert [e["args"]["outcome"] for e in events] == ["pending", "improved"]
    assert all(e["dur"] == 0 and e["args"]["decision_id"] == did
               and e["args"]["controller"] == "capacity"
               for e in events)
    assert events[1]["args"]["outcome_evidence"] == {"retries_after": 0}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_straggler_statistics_equal_jax(seed):
    xs = list(np.random.default_rng(seed).gamma(2.0, 0.1, size=seed + 4))
    med = tanalysis._median(xs)
    assert med == janalysis._median(xs)
    assert tanalysis._mad(xs, med) == janalysis._mad(xs, med)
    assert tanalysis.STRAGGLER_MAD_K == janalysis.STRAGGLER_MAD_K
    assert tanalysis._median([]) == janalysis._median([]) == 0.0


# -- admission ---------------------------------------------------------------


def advisor_script(control, auto):
    led = control.ControlLedger()
    adv = auto.AdmissionAdvisor(led)
    picks = [adv.choose("wave:wc")]  # nothing registered: a no-op
    adv.register_mesh("mesh-a", warm_programs=["wave:wc"], hbm_frac=0.3)
    picks.append(adv.choose("wave:wc"))  # one warm candidate: recorded
    adv.register_mesh("mesh-b", warm_programs=[], hbm_frac=0.1)
    picks.append(adv.choose("wave:wc", tenant="acme"))
    adv.register_mesh("mesh-a", warm_programs=["wave:wc"], hbm_frac=0.95)
    picks.append(adv.choose("wave:wc"))  # pressure outweighs warmth
    picks.append(adv.choose("wave:other"))
    adv.register_mesh("mesh-c")  # facts unknown: scored half-full
    picks.append(adv.choose("wave:other", tenant="t", task="x"))
    adv.unregister_mesh("mesh-b")
    adv.unregister_mesh("never-registered")
    picks.append(adv.candidates())
    return picks, strip(led.decisions())


def test_admission_advisor_script_matches_jax():
    port = advisor_script(tcontrol, tauto)
    assert port == advisor_script(jcontrol, jauto)
    picks, decs = port
    assert picks[:5] == [None, "mesh-a", "mesh-a", "mesh-b", "mesh-b"]
    assert picks[-1] == ["mesh-a", "mesh-c"]
    assert decs[1]["evidence"]["candidates"]["mesh-a"]["warm"] is True
    assert all(d["outcome"] == "applied" for d in decs)


@pytest.mark.parametrize("program,kind,want", [
    ("wave", "server", "m-warm"),
    (None, "session", "m-cold"),
])
def test_scheduler_routes_admitted_task_as_jax_does(program, kind, want):
    """The advisor keys on ``params["program"]``, else the task kind;
    the pick is set as ``mesh`` on the task doc and recorded."""
    out = {}
    for name, sched_cls in (("jax", JScheduler), ("port", TScheduler)):
        control, auto, docstore, _ = PACKAGES[name]
        led = control.ControlLedger()
        adv = auto.AdmissionAdvisor(led)
        adv.register_mesh("m-warm", warm_programs=["wave"], hbm_frac=0.4)
        adv.register_mesh("m-cold", warm_programs=[], hbm_frac=0.2)
        sched = sched_cls(docstore.MemoryDocStore(), use_lease=False,
                          advisor=adv)
        params = {"program": program} if program else {}
        doc = sched.submit("acme", kind=kind, params=params)
        admitted = sched.tick()
        assert [d["_id"] for d in admitted] == [doc["_id"]]
        assert admitted[0]["mesh"] == want
        out[name] = (sched.get(doc["_id"])["mesh"],
                     [{k: v for k, v in d.items() if k != "task"}
                      for d in strip(led.decisions())])
    assert out["port"] == out["jax"]
    assert out["port"][0] == want
    assert out["port"][1][0]["evidence"]["tenant"] == "acme"


def test_scheduler_without_advisor_sets_no_mesh_and_fleet_refused():
    sched = TScheduler(tdocstore.MemoryDocStore(), use_lease=False)
    assert sched.advisor is None
    doc = sched.submit("acme", params={"program": "wave"})
    sched.tick()
    assert "mesh" not in sched.get(doc["_id"])
    # the engine-host fleet attaches (it was refused before the port had
    # one); with no host ever joined its recovery sweep moves nothing
    from mapreduce_tpu_torch.coord.fleet import FleetRegistry

    store = tdocstore.MemoryDocStore()
    reg = FleetRegistry(store)
    fleet_sched = TScheduler(store, use_lease=False, fleet=reg)
    assert fleet_sched.fleet is reg and fleet_sched.recovery_sweep() == []


def test_local_mesh_facts_with_the_card_probes_stubbed(monkeypatch):
    """Warm program tokens from ``kernel_compat.is_built`` (the compile
    ledger's records and registry stubbed empty); the worst card's
    allocated share of ``mem_get_info``'s total; None with no card."""
    import torch

    from mapreduce_tpu_torch.obs import compile as tcompile
    from mapreduce_tpu_torch.ops import kernel_compat as kc

    monkeypatch.setattr(tcompile.LEDGER, "snapshot", lambda: {})
    monkeypatch.setattr(tcompile.LEDGER, "disk_buckets", lambda dir=None: {})
    built = {"tokenize", "segreduce"}
    monkeypatch.setattr(kc, "is_built", lambda name, defines=(): name in
                        built)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (0, 100 << 30))
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda i: (50 << 30) if i == 0 else (90 << 30))
    warm, frac = tauto.local_mesh_facts()
    assert warm == ["wave"] and frac == 0.9
    built.add("flash_attention")
    assert tauto.local_mesh_facts()[0] == ["tf_step", "wave"]
    built.clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tauto.local_mesh_facts() == ([], None)


# -- speculative re-claim over equal job documents ---------------------------


def _job(jid, worker, status, started_ago=0.0, real_time=None):
    d = {"_id": jid, "worker": worker, "tmpname": f"tmp-{jid}",
         "status": int(status), "started_time": NOW - started_ago,
         "repetitions": 0}
    if real_time is not None:
        d["real_time"] = real_time
        d["status"] = int(STATUS.WRITTEN)
    return d


def _boards(monkeypatch, docs):
    """Each package's memory board holding *docs*, at one frozen clock."""
    out = {}
    for name, (control, auto, docstore, _) in PACKAGES.items():
        monkeypatch.setattr(docstore, "now", lambda: NOW)
        store = docstore.MemoryDocStore()
        for d in docs:
            store.insert("db.map_jobs", dict(d))
        led = control.ControlLedger()
        out[name] = (store, led, auto.SpeculativeReclaimer(
            led, min_age_s=0.5))
    return out


def _written_by(store, jid, worker="w2"):
    store.update("db.map_jobs", {"_id": jid},
                 {"$set": {"status": int(STATUS.WRITTEN),
                           "worker": worker, "real_time": 0.05}})


def test_reclaimer_breaks_straggler_held_job_only(monkeypatch):
    boards = _boards(monkeypatch, [
        _job("a", "w2", STATUS.WRITTEN, real_time=0.05),
        _job("b", "w2", STATUS.WRITTEN, real_time=0.06),
        _job("c", "w3", STATUS.WRITTEN, real_time=0.04),
        _job("s", "w1", STATUS.RUNNING, started_ago=30.0),
        _job("f", "w2", STATUS.RUNNING, started_ago=0.01),
        _job("g", "w1", STATUS.FINISHED, started_ago=30.0)])
    out = {}
    for name, (store, led, rec) in boards.items():
        got = [rec.scan(store, "db.map_jobs"),
               rec.scan(store, "db.map_jobs")]  # never twice
        _written_by(store, "s")
        got.append(rec.scan(store, "db.map_jobs"))
        docs = {d["_id"]: (d["status"], d["repetitions"])
                for d in store.find("db.map_jobs")}
        out[name] = (got, docs, strip(led.decisions()), rec._pending)
    assert out["port"] == out["jax"]
    got, docs, decs, pending = out["port"]
    assert got == [["s"], [], []] and pending == {}
    assert docs["f"][0] == int(STATUS.RUNNING)
    assert docs["g"][0] == int(STATUS.FINISHED)
    assert docs["s"][1] == 1
    assert [d["outcome"] for d in decs] == ["improved"]
    assert decs[0]["evidence"]["worker"] == "w1"


def test_reclaimer_never_fires_without_peer_baseline(monkeypatch):
    boards = _boards(monkeypatch, [
        _job("a", "w1", STATUS.WRITTEN, real_time=0.05),
        _job("s", "w1", STATUS.RUNNING, started_ago=30.0)])
    for store, led, rec in boards.values():
        assert rec.scan(store, "db.map_jobs") == []
        assert led.decisions("reclaim") == []


def test_reclaimer_resolves_vanished_job_and_filters_find(monkeypatch):
    boards = _boards(monkeypatch, [
        _job("a", "w2", STATUS.WRITTEN, real_time=0.05),
        _job("b", "w2", STATUS.WRITTEN, real_time=0.06),
        _job("s", "w1", STATUS.RUNNING, started_ago=30.0)])
    out = {}
    for name, (store, led, rec) in boards.items():
        queries = []
        orig_find = store.find

        def spy_find(coll, query=None, _orig=orig_find, _q=queries):
            _q.append(query)
            return _orig(coll, query)

        store.find = spy_find
        got = [rec.scan(store, "db.map_jobs"),
               rec.scan(store, "db.map_jobs")]
        mid = strip(led.decisions())
        store.remove("db.map_jobs", {"_id": "s"})
        rec.scan(store, "db.map_jobs")
        out[name] = (got, queries, mid, strip(led.decisions()),
                     rec._pending)
    assert out["port"] == out["jax"]
    got, queries, mid, decs, pending = out["port"]
    assert got == [["s"], []] and None not in queries
    assert mid[0]["outcome"] == "pending"
    assert decs[0]["outcome_evidence"] == {"status": "vanished"}
    assert pending == {}


def test_reclaimer_finish_resolves_at_phase_end(monkeypatch):
    boards = _boards(monkeypatch, [
        _job("a", "w2", STATUS.WRITTEN, real_time=0.05),
        _job("b", "w2", STATUS.WRITTEN, real_time=0.06),
        _job("s", "w1", STATUS.RUNNING, started_ago=30.0)])
    out = {}
    for name, (store, led, rec) in boards.items():
        got = [rec.scan(store, "db.map_jobs")]
        _written_by(store, "s")
        rec.finish(store, "db.map_jobs")
        store.insert("db.map_jobs", _job("c", "w3", STATUS.WRITTEN,
                                         real_time=0.04))
        store.insert("db.map_jobs", _job("s2", "w1", STATUS.RUNNING,
                                         started_ago=30.0))
        store.insert("db.map_jobs", _job("s3", "w1", STATUS.RUNNING,
                                         started_ago=30.0))
        got.append(rec.scan(store, "db.map_jobs"))
        store.update("db.map_jobs", {"_id": "s2"},
                     {"$set": {"status": int(STATUS.WAITING)}})
        store.update("db.map_jobs", {"_id": "s3"},
                     {"$set": {"status": int(STATUS.FAILED)}})
        rec.finish(store, "db.map_jobs")
        rec.finish(store, "db.map_jobs")  # nothing pending: a no-op
        out[name] = (got, strip(led.decisions()), rec._pending)
    assert out["port"] == out["jax"]
    got, decs, pending = out["port"]
    assert got == [["s"], ["s2", "s3"]] and pending == {}
    assert [(d["action"]["job"], d["outcome"]) for d in decs] == [
        ("s", "improved"), ("s2", "neutral"), ("s3", "regressed")]
    assert decs[1]["outcome_evidence"] == {"status": "phase_ended"}


# -- chaos: speculative re-claim + fencing = exactly-once --------------------


def _witness_module(files, hold_key):
    """A fresh word-count module counting STARTED at map entry and
    COMPLETED after the last emit; *hold_key*'s first attempt blocks on
    ``HOLD`` (pinning its worker inside the job)."""
    name = f"torch_reclaim_{uuid.uuid4().hex[:8]}"
    mod = types.ModuleType(name)
    mod.STARTED, mod.COMPLETED, mod.RESULT = Counter(), Counter(), {}
    mod.HOLD = threading.Event()
    lock = threading.Lock()

    def taskfn(emit):
        for i, path in enumerate(files):
            emit(i, path)

    def mapfn(key, value, emit):
        with lock:
            mod.STARTED[key] += 1
            attempt = mod.STARTED[key]
        if key == hold_key and attempt == 1:
            mod.HOLD.wait(timeout=DEADLINE)
        with open(value) as f:
            for line in f:
                for word in line.split():
                    emit(word, 1)
        with lock:
            mod.COMPLETED[key] += 1

    def partitionfn(key):
        return fnv1a32(key.encode()) % 3

    def reducefn(key, values):
        return sum(values)

    def finalfn(pairs):
        mod.RESULT.clear()
        for key, values in pairs:
            mod.RESULT[key] = values[0]
        return True

    for fn in (taskfn, mapfn, partitionfn, reducefn, finalfn):
        setattr(mod, fn.__name__, fn)
    mod.associative_reducer = mod.commutative_reducer = True
    mod.idempotent_reducer = True
    sys.modules[name] = mod
    return name, mod


def _wait(pred, what):
    give_up = time.monotonic() + DEADLINE
    while time.monotonic() < give_up:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _in_thread(fn, what):
    """Run *fn* in a thread joined under the deadline; fail on it."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as exc:  # re-raised in the test's thread
            box["exc"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=DEADLINE)
    if t.is_alive():
        raise AssertionError(f"{what} did not finish in {DEADLINE} s")
    if "exc" in box:
        raise box["exc"]
    return box.get("out")


@pytest.mark.chaos
@pytest.mark.telemetry
def test_speculative_reclaim_never_double_executes(tmp_path):
    """The port's twin of the JAX chaos acceptance test: a worker
    pinned inside a map job holds a 60 s lease, so only the re-claim
    can re-issue the job inside the test; a healthy worker re-runs it,
    the deposed worker fences at its next emit.  STARTED == 2 for the
    held key, COMPLETED == 1 for every key."""
    from mapreduce_tpu_torch import spec
    from mapreduce_tpu_torch.examples import naive
    from mapreduce_tpu_torch.utils.constants import TASK_STATUS
    from mapreduce_tpu_torch.utils.httpclient import RetryPolicy
    from mapreduce_tpu_torch.worker import Worker

    spec.clear_caches()
    files = []
    for i in range(6):
        p = tmp_path / f"f{i}.txt"
        p.write_text(f"alpha beta f{i} gamma alpha\n" * 5)
        files.append(str(p))
    mod_name, mod = _witness_module(files, hold_key=2)
    params = {r: mod_name for r in ("taskfn", "mapfn", "partitionfn",
                                    "reducefn", "finalfn")}
    params["storage"] = f"mem:{uuid.uuid4().hex}"
    retry = RetryPolicy(max_attempts=4, base_delay=0.02, deadline=10.0,
                        breaker_threshold=0)
    led = tcontrol.ControlLedger()
    connstr = f"mem://{uuid.uuid4().hex}"
    server = TServer(connstr, "spec", job_lease=60.0, retry=retry,
                     reclaim=tauto.SpeculativeReclaimer(led,
                                                        min_age_s=0.5))
    server.configure(params)
    server.task.create_collection(TASK_STATUS.WAIT, server.params, 1)
    server._prepare_map()
    # serial one-job claims: claim-ahead would let the straggler claim
    # every job before pinning, starving the healthy worker of the
    # completed-job baseline the leave-one-out test requires
    serial = {"claim_batch": 1, "claim_ahead": False, "max_sleep": 0.2}
    w1 = Worker(connstr, "spec", name="w-straggler", retry=retry)
    w1.configure(serial)
    w1.heartbeat_period = 0.1
    w1.task.job_lease = 60.0
    t1 = threading.Thread(target=w1.execute, daemon=True)
    t1.start()
    w2 = None
    t2 = None
    try:
        _wait(lambda: mod.STARTED[2] == 1, "the straggler's held job")
        w2 = Worker(connstr, "spec", name="w-healthy", retry=retry)
        w2.configure(serial)
        t2 = threading.Thread(target=w2.execute, daemon=True)
        t2.start()
        _in_thread(lambda: server._poll_phase(server.task.map_jobs_ns(),
                                              "map"), "the map phase")
        _wait(lambda: (w1.current_fence is not None
                       and w1.current_fence.is_set()),
              "the straggler to be fenced")
    finally:
        mod.HOLD.set()  # release the stale run; it must abort
    server._prepare_reduce()
    _in_thread(lambda: server._poll_phase(server.task.red_jobs_ns(),
                                          "reduce"), "the reduce phase")
    stats = server._compute_stats()
    server._final()
    for t in (t1, t2):
        t.join(timeout=DEADLINE)
        assert not t.is_alive(), f"{t.name} did not exit"
    assert mod.RESULT == naive.wordcount(files)
    assert mod.STARTED[2] == 2
    assert mod.COMPLETED[2] == 1
    assert all(mod.COMPLETED[k] == 1 for k in range(len(files)))
    assert stats["map"]["failed"] == 0
    doc = server.cnn.connect().find(server.task.map_jobs_ns(),
                                    {"_id": "2"})[0]
    assert doc["status"] == int(STATUS.WRITTEN)
    assert doc["worker"] == "w-healthy" and doc["repetitions"] >= 1
    decs = led.decisions("reclaim")
    assert decs and decs[0]["action"]["job"] == "2"
    assert decs[0]["evidence"]["worker"] == "w-straggler"
    # the phase drained: finish() resolved the re-claim from the docs
    assert decs[0]["outcome"] == "improved"
    assert decs[0]["outcome_evidence"]["completed_by"] == "w-healthy"
    spec.clear_caches()


# -- surfaces ----------------------------------------------------------------


def test_collector_carries_control_family():
    from mapreduce_tpu.obs.collector import DIAG_FAMILIES as JFAM
    from mapreduce_tpu_torch.obs.collector import DIAG_FAMILIES

    assert "mrtpu_control_decisions_total" in DIAG_FAMILIES
    assert "mrtpu_control_decisions_total" in JFAM


class _Stop(Exception):
    """Ends a CLI command at ``Server.configure``, after the controllers
    were attached."""


@pytest.mark.parametrize("cmd", ["server", "wordcount"])
@pytest.mark.parametrize("flags,reclaim,autotune", [
    ([], True, True),
    (["--no-autotune"], True, False),
    (["--no-speculative-reclaim"], False, True),
    (["--no-autotune", "--no-speculative-reclaim"], False, False),
    (["--no-autotune", "--autotune", "--speculative-reclaim"], True, True),
])
def test_cli_controllers_default_on_as_in_jax(monkeypatch, cmd, flags,
                                              reclaim, autotune):
    """``server`` and ``wordcount`` attach a ``SpeculativeReclaimer``
    and an ``AutoTuner(repartition=False)`` unless ``--no-*`` is given,
    exactly as the JAX CLI does on the same flags."""
    seen = {}

    def stop(name):
        def configure(self, params):
            seen[name] = self
            raise _Stop

        return configure

    monkeypatch.setattr(TServer, "configure", stop("port"))
    monkeypatch.setattr(JServer, "configure", stop("jax"))
    argv = (["server", "mem://x", "db", "m", "m", "m", "m"]
            if cmd == "server" else
            ["wordcount", "f.txt", "--device", "--torch-device", "cpu"])
    with pytest.raises(_Stop):
        tcli.main(argv + flags)
    jargv = [a for a in argv if a not in ("--torch-device", "cpu")]
    with pytest.raises(_Stop):
        jmain(jargv + flags + ["--no-compile-cache"])
    for name, ctl in (("port", tauto), ("jax", jauto)):
        srv = seen[name]
        assert isinstance(srv.reclaim, ctl.SpeculativeReclaimer) == \
            reclaim, name
        assert (srv.autotune is not None) == autotune, name
        if autotune:
            assert isinstance(srv.autotune, ctl.AutoTuner)
            assert srv.autotune.repartition is None
            assert srv.autotune.capacity is not None


def test_library_server_defaults_both_off():
    srv = TServer(f"mem://{uuid.uuid4().hex}", "wc")
    assert srv.reclaim is None and srv.autotune is None
    rec = tauto.SpeculativeReclaimer(tcontrol.ControlLedger())
    assert TServer(f"mem://{uuid.uuid4().hex}", "wc",
                   reclaim=rec).reclaim is rec
