"""The port's device telemetry against the JAX package's, on the CPU.

The same numpy-seeded corpus goes through the JAX engine (the lax
formulations: ``segment_impl``, ``tokenize_impl`` and the exchange all
'lax', ``sort_impl='variadic'``; the 1- and 8-device CPU meshes) and the
port's (``Partitions(1 | 8, "cpu")``), fitting and through forced
capacity retries.  Held equal (tolerance: none, integers and names):
the wave, dispatch and retry counters, the per-partition records gauges,
the span tree under one root (names, parent links, counts and the
``attempt``, ``waves``, ``wave``, ``kind``, ``stage`` arguments; the JAX
compile spans, ROADMAP A.8b, left out), each child inside its wave, and
the ``capacity_retry`` events' attempt, overflow rows, bound and
capacities.  Also: the session, spill and checkpoint counters after the
same feed / snapshot / spill / evict / restore / save script, the
collector's ``device_seconds`` and ``flops`` roll-ups, the per-epoch
memory sample of the digits trainer, ``build_info``'s torch fields, the
``timeline`` command against a port docserver (its file accepted by the
JAX ``validate_trace``), and every JAX command either ported or named
with its ROADMAP item.
"""

import dataclasses
import json
import pathlib
import re
import uuid
from collections import Counter

import numpy as np
import pytest
import torch

from mapreduce_tpu.engine import device_engine as jde
from mapreduce_tpu.engine import session as jsession
from mapreduce_tpu.engine import wordcount as jwc
from mapreduce_tpu.models import checkpoint as jckpt
from mapreduce_tpu.obs import profile as jprofile
from mapreduce_tpu.obs.metrics import REGISTRY as JREG
from mapreduce_tpu.obs.trace import TRACER as JTRACER
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu.storage.router import router as jrouter
from mapreduce_tpu_torch import cli as tcli
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.engine import session as tsession
from mapreduce_tpu_torch.engine import wordcount as twc
from mapreduce_tpu_torch.engine.spill import SessionSpillStore
from mapreduce_tpu_torch.models import checkpoint as tckpt
from mapreduce_tpu_torch.obs.buildinfo import build_info
from mapreduce_tpu_torch.obs.collector import Collector
from mapreduce_tpu_torch.obs.metrics import REGISTRY as TREG
from mapreduce_tpu_torch.obs.trace import TRACER as TTRACER
from mapreduce_tpu_torch.parallel.mesh import Partitions
from mapreduce_tpu_torch.storage.router import router as trouter
from tests.test_fused_engine import _records_map_fn
from tests.test_torch_session import (
    jax_cfg, port_cfg, records_map_fn, chunk_stream)
from tests.test_torch_wordcount import CFG, TINY, _corpus

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHUNK = 1024
WAVES = 3
DATA = _corpus(seed=3, n_words=2500)
#: spans of the two packages' compile ledgers: JAX lowers and compiles,
#: the port builds, loads and captures (tests/test_torch_compile.py)
COMPILE_SPANS = {"compile", "lowering", "backend_compile", "nvcc", "g++",
                 "load", "capture"}
TREE_ARGS = ("attempt", "waves", "wave", "kind", "stage")
ENGINE_FAMILIES = ("mrtpu_device_waves_total", "mrtpu_device_retries_total",
                   "mrtpu_device_dispatches_total")


def _task():
    return "t" + uuid.uuid4().hex[:10]


def _family(tracer, root):
    """Every event of *root*'s trace, but the JAX compile spans."""
    return [e for e in tracer.events()
            if e["args"].get("trace_id") == root.trace_id
            and e["name"] not in COMPILE_SPANS]


def _tree(events):
    """The span tree as a multiset of (path of names, the tree args)."""
    by_id = {e["args"]["span_id"]: e for e in events}

    def path(e):
        names = []
        while e is not None:
            names.append(e["name"])
            e = by_id.get(e["args"]["parent_id"])
        return "/".join(reversed(names))

    return Counter((path(e), tuple((k, e["args"][k]) for k in TREE_ARGS
                                   if k in e["args"])) for e in events)


def _contains(outer, inner, slack=0.5):
    """Time containment with the JAX test's half-microsecond slack
    (``ts``/``dur`` are rounded to 0.1 µs independently)."""
    return (outer["ts"] <= inner["ts"] + slack
            and inner["ts"] + inner["dur"]
            <= outer["ts"] + outer["dur"] + slack)


def _retry_events(tracer, task):
    keys = ("attempt", "overflow_rows", "bound", "old_capacities",
            "new_capacities")
    return [{k: e["args"][k] for k in keys} for e in tracer.events()
            if e["name"] == "capacity_retry" and e["args"]["task"] == task]


def _run_jax(P, cfg, task):
    wc = jwc.DeviceWordCount(make_mesh(P), chunk_len=CHUNK, config=cfg)
    chunks, L = wc._to_chunks(DATA)
    eng = wc._engine_for(L)
    eng.task_label = task
    tm = {}
    with JTRACER.span("root") as root:
        eng.run(chunks, timings=tm, waves=WAVES)
    return tm, _family(JTRACER, root)


def _run_port(P, cfg, task):
    tcfg = convert.engine_config_from_jax(dataclasses.asdict(cfg))
    wc = twc.DeviceWordCount(Partitions(P, "cpu"), chunk_len=CHUNK,
                             config=tcfg)
    chunks, L = wc._to_chunks(DATA)
    eng = wc._engine_for(L)
    eng.task_label = task
    tm = {}
    with TTRACER.span("root") as root:
        eng.run(chunks, timings=tm, waves=WAVES)
    return tm, _family(TTRACER, root)


@pytest.fixture(scope="module", params=[
    (1, "fitting"), (1, "retry"), (8, "fitting"), (8, "retry")],
    ids=lambda p: f"P{p[0]}-{p[1]}")
def runs(request):
    P, name = request.param
    cfg = CFG if name == "fitting" else TINY
    jtask, ttask = _task(), _task()
    jtm, jev = _run_jax(P, cfg, jtask)
    ttm, tev = _run_port(P, cfg, ttask)
    return {"P": P, "retry": name == "retry", "jax": (jtask, jtm, jev),
            "port": (ttask, ttm, tev)}


def test_engine_counters_equal_jax(runs):
    jtask, jtm, _ = runs["jax"]
    ttask, ttm, _ = runs["port"]
    for fam in ENGINE_FAMILIES:
        assert TREG.sum(fam, task=ttask) == JREG.sum(fam, task=jtask), fam
    assert (TREG.value("mrtpu_device_dispatches_total", program="wave",
                       task=ttask) == TREG.sum(
                           "mrtpu_device_dispatches_total", task=ttask))
    assert TREG.sum("mrtpu_device_waves_total", task=ttask) \
        == ttm["waves"] == jtm["waves"]
    retries = TREG.sum("mrtpu_device_retries_total", task=ttask)
    assert (retries >= 1) == runs["retry"]
    assert ttm["retries"] == jtm["retries"] == retries


def test_partition_gauges_equal_jax(runs):
    jtask, _, _ = runs["jax"]
    ttask, _, _ = runs["port"]
    for p in range(runs["P"]):
        part = f"P{p:05d}"
        got = TREG.value("mrtpu_device_partition_records", task=ttask,
                         partition=part)
        assert got == JREG.value("mrtpu_device_partition_records",
                                 task=jtask, partition=part) > 0, part
        assert TREG.value("mrtpu_device_partition_bytes", task=ttask,
                          partition=part) == JREG.value(
                              "mrtpu_device_partition_bytes", task=jtask,
                              partition=part)


def test_span_tree_equals_jax(runs):
    _, _, jev = runs["jax"]
    _, _, tev = runs["port"]
    assert _tree(tev) == _tree(jev)
    names = Counter(e["name"] for e in tev)
    attempts = 1 + runs["port"][1]["retries"]
    assert names["device_run"] == attempts
    assert names["wave"] == names["upload"] == names["compute"] \
        == names["readback"] - 1 == runs["port"][1]["waves"] * attempts


def test_wave_children_lie_inside_their_waves(runs):
    _, _, tev = runs["port"]
    by_id = {e["args"]["span_id"]: e for e in tev}
    for e in tev:
        parent = by_id.get(e["args"]["parent_id"])
        if e["name"] in ("upload", "compute") or (
                e["name"] == "readback" and "kind" in e["args"]):
            assert parent["name"] == "wave"
            assert _contains(parent, e), e["name"]
        if e["name"] in ("upload", "compute"):
            assert e["args"]["clock"] == "host"  # the CPU has no events
        if e["name"] == "wave":
            assert parent["name"] == "device_run"
            assert _contains(parent, e)
            assert "truncated" not in e["args"]


def test_capacity_retry_events_equal_jax(runs):
    jtask, _, _ = runs["jax"]
    ttask, _, _ = runs["port"]
    got = _retry_events(TTRACER, ttask)
    assert got == _retry_events(JTRACER, jtask)
    assert len(got) == runs["port"][1]["retries"]
    assert all(e["bound"] == "capacity" for e in got)
    assert TREG.sum("mrtpu_device_capacity_retry_events_total",
                    task=ttask) == len(got)


def test_timings_carry_the_cost_and_memory_fields(runs):
    _, jtm, _ = runs["jax"]
    ttask, ttm, _ = runs["port"]
    for key in ("flops", "cost_bytes", "cost_source", "peak_source",
                "model_flops_per_s", "arith_intensity", "mfu",
                "roofline_frac", "program_memory_bytes", "memory_source",
                "upload_overlap_frac"):
        assert key in ttm and key in jtm, key
    assert ttm["cost_source"] == ttm["memory_source"] == "analytic"
    assert ttm["peak_source"] == "platform:cpu"
    assert ttm["flops"] > 0 and 0.0 <= ttm["upload_overlap_frac"] <= 1.0
    assert TREG.sum("mrtpu_device_flops_total", source="analytic",
                    task=ttask) == ttm["flops"]


def test_failed_attempt_truncates_its_waves(monkeypatch):
    """A wave that raises closes the attempt's begun waves truncated and
    its device_run, and nothing of the attempt is left open."""
    from mapreduce_tpu_torch.engine import device_engine as tde

    tcfg = convert.engine_config_from_jax(dataclasses.asdict(CFG))
    wc = twc.DeviceWordCount(Partitions(2, "cpu"), chunk_len=CHUNK,
                             config=tcfg)
    chunks, L = wc._to_chunks(DATA)
    eng = wc._engine_for(L)
    real = tde.DeviceEngine._wave
    calls = []

    def dying(self, cfg, chunks, first, *a, **kw):
        calls.append(first)
        if len(calls) == 2:
            raise RuntimeError("wave died")
        return real(self, cfg, chunks, first, *a, **kw)

    monkeypatch.setattr(tde.DeviceEngine, "_wave", dying)
    with TTRACER.span("root") as root:
        with pytest.raises(RuntimeError, match="wave died"):
            eng.run(chunks, waves=WAVES)
    ev = _family(TTRACER, root)
    waves = [e for e in ev if e["name"] == "wave"]
    assert [w["args"]["wave"] for w in waves] == [0, 1]
    assert all(w["args"]["truncated"] for w in waves)
    assert [e["name"] for e in ev].count("device_run") == 1


# -- sessions, spills, checkpoints --------------------------------------------

SESSION_FAMILIES = (
    "mrtpu_session_feeds_total", "mrtpu_session_chunks_total",
    "mrtpu_session_snapshots_total", "mrtpu_session_overflow_rows_total",
    "mrtpu_session_spills_total", "mrtpu_session_restores_total",
    "mrtpu_session_records_live", "mrtpu_device_waves_total",
    "mrtpu_device_dispatches_total")
CKPT_FAMILIES = ("mrtpu_ckpt_saves_total", "mrtpu_ckpt_restores_total",
                 "mrtpu_ckpt_corrupt_shards_total",
                 "mrtpu_ckpt_fallbacks_total", "mrtpu_ckpt_gc_total",
                 "mrtpu_ckpt_bytes_total")


def _session_script(sess, tasks, streams):
    """Feeds, snapshots, a spill, an evict (lazy restore on the next
    feed), a restore and a close, in one order for both packages."""
    a, b = tasks
    sess.feed(streams[0][:16], task=a)
    sess.feed(streams[1][:16], task=b)
    sess.snapshot(a)
    sess.spill_stream(a)
    sess.evict(b)
    sess.feed(streams[1][16:], task=b)   # restores b lazily
    sess.snapshot(b)
    sess.feed(streams[0][16:], task=a)
    sess.restore(a)                      # rolls a back to its spill
    sess.snapshot(a)
    sess.close(b)


def _counts(reg, families, tasks):
    out = {}
    for fam in families:
        for t in tasks:
            out[(fam, t[:1])] = reg.sum(fam, task=t)
    return out


@pytest.mark.parametrize("P", [1, 8])
def test_session_and_spill_counters_equal_jax(tmp_path, P):
    """The same script on both sessions: every session counter equal by
    task, the spill reasons and restore outcomes, the SLO feed/snapshot
    observations and staleness counts, the resident-streams gauge, the
    stream-age series, and the checkpoint metrics' deltas (bytes only
    at P = 1, where both packages write one shard a leaf)."""
    streams = [chunk_stream(20 + i, 32) for i in range(2)]
    jt = (f"a{uuid.uuid4().hex[:8]}", f"b{uuid.uuid4().hex[:8]}")
    tt = (f"a{uuid.uuid4().hex[:8]}", f"b{uuid.uuid4().hex[:8]}")
    j0 = {f: JREG.sum(f) for f in CKPT_FAMILIES}
    js = jsession.EngineSession(
        make_mesh(P), _records_map_fn, jax_cfg(), k=2,
        spill=jsession.SessionSpillStore(jrouter(f"shared:{tmp_path}/j")))
    _session_script(js, jt, streams)
    j1 = {f: JREG.sum(f) - j0[f] for f in CKPT_FAMILIES}
    t0 = {f: TREG.sum(f) for f in CKPT_FAMILIES}
    ts = tsession.EngineSession(
        Partitions(P, "cpu"), records_map_fn, port_cfg(jax_cfg()), k=2,
        spill=SessionSpillStore(trouter(f"shared:{tmp_path}/t")))
    _session_script(ts, tt, streams)
    t1 = {f: TREG.sum(f) - t0[f] for f in CKPT_FAMILIES}
    assert _counts(TREG, SESSION_FAMILIES, tt) == \
        _counts(JREG, SESSION_FAMILIES, jt)
    for reason in ("explicit",):
        for jtask, ttask in zip(jt, tt):
            assert TREG.value("mrtpu_session_spills_total", task=ttask,
                              reason=reason) == JREG.value(
                "mrtpu_session_spills_total", task=jtask, reason=reason)
    for jtask, ttask in zip(jt, tt):
        assert TREG.value("mrtpu_session_restores_total", task=ttask,
                          outcome="ok") == JREG.value(
            "mrtpu_session_restores_total", task=jtask, outcome="ok") > 0
        assert TREG.value("mrtpu_session_waves_total", task=ttask,
                          tier="-") == JREG.value(
            "mrtpu_session_waves_total", task=jtask, tier="-") > 0
        for op in ("feed", "snapshot"):
            assert TREG.value("mrtpu_slo_session_op_seconds", tenant=ttask,
                              op=op) == JREG.value(
                "mrtpu_slo_session_op_seconds", tenant=jtask, op=op) > 0
        assert TREG.value("mrtpu_slo_snapshot_staleness_seconds",
                          tenant=ttask) == JREG.value(
            "mrtpu_slo_snapshot_staleness_seconds", tenant=jtask)
    if P == 1:
        assert t1 == j1
    else:
        assert {f: v for f, v in t1.items() if f != "mrtpu_ckpt_bytes_total"} \
            == {f: v for f, v in j1.items() if f != "mrtpu_ckpt_bytes_total"}
        assert 0 < t1["mrtpu_ckpt_bytes_total"] < j1["mrtpu_ckpt_bytes_total"]
    assert TREG.value("mrtpu_session_resident_streams", task="-") == 1
    tsession.refresh_stream_age_gauges()
    ages = TREG.gauge("mrtpu_session_stream_age_seconds")
    assert TREG.value("mrtpu_session_stream_age_seconds", task=tt[0],
                      stamp="feed") >= 0.0
    assert all("task=" in line for line in ages.samples())
    # the closed stream's series is gone
    assert not any(tt[1] in line for line in ages.samples())


def test_session_backpressure_counts_both_reasons():
    s = tsession.EngineSession(Partitions(1, "cpu"), records_map_fn,
                               port_cfg(jax_cfg()), k=1)
    task = _task()
    s._handed_off.add(task)
    with pytest.raises(tsession.SessionBusyError):
        s.feed(chunk_stream(1, 2), task=task)
    assert TREG.value("mrtpu_session_backpressure_total", task=task,
                      reason="migrating") == 1
    s.max_pending_feeds = 1
    s._pending[task] = 1
    with pytest.raises(tsession.SessionBusyError):
        s.feed(chunk_stream(1, 2), task=task)
    assert TREG.value("mrtpu_session_backpressure_total", task=task,
                      reason="feed_queue") == 1


def test_spill_policy_reasons_label_the_spills():
    from mapreduce_tpu_torch.engine.spill import SpillPolicy
    from mapreduce_tpu_torch.storage.memory import MemoryStorage

    s = tsession.EngineSession(
        Partitions(1, "cpu"), records_map_fn, port_cfg(jax_cfg()), k=1,
        spill=SessionSpillStore(MemoryStorage()),
        spill_policy=SpillPolicy(max_resident=1))
    a, b = _task(), _task()
    s.feed(chunk_stream(1, 2), task=a)
    s.feed(chunk_stream(2, 2), task=b)   # a is the coldest: evicted
    assert s.tasks() == [b]
    assert TREG.value("mrtpu_session_spills_total", task=a,
                      reason="resident_cap") == 1


def _ckpt_script(mod, storage, restore_latest):
    """Save three steps (keep 2: one retention gc), corrupt the newest
    shard, restore the newest complete one (one fallback)."""
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": np.ones(5, dtype=np.int32)}
    mgr = mod.CheckpointManager(storage, prefix="ck/", keep_n=2)
    for step in (1, 2, 3):
        mgr.save(step, {k: v + step for k, v in tree.items()})
    blob = [n for n in storage.list(r"^ck/ckpt-00000003/.*\.npy$")][0]
    storage.write_bytes(blob, b"garbage")
    out = restore_latest(storage, tree)
    return int(out[1]["step"])


def test_checkpoint_counters_equal_jax(tmp_path):
    from mapreduce_tpu.storage.localdir import LocalDirStorage as JDir
    from mapreduce_tpu_torch.storage.localdir import LocalDirStorage as TDir

    j0 = {f: JREG.sum(f) for f in CKPT_FAMILIES}
    jstep = _ckpt_script(jckpt, JDir(str(tmp_path / "j")),
                         lambda st, tree: jckpt.restore_latest(
                             st, tree, prefix="ck/"))
    jd = {f: JREG.sum(f) - j0[f] for f in CKPT_FAMILIES}
    t0 = {f: TREG.sum(f) for f in CKPT_FAMILIES}
    tstep = _ckpt_script(tckpt, TDir(str(tmp_path / "t")),
                         lambda st, tree: tckpt.restore_latest(
                             st, prefix="ck/", template=tree))
    td = {f: TREG.sum(f) - t0[f] for f in CKPT_FAMILIES}
    assert tstep == jstep == 2
    assert td == jd
    assert td["mrtpu_ckpt_fallbacks_total"] == 1
    assert td["mrtpu_ckpt_gc_total"] == 1
    assert TREG.value("mrtpu_ckpt_last_step", op="restore") == 2


# -- the collector, the trainer, build info -----------------------------------


def test_collector_rolls_up_device_seconds_and_flops():
    task = _task()
    tcfg = convert.engine_config_from_jax(dataclasses.asdict(CFG))
    wc = twc.DeviceWordCount(Partitions(2, "cpu"), chunk_len=CHUNK,
                             config=tcfg)
    chunks, L = wc._to_chunks(DATA)
    eng = wc._engine_for(L)
    eng.task_label = task
    tm = {}
    eng.run(chunks, timings=tm, waves=2)
    doc = Collector().cluster_doc()
    roll = doc["mrtpuCluster"]["tasks"][task]
    assert set(roll) == {"records", "bytes", "device_seconds", "flops"}
    assert roll["flops"] == tm["flops"] > 0
    assert roll["device_seconds"] == round(tm["compute_s"], 4)


def test_trainer_samples_device_memory_each_epoch():
    from mapreduce_tpu_torch.models import digits
    from mapreduce_tpu_torch.models.trainer import (
        DistributedTrainer, TrainConfig)
    from mapreduce_tpu_torch.obs import memory

    memory.reset_state()
    x_tr, y_tr, x_va, y_va = digits.make_digits(n_train=256, n_val=64)
    tr = DistributedTrainer(cfg=TrainConfig(max_epochs=2, min_epochs=1),
                            device="cpu")
    tr.fit(x_tr, y_tr, x_va, y_va)
    snap = memory.memory_snapshot()
    assert snap["device_source"] == "analytic"
    assert snap["devices"]["0"]["bytes_in_use"] > 0


def test_build_info_has_the_torch_fields():
    info = build_info(refresh=True)
    assert info["torch"] == torch.__version__
    assert info["cuda"] == str(torch.version.cuda or "unavailable")
    assert info["backend"] == ("cuda" if torch.cuda.is_available()
                               else "cpu")
    assert info["device_kind"] != ""
    assert "jax" not in info
    samples = TREG.gauge("mrtpu_build_info").samples()
    assert len(samples) == 1 and samples[0].endswith(" 1")


# -- the CLI ------------------------------------------------------------------


def test_timeline_writes_a_trace_the_jax_validator_accepts(tmp_path,
                                                          capsys):
    from mapreduce_tpu_torch.coord.docserver import DocServer

    srv = DocServer().start_background()
    try:
        with TTRACER.span("timeline-probe"):
            pass
        out = tmp_path / "cluster.json"
        rc = tcli.main(["timeline", f"http://{srv.host}:{srv.port}",
                        "--out", str(out)])
    finally:
        srv.shutdown()
    assert rc == 0
    doc = json.loads(out.read_text())
    jprofile.validate_trace(doc)
    assert any(e["name"] == "timeline-probe" for e in doc["traceEvents"])
    assert "cluster timeline written" in capsys.readouterr().out
    assert tcli.main(["timeline", "mem://board", "--out",
                      str(out)]) == 2


def _jax_commands():
    """The JAX CLI's command names, read as text from its COMMANDS
    table."""
    src = (ROOT / "mapreduce_tpu" / "cli.py").read_text()
    table = re.search(r"^COMMANDS = \{(.*?)\}", src, re.S | re.M).group(1)
    return re.findall(r'"([a-z_]+)":', table)


def test_every_jax_command_is_ported_or_named(capsys):
    names = _jax_commands()
    assert len(names) == 19 and "timeline" in names
    for name in names:
        assert (name in tcli.COMMANDS) != (name in tcli.NOT_PORTED_COMMANDS), \
            name
    for name, item in tcli.NOT_PORTED_COMMANDS.items():
        assert tcli.main([name]) == 2
        err = capsys.readouterr().err
        assert "not ported" in err and item in err
        assert re.match(r"ROADMAP A\.(8[bc]|11)", item), item
