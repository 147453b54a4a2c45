"""Kill an engine host: the port's counterpart of
``tests/test_fleet_chaos.py``.

A real engine-host OS process (the victim, whose body is :func:`_victim`
in this module: ``python -m tests.test_torch_fleet_chaos CONNSTR
SPILL_DIR HOST_ID LEASE``) joins the port's fleet over a shared
``dir://`` board, routes the ``live`` stream to itself, feeds the record
stream one chunk at a time on ``Partitions(8, "cpu")`` with a spill after
every feed, and is SIGKILLed once 4 spills are durable.  Held:

* the scheduler's ``recovery_sweep`` re-homes the stream to the spare
  within the host lease plus 2 s (the JAX test's bound);
* a fresh session restores the stream from the last committed spill, and
  its snapshot is bit-equal to an uninterrupted port stream over exactly
  the chunks the spill covers, to the JAX session over the same chunks,
  and equal to the host oracle (each committed record folded once);
* the migration counter and the control ledger's ``fleet`` decision name
  the move.

And a ``cli runner`` process steps down when ``cli drain`` flags it.  The
victim imports nothing of JAX; every wait has a deadline.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

pytestmark = [pytest.mark.chaos]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the failed-host detection window under test (seconds)
LEASE = 1.0
#: chunks in the victim's stream, and the spills it must commit before
#: the kill
STREAM_CHUNKS = 48
KILL_AFTER = 4
#: seconds the victim may take to start and commit KILL_AFTER spills
STARTUP_S = 120
#: the small config of tests/test_fleet_chaos.py
CFG = dict(local_capacity=256, exchange_capacity=128, out_capacity=256,
           tile=64, tile_records=64, reduce_op="sum")


def _stream():
    """``tests.test_fused_engine._chunks(default_rng(13), 48)``."""
    return np.random.default_rng(13).integers(
        0, 1 << 14, size=(STREAM_CHUNKS, 32)).astype(np.int32)


def _records_map_fn(chunk, chunk_index, cfg):
    """The torch twin of ``tests.test_fused_engine._records_map_fn``."""
    c = chunk.to(torch.int64)
    k1 = (c % 23).to(torch.int32)
    k2 = (c % 5).to(torch.int32)
    keys = torch.stack([k1, k2], dim=-1)
    vals = (c % 101).to(torch.int32) + 1
    pay = (k1 * 7 + k2)[:, None]
    valid = (c % 7) != 0
    return keys, vals, pay, valid, torch.zeros((), dtype=torch.int32)


def _session(spill_dir=None, task="live"):
    from mapreduce_tpu_torch.engine.device_engine import EngineConfig
    from mapreduce_tpu_torch.engine.session import EngineSession
    from mapreduce_tpu_torch.engine.spill import SessionSpillStore
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.storage.localdir import LocalDirStorage

    spill = (None if spill_dir is None
             else SessionSpillStore(LocalDirStorage(str(spill_dir))))
    return EngineSession(Partitions(8, "cpu"), _records_map_fn,
                         EngineConfig(**CFG), task=task, k=1, spill=spill)


def _victim(connstr, spill_dir, host_id, lease):
    """Join, route ``live`` here, then feed one chunk and spill, again
    and again; progress is written AFTER each spill commits.  Idles
    heartbeating once the stream is fed: the parent's SIGKILL is the
    only way out."""
    from mapreduce_tpu_torch.coord import docstore
    from mapreduce_tpu_torch.coord.fleet import FleetMember, FleetRegistry

    torch.set_num_threads(2)
    store = docstore.connect(connstr)
    member = FleetMember(store, host_id=host_id, lease=float(lease))
    member.join(timeout=10.0, warm_programs=[], hbm_frac=0.2)
    FleetRegistry(store).assign("live", host_id, program="records")
    sess = _session(spill_dir)
    chunks = _stream()
    for i in range(len(chunks)):
        member.heartbeat(warm_programs=[], hbm_frac=0.2)
        sess.feed(chunks[i:i + 1])
        step = sess.spill_stream()
        store.update("__chaos__.progress", {"_id": host_id},
                     {"$set": {"spilled_chunks": i + 1, "step": step}},
                     upsert=True)
    while True:
        member.heartbeat(warm_programs=[], hbm_frac=0.2)
        time.sleep(0.1)


def _wait(pred, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.05)
    raise TimeoutError(what)


def test_sigkill_engine_host_streams_rehomed(tmp_path):
    from mapreduce_tpu_torch.coord import docstore
    from mapreduce_tpu_torch.coord.fleet import FleetMember, FleetRegistry
    from mapreduce_tpu_torch.engine.autotune import AdmissionAdvisor
    from mapreduce_tpu_torch.obs import control as _control
    from mapreduce_tpu_torch.obs.metrics import REGISTRY
    from mapreduce_tpu_torch.sched.scheduler import Scheduler

    board_dir, spill_dir = tmp_path / "board", tmp_path / "spill"
    board_dir.mkdir(), spill_dir.mkdir()
    connstr = f"dir://{board_dir}"
    child = subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_fleet_chaos", connstr,
         str(spill_dir), "victim", str(LEASE)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    spare = None
    try:
        store = docstore.connect(connstr)
        reg = FleetRegistry(store)
        # the spare joins BEFORE the kill: the latency below is detection
        # and sweep, not spare startup
        spare = FleetMember(store, host_id="spare", lease=30.0)
        spare.join(timeout=10.0, warm_programs=[], hbm_frac=0.1)
        # the spare beats while it waits: an expired spare would be
        # reaped by the sweep and leave nothing to re-home to
        _wait(lambda: spare.heartbeat() is not None
              and (store.find_one("__chaos__.progress",
                                  {"_id": "victim"}) or {}
                   ).get("spilled_chunks", 0) >= KILL_AFTER,
              STARTUP_S, "the victim never spilled 4 chunks")
        t_kill = time.monotonic()
        os.kill(child.pid, signal.SIGKILL)   # mid-feed by design
        child.wait(timeout=10)

        sched = Scheduler(store, use_lease=False,
                          advisor=AdmissionAdvisor(), fleet=reg)
        m0 = REGISTRY.sum("mrtpu_session_migrations_total", task="live",
                          reason="recovery")
        moves = _wait(lambda: sched.recovery_sweep() or None, LEASE + 5.0,
                      "recovery sweep never re-homed the stream")
        recovered_s = time.monotonic() - t_kill
        assert moves == [("live", "spare")]
        assert recovered_s <= LEASE + 2.0, (
            f"re-home took {recovered_s:.2f}s (host lease {LEASE}s)")
        assert reg.route("live")["host"] == "spare"
        doc = next(d for d in reg.hosts() if d["_id"] == "victim")
        assert doc.get("holder") is None        # reaped under guard

        # servable now: the lazy restore from the last committed spill
        chunks = _stream()
        dst = _session(spill_dir)
        got = dst.snapshot("live")
        pos = dst.stats("live")["chunks"]
        assert pos >= KILL_AFTER
        ref_s = _session(task="ref")
        for i in range(pos):                   # the victim's feed steps
            ref_s.feed(chunks[i:i + 1])
        ref = ref_s.snapshot("ref")
        for f in ("keys", "values", "payload", "valid"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
        _hold_against_jax(got, chunks[:pos])
        dst.close(drop_spill=False), ref_s.close()

        assert REGISTRY.sum("mrtpu_session_migrations_total", task="live",
                            reason="recovery") - m0 == 1
        assert REGISTRY.sum("mrtpu_fleet_recoveries_total",
                            host="victim") >= 1
        decs = _control.LEDGER.decisions(controller="fleet", task="live")
        assert any("victim to spare" in (d.get("note") or "")
                   for d in decs), [d.get("note") for d in decs]
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=10)
        if spare is not None:
            try:
                spare.leave()
            except OSError:
                pass


def test_runner_steps_down_on_drain(tmp_path):
    """``cli runner`` joins the fleet under ``hostname:pid``; ``cli drain``
    flags it, the runner sees the flag at its next beat, steps down and
    exits 0, its routed streams move to the live host, and ``status``
    renders it ``LEFT``."""
    import contextlib
    import io
    import socket

    from mapreduce_tpu_torch import cli as tcli
    from mapreduce_tpu_torch.coord.docserver import DocServer
    from mapreduce_tpu_torch.coord.docstore import connect
    from mapreduce_tpu_torch.coord.fleet import FleetMember, FleetRegistry

    srv = DocServer().start_background()
    url = f"http://{srv.host}:{srv.port}"
    log = open(tmp_path / "runner.log", "w")
    runner = subprocess.Popen(
        [sys.executable, "-m", "mapreduce_tpu_torch.cli", "runner", url,
         "--partitions", "1", "--torch-device", "cpu", "--workers", "1",
         "--telemetry-interval", "0", "--no-compile-cache"],
        stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    log.close()
    host = f"{socket.gethostname()}:{runner.pid}"
    dst = None
    try:
        reg = FleetRegistry(connect(url))
        _wait(lambda: any(d["_id"] == host for d in reg.live_hosts()),
              STARTUP_S, "the runner never joined the fleet")
        dst = FleetMember(reg.store, host_id="spare", lease=60.0)
        dst.join(timeout=10.0)
        for t in ("s0", "s1"):
            reg.assign(t, host, program="wave")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert tcli.main(["drain", url, host, "--timeout", "30"]) == 0
        assert runner.wait(timeout=30) == 0
        text = (tmp_path / "runner.log").read_text()
        assert f"drain requested for host {host}" in text, text
        assert sorted(r["_id"] for r in reg.routes_for("spare")) == \
            ["s0", "s1"]
        assert "re-homed stream s0 -> spare" in out.getvalue()
        status = io.StringIO()
        with contextlib.redirect_stdout(status):
            assert tcli.main(["status", url]) == 0
        line = [ln for ln in status.getvalue().splitlines()
                if f"host {host}:" in ln]
        assert line and "LEFT" in line[0], status.getvalue()
    finally:
        if runner.poll() is None:
            runner.kill()
            runner.wait(timeout=10)
        if dst is not None:
            dst.leave()
        srv.shutdown()


def _hold_against_jax(snap, fed):
    """The recovered snapshot against the JAX session fed the same chunks
    one at a time (bit for bit) and against the host oracle."""
    from mapreduce_tpu.engine.device_engine import EngineConfig
    from mapreduce_tpu.engine.session import EngineSession
    from mapreduce_tpu.parallel import make_mesh
    from tests.test_fused_engine import (
        _dict_oracle, _records_map_fn as jax_map_fn, _result_dict)
    from tests.test_torch_session import as_dict, assert_snap_equal

    js = EngineSession(make_mesh(), jax_map_fn, EngineConfig(**CFG),
                       task="live", k=1)
    for i in range(fed.shape[0]):
        js.feed(fed[i:i + 1])
    jsnap = js.snapshot("live")
    assert_snap_equal(snap, jsnap)
    assert as_dict(snap) == _result_dict(jsnap) == _dict_oracle(fed, "sum")
    js.close()


def test_victim_body_imports_no_jax():
    """The module's own imports and the victim's path import nothing of
    JAX (the victim runs without the JAX package)."""
    import ast

    tree = ast.parse(open(__file__).read())
    child = {"_victim", "_session", "_records_map_fn", "_stream"}
    nodes = [n for n in tree.body if isinstance(n, (ast.Import,
                                                    ast.ImportFrom))]
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in child:
            nodes += [n for n in ast.walk(fn)
                      if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in nodes if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in nodes if isinstance(n, ast.ImportFrom)]
    assert names and not [n for n in names
                          if n.split(".")[0] in ("jax", "mapreduce_tpu")]


if __name__ == "__main__":
    _victim(*sys.argv[1:5])
