"""The port's compile plane: the build ledger, the shape registry, the
build directory and ``warmup`` (``obs/compile.py``,
``utils/compile_cache.py``, ``engine/device_engine.replay_registry``,
the capacity controller's registry, ``cli warmup``).

Held against the JAX package where both record the same thing: the
registry's record and replay keys written by the same retrying device
run of the word count example (the JAX ledger's ``cache_dir`` pointed at
a temporary directory, its executables dropped first), and the capacity
controller's pre-sizing and control decision read from each package's
own registry.  On the CPU the observable builds are the ``g++`` host
core's (the ``nvcc`` ones run on the card: ``tests/test_torch_cuda.py``
and ``chip_smoke.py``'s phase 17).  Every comparison is exact.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import uuid

import numpy as np
import pytest
import torch

import mapreduce_tpu.examples.wordcount as jwc
from mapreduce_tpu import spec as jspec
from mapreduce_tpu.engine import autotune as jauto
from mapreduce_tpu.obs import compile as jcompile
from mapreduce_tpu.obs import control as jcontrol
from mapreduce_tpu.obs import profile as jprofile
from mapreduce_tpu.server import Server as JServer

import mapreduce_tpu_torch.examples.wordcount as twc
import mapreduce_tpu_torch.examples.wordspan as tws
from mapreduce_tpu_torch import cli as tcli
from mapreduce_tpu_torch import native as tnative
from mapreduce_tpu_torch import spec as tspec
from mapreduce_tpu_torch.engine import autotune as tauto
from mapreduce_tpu_torch.engine import wordcount as twcmod
from mapreduce_tpu_torch.engine.device_engine import (
    DeviceEngine, EngineConfig, replay_registry)
from mapreduce_tpu_torch.obs import compile as tcompile
from mapreduce_tpu_torch.obs import control as tcontrol
from mapreduce_tpu_torch.obs import profile as tprofile
from mapreduce_tpu_torch.obs.metrics import REGISTRY
from mapreduce_tpu_torch.obs.trace import TRACER
from mapreduce_tpu_torch.ops import kernel_compat as kc
from mapreduce_tpu_torch.parallel.mesh import Partitions
from mapreduce_tpu_torch.server import Server as TServer
from mapreduce_tpu_torch.utils import compile_cache

LOOP_TIMEOUT = 120
CLOCK = ("time", "monotonic", "age_s")
#: the word count example's capacities for the retrying runs
SMALL_CAPS = {"device_local_capacity": 1 << 7,
              "device_exchange_capacity": 1 << 5,
              "device_out_capacity": 1 << 7}


@contextlib.contextmanager
def _cache_at(path):
    """The port's compile cache enabled at *path*, put back after."""
    saved = compile_cache.save_state()
    try:
        yield compile_cache.enable_compile_cache(str(path))
    finally:
        compile_cache.restore_state(saved)


@pytest.fixture
def ledger(monkeypatch):
    """A fresh compile ledger everywhere the port records into one."""
    fresh = tcompile.CompileLedger()
    monkeypatch.setattr(tcompile, "LEDGER", fresh)
    monkeypatch.setattr(tnative, "LEDGER", fresh)
    monkeypatch.setattr(kc, "LEDGER", fresh)
    return fresh


def _reset_examples():
    jspec.clear_caches()
    tspec.clear_caches()
    for mod in (jwc, twc):
        mod._conf.clear()
        mod._conf.update({"files": [], "num_reducers": 15})
        mod.RESULT.clear()
    tws._conf.clear()
    tws._conf.update({"files": [], "num_reducers": 8})
    tws.RESULT.clear()


def _in_thread(fn, timeout=LOOP_TIMEOUT):
    box = {}

    def body():
        try:
            box["out"] = fn()
        except BaseException as exc:  # re-raised in the test thread
            box["err"] = exc

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{fn} still running after {timeout} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def _files(root, seed=5, vocab=600, lines=60):
    rng = np.random.default_rng(seed)
    files = []
    for f in range(3):
        text = "\n".join(" ".join(f"v{int(i)}" for i in rng.integers(
            0, vocab, int(rng.integers(0, 20)))) for _ in range(lines))
        p = root / f"c{f}.txt"
        p.write_text(text + "\n")
        files.append(str(p))
    return files


def _device_run(Server, module, files, parts=None, extra=None):
    params = {r: module for r in ("taskfn", "mapfn", "partitionfn",
                                  "reducefn", "finalfn")}
    params["combinerfn"] = module
    params["storage"] = f"mem:{uuid.uuid4().hex}"
    params["init_args"] = {"files": files, "num_reducers": 4,
                           "device_chunk_len": 1024, **SMALL_CAPS,
                           **(extra or {})}
    params["device"] = True
    if parts is not None:
        params["partitions"] = parts
    server = Server(f"mem://{uuid.uuid4().hex}", "cc")
    server.configure(params)
    stats = _in_thread(server.loop)
    return stats, server


# -- the g++ build through the ledger ------------------------------------------


def _compile_total(program, outcome):
    return REGISTRY.value("mrtpu_compile_total", program=program,
                          outcome=outcome)


def test_gxx_build_compiled_then_persistent_hit_then_cached(
        tmp_path, ledger, monkeypatch):
    monkeypatch.setattr(tnative, "_LIB", None)
    prog = tnative.PROGRAM
    before = {o: _compile_total(prog, o)
              for o in ("compiled", "persistent_hit", "cached")}
    with _cache_at(tmp_path / "c"):
        n0 = len(TRACER.events())
        tnative.load_library()             # empty dir: g++ runs
        assert tnative.lib_path().exists()
        assert str(tnative.lib_path()).startswith(str(tmp_path / "c"))
        tnative._forget()                   # a fresh process's state
        tnative.load_library()             # the .so is there
        tnative.load_library()             # already loaded
        spans = TRACER.events()[n0:]
    (rec,) = ledger.buckets()
    assert rec["program"] == prog
    assert rec["outcomes"] == {"compiled": 1, "persistent_hit": 1,
                               "cached": 1}
    assert rec["count"] == 3
    for o in before:
        assert _compile_total(prog, o) == before[o] + 1, o
    compiles = [e for e in spans if e["name"] == "compile"
                and e["args"].get("program") == prog]
    assert [e["args"]["outcome"] for e in compiles] == [
        "compiled", "persistent_hit"]
    ids = {e["args"]["span_id"] for e in compiles}
    kids = [e["name"] for e in spans if e["args"]["parent_id"] in ids]
    assert kids.count("g++") == 1 and kids.count("load") == 2
    snap = ledger.snapshot()["programs"][prog]
    assert (snap["compiled"], snap["persistent_hit"], snap["cached"]) == (
        1, 1, 1)


def test_no_compile_cache_counts_each_build(ledger, monkeypatch):
    monkeypatch.setattr(tnative, "_LIB", None)
    before = REGISTRY.value("mrtpu_compile_cache_disabled_total",
                            program=tnative.PROGRAM)
    saved = compile_cache.save_state()
    try:
        tmp = compile_cache.disable_compile_cache()
        assert compile_cache.disabled() and compile_cache.cache_dir() is None
        assert str(kc._lib_path("tokenize").parent) == tmp
        assert tmp != compile_cache.DEFAULT_DIR
        tnative.load_library()
        assert str(tnative.lib_path()).startswith(tmp)
        # a registry needs an enabled cache: none is kept
        assert tcompile.registry_path() is None
    finally:
        compile_cache.restore_state(saved)
    assert next(iter(ledger.buckets()))["outcomes"] == {"compiled": 1}
    assert REGISTRY.value("mrtpu_compile_cache_disabled_total",
                          program=tnative.PROGRAM) == before + 1
    assert not compile_cache.disabled()


class _Stop(Exception):
    """Ends a command right after its compile-cache setup."""


CMDS = {"wordcount": ["wordcount", "f.txt", "--device", "--torch-device",
                      "cpu"],
        "server": ["server", "mem://x", "db", "m", "m", "m", "m"],
        "worker": ["worker", "mem://x", "db"],
        "train": ["train", "mem://x", "db"],
        "runner": ["runner", "mem://x"]}


@pytest.mark.parametrize("cmd", sorted(CMDS))
@pytest.mark.parametrize("flags", ["none", "dir", "off"])
def test_cli_takes_the_compile_cache_flags(monkeypatch, tmp_path, cmd,
                                           flags):
    """Every command that once refused ``--compile-cache`` /
    ``--no-compile-cache`` takes them: the default enables the default
    directory, ``--compile-cache DIR`` that directory, and
    ``--no-compile-cache`` a temporary one; ``main`` puts the process's
    choice back when the command returns."""
    seen = {}
    setup = tcli._setup_compile_cache

    def stop(args):
        seen["path"] = setup(args)
        seen["cache_dir"] = compile_cache.cache_dir()
        seen["disabled"] = compile_cache.disabled()
        seen["kc"] = str(kc._lib_path("tokenize").parent)
        raise _Stop

    monkeypatch.setattr(tcli, "_setup_compile_cache", stop)
    argv = CMDS[cmd] + {"none": [], "dir": ["--compile-cache",
                                            str(tmp_path / "d")],
                        "off": ["--no-compile-cache"]}[flags]
    kc_before = kc._lib_path("tokenize")
    with pytest.raises(_Stop):
        tcli.main(argv)
    assert seen["kc"] == seen["path"]
    if flags == "off":
        assert seen["disabled"] and seen["cache_dir"] is None
    elif flags == "dir":
        assert seen["cache_dir"] == str(tmp_path / "d")
    else:
        assert seen["cache_dir"] == compile_cache.resolve_dir()
    assert kc._lib_path("tokenize") == kc_before
    assert compile_cache.cache_dir() is None and not compile_cache.disabled()


def test_build_dir_follows_the_cache_choice(tmp_path):
    before = kc._lib_path("tokenize")
    with _cache_at(tmp_path / "k") as path:
        assert kc._lib_path("tokenize").parent == tmp_path / "k"
        assert path == str(tmp_path / "k")
        assert compile_cache.build_dir() == path
        assert tnative.lib_path().parent == tmp_path / "k"
        assert tcompile.registry_path() == os.path.join(
            path, "mrtpu_shape_registry.json")
    assert kc._lib_path("tokenize") == before
    assert tcompile.registry_path() is None


# -- the registry against JAX's --------------------------------------------------


@pytest.fixture(scope="module")
def registries(tmp_path_factory):
    """The word count example through both packages' ``Server(device=
    True)`` at 8 partitions with capacities its ~600 uniques overflow,
    each package writing its own registry: the port's through its
    enabled cache, the JAX one through its ledger's ``cache_dir``.
    Returns the two directories and both servers."""
    root = tmp_path_factory.mktemp("reg")
    files = _files(root)
    pdir, jdir = root / "port", root / "jax"
    jdir.mkdir()
    _reset_examples()
    with _cache_at(pdir), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcompile, "LEDGER", tcompile.CompileLedger())
        pstats, pserver = _device_run(
            TServer, "mapreduce_tpu_torch.examples.wordcount", files,
            parts=Partitions(8, "cpu"))
        mp.setattr(jcompile, "cache_dir", lambda: str(jdir))
        # the JAX ledger's executables (an earlier test's same program
        # would be served "cached", and a cached program records nothing)
        jcompile.LEDGER.reset()
        jstats, jserver = _device_run(
            JServer, "mapreduce_tpu.examples.wordcount", files)
    want = dict(twc.RESULT)
    assert want == dict(jwc.RESULT)
    _reset_examples()
    assert pstats["device"]["retries"] >= 1
    assert pstats["device"]["retries"] == jstats["device"]["retries"]
    return {"port": str(pdir), "jax": str(jdir), "pserver": pserver,
            "jserver": jserver}


def _waves(path):
    with open(os.path.join(path, "mrtpu_shape_registry.json")) as f:
        doc = json.load(f)
    assert doc["kind"] == "mrtpu-shape-registry" and doc["version"] == 2
    return [r for r in doc["buckets"].values() if r["program"] == "wave"]


def _caps(rec):
    c = rec["replay"]["config"]
    return (c["local_capacity"], c["exchange_capacity"], c["out_capacity"],
            c["tile_records"])


def test_registry_records_match_jax(registries):
    port, jax = _waves(registries["port"]), _waves(registries["jax"])
    assert len(port) == len(jax) >= 2  # one bucket an attempt
    # the JAX record's keys, with ``torch`` for its ``jax`` and no
    # ``donation`` (PyTorch donates no buffers)
    for p, j in zip(port, jax):
        assert set(p) == (set(j) - {"jax", "donation"}) | {"torch"}
        assert set(p["replay"]) == set(j["replay"])
        assert set(p["replay"]["config"]) == set(j["replay"]["config"])
        assert p["replay"]["kind"] == j["replay"]["kind"] == "device_engine"
        assert p["replay"]["map_fn"] == (
            "mapreduce_tpu_torch.examples.wordcount:device_map")
        assert j["replay"]["map_fn"] == (
            "mapreduce_tpu.examples.wordcount:device_map")
    key = lambda r: (_caps(r), r["replay"]["n_dev"], r["replay"]["k"],
                     tuple(r["replay"]["row_shape"]),
                     r["replay"]["row_dtype"], r["tier"])
    assert sorted(map(key, port)) == sorted(map(key, jax))
    assert {r["outcomes"]["compiled"] for r in port} == {1}


def test_autotuner_presizes_from_the_registry_like_jax(registries,
                                                      monkeypatch):
    """A fresh controller on each side reads its own package's registry:
    the same capacities and the same control decision."""
    monkeypatch.setattr(jcompile, "cache_dir", lambda: registries["jax"])
    peng = registries["pserver"]._device_engine
    jeng = registries["jserver"]._device_engine
    _reset_examples()
    twc.init({**SMALL_CAPS})
    jwc.init({**SMALL_CAPS})
    pcfg, jcfg = twc.device_config(), jwc.device_config()
    assert (pcfg.local_capacity, pcfg.exchange_capacity) == (
        jcfg.local_capacity, jcfg.exchange_capacity)
    pled, jled = tcontrol.ControlLedger(), jcontrol.ControlLedger()
    with _cache_at(registries["port"]):
        pnew = tauto.AutoTuner(ledger=pled, repartition=False) \
            .recommend_config(pcfg, peng.autotune_key(), task="t")
    jnew = jauto.AutoTuner(ledger=jled, repartition=False) \
        .recommend_config(jcfg, jeng.autotune_key(), task="t")
    _reset_examples()
    fields = ("local_capacity", "exchange_capacity", "out_capacity",
              "combine_capacity")
    assert [getattr(pnew, f) for f in fields] == \
        [getattr(jnew, f) for f in fields]
    assert pnew.exchange_capacity > pcfg.exchange_capacity
    pd = [{k: v for k, v in d.items() if k not in CLOCK}
          for d in pled.decisions("capacity")]
    jd = [{k: v for k, v in d.items() if k not in CLOCK}
          for d in jled.decisions("capacity")]
    assert pd == jd and len(pd) == 1
    # a fresh controller has no retry forensics: the registry alone
    # (JAX appends the token once a raised field; the port does too)
    source = pd[0]["evidence"]["source"]
    assert set(source.split("+")) == {"shape_registry"}


def test_wordspan_registry_spells_the_tuple_op_as_a_list(tmp_path, ledger,
                                                        monkeypatch):
    """The per-lane op, patched in for the module's callable monoid,
    replays (recorded as a list, rebuilt as a tuple, and no ``sizing``
    beside it); the JAX module's monoid is a callable."""
    _reset_examples()
    files = _files(tmp_path, seed=9)
    with _cache_at(tmp_path / "c") as path, monkeypatch.context() as mp:
        # the same monoid as per-lane codes
        mp.setattr(tws, "SPAN_REDUCE_OP", ("sum", "min", "max"))
        stats, _ = _device_run(
            TServer, "mapreduce_tpu_torch.examples.wordspan", files,
            parts=Partitions(1, "cpu"))
        waves = _waves(path)
        rows = replay_registry(path, "cpu")
    _reset_examples()
    assert stats["device"]["retries"] >= 1
    assert waves and all(r["replay"]["config"]["reduce_op"] ==
                         ["sum", "min", "max"] for r in waves)
    assert len(rows) == len(waves) and all("seconds" in r for r in rows)
    assert all("sizing" not in r for r in waves)
    spans = [r for r in waves if r["replay"]["map_fn"].endswith(
        "wordspan:device_map")]
    assert len(spans) == len(waves)
    import mapreduce_tpu.examples.wordspan as jws
    assert callable(jws.device_config().reduce_op)


def test_callable_wordspan_presizes_from_its_own_buckets(tmp_path, ledger):
    """The module's callable monoid, as the JAX module's, records no
    replay spec, and the replay reports its buckets skipped; each bucket
    keeps the run's capacities (``sizing``), and a fresh controller
    pre-sizes the next run of the same map_fn from them alone."""
    _reset_examples()
    files = _files(tmp_path, seed=9)
    with _cache_at(tmp_path / "d") as path:
        stats, server = _device_run(
            TServer, "mapreduce_tpu_torch.examples.wordspan", files,
            parts=Partitions(1, "cpu"))
        waves = _waves(path)
        rows = replay_registry(path, "cpu")
        eng = server._device_engine
        cfg = eng.config
        pled = tcontrol.ControlLedger()
        new = tauto.AutoTuner(ledger=pled, repartition=False) \
            .recommend_config(cfg, eng.autotune_key(), task="t")
    _reset_examples()
    assert callable(cfg.reduce_op) and stats["device"]["retries"] >= 1
    assert waves and all(r.get("replay") is None for r in waves)
    assert len(rows) == len(waves) and all(
        r["skipped"] == "no replay spec recorded" for r in rows)
    assert all(r["sizing"]["map_fn"] ==
               "mapreduce_tpu_torch.examples.wordspan:device_map"
               for r in waves)
    fields = ("local_capacity", "exchange_capacity", "out_capacity")
    learned = {f: max(r["sizing"]["config"][f] for r in waves)
               for f in fields}
    assert {f: getattr(new, f) for f in fields} == learned
    assert any(learned[f] > getattr(cfg, f) for f in fields)
    (dec,) = pled.decisions("capacity")
    assert set(dec["evidence"]["source"].split("+")) == {"shape_registry"}


def test_replay_registry_reports_each_skip(tmp_path, ledger):
    spec = {"kind": "device_engine",
            "map_fn": "mapreduce_tpu_torch.examples.wordspan:device_map",
            "config": {**vars(EngineConfig(
                local_capacity=256, exchange_capacity=64, out_capacity=256,
                reduce_op=("sum", "min", "max")))},
            "k": 1, "row_shape": [1024], "row_dtype": "uint8", "n_dev": 2}
    spec["config"]["reduce_op"] = ["sum", "min", "max"]
    buckets = {
        "a-capture": {"program": "tf_steps"},
        "b-other": {"program": "wave", "replay": {"kind": "other"}},
        "c-missing": {"program": "wave", "tier": 1, "torch": "2",
                      "replay": {**spec, "map_fn": "no_such_module_xyz:fn"}},
        "d-good": {"program": "wave", "tier": 1, "torch": "2",
                   "replay": spec},
        # the JAX package's bucket in a shared dir: no torch version
        "e-jax": {"program": "wave", "tier": 1, "jax": "0", "replay": {
            **spec, "map_fn": "mapreduce_tpu.examples.wordspan:device_map"}},
    }
    with open(tmp_path / "mrtpu_shape_registry.json", "w") as f:
        json.dump({"kind": "mrtpu-shape-registry", "version": 2,
                   "buckets": buckets}, f)
    rows = replay_registry(str(tmp_path), "cpu")
    assert [r["bucket"] for r in rows] == sorted(buckets)
    assert rows[0]["skipped"] == rows[1]["skipped"] == \
        "no replay spec recorded"
    assert rows[2]["skipped"].startswith("replay failed: ")
    assert "no_such_module_xyz" in rows[2]["skipped"]
    assert "seconds" in rows[3] and rows[3]["tier"] == 1
    assert rows[4]["skipped"].startswith("not this port's bucket")
    (rec,) = [r for r in ledger.buckets() if r["program"] == "wave"]
    assert rec["replay"]["n_dev"] == 2
    assert rec["mesh"] == {"n_devices": 2, "device_kind": "cpu",
                           "platform": "cpu"}


#: a fresh interpreter's replay of a registry directory: the rows, and
#: every module of JAX or of the JAX package it imported
REPLAY_CHILD = """
import json, sys
from mapreduce_tpu_torch.engine.device_engine import replay_registry
rows = replay_registry(sys.argv[1], "cpu")
print(json.dumps({"rows": rows, "jax": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "mapreduce_tpu"))}))
"""


def test_replay_of_a_shared_dir_imports_nothing_of_jax(registries,
                                                      tmp_path):
    """One directory holding both packages' buckets (a shared
    ``$MAPREDUCE_TPU_CACHE``): the port replays its own and skips the
    JAX package's with the reason, importing none of JAX."""
    buckets = {}
    for side in ("jax", "port"):
        with open(os.path.join(registries[side],
                               "mrtpu_shape_registry.json")) as f:
            buckets.update(json.load(f)["buckets"])
    with open(tmp_path / "mrtpu_shape_registry.json", "w") as f:
        json.dump({"kind": "mrtpu-shape-registry", "version": 2,
                   "buckets": buckets}, f)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", REPLAY_CHILD,
                           str(tmp_path)], capture_output=True, text=True,
                          env=env, timeout=LOOP_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["jax"] == []
    rows = {r["bucket"]: r for r in doc["rows"]}
    jax_waves = {b for b, r in buckets.items() if "jax" in r
                 and (r.get("replay") or {}).get("kind") == "device_engine"}
    port_waves = {b for b, r in buckets.items() if "torch" in r
                  and r["program"] == "wave"}
    assert jax_waves and port_waves and set(rows) == set(buckets)
    for b in jax_waves:
        assert rows[b]["skipped"].startswith("not this port's bucket"), \
            rows[b]
        assert "mapreduce_tpu.examples.wordcount" in rows[b]["skipped"]
    assert all("seconds" in rows[b] for b in port_waves)


def test_a_capture_is_never_a_registry_hit(tmp_path, ledger, monkeypatch):
    """A CUDA-graph capture is this process's own: ``compiled`` even
    where the registry holds a bucket of the same avals, and never
    written there."""
    monkeypatch.setattr(kc, "capture_steps", lambda step, n, state: "g")
    xs, ys = torch.zeros(2, 3), torch.zeros(2)
    with _cache_at(tmp_path / "c") as path:
        # a bucket of the same program and avals already in the registry
        ledger.acquire("tf_steps", lambda: None, avals=[xs, ys])
        reg = tcompile.registry_path(path)
        before = open(reg).read()
        graph = kc.StepsGraph(lambda x, y: x, xs, ys, [], [],
                              program="tf_steps")
        assert graph.graph == "g"
        assert open(reg).read() == before
    with _cache_at(tmp_path / "d") as path:
        kc.StepsGraph(lambda x, y: x, xs, ys, [], [], program="tf_steps")
        assert not os.path.exists(tcompile.registry_path(path))
    (rec,) = [r for r in ledger.buckets() if r["program"] == "tf_steps"]
    assert rec["outcomes"] == {"compiled": 3}


def test_the_wave_loop_does_no_registry_io(tmp_path, ledger, monkeypatch):
    """A run reads the shape registry before each attempt and writes
    what the attempt acquired after its readback: no wave of the timed
    loop reads or writes the file."""
    from dataclasses import replace

    data = b" ".join(f"w{i % 300}".encode() for i in range(3000))
    wc = twcmod.DeviceWordCount(Partitions(1, "cpu"), chunk_len=1024)
    chunks, _ = wc._to_chunks(data)
    cfg = replace(wc.config, local_capacity=1 << 5,
                  exchange_capacity=1 << 5, out_capacity=1 << 5)
    eng = DeviceEngine(Partitions(1, "cpu"), twcmod._wordcount_map_fn, cfg)
    waves, io = [0], []
    real_wave = eng._wave

    def wave(*a, **kw):
        waves[0] += 1
        return real_wave(*a, **kw)

    monkeypatch.setattr(eng, "_wave", wave)
    for name in ("_persist", "_load_disk"):
        def spy(*a, _real=getattr(ledger, name), _name=name, **kw):
            io.append((_name, waves[0]))
            return _real(*a, **kw)

        monkeypatch.setattr(ledger, name, spy)
    tm = {}
    with _cache_at(tmp_path / "c") as path:
        eng.run(chunks, timings=tm, waves=3)
        disk = _waves(path)
    assert tm["retries"] >= 1 and tm["waves"] == 3
    # one bucket an attempt, each written once, after its attempt
    assert len(disk) == tm["retries"] + 1
    writes = [w for n, w in io if n == "_persist"]
    assert writes == [3 * (a + 1) for a in range(tm["retries"] + 1)], io
    assert all(w % 3 == 0 for _, w in io), io


# -- the engine's wave acquisitions ---------------------------------------------


def test_wave_program_is_cached_for_a_second_engine(tmp_path, ledger):
    data = b" ".join(f"w{i % 300}".encode() for i in range(3000))
    wc = twcmod.DeviceWordCount(Partitions(1, "cpu"), chunk_len=1024)
    chunks, _ = wc._to_chunks(data)
    cfg = replace_caps(wc.config)
    n0 = len(TRACER.events())
    DeviceEngine(Partitions(1, "cpu"), twcmod._wordcount_map_fn,
                 cfg).run(chunks)
    # a registry needs an enabled cache
    assert tcompile.registry_path() is None
    with _cache_at(tmp_path / "c") as path:
        DeviceEngine(Partitions(1, "cpu"), twcmod._wordcount_map_fn,
                     cfg).run(chunks)
        # acquired before the cache was enabled: written once it is
        (disk,) = tcompile.LEDGER.disk_buckets(path).values()
        assert disk["replay"]["config"]["local_capacity"] == \
            cfg.local_capacity
    (rec,) = [r for r in ledger.buckets() if r["program"] == "wave"]
    assert rec["outcomes"] == {"compiled": 1, "cached": 1}
    assert rec["replay"]["config"]["local_capacity"] == cfg.local_capacity
    assert rec["mesh"]["n_devices"] == 1
    compiles = [e for e in TRACER.events()[n0:] if e["name"] == "compile"]
    assert len(compiles) == 1 and compiles[0]["args"]["program"] == "wave"


def replace_caps(cfg):
    from dataclasses import replace

    return replace(cfg, local_capacity=1 << 12, exchange_capacity=1 << 12,
                   out_capacity=1 << 12)


def test_local_mesh_facts_reads_the_ledger_and_the_registry(
        tmp_path, ledger, monkeypatch):
    monkeypatch.setattr(kc, "is_built", lambda name, defines=(): False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tauto.local_mesh_facts() == ([], None)
    ledger.observe("wave", "compiled", {"build": 0.0})
    assert tauto.local_mesh_facts()[0] == ["wave"]
    with open(tmp_path / "mrtpu_shape_registry.json", "w") as f:
        json.dump({"kind": "mrtpu-shape-registry", "version": 2,
                   "buckets": {"x": {"program": "tf_steps"}}}, f)
    with _cache_at(tmp_path):
        assert tauto.local_mesh_facts()[0] == ["tf_steps", "wave"]


def test_profile_bundle_carries_the_compile_ledger(tmp_path, ledger,
                                                   monkeypatch):
    monkeypatch.setattr(tnative, "_LIB", None)
    with _cache_at(tmp_path / "c"):
        tnative.load_library()
    out = tprofile.write_bundle(str(tmp_path / "b"))
    doc = tprofile.load_bundle(out)["compile_ledger"]
    assert doc["kind"] == "mrtpu-compile-ledger"
    assert doc["buckets"][0]["program"] == tnative.PROGRAM
    assert doc["snapshot"]["programs"][tnative.PROGRAM]["compiled"] == 1
    assert jprofile.load_bundle(out)["compile_ledger"] == doc


# -- warmup ----------------------------------------------------------------------


def _warmup(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tcli.main(["warmup", "--torch-device", "cpu", *argv])
    return rc, out.getvalue(), err.getvalue()


def test_warmup_refuses_a_dir_it_cannot_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    rc, _, err = _warmup(["--compile-cache", str(blocker / "sub")])
    assert rc == 1 and "not writable" in err
    rc, _, err = _warmup(["--no-compile-cache"])
    assert rc == 1 and "persist nothing" in err
    assert compile_cache.cache_dir() is None


def test_warmup_builds_then_hits_then_replays(tmp_path, ledger,
                                              monkeypatch):
    monkeypatch.setattr(tnative, "_LIB", None)
    d = str(tmp_path / "w")
    rc, out, _ = _warmup(["--compile-cache", d, "--json"])
    assert rc == 0
    first = json.loads(out.strip().splitlines()[-1])["warmup"]
    assert first["build_dir"] == d
    assert first["libraries"][tnative.PROGRAM]["outcome"] == "compiled"
    assert first["libraries"][tnative.PROGRAM]["compiler_s"] > 0
    assert first["wave"]["compiled"] == 2  # --tier both: argsort, variadic
    # a fresh process: nothing loaded, nothing acquired
    fresh = tcompile.CompileLedger()
    for mod in (tcompile, tnative, kc):
        monkeypatch.setattr(mod, "LEDGER", fresh)
    tnative._forget()
    rc, out, _ = _warmup(["--cache-dir", d, "--replay", "--json"])
    assert rc == 0
    again = json.loads(out.strip().splitlines()[-1])["warmup"]
    assert again["libraries"][tnative.PROGRAM] == {
        "outcome": "persistent_hit", "compiler_s": 0.0,
        "seconds": again["libraries"][tnative.PROGRAM]["seconds"]}
    assert again["wave"]["persistent_hit"] == 2
    assert len(again["replay"]) == 2
    assert all("seconds" in r and r["tier"] in (0, 1)
               for r in again["replay"])
    assert "replay: 2 bucket(s) primed, 0 skipped" in out
    assert "warmup" in tcli.COMMANDS
    assert "warmup" not in tcli.NOT_PORTED_COMMANDS
