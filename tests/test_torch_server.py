"""The port's job plane end to end against the JAX package's.

``mapreduce_tpu_torch.server.Server`` drives WordCount on both planes:
the host plane (worker threads claim map and reduce jobs on the board)
and the device plane (``configure(device=True)``: the fused map, shuffle
and reduce on the port's engine over ``Partitions(8, "cpu")``, where
every kernel runs as its plain PyTorch version).  Each is held against
the JAX package's ``Server`` on the same files: ``RESULT`` equal, the
map output files and the result partition byte-equal, the job and stats
docs with the same keys.  The JAX device plane runs its default ``lax``
and ``variadic`` formulations with the small capacities of
``tests/test_device_path.py``.  Every comparison is exact.

Every ``Server.loop`` (and the host plane's phase polling) runs in a
thread joined under a timeout of its own: ``_poll_phase`` has no
deadline, so a lost worker must fail the test, not stall the run.
"""

import contextlib
import io
import json
import threading
import uuid

import numpy as np
import pytest
import torch

import mapreduce_tpu.examples.wordcount as jwc
from mapreduce_tpu import cli as jcli
from mapreduce_tpu import spec as jspec
from mapreduce_tpu.server import Server as JServer
from mapreduce_tpu.storage.router import router as jrouter
from mapreduce_tpu.worker import spawn_worker_threads as jspawn

import mapreduce_tpu_torch.examples.wordcount as twc
from mapreduce_tpu_torch import cli as tcli
from mapreduce_tpu_torch import spec as tspec
from mapreduce_tpu_torch.examples import naive
from mapreduce_tpu_torch.ops import kernel_compat as kc
from mapreduce_tpu_torch.parallel.mesh import Partitions
from mapreduce_tpu_torch.server import Server as TServer
from mapreduce_tpu_torch.storage.router import router as trouter
from mapreduce_tpu_torch.utils.constants import STATUS, TASK_STATUS
from mapreduce_tpu_torch.worker import spawn_worker_threads as tspawn

JMOD = "mapreduce_tpu.examples.wordcount"
TMOD = "mapreduce_tpu_torch.examples.wordcount"
#: seconds a whole loop may take here before the test fails
LOOP_TIMEOUT = 60

# -- roles without the device hooks or the ACI flags (the refusals) ---------


def mapfn(key, value, emit):
    emit(value, 1)


def reducefn(key, values):
    return sum(values)


@pytest.fixture(autouse=True)
def fresh_modules():
    def reset():
        jspec.clear_caches()
        tspec.clear_caches()
        for mod in (jwc, twc):
            mod._conf.clear()
            mod._conf.update({"files": [], "num_reducers": 15})
            mod.RESULT.clear()
    reset()
    yield
    reset()


def _write_corpus(root):
    """Three files of whole lines: repeated words (so counts exceed 1),
    unicode, punctuation glued to words, tabs and blank lines."""
    rng = np.random.default_rng(0)
    vocab = ["the", "fox", "dog", "über", "naïve", "日本", "a,b", "x" * 40,
             "€9", "it's", "LOUD", "quiet."] + [f"w{i}" for i in range(60)]
    files = []
    for f in range(3):
        lines = []
        for _ in range(40):
            n = int(rng.integers(0, 12))
            words = [vocab[int(i)] for i in rng.integers(0, len(vocab), n)]
            lines.append(("\t" if f == 1 else " ").join(words))
        p = root / f"f{f}.txt"
        p.write_text("\n".join(lines) + "\n", encoding="utf-8")
        files.append(str(p))
    return files


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _write_corpus(tmp_path_factory.mktemp("corpus"))


def _params(files, module, device=False, sort_impl="variadic",
            storage=None, num_reducers=4):
    params = {r: module for r in ("taskfn", "mapfn", "partitionfn",
                                  "reducefn", "finalfn")}
    params["combinerfn"] = module
    params["storage"] = storage or f"mem:{uuid.uuid4().hex}"
    params["init_args"] = {"files": files, "num_reducers": num_reducers,
                           "device_chunk_len": 2048,
                           "device_local_capacity": 1 << 10,
                           "device_exchange_capacity": 1 << 8,
                           "device_out_capacity": 1 << 10,
                           "device_sort_impl": sort_impl}
    if device:
        params["device"] = True
    return params


def _in_thread(fn, timeout=LOOP_TIMEOUT):
    """Run *fn* in a daemon thread, fail if it outlives *timeout*, and
    re-raise what it raised."""
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


def _join(threads):
    for t in threads:
        assert t.daemon
        t.join(timeout=LOOP_TIMEOUT)
        assert not t.is_alive(), f"worker {t.name} did not exit"


@contextlib.contextmanager
def _keep_results(mod):
    """finalfn returns None: the result partitions stay in storage (the
    reference keeps them unless finalfn returns True)."""
    orig = mod.finalfn

    def keeping(pairs):
        orig(pairs)
        return None

    mod.finalfn = keeping
    try:
        yield
    finally:
        mod.finalfn = orig


def _device_run(server_cls, module, mod, params, router):
    with _keep_results(mod):
        server = server_cls(f"mem://{uuid.uuid4().hex}", "wc")
        server.configure(params)
        stats = _in_thread(server.loop)
    store = server.cnn.connect()
    job_doc = store.find(server.task.map_jobs_ns())
    st = router(server.params["storage"])
    names = server._result_partitions(st)
    return {"result": dict(mod.RESULT), "stats": stats, "jobs": job_doc,
            "names": [n.rsplit(".", 1)[1] for n in names],
            "text": {n.rsplit(".", 1)[1]: st.read(n) for n in names},
            "server": server}


@pytest.fixture(scope="module")
def jax_device(corpus):
    """The JAX device plane on the 8-device CPU mesh, run once."""
    jspec.clear_caches()
    out = _device_run(JServer, JMOD, jwc, _params(corpus, JMOD, device=True),
                      jrouter)
    jspec.clear_caches()
    return out


@pytest.mark.parametrize("sort_impl", ["variadic", "radix"])
def test_device_plane_equals_jax(corpus, jax_device, sort_impl):
    params = _params(corpus, TMOD, device=True, sort_impl=sort_impl)
    params["partitions"] = Partitions(8, "cpu")
    kc.reset_counts()
    port = _device_run(TServer, TMOD, twc, params, trouter)
    oracle = naive.wordcount(corpus)
    assert port["result"] == oracle
    assert port["result"] == jax_device["result"]
    # one result partition, byte-equal record lines
    assert port["names"] == jax_device["names"] == ["P00000"]
    assert port["text"] == jax_device["text"]
    # the job and stats docs carry the same keys
    (pdoc,), (jdoc,) = port["jobs"], jax_device["jobs"]
    assert set(pdoc) == set(jdoc)
    assert pdoc["_id"] == "__device__" and pdoc["worker"] == "server"
    assert pdoc["status"] == int(STATUS.WRITTEN)
    assert set(port["stats"]) == set(jax_device["stats"])
    assert set(port["stats"]["map"]) == set(jax_device["stats"]["map"])
    shared = {"waves", "retries", "compute_s", "readback_s", "upload_s",
              "first_dispatch_s", "exchange"}
    assert shared <= set(pdoc["device_timings"]) & set(
        jdoc["device_timings"])
    assert {"prepare_s", "engine_s", "result_s", "write_s"} <= set(
        port["stats"]["device"])
    assert port["stats"]["map"]["count"] == 1
    assert port["stats"]["reduce"]["count"] == 0
    # the traffic matrix of the same chunks is the JAX one
    assert (pdoc["device_timings"]["exchange"]["matrix"]
            == jdoc["device_timings"]["exchange"]["matrix"])
    json.dumps(pdoc)  # a dir: board writes it with json.dump
    assert port["server"].task.finished()
    # on the CPU every kernel is its plain version
    assert kc.PLAIN_CALLS["tokenize"] > 0 and kc.PLAIN_CALLS["segreduce"] > 0
    if sort_impl == "radix":
        assert kc.PLAIN_CALLS["radix_onesweep"] > 0
        assert kc.PLAIN_CALLS["radix_plan"] > 0
    assert sum(kc.LAUNCHES.values()) == 0


def _host_run(server_cls, spawn, params, connstr, router, mod):
    """The host plane phase by phase (Server.loop's steps), snapshotting
    the map output files before the reduce consumes them."""
    server = server_cls(connstr, "wc")
    server.configure(params)
    threads = spawn(connstr, "wc", 2)
    st = router(server.params["storage"])

    def body():
        server.task.create_collection(TASK_STATUS.WAIT, server.params, 1)
        server._prepare_map()
        server._poll_phase(server.task.map_jobs_ns(), "map")
        maps = {n: st.read(n) for n in st.list(r"map_results\.P\d+\.M")}
        server._prepare_reduce()
        server._poll_phase(server.task.red_jobs_ns(), "reduce")
        reds = {n: st.read(n) for n in server._result_partitions(st)}
        stats = server._compute_stats()
        assert server._final() is True
        return maps, reds, stats

    maps, reds, stats = _in_thread(body)
    _join(threads)
    return maps, reds, stats, dict(mod.RESULT)


def test_host_plane_equals_jax(corpus):
    storage = f"mem:{uuid.uuid4().hex}"  # one name, two registries
    connstr = f"mem://{uuid.uuid4().hex}"
    jmaps, jreds, jstats, jresult = _host_run(
        JServer, jspawn, _params(corpus, JMOD, storage=storage), connstr,
        jrouter, jwc)
    tmaps, treds, tstats, tresult = _host_run(
        TServer, tspawn, _params(corpus, TMOD, storage=storage), connstr,
        trouter, twc)
    assert tresult == jresult == naive.wordcount(corpus)
    assert len(tmaps) == 3 * 4  # 3 map jobs x 4 partitions
    assert tmaps == jmaps  # names and bytes
    assert treds == jreds
    assert set(tstats) == set(jstats)
    for phase in ("map", "reduce"):
        assert tstats[phase]["count"] == jstats[phase]["count"]
        assert tstats[phase]["failed"] == 0


def test_run_map_inline_equal(corpus):
    from mapreduce_tpu.coord.job import run_map_inline as jinline
    from mapreduce_tpu_torch.coord.job import (
        map_file_name, map_results_prefix, run_map_inline)

    emitted = {}
    for name, fn, mod in (("jax", jinline, JMOD), ("port", run_map_inline,
                                                    TMOD)):
        out = emitted[name] = []
        fn({"mapfn": mod, "init_args": {"files": corpus}}, 0, corpus[1],
           lambda k, v: out.append((k, v)))
    assert emitted["port"] == emitted["jax"]
    assert len(emitted["port"]) > 100
    assert (map_file_name(map_results_prefix("p"), 3, "a/b")
            == "p/map_results.P00003.Ma%2Fb")


def test_refusals(corpus):
    cpu = Partitions(1, "cpu")
    params = _params(corpus, TMOD, device=True)
    params["reducefn"] = __name__  # no ACI flags
    params["partitions"] = cpu
    with pytest.raises(ValueError, match="associative"):
        TServer(f"mem://{uuid.uuid4().hex}", "wc").configure(params)
    params = _params(corpus, TMOD, device=True)
    params["mapfn"] = __name__  # no device hooks
    params["partitions"] = cpu
    with pytest.raises(ValueError, match="device hooks"):
        TServer(f"mem://{uuid.uuid4().hex}", "wc").configure(params)
    params = _params(corpus, TMOD)
    del params["finalfn"]
    with pytest.raises(ValueError, match="finalfn"):
        TServer(f"mem://{uuid.uuid4().hex}", "wc").configure(params)
    # a re-claimer attaches (once refused as ROADMAP A.7); the library
    # default is none
    reclaim = object()
    assert TServer(f"mem://{uuid.uuid4().hex}", "wc",
                   reclaim=reclaim).reclaim is reclaim
    assert TServer(f"mem://{uuid.uuid4().hex}", "wc").reclaim is None
    # an unreachable http:// board raises once the retry policy is
    # spent; the loop never falls back to a local board
    from mapreduce_tpu_torch.utils.httpclient import RetryError, RetryPolicy

    server = TServer("http://127.0.0.1:1", "wc", retry=RetryPolicy(
        max_attempts=2, base_delay=0.01, deadline=1.0))
    server.configure(_params(corpus, TMOD))
    with pytest.raises(RetryError):
        _in_thread(server.loop)


def test_configure_without_partitions_needs_cuda(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    server = TServer(f"mem://{uuid.uuid4().hex}", "wc")
    with pytest.raises(RuntimeError, match="CUDA"):
        server.configure(_params(corpus, TMOD, device=True))
    # the CLI's default device is the card: no silent CPU fallback
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["wordcount", *corpus, "--device"])
    # the host plane needs no device
    TServer(f"mem://{uuid.uuid4().hex}", "wc").configure(
        _params(corpus, TMOD))


def _device_params(corpus, **kw):
    params = _params(corpus, TMOD, device=True, **kw)
    params["partitions"] = Partitions(8, "cpu")
    return params


def test_device_crash_resume_at_reduce(corpus):
    """A server that died between the engine run and the result write
    left the task doc at REDUCE: the fused phase has no map files in
    storage, so the resume re-runs the whole device iteration."""
    connstr = f"mem://{uuid.uuid4().hex}"
    params = _device_params(corpus)
    dead = TServer(connstr, "wc")
    dead.configure(params)
    dead.task.create_collection(TASK_STATUS.REDUCE, dead.params, 1)
    tspec.clear_caches()
    server = TServer(connstr, "wc")
    server.configure(params)
    stats = _in_thread(server.loop)
    assert dict(twc.RESULT) == naive.wordcount(corpus)
    assert stats["iteration"] == 1
    assert server.task.finished()


def test_device_phase_clears_stale_result_partitions(corpus):
    """A crashed host-plane run's result partition must not blend into
    the device output (_result_pairs merges every result.P* file)."""
    params = _device_params(corpus)
    st = trouter(params["storage"])
    from mapreduce_tpu_torch.utils.serialization import serialize_record
    b = st.builder()
    b.write_record_line(serialize_record("the", [99999]))
    connstr = f"mem://{uuid.uuid4().hex}"
    b.build(f"{TServer(connstr, 'wc').task.red_results_ns()}.P00001")
    server = TServer(connstr, "wc")
    server.configure(params)
    _in_thread(server.loop)
    assert dict(twc.RESULT) == naive.wordcount(corpus)
    # finalfn returned True: the result partitions are gone
    assert server._result_partitions(st) == []


def test_device_two_iteration_loop(corpus, monkeypatch):
    iterations = []
    orig = twc.finalfn

    def looping(pairs):
        orig(pairs)
        iterations.append(dict(twc.RESULT))
        return "loop" if len(iterations) < 2 else True

    monkeypatch.setattr(twc, "finalfn", looping)
    server = TServer(f"mem://{uuid.uuid4().hex}", "wc")
    server.configure(_device_params(corpus))
    stats = _in_thread(server.loop)
    oracle = naive.wordcount(corpus)
    assert iterations == [oracle, oracle]
    assert stats["iteration"] == 2
    assert server.task.finished()


def test_dir_board_shared_storage_both_planes(corpus, tmp_path):
    """The host plane with 4 worker threads and the device plane, each
    on a dir: board with shared: storage: equal RESULTs, stats with map,
    reduce and device sections, and device timings that round-trip
    through the board's JSON files."""
    host_params = _params(corpus, TMOD, storage=f"shared:{tmp_path / 'hs'}")
    connstr = f"dir://{tmp_path / 'hb'}"
    threads = tspawn(connstr, "wc", 4)
    server = TServer(connstr, "wc")
    server.configure(host_params)
    host_stats = _in_thread(server.loop)
    _join(threads)
    host = dict(twc.RESULT)
    assert host == naive.wordcount(corpus)
    assert host_stats["map"]["count"] == 3
    assert host_stats["reduce"]["count"] == 4

    tspec.clear_caches()
    params = _device_params(corpus)
    params["storage"] = f"shared:{tmp_path / 'ds'}"
    connstr = f"dir://{tmp_path / 'db'}"
    server = TServer(connstr, "wc")
    server.configure(params)
    stats = _in_thread(server.loop)
    assert dict(twc.RESULT) == host
    assert {"map", "reduce", "device"} <= set(stats)
    # read back from the board's files by a fresh handle
    again = TServer(connstr, "wc")
    (doc,) = again.cnn.connect().find(again.task.map_jobs_ns())
    assert doc["device_timings"] == json.loads(json.dumps(
        server._last_device_timings))
    assert again.task.update() and again.task.tbl["stats"]["device"]


def test_cli_stdout_equals_jax_cli(corpus):
    def run(main, argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            assert _in_thread(lambda: main(argv)) == 0
        return out.getvalue(), err.getvalue()

    jout, _ = run(jcli.main, ["wordcount", *corpus, "--workers", "2",
                              "--num-reducers", "4", "--no-autotune",
                              "--no-speculative-reclaim",
                              "--no-compile-cache"])
    tspec.clear_caches()
    tout, terr = run(tcli.main, ["wordcount", *corpus, "--device",
                                 "--torch-device", "cpu"])
    assert tout == jout
    counts = naive.wordcount(corpus)
    top = min(counts.items(), key=lambda wc: (-wc[1], wc[0]))
    assert tout.splitlines()[0] == f"{top[1]} {top[0]}"
    assert "device: 1 waves, 0 retries" in terr
    # the host plane of the port's CLI prints the same lines
    tspec.clear_caches()
    hout, herr = run(tcli.main, ["wordcount", *corpus, "--workers", "2",
                                 "--num-reducers", "3"])
    assert hout == jout
    assert "3 reduce jobs written" in herr
    # a server command line without its role modules is refused (exit 2)
    with contextlib.redirect_stderr(io.StringIO()), \
            pytest.raises(SystemExit) as exc:
        tcli.main(["server", "mem://x", "wc"])
    assert exc.value.code == 2
    assert sum(counts.values()) == sum(
        int(line.split(" ", 1)[0]) for line in tout.splitlines())
