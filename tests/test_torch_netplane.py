"""The port's networked job plane end to end, held against the JAX
package's.

* Word count through the port's ``Server`` and worker threads over a
  port ``http://`` board and ``http:`` blob storage: ``RESULT`` equals
  the JAX package's run on its own docserver and blob server, and the
  result partitions are byte-equal.  The device plane
  (``Partitions(8, "cpu")``) over the same planes writes a
  ``result.P00000`` byte-equal to the same run on a ``dir:`` board.
* The reference's topology as OS processes: ``cli docserver`` and ``cli
  blobserver`` on port 0 under ``$MAPREDUCE_TPU_AUTH``, two ``cli
  worker`` processes and a ``cli server`` with the split-module example.
* Telemetry: the Prometheus text and the push payload cross packages
  both ways; ``Tracer.export`` has the JAX export's keys; the
  docserver's ``/metrics`` and ``/clusterz`` show each worker's jobs.
* ``cli drop`` and the refusal of the JAX flags the port lacks.

Every server binds port 0, every ``Server.loop`` runs in a thread
joined under a timeout, and every process is waited on with a timeout
and killed after it.
"""

import collections
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import uuid

import pytest

import mapreduce_tpu.examples.wordcount as jwc
from mapreduce_tpu import spec as jspec
from mapreduce_tpu.coord.docserver import DocServer as JDocServer
from mapreduce_tpu.obs import collector as jcollector
from mapreduce_tpu.obs import metrics as jmetrics
from mapreduce_tpu.obs.trace import Tracer as JTracer
from mapreduce_tpu.server import Server as JServer
from mapreduce_tpu.storage.httpstore import BlobServer as JBlobServer
from mapreduce_tpu.storage.router import router as jrouter
from mapreduce_tpu.worker import spawn_worker_threads as jspawn

import mapreduce_tpu_torch.examples.wordcount as twc
from mapreduce_tpu_torch import cli as tcli
from mapreduce_tpu_torch import spec as tspec
from mapreduce_tpu_torch.coord.docserver import DocServer, HttpDocStore
from mapreduce_tpu_torch.examples import naive
from mapreduce_tpu_torch.obs import collector as tcollector
from mapreduce_tpu_torch.obs import metrics as tmetrics
from mapreduce_tpu_torch.obs.trace import Tracer
from mapreduce_tpu_torch.parallel.mesh import Partitions
from mapreduce_tpu_torch.server import Server
from mapreduce_tpu_torch.storage.httpstore import BlobServer, HttpStorage
from mapreduce_tpu_torch.storage.router import router as trouter
from mapreduce_tpu_torch.utils.serialization import parse_record
from mapreduce_tpu_torch.worker import spawn_worker_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a loop, a worker thread or a process may take here
TIMEOUT = 90
TMOD = "mapreduce_tpu_torch.examples.wordcount"
JMOD = "mapreduce_tpu.examples.wordcount"
SPLIT = "mapreduce_tpu_torch.examples.wordcount_split"


@pytest.fixture(autouse=True)
def fresh_modules(monkeypatch):
    monkeypatch.delenv("MAPREDUCE_TPU_AUTH", raising=False)

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


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("netcorpus")
    files = []
    for i in range(6):
        p = root / f"f{i}.txt"
        words = [f"w{(i * 7 + j * j) % 23}" for j in range(60)]
        p.write_text(" ".join(words[:30]) + "\n" + "\t".join(words[30:])
                     + "\nüber naïve 日本 a,b\n", encoding="utf-8")
        files.append(str(p))
    return files


def _in_thread(fn, timeout=TIMEOUT):
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


def _params(files, module, storage, **init):
    params = {r: module for r in ("taskfn", "mapfn", "partitionfn",
                                  "reducefn", "finalfn")}
    params["combinerfn"] = module
    params["storage"] = storage
    params["init_args"] = {"files": files, "num_reducers": 4, **init}
    return params


def _capture_results(mod, open_storage, box):
    """Wrap *mod*'s finalfn so the result partitions' bytes are read from
    the task's storage before the server deletes them."""
    real = mod.finalfn

    def finalfn(pairs):
        st = open_storage()
        box.update({n: st.read_bytes(n)
                    for n in st.list(r"\.result\.P\d+$")})
        return real(pairs)

    return real, finalfn


def _run(make_server, spawn, connstr, db, params, n_workers=2):
    threads = spawn(connstr, db, n_workers) if n_workers else []
    server = make_server(connstr, db)
    server.configure(params)
    stats = _in_thread(server.loop)
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive(), f"worker {t.name} did not exit"
    return server, stats


def test_wordcount_over_http_equals_jax(corpus, tmp_path):
    """Port server + worker threads over a port docserver and blob
    server against the JAX package's run on its own: RESULT equal,
    result partitions byte-equal, and /metrics shows each worker's jobs
    under that worker's label."""
    out = {}
    for pkg in ("jax", "port"):
        board = (JDocServer if pkg == "jax" else DocServer)()
        blobs = (JBlobServer if pkg == "jax" else BlobServer)(
            str(tmp_path / pkg)).start_background()
        board.start_background()
        dsl = f"http:{blobs.address}"
        connstr = f"http://{board.host}:{board.port}"
        mod, rt = (jwc, jrouter) if pkg == "jax" else (twc, trouter)
        box = {}
        real, mod.finalfn = _capture_results(mod, lambda: rt(dsl), box)
        try:
            server, stats = _run(
                JServer if pkg == "jax" else Server,
                (lambda c, d, n: jspawn(c, d, n, conf={"claim_batch": 1}))
                if pkg == "jax" else
                (lambda c, d, n: spawn_worker_threads(
                    c, d, n, conf={"claim_batch": 1})),
                connstr, "netwc",
                _params(corpus, JMOD if pkg == "jax" else TMOD, dsl))
        finally:
            mod.finalfn = real
        docs = server.cnn.connect().find(server.task.map_jobs_ns())
        docs += server.cnn.connect().find(server.task.red_jobs_ns())
        out[pkg] = {"result": dict(mod.RESULT), "parts": box,
                    "stats": stats, "docs": docs}
        if pkg == "port":
            metrics = HttpDocStore(f"{board.host}:{board.port}"
                                   ).metrics_text()
        board.shutdown()
        blobs.shutdown()
    assert out["port"]["result"] == out["jax"]["result"] == \
        naive.wordcount(corpus)
    assert out["port"]["parts"] == out["jax"]["parts"]
    assert len(out["port"]["parts"]) == 4
    assert out["port"]["stats"]["map"]["count"] == 6
    # each worker's written jobs, as the board records them, under its
    # own label in the docserver's exposition
    ran = collections.Counter((d["worker"], d["_id"].startswith("P"))
                              for d in out["port"]["docs"])
    parsed = tmetrics.parse_prometheus(metrics)
    for (worker, reduce_job), n in ran.items():
        key = ("mrtpu_worker_jobs_total", (
            ("outcome", "written"),
            ("phase", "REDUCE" if reduce_job else "MAP"),
            ("task", "netwc"), ("worker", worker)))
        assert parsed.get(key) == n, (key, n)


def test_device_phase_over_http_equals_dir(corpus, tmp_path):
    """configure(device=True) over Partitions(8, "cpu"): the result the
    device phase PUTs to http: storage is byte-equal to the same run's
    result on a dir: board with shared: storage."""
    parts = {}
    for plane in ("dir", "http"):
        tspec.clear_caches()
        twc._conf.clear()
        twc._conf.update({"files": [], "num_reducers": 15})
        if plane == "http":
            board = DocServer().start_background()
            blobs = BlobServer(str(tmp_path / "blobs")).start_background()
            connstr = board.connstr
            dsl = f"http:{blobs.address}"
        else:
            connstr = f"dir://{tmp_path / 'board'}"
            dsl = f"shared:{tmp_path / 'shared'}"
        box = {}
        real, twc.finalfn = _capture_results(twc, lambda: trouter(dsl), box)
        try:
            params = _params(corpus, TMOD, dsl, device_chunk_len=2048,
                             device_local_capacity=1 << 10,
                             device_exchange_capacity=1 << 8,
                             device_out_capacity=1 << 10,
                             device_sort_impl="radix")
            params["device"] = True
            params["partitions"] = Partitions(8, "cpu")
            server, stats = _run(Server, None, connstr, "devwc", params,
                                 n_workers=0)
        finally:
            twc.finalfn = real
            if plane == "http":
                board.shutdown()
                blobs.shutdown()
        assert dict(twc.RESULT) == naive.wordcount(corpus)
        assert {"prepare_s", "engine_s", "write_s"} <= set(
            stats["device"])
        parts[plane] = box
    assert list(parts["http"]) == ["devwc.result.P00000"]
    assert parts["http"] == parts["dir"]


def _cli(*args, env, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "mapreduce_tpu_torch.cli", *args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw)


def _reap(procs):
    """Wait for every process under the timeout, kill what is left."""
    for p in procs:
        try:
            p.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


def test_worker_processes_and_cli_server(tmp_path):
    """The README's topology in OS processes: `cli docserver` and `cli
    blobserver` on port 0 under $MAPREDUCE_TPU_AUTH, two `cli worker`
    processes of 2 threads each and a `cli server` with the split-module
    example.  The result read back from the blob server equals Counter;
    a tokenless request gets 401; /clusterz carries the workers' jobs
    and the server process's spans."""
    token = uuid.uuid4().hex
    env = dict(os.environ, MAPREDUCE_TPU_AUTH=token,
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    files, want = [], collections.Counter()
    for i in range(4):
        text = f"alpha beta p{i} gamma alpha delta\n" * 20
        p = tmp_path / f"f{i}.txt"
        p.write_text(text)
        files.append(str(p))
        want.update(text.split())
    servers = [_cli("docserver", "--host", "127.0.0.1", "--port", "0",
                    env=env),
               _cli("blobserver", str(tmp_path / "blobs"), "--host",
                    "127.0.0.1", "--port", "0", env=env)]
    procs = list(servers)
    try:
        board_line = servers[0].stdout.readline()
        blob_line = servers[1].stdout.readline()
        board = re.search(r"job board at http://([\d.]+:\d+)",
                          board_line).group(1)
        blob = re.search(r"at http:([\d.]+:\d+)", blob_line).group(1)
        import http.client
        host, port = board.split(":")
        cnn = http.client.HTTPConnection(host, int(port), timeout=10)
        cnn.request("GET", "/metrics")
        r = cnn.getresponse()
        r.read()
        assert r.status == 401  # tokenless
        cnn.close()
        connstr, dsl = f"http://{board}", f"http:{blob}"
        workers = [_cli("worker", connstr, "splitwc", "--workers", "2",
                        "--name", f"p{i}", "--max-iter", "400",
                        "--max-sleep", "0.2", "--claim-batch", "1",
                        "--telemetry-interval", "0.2", env=env)
                   for i in range(2)]
        procs += workers
        server = _cli("server", connstr, "splitwc", f"{SPLIT}.taskfn",
                      f"{SPLIT}.mapfn", f"{SPLIT}.partitionfn",
                      f"{SPLIT}.reducefn", f"{SPLIT}.finalfn",
                      f"{SPLIT}.reducefn", dsl, "--init-args",
                      json.dumps({"files": files, "num_reducers": 3,
                                  "keep_results": True}),
                      "--telemetry-interval", "0.2", env=env)
        procs.append(server)
        out, err = server.communicate(timeout=TIMEOUT)
        assert server.returncode == 0, err[-2000:]
        stats = json.loads(out.strip().splitlines()[-1])
        assert stats["map"]["count"] == 4 and stats["reduce"]["count"] == 3
        for w in workers:
            w.wait(timeout=TIMEOUT)
            assert w.returncode == 0, w.stderr.read()[-2000:]
        st = HttpStorage(blob, auth_token=token)
        got = {}
        for name in st.list(r"\.result\.P\d+$"):
            for line in st.open_lines(name):
                key, values = parse_record(line)
                got[key] = values[0]
        assert got == dict(want)
        client = HttpDocStore(board, auth_token=token)
        docs = client.find("splitwc.map_jobs") + client.find(
            "splitwc.red_jobs")
        cz = client.clusterz()
        roles = {p["role"] for p in cz["mrtpuCluster"]["procs"].values()}
        assert "server:splitwc" in roles
        pushed = collections.Counter()
        for name, labels, value in cz["mrtpuCluster"]["metrics"]:
            if (name == "mrtpu_worker_jobs_total"
                    and labels.get("task") == "splitwc"):
                pushed[labels["worker"]] += value
        ran = collections.Counter(d["worker"] for d in docs)
        assert pushed == ran
        # every job's span reached the merged timeline from its process
        spans = collections.Counter(
            e["args"]["worker"] for e in cz["traceEvents"]
            if e.get("name") == "job")
        assert spans == ran
        assert all(re.fullmatch(r"p[01]-[01]", w) for w in ran)
        client.close()
        st.close()
    finally:
        for s in servers:
            s.terminate()
        _reap(procs)


def _twin_registries():
    """The same instruments in a port and a JAX registry, label values
    that need escaping included."""
    regs = []
    for mod in (tmetrics, jmetrics):
        reg = mod.Registry()
        reg.counter("mrtpu_worker_jobs_total", 'jobs "done"\nby worker'
                    ).inc(3, worker="w\\0", task='t"1', outcome="written")
        reg.gauge("mrtpu_board_jobs", "depth").replace(
            [({"db": "wc", "phase": "map", "status": "WAITING"}, 2.5)])
        h = reg.histogram("mrtpu_worker_job_seconds", "job s")
        for v in (0.0004, 0.3, 7.0, 100.0):
            h.observe(v, worker="w0")
        regs.append(reg)
    return regs


def test_prometheus_text_crosses_packages():
    """The port's render is the JAX render byte for byte, and each
    package's parser reads the other's text to the same map."""
    treg, jreg = _twin_registries()
    ttext, jtext = treg.render(), jreg.render()
    assert ttext == jtext
    assert jmetrics.parse_prometheus(ttext) == tmetrics.parse_prometheus(
        ttext)
    assert tmetrics.parse_prometheus(jtext) == jmetrics.parse_prometheus(
        jtext)
    with pytest.raises(ValueError):
        tmetrics.parse_prometheus("mrtpu_x{a=1} 2")


def test_trace_export_matches_jax_keys(tmp_path):
    """Tracer.export loads with the keys of the JAX export, top level and
    per event."""
    docs = []
    for cls in (Tracer, JTracer):
        tr = cls()
        with tr.span("job", job="j1"):
            tr.record("claim", 0.0, 0.001, job="j1")
        sp = tr.begin("wave", w=0)
        tr.end(sp)
        path = tmp_path / f"{cls.__module__}.json"
        tr.export(str(path))
        docs.append(json.loads(path.read_text()))
    tdoc, jdoc = docs
    assert set(tdoc) == set(jdoc)
    assert tdoc["otherData"] == jdoc["otherData"]
    assert [e["name"] for e in tdoc["traceEvents"]] == [
        e["name"] for e in jdoc["traceEvents"]]
    for te, je in zip(tdoc["traceEvents"], jdoc["traceEvents"]):
        assert set(te) == set(je) and set(te["args"]) == set(je["args"])


@pytest.mark.parametrize("pusher_pkg", ["port", "jax"])
def test_pusher_crosses_packages_and_stops(pusher_pkg):
    """A pusher of either package feeds the other's collector; the last
    release flushes, stops the pusher's thread and closes its socket."""
    board = (JDocServer() if pusher_pkg == "port"
             else DocServer()).start_background()
    mod = tcollector if pusher_pkg == "port" else jcollector
    try:
        lease = mod.acquire_pusher(f"{board.host}:{board.port}", None,
                                   role="worker:probe", interval=30.0)
        again = mod.acquire_pusher(f"{board.host}:{board.port}", None,
                                   role="worker:other", interval=30.0)
        assert again is lease and lease.refs == 2
        with mod.TRACER.span("probe_span", probe=pusher_pkg):
            pass
        thread = lease.pusher._thread
        mod.release_pusher(again)
        assert thread.is_alive()
        mod.release_pusher(lease)  # the last: final flush, then stop
        assert not thread.is_alive() and lease.pusher._thread is None
        doc = board.collector.cluster_doc()
        procs = doc["mrtpuCluster"]["procs"]
        assert mod.PROC_ID in procs
        # the collector's per-process health and snapshots
        summary = board.collector.summary()
        assert summary["procs"][mod.PROC_ID]["pushes"] >= 1
        assert any(("mrtpu_trace_spans_total", (("name", "probe_span"),))
                   in snap for snap in board.collector.metric_snapshots())
        assert procs[mod.PROC_ID]["role"] == "worker:probe"
        assert any(e.get("name") == "probe_span"
                   and e["args"].get("probe") == pusher_pkg
                   for e in doc["traceEvents"])
    finally:
        board.shutdown()


def test_cli_drop_clears_collections_and_storage(tmp_path):
    """`cli drop CONNSTR DB --storage DSL` drops the task's collections on
    a docserver (and nothing of another db) and clears the storage."""
    board = DocServer().start_background()
    blobs = BlobServer(str(tmp_path / "blobs")).start_background()
    try:
        client = HttpDocStore(f"{board.host}:{board.port}")
        for coll in ("wc.task", "wc.map_jobs", "wc.errors", "other.task"):
            client.insert(coll, {"_id": "x"})
        st = HttpStorage(blobs.address)
        st.write("wc.result.P00000", "('a', [1])\n")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tcli.main(["drop", board.connstr, "wc", "--storage",
                            f"http:{blobs.address}"])
        assert rc == 0
        assert "dropped 3 collections" in out.getvalue()
        assert "cleared 1 blobs" in out.getvalue()
        assert client.collections() == ["other.task"]
        assert st.list() == []
        client.close()
        st.close()
    finally:
        board.shutdown()
        blobs.shutdown()


@pytest.mark.parametrize("argv,item", [
    (["docserver", "--ha-dir", "/x"], "A.4b-2"),
    (["docserver", "--max-inflight", "2"], "A.4c"),
    (["docserver", "--history-dir", "/x"], "A.8"),
    (["docserver", "--slo", "q:p99:1"], "A.8"),
    (["server", "--autotune"], "A.7"),
    (["worker", "mem://x", "db", "--compile-cache"], "A.8"),
    (["wordcount", "f", "--speculative-reclaim"], "A.7"),
    (["train", "mem://x", "db", "--no-compile-cache"], "A.8"),
])
def test_cli_refuses_unported_flags(argv, item):
    """A JAX flag the port lacks is refused by name (exit 2), naming the
    ROADMAP item; it is never accepted and then ignored."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as exc:
        tcli.main(argv)
    assert exc.value.code == 2
    assert "not ported" in err.getvalue() and item in err.getvalue()
