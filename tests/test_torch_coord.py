"""The port's job-plane host modules against the JAX package's.

The record format, the k-way merge, the host hashes, the metrics
registry's read-backs, the line-record storage and the job board's
claim / heartbeat / release / reap sequence, each driven with the same
inputs through ``mapreduce_tpu`` and ``mapreduce_tpu_torch`` in one
process.  Every comparison is exact (bytes, docs and counts): no
tolerance.
"""

import json
import math

import numpy as np
import pytest

from mapreduce_tpu.coord import connection as jconn
from mapreduce_tpu.coord import docstore as jdoc
from mapreduce_tpu.coord import task as jtask
from mapreduce_tpu.obs import metrics as jmetrics
from mapreduce_tpu.storage.router import router as jrouter
from mapreduce_tpu.utils import hashing as jhash
from mapreduce_tpu.utils import iterators as jit
from mapreduce_tpu.utils import serialization as jser
from mapreduce_tpu.utils.constants import STATUS, TASK_STATUS

from mapreduce_tpu_torch.coord import connection as tconn
from mapreduce_tpu_torch.coord import docstore as tdoc
from mapreduce_tpu_torch.coord import task as ttask
from mapreduce_tpu_torch.core.heap import Heap
from mapreduce_tpu_torch.obs import metrics as tmetrics
from mapreduce_tpu_torch.obs.trace import Tracer
from mapreduce_tpu_torch.storage.router import router as trouter
from mapreduce_tpu_torch.utils import constants as tconst
from mapreduce_tpu_torch.utils import hashing as thash
from mapreduce_tpu_torch.utils import iterators as tit
from mapreduce_tpu_torch.utils import serialization as tser

#: adversarial records: framing characters, quotes, unicode, lone
#: surrogates, mixed key types, nested values, non-finite floats
RECORDS = [
    ("plain", [1, 2, 3]),
    ("new\nline", [1]),
    ('quote"s', ["a'b", 'c"d']),
    ("back\\slash", ["\\n"]),
    ("unicode é€😀", ["ß", "日本"]),
    ("\ud800lone", ["\udcff"]),
    ("", [""]),
    (None, [None, True, False]),
    (True, [0]),
    (7, [1.5, -2, 10 ** 30]),
    (-3.25, [float("inf"), -float("inf")]),
    (b"by\x00tes", [b"\xff", "s"]),
    (("tu", 1), [("a", (2, 3))]),
    ("dict", [{"k": [1, {"n": None}]}, {2: "x"}]),
    ("np", [np.int32(5), np.float64(0.5), np.str_("s")]),
]


@pytest.mark.parametrize("key,values", RECORDS,
                         ids=[repr(k)[:12] for k, _ in RECORDS])
def test_record_line_byte_equal(key, values):
    line = tser.serialize_record(key, values)
    assert line == jser.serialize_record(key, values)
    assert "\n" not in line
    got = tser.parse_record(line)
    assert repr(got) == repr(jser.parse_record(line))
    # round trip (normalised values; nan-free, so == holds)
    assert got[0] == jser.normalize(key)


def test_record_nan_and_refusals():
    line = tser.serialize_record("x", [float("nan")])
    assert line == jser.serialize_record("x", [float("nan")])
    assert math.isnan(tser.parse_record(line)[1][0])
    # repr path with nan inside a tuple key
    line = tser.serialize_record(("n", float("nan")), [1])
    assert line == jser.serialize_record(("n", float("nan")), [1])
    # parse never evaluates code
    for bad in ("__import__('os').system('true')", "(x, [1])",
                "[1, 2] + [3]"):
        with pytest.raises((ValueError, SyntaxError)):
            tser.parse_record(bad)
    with pytest.raises(TypeError):
        tser.check_serializable(object())
    with pytest.raises(TypeError):
        tser.sort_key([1])


def test_sort_key_total_order_equal():
    keys = [k for k, _ in RECORDS] + [0, 1, 2.5, "a", "b", b"a", ("a",),
                                      ("a", 0)]
    keys = [tser.normalize(k) for k in keys]
    port = sorted(keys, key=tser.sort_key)
    jax = sorted(keys, key=jser.sort_key)
    assert repr(port) == repr(jax)
    assert [tser.sort_key(k) for k in keys] == [jser.sort_key(k)
                                                for k in keys]


def _streams(seed):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(5):
        n = int(rng.integers(0, 40))
        keys = sorted({int(x) for x in rng.integers(0, 60, n)}
                      | {f"w{int(x)}" for x in rng.integers(0, 30, n)},
                      key=jser.sort_key)
        out.append([(k, [int(v) for v in rng.integers(0, 9, 2)])
                    for k in keys])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_iterator_equal(seed):
    streams = _streams(seed)
    port = list(tit.merge_iterator([(lambda s=s: iter(s))
                                    for s in streams]))
    jax = list(jit.merge_iterator([(lambda s=s: iter(s))
                                   for s in streams]))
    assert port == jax
    flat = [r for s in streams for r in s]
    # the heap orders the same keys as the merge
    h = Heap(lambda a, b: jser.sort_key(a) < jser.sort_key(b))
    for k, _ in flat:
        h.push(k)
    popped = [h.pop() for _ in range(len(h))]
    assert popped == sorted((k for k, _ in flat), key=jser.sort_key)


def test_hashing_equal():
    rng = np.random.default_rng(0)
    words = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
             for n in rng.integers(0, 24, 200)]
    for w in words + [b"", "é€".encode()]:
        assert thash.fnv1a32(w) == jhash.fnv1a32(w)
    W = 24
    mat = np.zeros((len(words), W), np.uint8)
    lens = np.array([len(w) for w in words], np.int32)
    for i, w in enumerate(words):
        mat[i, :len(w)] = np.frombuffer(w, np.uint8)
    assert np.array_equal(thash.fnv1a32_np(mat, lens),
                          jhash.fnv1a32_np(mat, lens))
    for key in ["the", "é", b"raw", 12, ("t", 1), None]:
        for p in (1, 4, 15):
            assert (thash.default_partitioner(key, p)
                    == jhash.default_partitioner(key, p))
            assert (thash.byte_sum_hash(key, p)
                    == jhash.byte_sum_hash(key, p))
    assert not hasattr(thash, "fnv1a32_jnp")


def test_constants_equal():
    from mapreduce_tpu.utils import constants as jc
    for name in ("DEFAULT_SLEEP", "MAX_JOB_RETRIES", "MAX_TASKFN_VALUE_SIZE",
                 "MAX_PENDING_INSERTS", "DEFAULT_JOB_LEASE",
                 "DEFAULT_HEARTBEAT", "DEFAULT_CLAIM_BATCH",
                 "MAX_MAP_RESULT", "MAP_RESULT_TEMPLATE",
                 "MAX_WORKER_RETRIES", "MAX_IDLE_COUNT"):
        assert getattr(tconst, name) == getattr(jc, name), name
    assert ({s.name: int(s) for s in tconst.STATUS}
            == {s.name: int(s) for s in STATUS})
    assert ([s.value for s in tconst.TASK_STATUS]
            == [s.value for s in TASK_STATUS])


def _drive_registry(mod):
    reg = mod.Registry()
    c = reg.counter("mr_c_total", "a counter")
    g = reg.gauge("mr_g", 'help with "quotes"\nand newline')
    h = reg.histogram("mr_h_seconds", "h", buckets=(0.01, 0.1, 1.0))
    c.inc(task="wc", phase="map")
    c.inc(2.5, task="wc", phase="reduce")
    g.set(3, db='we"ird\\', field="compute_s")
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v, worker="w0")
    return reg


def _registry_reads(reg):
    """What the server and the CLI read back from a registry."""
    return (reg.sum("mr_c_total", task="wc"),
            reg.value("mr_c_total", task="wc", phase="reduce"),
            reg.value("mr_g", db='we"ird\\', field="compute_s"),
            reg.sum("mr_g"),
            reg.value("mr_h_seconds", worker="w0"),
            reg.sum("mr_h_seconds"),
            reg.value("missing"), reg.sum("missing", task="wc"))


def test_metrics_registry_reads_equal():
    port, jax = _drive_registry(tmetrics), _drive_registry(jmetrics)
    assert _registry_reads(port) == _registry_reads(jax)
    assert _registry_reads(port)[:2] == (3.5, 2.5)
    assert port.value("mr_h_seconds", worker="w0") == 4
    # the histograms' buckets and per-series state are the JAX ones
    th = port.histogram("mr_h_seconds")
    jh = jax.histogram("mr_h_seconds")
    assert th.buckets == jh.buckets and th._series == jh._series
    with pytest.raises(ValueError):
        port.counter("bad name")
    with pytest.raises(ValueError):
        port.counter("mr_c_total").inc(-1)
    with pytest.raises(TypeError):
        port.gauge("mr_c_total")


def test_auth_refused_until_networked_board():
    """``auth`` is taken in every shape ``Connection.auth_token`` reads,
    as the JAX package takes it, by the connection, the server and the
    worker alike; the local boards have no wire to guard."""
    from mapreduce_tpu_torch.server import Server
    from mapreduce_tpu_torch.worker import Worker
    for auth in ("t", {"user": "u", "password": "t"}, {"token": "t"}):
        for pkg in (tconn, jconn):
            assert pkg.Connection("mem://a", "db", auth).auth_token() == "t"
    assert Server("mem://a", "db", auth={"password": "t"}
                  ).cnn.auth_token() == "t"
    assert Worker("mem://a", "db", auth="t").cnn.auth_token() == "t"
    for pkg in (tconn, jconn):
        cnn = pkg.Connection("http://tok@h1:1,h2:2", "db")
        assert cnn.auth_token() == "tok"
        assert cnn.board_hostports() == ["h1:1", "h2:2"]
    assert tconn.Connection("mem://a", "db").auth_token() is None


def test_tracer_nests_claim_run_write():
    tr = Tracer(max_events=4)
    with tr.span("job", start=0.0, job="j") as root:
        tr.record("claim", 0.0, 0.001, job="j")
        with tr.span("run", job="j"):
            pass
        with tr.span("write", job="j"):
            pass
        root.args["outcome"] = "written"
    ev = {e["name"]: e for e in tr.events()}
    assert set(ev) == {"job", "claim", "run", "write"}
    root_id = ev["job"]["args"]["span_id"]
    for name in ("claim", "run", "write"):
        assert ev[name]["args"]["parent_id"] == root_id
    assert ev["job"]["args"]["outcome"] == "written"
    with tr.span("extra"):
        pass  # the ring drops the oldest
    events = tr.events()
    assert [e["name"] for e in events] == ["run", "write", "job", "extra"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    json.dumps(events)  # Chrome trace events: JSON as they are


@pytest.mark.parametrize("scheme", ["mem", "shared"])
def test_line_records_cross_packages(scheme, tmp_path):
    dsl = (f"mem:lines-{scheme}" if scheme == "mem"
           else f"shared:{tmp_path}")
    port, jax = trouter(dsl), jrouter(dsl)
    lines = [tser.serialize_record(k, v) for k, v in RECORDS]
    before = tmetrics.REGISTRY.value("mrtpu_storage_records_total",
                                     scheme=port.scheme,
                                     direction="write")
    for st in (port, jax):
        b = st.builder()
        for ln in lines:
            b.write_record_line(ln)
        b.build("res/map_results.P00001.M0")
    assert tmetrics.REGISTRY.value(
        "mrtpu_storage_records_total", scheme=port.scheme,
        direction="write") == before + len(lines)
    assert list(port.open_lines("res/map_results.P00001.M0")) == lines
    if scheme == "shared":  # one directory: each reads the other's file
        assert (list(jax.open_lines("res/map_results.P00001.M0"))
                == lines)
        assert port.read_bytes("res/map_results.P00001.M0") == \
            jax.read_bytes("res/map_results.P00001.M0")
    else:
        assert port.read("res/map_results.P00001.M0") == \
            jax.read("res/map_results.P00001.M0")
    assert port.exists("res/map_results.P00001.M0")
    assert port.list(r"\.P\d+\.M") == ["res/map_results.P00001.M0"]
    port.write_bytes("blob", b"\x00\x01")
    assert port.read_bytes("blob") == b"\x00\x01"
    port.clear()
    assert port.list() == [] and not port.exists("blob")


def test_http_board_and_storage_refused():
    """An unreachable ``http://`` board or ``http:`` store raises once the
    retry policy is spent; nothing falls back to a local board or
    store."""
    from mapreduce_tpu_torch.coord.docserver import HttpDocStore
    from mapreduce_tpu_torch.storage.httpstore import HttpStorage
    from mapreduce_tpu_torch.utils.httpclient import RetryError, RetryPolicy

    policy = RetryPolicy(max_attempts=2, base_delay=0.01, deadline=1.0)
    board = tdoc.connect("http://127.0.0.1:1", retry=policy)
    assert isinstance(board, HttpDocStore)
    with pytest.raises(RetryError):
        board.find("c")
    store = trouter("http:127.0.0.1:1", retry=policy)
    assert isinstance(store, HttpStorage)
    with pytest.raises(RetryError):
        store.read("blob")
    with pytest.raises(ValueError):
        tdoc.connect("nonsense")


def _board_sequence(pkg_doc, pkg_conn, pkg_task, connstr, clock):
    """One claim / heartbeat / release / reap / re-claim sequence whose
    outcome does not depend on the store's iteration order; returns
    every step's answer and the final docs."""
    cnn = pkg_conn.Connection(connstr, "db")
    task = pkg_task.Task(cnn, job_lease=10.0)
    params = {r: "m" for r in ("taskfn", "mapfn", "partitionfn",
                               "reducefn", "finalfn")}
    params.update(storage="mem:x", path="x")
    task.create_collection(TASK_STATUS.MAP, params, 1)
    coll = task.map_jobs_ns()
    task.insert_jobs(coll, [pkg_task.make_job(i, f"v{i}")
                            for i in range(4)])
    steps = []
    got, st = task.take_next_jobs("w1", "t1", 8)
    got = sorted(got, key=lambda d: d["_id"])
    steps.append(("claim", st.value, got))
    steps.append(("beat", task.heartbeat_many(coll, got)))
    steps.append(("release", task.release_jobs(coll, got[2:])))
    clock[0] += 11.0  # past the lease of jobs 0 and 1
    steps.append(("reap", task.reap_expired(coll)))
    steps.append(("beat lost", task.heartbeat_many(coll, got[:2])))
    got2, st = task.take_next_jobs("w2", "t2", 8)
    steps.append(("reclaim", st.value,
                  sorted(got2, key=lambda d: d["_id"])))
    clock[0] += 1.0
    steps.append(("beat2", task.heartbeat_many(
        coll, sorted(got2, key=lambda d: d["_id"]))))
    store = cnn.connect()
    store.update(coll, {"status": int(STATUS.RUNNING),
                        "repetitions": {"$gte": 1}},
                 {"$set": {"status": int(STATUS.WRITTEN)}}, multi=True)
    steps.append(("counts", store.count(coll),
                  store.count(coll, {"status": {"$in": [4, 5]}}),
                  store.count(coll, {"status": {"$nin": [4]}})))
    docs = sorted(store.find(coll), key=lambda d: d["_id"])
    task_doc = store.find_one(task.task_ns(), {"_id": "unique"})
    return steps, docs, task_doc


@pytest.mark.parametrize("kind", ["mem", "dir"])
def test_board_sequence_equal(kind, tmp_path, monkeypatch):
    clock = [1_000_000.0]
    for mod in (jdoc, tdoc):
        monkeypatch.setattr(mod, "now", lambda: clock[0])
    out = {}
    for name, mods in (("jax", (jdoc, jconn, jtask)),
                       ("port", (tdoc, tconn, ttask))):
        clock[0] = 1_000_000.0
        connstr = (f"mem://board-{kind}-{name}" if kind == "mem"
                   else f"dir://{tmp_path / name}")
        out[name] = _board_sequence(*mods, connstr, clock)
    steps, docs, task_doc = out["port"]
    assert out["port"] == out["jax"]
    assert steps[1] == ("beat", [True] * 4)
    assert steps[2] == ("release", 2)
    assert steps[3] == ("reap", 2)
    assert steps[4] == ("beat lost", [False, False])
    assert [d["worker"] for d in steps[5][2]] == ["w2"] * 4
    assert [d["repetitions"] for d in docs] == [1, 1, 0, 0]
    assert task_doc["status"] == "MAP"


def test_dir_board_claim_is_atomic_across_threads(tmp_path):
    """Eight threads claim from one dir: board; every job is claimed
    exactly once (the flock-guarded find_and_modify_many)."""
    import threading

    connstr = f"dir://{tmp_path}"
    cnn = tconn.Connection(connstr, "db")
    task = ttask.Task(cnn)
    params = {r: "m" for r in ("taskfn", "mapfn", "partitionfn",
                               "reducefn", "finalfn")}
    params.update(storage="mem:x", path="x")
    task.create_collection(TASK_STATUS.MAP, params, 1)
    task.insert_jobs(task.map_jobs_ns(),
                     [ttask.make_job(i, i) for i in range(40)])
    claimed = []
    lock = threading.Lock()

    def claim(i):
        t = ttask.Task(tconn.Connection(connstr, "db"))
        while True:
            got, _ = t.take_next_jobs(f"w{i}", f"t{i}", 3)
            if not got:
                return
            with lock:
                claimed.extend(d["_id"] for d in got)

    threads = [threading.Thread(target=claim, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(claimed, key=int) == [str(i) for i in range(40)]
