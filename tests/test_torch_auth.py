"""Shared-secret auth for the port's two networked planes (docserver +
blobserver), mirroring ``tests/test_auth.py`` case for case.

A server constructed with a token rejects tokenless clients; the token
reaches clients explicitly, through the ``TOKEN@HOST:PORT`` connstr form,
or through ``$MAPREDUCE_TPU_AUTH``; a job's user functions inherit it
ambiently, for the job's own endpoints only.  The tokens and headers are
the JAX package's, so a JAX client holding the token is let in and one
without it is refused.  This module doubles as the user module of the
ambient-token case (its roles read their input blobs through the port's
storage router).
"""

from typing import Any, Dict, List

import pytest

from mapreduce_tpu_torch import spec
from mapreduce_tpu_torch.coord.connection import Connection
from mapreduce_tpu_torch.coord.docserver import DocServer, HttpDocStore
from mapreduce_tpu_torch.storage.httpstore import BlobServer, HttpStorage

TOKEN = "sekrit-r5"
#: seconds a loop may take, and a worker thread to exit after it
JOIN_TIMEOUT = 30

# -- the user module of test_user_module_storage_inherits_worker_auth ----

_conf: Dict[str, Any] = {"blobs": [], "num_reducers": 3, "storage": None}
RESULT: Dict[str, int] = {}

associative_reducer = True
commutative_reducer = True
idempotent_reducer = True


def init(args: Any) -> None:
    if args:
        _conf.update(args)


def taskfn(emit) -> None:
    for i, name in enumerate(_conf["blobs"]):
        emit(i, name)


def mapfn(key: Any, blobname: str, emit) -> None:
    from mapreduce_tpu_torch import storage

    st = storage.router(_conf["storage"])  # no token: the ambient one
    for line in st.open_lines(blobname):
        for word in line.split():
            emit(word, 1)


def partitionfn(key: str) -> int:
    from mapreduce_tpu_torch.utils.hashing import fnv1a32

    return fnv1a32(key.encode("utf-8")) % _conf["num_reducers"]


def reducefn(key: str, values: List[int]) -> int:
    return sum(values)


def finalfn(pairs) -> bool:
    RESULT.clear()
    for key, values in pairs:
        RESULT[key] = values[0]
    return True


@pytest.fixture(autouse=True)
def _no_env_token(monkeypatch):
    """Isolate from a machine-wide $MAPREDUCE_TPU_AUTH — the tokenless-
    rejection tests must see genuinely tokenless clients."""
    monkeypatch.delenv("MAPREDUCE_TPU_AUTH", raising=False)
    spec.clear_caches()
    yield
    spec.clear_caches()


@pytest.fixture
def doc_srv():
    s = DocServer(auth_token=TOKEN).start_background()
    yield s
    s.shutdown()


@pytest.fixture
def blob_srv(tmp_path):
    s = BlobServer(str(tmp_path / "blobs"), port=0,
                   auth_token=TOKEN).start_background()
    yield s
    s.shutdown()


def test_docserver_rejects_tokenless_and_wrong_token(doc_srv):
    from mapreduce_tpu.coord.docserver import HttpDocStore as JHttpDocStore

    addr = f"{doc_srv.host}:{doc_srv.port}"
    with pytest.raises(PermissionError):
        HttpDocStore(addr).ping()
    with pytest.raises(PermissionError):
        HttpDocStore(addr, auth_token="wrong").insert("c", {"x": 1})
    with pytest.raises(PermissionError):  # the JAX client, refused alike
        JHttpDocStore(addr).insert("c", {"x": 1})
    assert doc_srv.store.count("c") == 0  # nothing slipped through
    jst = JHttpDocStore(addr, auth_token=TOKEN)
    assert jst.ping()
    jst.close()


def test_docserver_accepts_explicit_and_connstr_token(doc_srv):
    addr = f"{doc_srv.host}:{doc_srv.port}"
    st = HttpDocStore(addr, auth_token=TOKEN)
    assert st.ping()
    st.insert("c", {"_id": "a"})
    assert st.count("c") == 1
    st.close()
    st2 = HttpDocStore(f"{TOKEN}@{addr}")
    assert st2.find("c") == [{"_id": "a"}]
    st2.close()


def test_docserver_env_token(doc_srv, monkeypatch):
    monkeypatch.setenv("MAPREDUCE_TPU_AUTH", TOKEN)
    st = HttpDocStore(f"{doc_srv.host}:{doc_srv.port}")
    assert st.ping()
    st.close()


def test_connection_auth_shapes(doc_srv):
    """Connection honors auth as a plain token or a reference-shaped
    {user, password} table (cnn.lua:106-113)."""
    connstr = f"http://{doc_srv.host}:{doc_srv.port}"
    for auth in (TOKEN, {"user": "u", "password": TOKEN},
                 {"token": TOKEN}):
        cnn = Connection(connstr, "db", auth)
        assert cnn.connect().ping()
        cnn.connect().close()
    with pytest.raises(PermissionError):
        Connection(connstr, "db").connect().ping()
    # a connstr-embedded token is visible to the STORAGE plane too
    cnn = Connection(f"http://{TOKEN}@{doc_srv.host}:{doc_srv.port}", "db")
    assert cnn.auth_token() == TOKEN
    assert cnn.connect().ping()
    cnn.connect().close()


def test_blobserver_rejects_tokenless(blob_srv):
    st = HttpStorage(blob_srv.address)
    with pytest.raises(PermissionError):
        st.write("k", "v")
    with pytest.raises(PermissionError):
        st.read("k")
    with pytest.raises(PermissionError):
        st.exists("k")
    with pytest.raises(PermissionError):
        st.list()
    with pytest.raises(PermissionError):
        st.remove("k")
    with pytest.raises(PermissionError):
        next(st.open_lines("k"))
    st.close()


def test_blobserver_token_full_surface(blob_srv):
    st = HttpStorage(blob_srv.address, auth_token=TOKEN)
    st.write("k", "line1\nline2\n")
    assert st.read("k") == "line1\nline2\n"
    assert st.exists("k")
    assert list(st.open_lines("k")) == ["line1", "line2"]  # Range path
    assert st.list() == ["k"]
    st.remove("k")
    assert not st.exists("k")
    st2 = HttpStorage(f"{TOKEN}@{blob_srv.address}")
    st2.write("k2", "v")
    assert st2.read("k2") == "v"
    st.close()
    st2.close()


def _run_wordcount(connstr, dbname, params):
    """Server + 2 worker threads; the loop runs in a thread joined under
    a timeout (its phase polling has no deadline of its own)."""
    import threading

    from mapreduce_tpu_torch.server import Server
    from mapreduce_tpu_torch.worker import spawn_worker_threads

    threads = spawn_worker_threads(connstr, dbname, 2,
                                   conf={"max_iter": 60}, auth=TOKEN)
    server = Server(connstr, dbname, auth=TOKEN)
    server.configure(params)
    box = {}

    def body():
        try:
            box["stats"] = server.loop()
        except BaseException as exc:  # re-raised in the test thread
            box["err"] = exc

    loop = threading.Thread(target=body, daemon=True)
    loop.start()
    loop.join(JOIN_TIMEOUT)
    assert not loop.is_alive(), "Server.loop still running"
    if "err" in box:
        raise box["err"]
    for t in threads:
        t.join(timeout=JOIN_TIMEOUT)
        assert not t.is_alive(), f"worker {t.name} did not exit"


def test_user_module_storage_inherits_worker_auth(doc_srv, blob_srv):
    """A mapfn that builds its OWN storage handle (router(DSL) in module
    code — the train_digits pattern) must inherit the worker's auth
    token ambiently: no env var, no token in the DSL."""
    from mapreduce_tpu_torch import storage as storage_mod

    dsl = f"http:{blob_srv.address}"
    seed = storage_mod.router(dsl, auth=TOKEN)
    seed.write("in1", "p q p\n")
    seed.close()
    _conf.update({"blobs": ["in1"], "num_reducers": 3, "storage": dsl})
    RESULT.clear()
    m = __name__
    _run_wordcount(f"http://{doc_srv.host}:{doc_srv.port}", "ambwc", {
        "taskfn": m, "mapfn": m, "partitionfn": m, "reducefn": m,
        "finalfn": m, "storage": dsl,
        "init_args": {"blobs": ["in1"], "num_reducers": 3,
                      "storage": dsl}})
    assert RESULT == {"p": 2, "q": 1}


def test_ambient_token_scoped_to_job_endpoints():
    """The ambient job token must reach the job's own endpoints and NOT a
    third-party host."""
    from mapreduce_tpu_torch.utils.httpclient import (
        KeepAliveClient, push_ambient_auth, restore_ambient_auth)

    prev = push_ambient_auth(TOKEN, {"10.0.0.1:8750"})
    try:
        own = KeepAliveClient("10.0.0.1", 8750)
        foreign = KeepAliveClient("evil.example.com", 8750)
        assert own.auth_token == TOKEN
        assert foreign.auth_token is None
    finally:
        restore_ambient_auth(prev)
    assert KeepAliveClient("10.0.0.1", 8750).auth_token is None  # restored


def test_worker_server_auth_end_to_end(doc_srv, blob_srv, tmp_path):
    """Workers and server holding the token complete a job whose board AND
    blob storage both require auth — with a token-free storage DSL, so
    the framework's auth threading (Connection -> router) carries it."""
    import mapreduce_tpu_torch.examples.wordcount as mod

    f = tmp_path / "f1.txt"
    f.write_text("a b a\n")
    m = "mapreduce_tpu_torch.examples.wordcount"
    mod.RESULT.clear()
    _run_wordcount(f"http://{doc_srv.host}:{doc_srv.port}", "authwc", {
        "taskfn": m, "mapfn": m, "partitionfn": m, "reducefn": m,
        "finalfn": m, "storage": f"http:{blob_srv.address}",
        "init_args": {"files": [str(f)], "num_reducers": 3}})
    assert dict(mod.RESULT) == {"a": 2, "b": 1}
    mod._conf.clear()
    mod._conf.update({"files": [], "num_reducers": 15})


def test_exposition_is_gated_and_healthz_open(doc_srv):
    """/metrics, /tracez and /clusterz want the token; /healthz is open
    (orchestrator probes cannot send one)."""
    import http.client

    cnn = http.client.HTTPConnection(doc_srv.host, doc_srv.port,
                                     timeout=10)
    for path in ("/metrics", "/tracez", "/clusterz", "/healthz"):
        cnn.request("GET", path)
        r = cnn.getresponse()
        r.read()
        assert r.status == (200 if path == "/healthz" else 401), path
    cnn.request("GET", "/metrics",
                headers={"Authorization": f"Bearer {TOKEN}"})
    r = cnn.getresponse()
    assert r.status == 200 and b"mrtpu_board_jobs" in r.read()
    cnn.close()
