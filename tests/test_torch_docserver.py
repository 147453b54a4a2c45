"""The port's networked job board (``mapreduce_tpu_torch.coord.docserver``)
against the JAX package's.

The wire is the JAX package's byte for byte, so the same operation
script runs over the four pairings {port, JAX} ``HttpDocStore`` x
{port, JAX} ``DocServer`` and must give the same documents and the same
exception classes in each.  The cases of ``tests/test_docserver.py`` are
mirrored on the port's pair.  Every server binds port 0 and is shut down
by its fixture; every socket has a timeout.
"""

import http.client
import json
import threading
import time

import pytest

from mapreduce_tpu.coord import docserver as jds
from mapreduce_tpu_torch.coord import docserver as tds
from mapreduce_tpu_torch.coord.docserver import DocServer, HttpDocStore
from mapreduce_tpu_torch.coord.docstore import DirDocStore, MemoryDocStore

PKGS = {"port": tds, "jax": jds}


@pytest.fixture
def srv():
    s = DocServer().start_background()
    yield s
    s.shutdown()


def _post(srv, payload, path="/rpc"):
    cnn = http.client.HTTPConnection(srv.host, srv.port, timeout=10)
    try:
        cnn.request("POST", path, body=json.dumps(payload).encode())
        r = cnn.getresponse()
        return json.loads(r.read())
    finally:
        cnn.close()


def _start(pkg):
    """A DocServer of *pkg* on port 0, JAX's with its default scheduler
    (the JAX server hosts one on every board)."""
    return PKGS[pkg].DocServer().start_background()


def _script(client, server):
    """The operation script: every op of the RPC surface, a retried
    mutation, a deduped read and each error case.  Returns the answers
    (exception class names in place of raised errors) and the final
    documents, both independent of the package."""
    out = []

    def step(name, fn):
        try:
            out.append((name, fn()))
        except Exception as exc:  # the class is the answer here
            out.append((name, "raised " + type(exc).__name__))

    step("insert", lambda: client.insert("c", {"_id": "a", "n": 0}))
    auto = client.insert("c", {"n": 9})
    out.append(("auto_id", len(auto) == 32))
    client.remove("c", {"_id": auto})
    step("insert_many", lambda: client.insert_many(
        "c", [{"_id": f"j{i}", "status": 0, "i": i} for i in range(5)]))
    step("find", lambda: sorted(d["_id"] for d in client.find("c")))
    step("find_one_query", lambda: client.find("c", {"i": {"$gte": 3}}))
    step("count", lambda: client.count("c", {"status": 0}))
    step("update_inc", lambda: client.update(
        "c", {"_id": "a"}, {"$inc": {"n": 2}}))
    step("update_multi", lambda: client.update(
        "c", {"status": 0}, {"$set": {"seen": True}}, multi=True))
    step("upsert", lambda: client.update(
        "c", {"_id": "u"}, {"$set": {"x": 1}}, upsert=True))
    step("claim", lambda: client.find_and_modify(
        "c", {"_id": "j0", "status": 0}, {"$set": {"status": 1}}))
    step("claim_missing", lambda: client.find_and_modify(
        "c", {"_id": "nope"}, {"$set": {"status": 1}}))
    step("claim_many", lambda: sorted(
        d["_id"] for d in client.find_and_modify_many(
            "c", {"status": 0}, {"$set": {"status": 1}}, limit=3)))
    step("remove", lambda: client.remove("c", {"_id": "j4"}))
    step("collections", lambda: sorted(client.collections()))
    step("ping", client.ping)
    # errors: a bad operator, a callable sort key, an unknown op
    step("bad_operator", lambda: client.find("c", {"x": {"$regex": "."}}))
    step("sort_key", lambda: client.find_and_modify(
        "c", {}, {"$set": {"x": 1}}, sort_key=lambda d: d["x"]))
    step("unknown_op", lambda: client._rpc("frobnicate", coll="c"))
    # a retried mutation applies once, a read is never deduped
    inc = {"op": "update", "coll": "c", "query": {"_id": "a"},
           "update": {"$inc": {"n": 1}}, "rid": "sess:1"}
    out.append(("retry_1", _post(server, inc)))
    out.append(("retry_2", _post(server, inc)))
    find = {"op": "find", "coll": "c", "query": {"_id": "a"},
            "rid": "sess:2"}
    out.append(("read_1", _post(server, find)["result"][0]["n"]))
    client.update("c", {"_id": "a"}, {"$inc": {"n": 10}})
    out.append(("read_2", _post(server, find)["result"][0]["n"]))
    # a malformed body is a 400, an unknown path a 404
    cnn = http.client.HTTPConnection(server.host, server.port, timeout=10)
    cnn.request("POST", "/rpc", body=b"[1, 2]")
    r = cnn.getresponse()
    out.append(("bad_request", r.status, r.read()))
    cnn.close()
    step("drop", lambda: client.drop_collection("c"))
    step("after_drop", lambda: (client.count("c"), client.collections()))
    client.insert("d", {"_id": "z"})
    docs = {c: sorted(client.find(c), key=lambda d: d["_id"])
            for c in client.collections()}
    return out, docs


def _evicted_straggler(client_pkg, server, monkeypatch):
    """A dedupe cache of 8 entries: the first rid's straggling retry is
    refused, never re-applied, and the client raises the package's
    DedupeEvictedError."""
    client = PKGS[client_pkg].HttpDocStore(f"{server.host}:{server.port}")
    try:
        client.insert("e", {"_id": "a", "n": 0})
        first = {"op": "update", "coll": "e", "query": {"_id": "a"},
                 "update": {"$inc": {"n": 1}}, "rid": "s:1"}
        _post(server, first)
        for i in range(2, 20):
            _post(server, {"op": "update", "coll": "e",
                           "query": {"_id": "a"},
                           "update": {"$set": {"x": i}}, "rid": f"s:{i}"})
        reply = _post(server, first)
        # the same straggler through the client's own error mapping
        client._rid_session = "s"
        client._rid_seq = iter([1])
        try:
            client.update("e", {"_id": "a"}, {"$inc": {"n": 1}})
            raised = None
        except IOError as exc:
            raised = type(exc).__name__
        return (reply["ok"], reply["type"], raised,
                client.find("e")[0]["n"])
    finally:
        client.close()


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_cross_wire_script(client_pkg, server_pkg, monkeypatch):
    """Every pairing of {port, JAX} client x {port, JAX} server gives the
    answers, documents and exception classes of the JAX pair."""
    for mod in PKGS.values():
        monkeypatch.setattr(mod, "_DEDUPE_CAP", 8)
    results = []
    for c, s in ((client_pkg, server_pkg), ("jax", "jax")):
        server = _start(s)
        client = PKGS[c].HttpDocStore(f"{server.host}:{server.port}")
        try:
            results.append((_script(client, server),
                            _evicted_straggler(c, server, monkeypatch)))
        finally:
            client.close()
            server.shutdown()
    (got, got_evicted), (want, want_evicted) = results
    assert got == want
    assert got_evicted == want_evicted == (
        False, "DedupeEvictedError", "DedupeEvictedError", 1)
    answers = dict((a[0], a[1:]) for a in got[0])
    assert answers["retry_1"] == answers["retry_2"]  # replayed, not re-run
    assert answers["read_2"][0] == answers["read_1"][0] + 10
    assert answers["bad_operator"] == ("raised ValueError",)
    assert answers["sort_key"] == ("raised NotImplementedError",)
    assert answers["unknown_op"] == ("raised ValueError",)


def test_retried_mutation_applies_once(srv):
    """The same request id replayed (a client reconnect after a broken
    socket) must not double-apply: the recorded response comes back and
    state is unchanged."""
    ins = {"op": "insert", "coll": "c", "doc": {"_id": "a", "n": 0},
           "rid": "rid-ins"}
    assert _post(srv, ins)["ok"]
    assert _post(srv, ins)["ok"]  # replayed, not re-inserted
    assert srv.store.count("c") == 1

    inc = {"op": "update", "coll": "c", "query": {"_id": "a"},
           "update": {"$inc": {"n": 1}}, "rid": "rid-inc"}
    assert _post(srv, inc)["result"] == 1
    assert _post(srv, inc)["result"] == 1  # replay: same answer, no 2nd $inc
    assert srv.store.find_one("c", {"_id": "a"})["n"] == 1

    claim = {"op": "find_and_modify", "coll": "c", "query": {"n": 1},
             "update": {"$set": {"who": "w1"}}, "rid": "rid-claim"}
    first = _post(srv, claim)["result"]
    again = _post(srv, claim)["result"]
    assert first == again  # a retried claim cannot double-claim


def test_concurrent_retry_waits_for_inflight_original():
    """A retry arriving while the original is STILL executing must wait for
    the recorded response, not re-apply (the in-flight reservation)."""

    class SlowStore(MemoryDocStore):
        def update(self, *a, **kw):
            time.sleep(0.4)
            return super().update(*a, **kw)

    srv = DocServer(SlowStore()).start_background()
    try:
        srv.store.insert("c", {"_id": "a", "n": 0})
        req = {"op": "update", "coll": "c", "query": {"_id": "a"},
               "update": {"$inc": {"n": 1}}, "rid": "rid-race"}
        replies = []

        def fire():
            replies.append(_post(srv, req))

        t1 = threading.Thread(target=fire)
        t2 = threading.Thread(target=fire)
        t1.start()
        time.sleep(0.1)  # original is mid-update when the duplicate lands
        t2.start()
        t1.join(timeout=10)
        t2.join(timeout=10)
        assert [r["ok"] for r in replies] == [True, True]
        assert srv.store.find_one("c", {"_id": "a"})["n"] == 1
    finally:
        srv.shutdown()


def test_eviction_straggler_fails_loudly_not_double_applied(srv):
    """Drive more than _DEDUPE_CAP mutating RPCs, then replay the very
    first rid: its recorded answer is long evicted, so the server must
    refuse (DedupeEvictedError) — NOT silently re-apply the $inc.  A rid
    still inside the cap keeps the normal replay contract."""
    cnn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)

    def rpc(payload):
        cnn.request("POST", "/rpc", body=json.dumps(payload).encode())
        return json.loads(cnn.getresponse().read())

    srv.store.insert("c", {"_id": "a", "n": 0})
    first = {"op": "update", "coll": "c", "query": {"_id": "a"},
             "update": {"$inc": {"n": 1}}, "rid": "sess:1"}
    assert rpc(first)["result"] == 1
    for i in range(2, tds._DEDUPE_CAP + 10):
        assert rpc({"op": "update", "coll": "c", "query": {"_id": "a"},
                    "update": {"$set": {"x": i}},
                    "rid": f"sess:{i}"})["ok"]
    reply = rpc(first)
    assert reply["ok"] is False
    assert reply["type"] == "DedupeEvictedError"
    assert srv.store.find_one("c", {"_id": "a"})["n"] == 1
    last = tds._DEDUPE_CAP + 9
    assert rpc({"op": "update", "coll": "c", "query": {"_id": "a"},
                "update": {"$set": {"x": last}},
                "rid": f"sess:{last}"})["ok"]
    cnn.close()


def test_legacy_opaque_rids_keep_old_semantics(srv):
    """Opaque (colon-free) rids can't be watermarked; they keep the
    within-cap replay contract and are never refused."""
    ins = {"op": "insert", "coll": "c2", "doc": {"_id": "z"},
           "rid": "deadbeef"}
    assert _post(srv, ins)["ok"]
    assert _post(srv, ins)["ok"]  # replayed
    assert srv.store.count("c2") == 1


def test_reads_are_not_deduped(srv):
    srv.store.insert("c", {"_id": "a"})
    find = {"op": "find", "coll": "c", "rid": "rid-find"}
    assert len(_post(srv, find)["result"]) == 1
    srv.store.insert("c", {"_id": "b"})
    assert len(_post(srv, find)["result"]) == 2  # fresh execution


def test_error_mapping(srv):
    store = HttpDocStore(f"{srv.host}:{srv.port}")
    srv.store.insert("c", {"_id": "a", "x": 1})
    with pytest.raises(ValueError):
        store.find("c", {"x": {"$regex": "unsupported"}})
    with pytest.raises(NotImplementedError):
        store.find_and_modify("c", {}, {"$set": {"x": 1}},
                              sort_key=lambda d: d["x"])
    assert store.ping()
    store.close()


def test_durable_board_survives_restart(tmp_path):
    """--root mode: the board state is a DirDocStore, so a docserver
    restart (the mongod-restart story) loses nothing."""
    root = str(tmp_path / "board")
    s1 = DocServer(DirDocStore(root)).start_background()
    c1 = HttpDocStore(f"{s1.host}:{s1.port}")
    c1.insert("jobs", {"_id": "j1", "status": 0})
    c1.close()
    s1.shutdown()

    s2 = DocServer(DirDocStore(root)).start_background()
    c2 = HttpDocStore(f"{s2.host}:{s2.port}")
    assert c2.find_one("jobs", {"_id": "j1"})["status"] == 0
    c2.close()
    s2.shutdown()


def _jax_get_paths():
    """The JAX docserver's GET allow-list, read as text from its
    ``do_GET``."""
    import pathlib
    import re

    src = (pathlib.Path(jds.__file__)).read_text()
    allow = re.search(r'if path not in \(("/metrics".*?)\):', src, re.S)
    return re.findall(r'"(/[a-z]+)"', allow.group(1))


def test_unported_surfaces_name_their_item(srv, tmp_path):
    """Every GET path of the JAX docserver is served by the port's: on a
    board with the history and an alert rule each answers 200 (and
    ``POST /alertz`` acks); on a board without them ``/queryz`` and
    ``/alertz`` answer the JAX server's 404 bodies; ``/healthz`` is the
    JAX body.  Nothing is left unported."""
    paths = _jax_get_paths()
    assert {"/queryz", "/alertz", "/healthz", "/metrics"} <= set(paths)
    assert set(paths) <= set(tds.GET_PATHS)
    assert not hasattr(tds, "NOT_PORTED")
    jsrv = jds.DocServer().start_background()
    try:
        for path in ("/queryz", "/alertz"):
            got = {}
            for name, s in (("port", srv), ("jax", jsrv)):
                cnn = http.client.HTTPConnection(s.host, s.port,
                                                 timeout=10)
                cnn.request("GET", path)
                r = cnn.getresponse()
                got[name] = (r.status, r.read())
                cnn.close()
            assert got["port"] == got["jax"] and got["port"][0] == 404
    finally:
        jsrv.shutdown()
    planed = DocServer(history_dir=str(tmp_path / "hist"),
                       alert_rules=["r:increase(mrtpu_x_total[60]):gt:0"],
                       alert_interval=3600.0).start_background()
    try:
        cnn = http.client.HTTPConnection(planed.host, planed.port,
                                         timeout=10)
        for path in paths:
            q = "?metric=mrtpu_x_total" if path == "/queryz" else ""
            cnn.request("GET", path + q)
            r = cnn.getresponse()
            r.read()
            assert r.status == 200, path
        cnn.request("POST", "/alertz",
                    body=json.dumps({"op": "ack", "rule": "r"}).encode())
        r = cnn.getresponse()
        assert (r.status, json.loads(r.read())) == (
            200, {"ok": True, "result": {"rule": "r",
                                         "acked_instances": 0}})
        cnn.request("GET", "/healthz")
        r = cnn.getresponse()
        assert (r.status, r.read()) == (200, b'{"ok": true}')
        cnn.close()
    finally:
        planed.shutdown()


def test_unreachable_board_raises_once_policy_spent():
    """No fallback: a dead endpoint costs the policy's attempts and then
    raises RetryError, whose cause is the transport error."""
    from mapreduce_tpu_torch.utils.httpclient import RetryError, RetryPolicy

    policy = RetryPolicy(max_attempts=3, base_delay=0.01, deadline=2.0,
                         breaker_threshold=0)
    store = HttpDocStore("127.0.0.1:1", retry=policy)
    t0 = time.monotonic()
    with pytest.raises(RetryError) as exc:
        store.insert("c", {"x": 1})
    assert time.monotonic() - t0 < 2.5
    assert isinstance(exc.value.__cause__, OSError)
