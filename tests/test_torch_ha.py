"""The port's replicated board (``mapreduce_tpu_torch.coord.ha``, the HA
docserver) against the JAX package's.

The mutation log is the JAX format byte for byte, so a log written by
either package's ``ReplicatedDocStore`` replays in the other's
``HaController`` to the writer's documents.  Failover is checked the way
``tests/test_board_ha.py`` checks it: the "kill" is the in-process
equivalent of a SIGKILL (the HA loop stopped with the lease unreleased,
the validity horizon zeroed, the listener closed), so the standby must
wait out the lease.  Every lease here is under a second, and every wait
has a deadline.
"""

import json
import os
import time

import pytest

from mapreduce_tpu.coord import docserver as jds
from mapreduce_tpu.coord import ha as jha
from mapreduce_tpu.coord import persistent_table as jpt
from mapreduce_tpu.coord.docstore import MemoryDocStore as JMemoryDocStore
from mapreduce_tpu_torch.coord import docserver as tds
from mapreduce_tpu_torch.coord import ha as tha
from mapreduce_tpu_torch.coord import persistent_table as tpt
from mapreduce_tpu_torch.coord.docstore import MemoryDocStore
from mapreduce_tpu_torch.utils.httpclient import (
    KeepAliveClient, NotPrimaryError, RetryPolicy)

FAST = RetryPolicy(max_attempts=4, base_delay=0.02, max_delay=0.2,
                   deadline=10.0, breaker_threshold=0)
LEASE = 0.6
PKGS = {"port": (tds, tha, tpt, MemoryDocStore),
        "jax": (jds, jha, jpt, JMemoryDocStore)}


def _kill(srv) -> None:
    """Make *srv* dead to clients without releasing its lease (the
    silent-death path)."""
    srv.ha._stop.set()
    srv.ha._thread.join(timeout=10)
    srv.ha._valid_until = 0.0
    srv.httpd.shutdown()
    srv.httpd.server_close()


def _shutdown(*servers) -> None:
    for s in servers:
        try:
            s.shutdown()
        except Exception:
            pass


def _pair(tmp_path, pkg="port", lease=LEASE):
    ds = PKGS[pkg][0]
    d = str(tmp_path / "ha")
    a = ds.DocServer(ha_dir=d, ha_lease=lease).start_background()
    b = ds.DocServer(ha_dir=d, ha_lease=lease).start_background()
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and not (a.ha.is_primary()
                                               or b.ha.is_primary()):
        time.sleep(0.01)
    assert a.ha.is_primary() or b.ha.is_primary()
    prim, stby = (a, b) if a.ha.is_primary() else (b, a)
    return a, b, prim, stby


def _post(srv, path, payload):
    k = KeepAliveClient(srv.host, srv.port, retry=FAST)
    try:
        status, body = k.request(
            "POST", path, body=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        return status, json.loads(body)
    finally:
        k.close()


def _script(store):
    """Every logged mutation kind, one generated id and an id-less
    upsert (the two cases replay must not re-generate)."""
    gen = store.insert("c.docs", {"v": 1})
    store.insert("c.docs", {"_id": "k", "v": 2})
    store.insert_many("c.docs", [{"_id": f"m{i}", "v": i} for i in range(3)])
    store.update("c.docs", {"_id": "k"}, {"$inc": {"v": 5}})
    store.update("c.docs", {"v": {"$gte": 0}}, {"$set": {"all": True}},
                 multi=True)
    store.update("c.docs", {"name": "up"}, {"$set": {"v": 9}}, upsert=True)
    store.update("c.docs", {"_id": "u2"}, {"$set": {"w": 1}}, upsert=True)
    store.find_and_modify("c.docs", {"_id": "k"}, {"$set": {"fam": 1}})
    store.find_and_modify_many("c.docs", {"v": {"$gte": 0}},
                               {"$inc": {"seen": 1}}, limit=2)
    store.remove("c.docs", {"_id": gen})
    store.insert("c.other", {"_id": "o"})
    store.drop_collection("c.other")


def _docs(store, colls=("c.docs", "c.other")):
    return {c: sorted(store.find(c), key=lambda d: d["_id"]) for c in colls}


# -- the mutation log --------------------------------------------------------


def test_mutation_log_torn_tail_and_garbled_line(tmp_path):
    log = tpt.MutationLog(str(tmp_path / "l" / "board.log"))
    log.append({"op": "x", "n": 1})
    log.append_many([{"op": "y"}, {"op": "z"}])
    entries, off = log.read_from(0)
    assert [e["op"] for e in entries] == ["x", "y", "z"]
    # a torn final line is an unanswered append: skipped, not consumed
    with open(log.path, "ab") as f:
        f.write(b'{"op": "torn"')
    assert log.read_from(off) == ([], off)
    # a garbled COMPLETE line is corruption, loudly
    with open(log.path, "ab") as f:
        f.write(b' garbage}\n')
    with pytest.raises(tpt.BoardLogCorruptError):
        log.read_from(off)
    log.close()


def test_log_bytes_are_the_jax_format(tmp_path):
    entries = [{"op": "insert", "coll": "c", "g": 3, "s": 1,
                "doc": {"_id": "ü", "z": [1, 2.5, None], "a": {"b": 1}}},
               {"op": "resp", "rid": "s:1", "body": '{"ok": true}',
                "g": 3, "s": 2}]
    paths = []
    for name, pt in (("port", tpt), ("jax", jpt)):
        log = pt.MutationLog(str(tmp_path / name / "board.log"))
        log.append_many(entries)
        log.close()
        paths.append(log.path)
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_log_replays_across_packages(tmp_path, writer):
    """A log written by one package's replicated store replays through
    the other package's controller (and its own) to the writer's docs."""
    _, wha, wpt, wmem = PKGS[writer]
    d = tmp_path / "ha"
    log = wpt.MutationLog(str(d / "board.log"))
    store = wha.ReplicatedDocStore(wmem(), log)
    _script(store)
    log.close()
    want = _docs(store.inner)
    for reader in ("port", "jax"):
        ctl = PKGS[reader][1].HaController(str(d), lease=LEASE)
        ctl._apply_new()
        assert _docs(ctl.store.inner) == want, reader
        ctl.log.close()


def test_replay_applies_each_entry_to_the_primarys_document(tmp_path):
    """A non-multi update and a find_and_modify pick the FIRST matching
    doc; the replica rebuilt from the log picks the same one."""
    log = tpt.MutationLog(str(tmp_path / "board.log"))
    store = tha.ReplicatedDocStore(MemoryDocStore(), log)
    for i in range(5):
        store.insert("q", {"_id": f"j{4 - i}", "status": 0})
    store.update("q", {"status": 0}, {"$set": {"status": 1, "by": "u"}})
    store.find_and_modify("q", {"status": 0}, {"$set": {"status": 2}})
    log.close()
    replica = MemoryDocStore()
    for e in log.replay():
        tha.apply_entry(replica, e)
    assert _docs(replica, ("q",)) == _docs(store.inner, ("q",))


def test_stale_generation_entries_are_skipped(tmp_path):
    log = tpt.MutationLog(str(tmp_path / "board.log"))
    log.append({"op": "insert", "coll": "c.d", "g": 1, "s": 1,
                "doc": {"_id": "a", "v": 1}})
    log.append({"op": "insert", "coll": "c.d", "g": 2, "s": 1,
                "doc": {"_id": "b", "v": 2}})
    # the generation-1 holder's straggler, appended after its deposal
    log.append({"op": "insert", "coll": "c.d", "g": 1, "s": 2,
                "doc": {"_id": "stale", "v": 3}})
    log.close()
    ctl = tha.HaController(str(tmp_path), lease=LEASE)
    ctl._apply_new()
    assert {d["_id"] for d in ctl.store.inner.find("c.d")} == {"a", "b"}
    ctl.log.close()


def test_corrupt_line_mid_tail_breaks_the_replica(tmp_path):
    a = tha.HaController(str(tmp_path), lease=30.0).start()
    b = None
    try:
        assert a.wait_role("primary", timeout=10)
        b = tha.HaController(str(tmp_path), lease=30.0).start()
        assert b.wait_role("replica", timeout=5)
        with open(a.log.path, "ab") as f:
            f.write(b"{this is not json\n")
        assert b.wait_role("broken", timeout=10)
        assert b.failed is not None and "failed" in b.snapshot()
        assert not b.is_primary()
    finally:
        a.stop()
        if b is not None:
            b.stop()


# -- promotion, dedupe, restart ----------------------------------------------


def test_promotion_keeps_dedupe_exactly_once(tmp_path):
    """A mutation the old primary answered, re-sent with its rid to the
    promoted standby, replays the recorded answer: not re-applied."""
    a, b, prim, stby = _pair(tmp_path)
    try:
        cli = tds.HttpDocStore(f"{prim.host}:{prim.port},"
                               f"{stby.host}:{stby.port}", retry=FAST)
        cli.insert("t.docs", {"_id": "x", "v": 1})
        cli.update("t.docs", {"_id": "x"}, {"$inc": {"v": 1}})  # rid :2
        _kill(prim)
        assert stby.ha.wait_role("primary", timeout=10)
        status, reply = _post(stby, "/rpc", {
            "op": "update", "coll": "t.docs", "query": {"_id": "x"},
            "update": {"$inc": {"v": 1}}, "rid": f"{cli._rid_session}:2"})
        assert status == 200 and reply == {"ok": True, "result": 1}
        assert cli.find_one("t.docs", {"_id": "x"})["v"] == 2
        assert stby.ha.snapshot()["promotions"] == 1
        cli.close()
    finally:
        _shutdown(a, b)


def test_logged_mutation_without_answer_is_refused(tmp_path):
    d = str(tmp_path / "ha")
    log = tpt.MutationLog(os.path.join(d, "board.log"))
    log.append({"op": "insert", "coll": "t.docs", "g": 1, "s": 1,
                "doc": {"_id": "x", "v": 1}, "rid": "sess:7"})
    log.close()
    srv = tds.DocServer(ha_dir=d, ha_lease=0.4).start_background()
    try:
        assert srv.ha.wait_role("primary", timeout=10)
        assert srv.ha.store.inner.find_one("t.docs", {"_id": "x"})["v"] == 1
        status, reply = _post(srv, "/rpc", {
            "op": "insert", "coll": "t.docs", "doc": {"_id": "x2"},
            "rid": "sess:7"})
        assert not reply["ok"] and reply["type"] == "DedupeEvictedError"
        assert srv.ha.store.inner.find_one("t.docs", {"_id": "x2"}) is None
    finally:
        srv.shutdown()


def test_restart_replays_the_board_and_its_answers(tmp_path):
    d = str(tmp_path / "ha")
    srv = tds.DocServer(ha_dir=d, ha_lease=0.4).start_background()
    assert srv.ha.wait_role("primary", timeout=10)
    cli = tds.HttpDocStore(f"{srv.host}:{srv.port}", retry=FAST)
    cli.insert("t.docs", {"_id": "x", "v": 41})
    cli.update("t.docs", {"_id": "x"}, {"$inc": {"v": 1}})
    session = cli._rid_session
    cli.close()
    srv.shutdown()
    srv2 = tds.DocServer(ha_dir=d, ha_lease=0.4).start_background()
    try:
        assert srv2.ha.wait_role("primary", timeout=10)
        cli2 = tds.HttpDocStore(f"{srv2.host}:{srv2.port}", retry=FAST)
        assert cli2.find_one("t.docs", {"_id": "x"})["v"] == 42
        status, reply = _post(srv2, "/rpc", {
            "op": "update", "coll": "t.docs", "query": {"_id": "x"},
            "update": {"$inc": {"v": 1}}, "rid": f"{session}:2"})
        assert status == 200 and reply["ok"]
        assert cli2.find_one("t.docs", {"_id": "x"})["v"] == 42
        cli2.close()
    finally:
        srv2.shutdown()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_standby_answers_421_with_the_jax_body(tmp_path, pkg):
    """A standby of either package answers every POST with 421 and the
    same body; /healthz names the role without auth; a single-endpoint
    client of the port raises NotPrimaryError."""
    a, b, prim, stby = _pair(tmp_path, pkg)
    try:
        status, reply = _post(stby, "/rpc", {"op": "ping"})
        assert status == 421
        assert reply == {"ok": False, "type": "NotPrimaryError",
                         "error": "this board replica is replica; dial "
                                  "the lease-holding primary"}
        status, _ = _post(stby, "/tasks", {"op": "tick"})
        assert status == 421
        k = KeepAliveClient(stby.host, stby.port, retry=FAST)
        status, body = k.request("GET", "/healthz")
        k.close()
        assert status == 200 and json.loads(body) == {
            "ok": True, "role": "replica", "primary": False}
        only = tds.HttpDocStore(f"{stby.host}:{stby.port}", retry=FAST)
        with pytest.raises(NotPrimaryError):
            only.insert("t.docs", {"_id": "q"})
        only.close()
    finally:
        _shutdown(a, b)


# -- the four client x server pairings through a primary kill ----------------


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_pairings_keep_exactly_once_through_a_kill(tmp_path, client_pkg,
                                                   server_pkg):
    """bench.py's failover measurement on each pairing: after the kill,
    the first mutation acknowledged by the promoted standby applied
    once (n == 1, v == 2), and the standby carries every doc."""
    a, b, prim, stby = _pair(tmp_path, server_pkg)
    try:
        cli = PKGS[client_pkg][0].HttpDocStore(
            f"{a.host}:{a.port},{b.host}:{b.port}", retry=FAST)
        cli.insert("bench.docs", {"_id": "x", "v": 0})
        cli.insert_many("bench.docs", [{"_id": f"j{i}"} for i in range(3)])
        cli.update("bench.docs", {"_id": "x"}, {"$inc": {"v": 1}})
        t0 = time.monotonic()
        _kill(prim)
        n = cli.update("bench.docs", {"_id": "x"}, {"$inc": {"v": 1}})
        took = time.monotonic() - t0
        assert n == 1 and stby.ha.is_primary(), (n, stby.ha.role)
        assert cli.find_one("bench.docs", {"_id": "x"})["v"] == 2
        assert cli.count("bench.docs") == 4
        assert took < 4 * LEASE + 2.0, took
        cli.close()
    finally:
        _shutdown(a, b)
