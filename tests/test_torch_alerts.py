"""The port's alerting plane (``mapreduce_tpu_torch.obs.alerts``) and the
surfaces that serve it, held against the JAX package's.

Every case of ``tests/test_alerts.py`` runs through BOTH packages on the
same inputs — histories written with explicit ``t=`` stamps, sweeps with
explicit ``now=``, both packages' ``coord.docstore.now`` monkeypatched
to one settable clock — in the same directory path (wiped between the
two runs), and the two results must be equal: transitions, snapshots,
delivered notifications and rendered CLI text, floats with ``==``.  Each
test then makes the JAX test's own assertions on the port's result.

Beyond the mirrored cases: an alert log written by either package is
replayed by the other with no transition re-entering ``firing`` and no
second delivery, both validators refuse the same documents, a port
bundle's ``alerts.json`` passes the JAX ``validate_alerts``, the
``/queryz`` / ``/alertz`` answers and the ``history`` / ``top`` /
``alerts`` / ``status`` output are equal across the four client x server
pairings, and the SIGKILL failover acceptance run of
``tests/test_ha_chaos.py`` has its port counterpart.  Every wait has a
deadline.
"""

import contextlib
import http.client
import io
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from mapreduce_tpu import cli as jcli
from mapreduce_tpu.coord import docserver as jds
from mapreduce_tpu.coord import docstore as jdocstore
from mapreduce_tpu.coord import persistent_table as jpt
from mapreduce_tpu.obs import alerts as jalerts
from mapreduce_tpu.obs import history as jhistory
from mapreduce_tpu.obs import metrics as jmetrics
from mapreduce_tpu.obs import profile as jprofile
from mapreduce_tpu.obs import slo as jslo
from mapreduce_tpu.obs import statusz as jstatusz
from mapreduce_tpu_torch import cli as tcli
from mapreduce_tpu_torch.coord import docserver as tds
from mapreduce_tpu_torch.coord import docstore as tdocstore
from mapreduce_tpu_torch.coord import persistent_table as tpt
from mapreduce_tpu_torch.obs import alerts as talerts
from mapreduce_tpu_torch.obs import collector as tcollector
from mapreduce_tpu_torch.obs import history as thistory
from mapreduce_tpu_torch.obs import metrics as tmetrics
from mapreduce_tpu_torch.obs import profile as tprofile
from mapreduce_tpu_torch.obs import slo as tslo
from mapreduce_tpu_torch.obs import statusz as tstatusz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": types.SimpleNamespace(
        alerts=jalerts, history=jhistory, metrics=jmetrics,
        profile=jprofile, slo=jslo, statusz=jstatusz, cli=jcli, ds=jds,
        docstore=jdocstore, pt=jpt),
    "port": types.SimpleNamespace(
        alerts=talerts, history=thistory, metrics=tmetrics,
        profile=tprofile, slo=tslo, statusz=tstatusz, cli=tcli, ds=tds,
        docstore=tdocstore, pt=tpt),
}

T0 = 1_000_000.0
FAMILY = "mrtpu_alert_probe_total"


class _Clock:
    def __init__(self) -> None:
        self.t = T0

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for P in PKGS.values():
        monkeypatch.setattr(P.docstore, "now", c)
    return c


def _k(name, **labels):
    return (name, tuple(sorted(labels.items())))


def _probe_hist(P, d, counts, step_s=10.0):
    """History holding one counter series sampled every *step_s*."""
    h = P.history.MetricHistory(str(d / "hist"))
    for i, c in enumerate(counts):
        h.append_snapshot("p0", {_k(FAMILY, task="wc"): float(c)},
                          t=T0 + step_s * i)
    return h


class _MemSink:
    """In-memory sink recording every notification; optionally fails
    the first *fail_first* deliveries."""

    def __init__(self, name="mem", fail_first=0):
        self.name = name
        self.docs = []
        self._fail = fail_first

    def deliver(self, doc):
        if self._fail > 0:
            self._fail -= 1
            raise IOError("injected sink failure")
        self.docs.append(doc)


def _raised(fn):
    try:
        fn()
    except Exception as exc:  # the class and text are the answer here
        return [type(exc).__name__, str(exc)]
    return None


def _log(d):
    """The alert log's entries, as written."""
    with open(d / "alerts" / "alert.log") as f:
        return [json.loads(line) for line in f if line.strip()]


def _both(case, tmp_path, clock=None, *args):
    out = {}
    for name, P in PKGS.items():
        d = tmp_path / "run"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir()
        if clock is not None:
            clock.t = T0
        try:
            out[name] = case(P, d, *args)
        finally:
            P.alerts.PLANE.reset()
    assert out["port"] == out["jax"], (out["port"], out["jax"])
    return out["port"]


# -- rule grammar -------------------------------------------------------------

def _case_parse(P, d):
    r = P.alerts.parse_alert("hot:rate(mrtpu_wc_total{task=wc}[60]):>:5:30")
    r2 = P.alerts.parse_alert("cold:increase(mrtpu_wc_total):lt:1")
    a = P.alerts.parse_alert("odd:anomaly(mrtpu_wc_total[20]):ge:6")
    b = P.alerts.parse_alert("burny:burn(avail,short):>=:2:10",
                             objectives=["avail"])
    return [r.describe(), r2.describe(), a.describe(), b.describe(),
            [r.fn, r.matchers], P.alerts.DEFAULT_WINDOW_S]


def test_parse_threshold_rule_and_defaults(tmp_path):
    r, r2, a, b, (fn, matchers), default_w = _both(_case_parse, tmp_path)
    assert (r["name"], r["kind"], fn) == ("hot", "threshold", "rate")
    assert r["family"] == "mrtpu_wc_total" and matchers == {"task": "wc"}
    assert (r["window_s"], r["op"], r["threshold"], r["for_s"]) == (
        60.0, "gt", 5.0, 30.0)
    assert (r2["op"], r2["window_s"], r2["for_s"]) == ("lt", default_w, 0.0)
    assert r["fn"] == "rate" and r["matchers"] == {"task": "wc"}
    assert a["kind"] == "anomaly" and "fn" not in a
    assert (b["kind"], b["objective"], b["burn_window"]) == (
        "burn", "avail", "short")


BAD_SPECS = [
    ("a:b:c", "want NAME:EXPR:OP:THRESHOLD"),
    ("no spaces!:rate(x):>:1", "bad alert name"),
    ("a:rate(mrtpu_x_total):~:1", "bad alert op"),
    ("a:rate(mrtpu_x_total):>:warm", "bad alert threshold"),
    ("a:rate(mrtpu_x_total):>:1:soon", "bad alert for-duration"),
    ("a:rate(mrtpu_x_total):>:1:-5", "for-duration must be >= 0"),
    ("a:mrtpu_x_total:>:1", "bad alert expr"),
    ("a:median(mrtpu_x_total):>:1", "bad alert expr function"),
    ("a:rate(mrtpu_x_total[0]):>:1", "window must be > 0"),
    ("a:rate(mrtpu_x_total{task}):>:1", "bad alert matcher"),
    ("a:burn(avail,medium):>:1", "bad alert burn window"),
    ("a:burn():>:1", "wants an objective name")]


def _case_parse_bad(P, d):
    out = [_raised(lambda s=spec: P.alerts.parse_alert(s))
           for spec, _msg in BAD_SPECS]
    out.append(_raised(lambda: P.alerts.parse_alert(
        "a:burn(availability):>:1", objectives=["avail"])))
    return out


def test_parse_rejects_bad_specs(tmp_path):
    got = _both(_case_parse_bad, tmp_path)
    for (spec, msg), r in zip(BAD_SPECS, got):
        assert r[0] == "ValueError" and msg in r[1], (spec, r)
    assert "unknown alert objective" in got[-1][1]


def _case_rules_file(P, d):
    bare = d / "bare.json"
    bare.write_text(json.dumps(
        ["a:rate(mrtpu_x_total):>:1", "b:increase(mrtpu_y_total):<:2:9"]))
    wrapped = d / "wrapped.json"
    wrapped.write_text(json.dumps(
        {"rules": ["c:delta(mrtpu_z_total[30]):>=:0.5"]}))
    bad = d / "bad.json"
    bad.write_text(json.dumps({"alerts": []}))
    return [[r.describe() for r in P.alerts.load_rules_file(str(bare))],
            [r.describe() for r in P.alerts.load_rules_file(str(wrapped))],
            _raised(lambda: P.alerts.load_rules_file(str(bad)))]


def test_load_rules_file_both_shapes_and_reject(tmp_path):
    bare, wrapped, bad = _both(_case_rules_file, tmp_path)
    assert [r["name"] for r in bare] == ["a", "b"]
    assert [r["name"] for r in wrapped] == ["c"]
    assert "want a JSON array" in bad[1]


def _case_sink_specs(P, d):
    s = P.alerts.parse_webhook_spec("pager=127.0.0.1:9093")
    e = P.alerts.parse_exec_spec("log=cat /dev/null")
    return [s.name, P.alerts.parse_webhook_spec("127.0.0.1:9093").name,
            _raised(lambda: P.alerts.parse_webhook_spec("no-port-here")),
            e.name, e.argv, P.alerts.parse_exec_spec("/usr/bin/true").name,
            _raised(lambda: P.alerts.parse_exec_spec("noop="))]


def test_sink_spec_parsing(tmp_path):
    (name, auto, no_port, ename, argv, true_name,
     empty) = _both(_case_sink_specs, tmp_path)
    assert name == "pager" and auto == "webhook-127.0.0.1-9093"
    assert no_port is not None and empty is not None
    assert ename == "log" and argv[0] == "cat" and true_name == "exec-true"


# -- the state machine --------------------------------------------------------

def _case_lifecycle(P, d):
    h = _probe_hist(P, d, [0.0, 9.0])
    t = T0 + 10.0
    sink = _MemSink()
    reg = P.metrics.REGISTRY
    plane = P.alerts.AlertPlane(flap_damp_s=0.0)
    plane.configure(
        [P.alerts.parse_alert(f"hot:increase({FAMILY}[60]):>:5:5")],
        log_dir=str(d / "alerts"), sinks=[sink])
    out = []
    try:
        plane.evaluate(history=h, now=t)
        out += [plane.snapshot(now=t), plane.pump()]
        plane.evaluate(history=h, now=t + 4.0)
        out.append(plane.snapshot(now=t + 4.0))
        plane.evaluate(history=h, now=t + 5.0)
        out += [plane.snapshot(now=t + 5.0),
                reg.sum("mrtpu_alerts_firing"), plane.pump(), plane.pump()]
        h.append_snapshot("p0", {_k(FAMILY, task="wc"): 9.0},
                          t=t + 100.0)
        plane.evaluate(history=h, now=t + 100.0)
        out += [plane.snapshot(now=t + 100.0),
                reg.sum("mrtpu_alerts_firing"), plane.pump(), sink.docs,
                _log(d)]
    finally:
        plane.reset()
        h.close()
    return out


def test_lifecycle_pending_firing_resolved(tmp_path):
    (pend, pump0, still, fire, firing_g, pump1, pump2, resolved,
     firing_g2, pump3, docs, _log_entries) = _both(_case_lifecycle,
                                                   tmp_path)
    assert pend["counts"] == {"pending": 1}
    (inst,) = pend["instances"]
    assert inst["state"] == "pending" and inst["value"] == 9.0
    assert inst["labels"] == {"task": "wc"} and pump0 == {}
    assert still["counts"] == {"pending": 1}
    assert fire["counts"] == {"firing": 1} and firing_g == 1.0
    assert (pump1, pump2) == ({"mem": 1}, {})
    assert resolved["counts"] == {"resolved": 1} and firing_g2 == 0.0
    assert pump3 == {"mem": 1}
    assert [(x["rule"], x["to"]) for x in docs] == [("hot", "firing"),
                                                   ("hot", "resolved")]


def _case_for_zero(P, d):
    h = _probe_hist(P, d, [0.0, 9.0])
    t = T0 + 10.0
    plane = P.alerts.AlertPlane(flap_damp_s=0.0)
    plane.configure([P.alerts.parse_alert(f"now:increase({FAMILY}[60]):>:5")])
    try:
        plane.evaluate(history=h, now=t)
        out = [plane.snapshot(now=t)]
    finally:
        plane.reset()
    plane2 = P.alerts.AlertPlane(flap_damp_s=0.0)
    plane2.configure(
        [P.alerts.parse_alert(f"slow:increase({FAMILY}[60]):>:5:30")])
    try:
        plane2.evaluate(history=h, now=t)
        out.append(plane2.snapshot(now=t))
        h.append_snapshot("p0", {_k(FAMILY, task="wc"): 9.0},
                          t=t + 100.0)
        plane2.evaluate(history=h, now=t + 100.0)
        plane2.evaluate(history=h, now=t + 101.0)
        out.append(plane2.snapshot(now=t + 101.0))
    finally:
        plane2.reset()
        h.close()
    return out


def test_for_zero_fires_immediately_and_pending_clears(tmp_path):
    fired, pend, cleared = _both(_case_for_zero, tmp_path)
    assert fired["counts"] == {"firing": 1}
    assert pend["counts"] == {"pending": 1}
    assert cleared["instances"] == []


# -- durable log: failover resume + generation fencing ------------------------

def _case_failover(P, d):
    h = _probe_hist(P, d, [0.0, 9.0])
    t = T0 + 10.0
    log_dir = str(d / "alerts")
    rule = f"hot:increase({FAMILY}[60]):>:5:5"
    parse = P.alerts.parse_alert
    primary = P.alerts.AlertPlane(flap_damp_s=0.0)
    primary.configure([parse(rule)], log_dir=log_dir, gen_fn=lambda: 1,
                      sinks=[_MemSink(name="pager")])
    primary.evaluate(history=h, now=t)
    out = [primary.snapshot(now=t)]
    standby = P.alerts.AlertPlane(flap_damp_s=0.0)
    new_sink = _MemSink(name="pager")
    standby.configure([parse(rule)], log_dir=log_dir, gen_fn=lambda: 2,
                      sinks=[new_sink])
    out.append(standby.snapshot(now=t + 1.0))
    standby.evaluate(history=h, now=t + 5.0)
    out += [standby.snapshot(now=t + 5.0), standby.pump()]
    late = P.pt.MutationLog(os.path.join(log_dir, "alert.log"))
    late.append({"kind": "transition", "rule": "hot",
                 "labels": {"task": "wc"}, "from": "firing",
                 "to": "resolved", "t": t + 6.0, "value": 0.0,
                 "g": 1, "n": 99})
    late.close()
    standby.refresh()
    out += [standby.snapshot(now=t + 6.0), standby.pump(), new_sink.docs]
    reader = P.alerts.AlertPlane(flap_damp_s=0.0)
    reader.configure([parse(rule)], log_dir=log_dir, gen_fn=lambda: 2)
    out += [reader.snapshot(now=t + 6.0), _log(d)]
    reader.reset()
    standby.reset()
    primary.reset()
    h.close()
    return out


def test_failover_resumes_pending_and_fences_stale_writes(tmp_path):
    (prim, replayed, fired, pump1, fenced, pump2, docs, rsnap,
     _entries) = _both(_case_failover, tmp_path)
    assert prim["counts"] == {"pending": 1}
    assert replayed["counts"] == {"pending": 1}
    assert replayed["log"]["replayed"] >= 1
    assert fired["counts"] == {"firing": 1}
    assert fired["log"]["generation"] == 2 and pump1 == {"pager": 1}
    assert fenced["log"]["skipped_stale"] >= 1 and pump2 == {}
    assert [x["to"] for x in docs] == ["firing"]
    assert rsnap["counts"] == {"firing": 1}
    assert rsnap["log"]["skipped_stale"] >= 1


def _case_pump_retry(P, d):
    h = _probe_hist(P, d, [0.0, 9.0])
    t = T0 + 10.0
    reg = P.metrics.REGISTRY
    err0 = reg.sum("mrtpu_alert_notifications_total", sink="flaky",
                   outcome="error")
    sink = _MemSink(name="flaky", fail_first=1)
    plane = P.alerts.AlertPlane(flap_damp_s=0.0)
    plane.configure([P.alerts.parse_alert(f"hot:increase({FAMILY}[60]):>:5")],
                    log_dir=str(d / "alerts"), sinks=[sink])
    try:
        plane.evaluate(history=h, now=t)
        out = [plane.pump(),
               reg.sum("mrtpu_alert_notifications_total", sink="flaky",
                       outcome="error") - err0,
               plane.pump(), plane.pump(), sink.docs]
    finally:
        plane.reset()
        h.close()
    return out


def test_pump_retries_without_advancing_cursor(tmp_path):
    first, errors, second, third, docs = _both(_case_pump_retry, tmp_path)
    assert first == {} and errors == 1
    assert second == {"flaky": 1} and third == {}
    assert len(docs) == 1 and docs[0]["seq"] >= 1


# -- silences, acks, refire on expiry -----------------------------------------

def _case_silence(P, d):
    h = _probe_hist(P, d, [0.0, 9.0])
    t = T0 + 10.0
    sink = _MemSink()
    plane = P.alerts.AlertPlane(flap_damp_s=0.0)
    plane.configure([P.alerts.parse_alert(f"hot:increase({FAMILY}[60]):>:5")],
                    log_dir=str(d / "alerts"), sinks=[sink])
    try:
        out = [plane.silence("hot", 30.0, now=t)]
        plane.evaluate(history=h, now=t)
        out += [plane.snapshot(now=t), plane.pump()]
        plane.evaluate(history=h, now=t + 31.0)
        out += [plane.snapshot(now=t + 31.0), plane.pump(), plane.pump(),
                sink.docs, plane.ack("hot"), plane.snapshot(now=t + 31.0)]
    finally:
        plane.reset()
        h.close()
    return out


def test_silence_suppresses_then_expiry_refires_once(tmp_path):
    (sil, snap, pump0, snap2, pump1, pump2, docs, acked,
     snap3) = _both(_case_silence, tmp_path)
    assert sil["rule"] == "hot"
    assert snap["counts"] == {"firing": 1}
    assert snap["instances"][0]["suppressed"] is True
    assert snap["silences"][0]["rule"] == "hot" and pump0 == {}
    assert snap2["counts"] == {"firing": 1}
    assert not snap2["instances"][0].get("suppressed")
    assert snap2["silences"] == []
    assert (pump1, pump2) == ({"mem": 1}, {})
    (doc,) = docs
    assert doc["refire"] is True and doc["to"] == "firing"
    assert acked["acked_instances"] == 1 and snap3["instances"][0]["acked"]


def _case_silence_validation(P, d):
    plane = P.alerts.AlertPlane()
    plane.configure([P.alerts.parse_alert("a:rate(mrtpu_x_total):>:1")])
    try:
        out = [_raised(lambda: plane.silence("nope", 10.0, now=T0)),
               _raised(lambda: plane.silence("a", 0.0, now=T0)),
               _raised(lambda: plane.ack("nope"))]
        plane.silence("*", 10.0, now=T0)
        out.append(plane.snapshot(now=T0))
    finally:
        plane.reset()
    return out


def test_silence_and_ack_validation(tmp_path):
    nope, zero, ack, snap = _both(_case_silence_validation, tmp_path)
    assert "unknown alert rule" in nope[1] and "unknown alert rule" in ack[1]
    assert "duration must be > 0" in zero[1]
    assert snap["silences"][0]["rule"] == "*"


# -- anomaly + burn evaluation ------------------------------------------------

def _case_anomaly(P, d):
    h = _probe_hist(P, d, [float(i) for i in range(10)] + [59.0])
    plane = P.alerts.AlertPlane(flap_damp_s=0.0)
    plane.configure(
        [P.alerts.parse_alert(f"spike:anomaly({FAMILY}[10]):gt:10")])
    try:
        plane.evaluate(history=h, now=T0 + 30.0)
        out = [plane.snapshot(now=T0 + 30.0)]
        plane.evaluate(history=h, now=T0 + 100.0)
        out.append(plane.snapshot(now=T0 + 100.0))
    finally:
        plane.reset()
        h.close()
    return out


def test_anomaly_rule_scores_spike_against_baseline(tmp_path):
    early, snap = _both(_case_anomaly, tmp_path)
    assert early["instances"] == []
    assert snap["counts"] == {"firing": 1}
    assert snap["instances"][0]["value"] > 10


def _case_burn(P, d, monkeypatch):
    monkeypatch.setattr(
        P.slo.PLANE, "evaluate",
        lambda **kw: {"tenants": {"t0": {"avail": {
            "burn_short": 9.9, "burn_long": 3.0}}}})
    plane = P.alerts.AlertPlane(flap_damp_s=0.0)
    plane.configure([P.alerts.parse_alert("b:burn(avail):>:2",
                                          objectives=["avail"])])
    try:
        plane.evaluate(now=T0)
        return plane.snapshot(now=T0)
    finally:
        plane.reset()


def test_burn_rule_reads_slo_plane(tmp_path, monkeypatch):
    snap = _both(_case_burn, tmp_path, None, monkeypatch)
    (inst,) = snap["instances"]
    assert inst["state"] == "firing" and inst["value"] == 3.0
    assert inst["labels"] == {"tenant": "t0", "objective": "avail"}


def _case_no_history(P, d):
    plane = P.alerts.AlertPlane()
    plane.configure([P.alerts.parse_alert("a:rate(mrtpu_x_total):>:1")])
    try:
        plane.evaluate(history=None, now=T0)
        return plane.snapshot(now=T0)
    finally:
        plane.reset()


def test_threshold_rule_without_history_surfaces_error(tmp_path):
    (rule,) = _both(_case_no_history, tmp_path)["rules"]
    assert "needs the history plane" in rule["last_error"]


# -- real sinks ---------------------------------------------------------------

class _Hook(BaseHTTPRequestHandler):
    """A webhook receiver: every POSTed body lands in ``hits``."""

    hits: list

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        self.hits.append(json.loads(self.rfile.read(n)))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *a):
        pass


@contextlib.contextmanager
def _webhook():
    hits = []
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              type("Hook", (_Hook,), {"hits": hits}))
    thr = threading.Thread(target=srv.serve_forever, daemon=True)
    thr.start()
    try:
        yield f"127.0.0.1:{srv.server_address[1]}", hits
    finally:
        srv.shutdown()
        srv.server_close()
        thr.join(timeout=10)


def _case_webhook(P, d):
    with _webhook() as (addr, hits):
        sink = P.alerts.WebhookSink("hook", addr)
        sink.deliver({"rule": "hot", "to": "firing", "seq": 3})
        return list(hits)


def test_webhook_sink_posts_notification(tmp_path):
    assert _both(_case_webhook, tmp_path) == [
        {"rule": "hot", "to": "firing", "seq": 3}]


def _case_exec(P, d):
    out = d / "notify.jsonl"
    P.alerts.ExecSink("tee", f"sh -c 'cat >> {out}'").deliver(
        {"rule": "hot", "to": "firing", "seq": 7})
    bad = _raised(lambda: P.alerts.ExecSink("bad", "false").deliver(
        {"rule": "hot"}))
    return [out.read_text(), bad, P.alerts.EXEC_SINK_TIMEOUT_S]


def test_exec_sink_pipes_json_and_propagates_failure(tmp_path):
    text, bad, timeout = _both(_case_exec, tmp_path)
    assert json.loads(text)["seq"] == 7
    assert bad[0] in ("OSError", "IOError") and timeout == 10.0


# -- surfaces: validator, statusz, bundle -------------------------------------

def _configured_global_plane(P, d, h):
    P.alerts.PLANE.configure(
        [P.alerts.parse_alert(f"hot:increase({FAMILY}[60]):>:5")],
        log_dir=str(d / "alerts"))
    P.alerts.PLANE.evaluate(history=h, now=T0 + 10.0)


VALIDATE_MUTATIONS = [
    (lambda d: d.__setitem__("kind", "mrtpu-alert"), "kind"),
    (lambda d: d.__setitem__("snapshot", []), "snapshot"),
    (lambda d: d["snapshot"].__setitem__("rules", []), "rules"),
    (lambda d: d["snapshot"]["rules"][0].pop("name"), "no name"),
    (lambda d: d["snapshot"]["rules"][0].__setitem__("op", "beyond"), "op"),
    (lambda d: d["snapshot"]["instances"][0].__setitem__(
        "state", "screaming"), "state"),
    (lambda d: d["snapshot"].__setitem__("instances", {}), "instances"),
    (lambda d: d["snapshot"].__setitem__("counts", [3]), "counts")]

#: more refusals, one per remaining branch of validate_alerts
MORE_MUTATIONS = [
    lambda d: d.clear(),
    lambda d: d["snapshot"]["rules"].__setitem__(0, "r"),
    lambda d: d["snapshot"]["rules"][0].__setitem__("threshold", "5"),
    lambda d: d["snapshot"]["rules"][0].__setitem__("kind", "ratio"),
    lambda d: d["snapshot"]["instances"].__setitem__(0, "firing"),
    lambda d: d["snapshot"]["instances"][0].__setitem__("labels", []),
    lambda d: d["snapshot"].pop("counts"),
    lambda d: d["snapshot"].pop("rules"),
]


def _case_validate(P, d):
    h = _probe_hist(P, d, [0.0, 9.0])
    try:
        _configured_global_plane(P, d, h)
        doc = json.loads(json.dumps(P.alerts.alertz_doc(), default=float))
        P.alerts.validate_alerts(doc)
        out = [doc]
        for mutate, _msg in VALIDATE_MUTATIONS:
            bad = json.loads(json.dumps(doc))
            mutate(bad)
            out.append(_raised(lambda: P.alerts.validate_alerts(bad)))
    finally:
        P.alerts.PLANE.reset()
        h.close()
    return out


def test_validate_alerts_is_strict(tmp_path, clock):
    doc, *refused = _both(_case_validate, tmp_path, clock)
    assert doc["kind"] == "mrtpu-alerts" and doc["time"] == T0
    for (_m, msg), r in zip(VALIDATE_MUTATIONS, refused):
        assert r[0] == "ValueError" and msg in r[1], (msg, r)


def test_validate_alerts_refuses_the_same_documents(tmp_path, clock):
    """One document from each package's plane: both validators accept
    both, and refuse each mutation of either with the same message."""
    docs = _both(_case_validate, tmp_path, clock)
    doc = docs[0]
    for P in PKGS.values():
        P.alerts.validate_alerts(json.loads(json.dumps(doc)))
        P.alerts.validate_alerts({"kind": "mrtpu-alerts", "version": 1,
                                  "snapshot": {}})
    for mutate in [m for m, _ in VALIDATE_MUTATIONS] + MORE_MUTATIONS:
        got = {}
        for name, P in PKGS.items():
            bad = json.loads(json.dumps(doc))
            mutate(bad)
            got[name] = _raised(lambda: P.alerts.validate_alerts(bad))
        assert got["port"] == got["jax"] and got["port"] is not None, got


def _case_statusz_bundle(P, d):
    h = _probe_hist(P, d, [0.0, 9.0])
    try:
        out = [P.alerts.alerts_snapshot(),
               P.statusz.alerts_snapshot_section(),
               "alerts" in P.statusz.cluster_status(
                   P.docstore.MemoryDocStore())]
        _configured_global_plane(P, d, h)
        out += [P.statusz.alerts_snapshot_section(),
                P.statusz.cluster_status(
                    P.docstore.MemoryDocStore())["alerts"]]
        bundle = str(d / "bundle")
        P.profile.write_bundle(bundle)
        out += [os.path.exists(os.path.join(bundle, "alerts.json")),
                P.profile.load_bundle(bundle)["alerts"]]
        with open(os.path.join(bundle, "alerts.json"), "w") as f:
            json.dump({"kind": "mrtpu-alerts", "version": 1,
                       "snapshot": {"rules": "?"}}, f)
        out.append(_raised(lambda: P.profile.load_bundle(bundle)))
    finally:
        P.alerts.PLANE.reset()
        h.close()
    return out


def test_statusz_and_bundle_carry_alerts(tmp_path, clock):
    (empty, empty_sec, listed, sec, snap, written, loaded,
     refused) = _both(_case_statusz_bundle, tmp_path, clock)
    assert empty == {} and empty_sec == {} and listed is False
    assert sec["counts"] == {"firing": 1}
    assert snap["counts"] == {"firing": 1}
    assert written and loaded["snapshot"]["counts"] == {"firing": 1}
    assert refused[0] == "ValueError"


def test_port_bundle_alerts_are_read_by_jax(tmp_path, clock):
    """A port bundle's ``alerts.json`` passes the JAX ``validate_alerts``
    and the JAX ``load_bundle`` returns the same document."""
    h = _probe_hist(PKGS["port"], tmp_path, [0.0, 9.0])
    try:
        _configured_global_plane(PKGS["port"], tmp_path, h)
        out = str(tmp_path / "bundle")
        tprofile.write_bundle(out, history=h)
    finally:
        talerts.PLANE.reset()
        h.close()
    with open(os.path.join(out, "alerts.json")) as f:
        doc = json.load(f)
    jalerts.validate_alerts(doc)
    assert doc["snapshot"]["counts"] == {"firing": 1}
    loaded = jprofile.load_bundle(out)
    assert loaded["alerts"] == doc
    assert loaded["history"] == tprofile.load_bundle(out)["history"]


def _case_render(P, d, clock):
    h = _probe_hist(P, d, [0.0, 9.0])
    try:
        _configured_global_plane(P, d, h)
        clock.t = T0 + 42.0
        P.alerts.PLANE.ack("hot")
        return "\n".join(P.cli._render_alerts(P.alerts.alerts_snapshot()))
    finally:
        P.alerts.PLANE.reset()
        h.close()


def test_cli_render_alerts_section(tmp_path, clock):
    text = _both(_case_render, tmp_path, clock, clock)
    assert "alerts: 1 rule(s)" in text
    assert "FIRING" in text and "hot" in text and "acked" in text
    assert "32s" in text


# -- the alert log across the packages ---------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_alert_log_written_by_one_package_replays_in_the_other(
        tmp_path, writer, reader):
    """A writer plane walks a rule to firing (delivered once), is
    silenced and acked, and stops; the other package's plane configures
    over the same directory: its snapshot equals the writer's (but for
    the replay count), later sweeps with the condition still true
    append no transition, and its pump delivers nothing again."""
    W, R = PKGS[writer], PKGS[reader]
    h = _probe_hist(W, tmp_path, [0.0, 9.0, 12.0])
    rules = [f"hot:increase({FAMILY}[60]):>:5:5",
             f"cold:increase({FAMILY}[60]):<:1"]
    log_dir = str(tmp_path / "alerts")
    t = T0 + 20.0
    wsink = _MemSink(name="pager")
    wplane = W.alerts.AlertPlane(flap_damp_s=0.0)
    wplane.configure([W.alerts.parse_alert(s) for s in rules],
                     log_dir=log_dir, gen_fn=lambda: 3, sinks=[wsink])
    wplane.evaluate(history=h, now=t)
    wplane.evaluate(history=h, now=t + 6.0)
    assert wplane.pump() == {"pager": 1}
    wplane.silence("cold", 600.0, now=t + 6.0)
    wplane.ack("hot")
    want = wplane.snapshot(now=t + 7.0)
    wplane.reset()
    assert want["counts"] == {"firing": 1}
    n_log = len(_log(tmp_path))

    rsink = _MemSink(name="pager")
    rplane = R.alerts.AlertPlane(flap_damp_s=0.0)
    rplane.configure([R.alerts.parse_alert(s) for s in rules],
                     log_dir=log_dir, gen_fn=lambda: 3, sinks=[rsink])
    try:
        got = rplane.snapshot(now=t + 7.0)
        assert got["log"].pop("replayed") == n_log
        want["log"].pop("replayed")
        assert got == want
        rh = R.history.MetricHistory(str(tmp_path / "hist"))
        for dt in (8.0, 9.0, 10.0):
            rplane.evaluate(history=rh, now=t + dt)
        assert rplane.pump() == {} and rsink.docs == []
        rh.close()
    finally:
        rplane.reset()
        h.close()
    entries = _log(tmp_path)
    assert len(entries) == n_log
    assert [e["to"] for e in entries if e.get("kind") == "transition"
            and e["rule"] == "hot"] == ["pending", "firing"]
    assert [d["to"] for d in wsink.docs] == ["firing"]


# -- /queryz, /alertz and the CLI across the four pairings -------------------

PUSHED = "\n".join([
    '# TYPE mrtpu_kernel_launches_total counter',
    'mrtpu_kernel_launches_total{kernel="radix_onesweep"} 64',
    'mrtpu_kernel_launches_total{kernel="radix_upfront"} 8',
    '# TYPE mrtpu_device_waves_total counter',
    'mrtpu_device_waves_total{task="wc"} 2',
    '# TYPE mrtpu_device_seconds_total counter',
    'mrtpu_device_seconds_total{stage="compute"} 0.125',
    '# TYPE mrtpu_device_memory_bytes gauge',
    'mrtpu_device_memory_bytes{device="0"} 123456789',
    ""])

RULE = ("onesweep_ran:increase(mrtpu_kernel_launches_total"
        "{kernel=radix_onesweep}[300]):gt:0")


def _push(srv, text, proc="runner-1"):
    cnn = http.client.HTTPConnection(srv.host, srv.port, timeout=10)
    try:
        cnn.request("POST", "/telemetry", body=json.dumps(
            {"proc": proc, "role": "runner", "pid": 1, "spans": [],
             "metrics": text}).encode())
        r = cnn.getresponse()
        r.read()
        assert r.status == 200
    finally:
        cnn.close()


def _run_cli(P, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = P.cli.main(argv)
    return rc, out.getvalue()


def _plane_lines(text):
    """The history row and the alerts block of a ``status`` render."""
    keep, in_alerts = [], False
    for line in text.splitlines():
        if line.startswith("alerts:"):
            in_alerts = True
        elif not line.startswith("  "):
            in_alerts = False
        if in_alerts or line.startswith("history:"):
            keep.append(line)
    return keep


def test_queryz_alertz_and_cli_across_the_four_pairings(tmp_path, clock):
    """A docserver of each package with the history and one rule, fed
    the same push; each package's client and CLI read it.  All four
    pairings give equal answers and equal text."""
    got = {}
    for sname, S in PKGS.items():
        root = tmp_path / "srv"
        shutil.rmtree(root, ignore_errors=True)
        clock.t = T0
        srv = S.ds.DocServer(history_dir=str(root / "hist"),
                             alert_rules=[RULE],
                             alert_interval=3600.0).start_background()
        url = f"http://{srv.host}:{srv.port}"
        try:
            _push(srv, PUSHED)
            clock.t = T0 + 5.0
            _push(srv, PUSHED.replace(" 64\n", " 128\n"))
            S.alerts.PLANE.evaluate(history=srv.history,
                                    collector=srv.collector)
            for cname, C in PKGS.items():
                client = C.ds.HttpDocStore(f"{srv.host}:{srv.port}")
                try:
                    res = {
                        "query": client.queryz({
                            "metric": "mrtpu_kernel_launches_total",
                            "match": ["kernel=radix_onesweep"],
                            "fn": "increase", "start": -300}),
                        "raw": client.queryz({
                            "metric": "mrtpu_device_waves_total",
                            "fn": "raw", "start": -300, "step": 1}),
                        "top": client.queryz({"op": "top", "k": 5}),
                        "trends": client.queryz({"op": "trends"}),
                        "alertz": client.alertz(),
                        "history_row": client.statusz()["history"],
                    }
                finally:
                    client.close()
                for cmd in (["history", url, "--metric",
                             "mrtpu_kernel_launches_total", "--label",
                             "kernel=radix_onesweep", "--range", "300"],
                            ["history", url, "--metric",
                             "mrtpu_device_waves_total", "--json"],
                            ["top", url, "--k", "3"],
                            ["alerts", url], ["alerts", url, "--json"]):
                    res[" ".join(cmd[:1] + cmd[2:])] = _run_cli(C, cmd)
                rc, text = _run_cli(C, ["status", url])
                res["status"] = (rc, _plane_lines(text))
                got[(sname, cname)] = res
            for cname, C in PKGS.items():
                client = C.ds.HttpDocStore(f"{srv.host}:{srv.port}")
                try:
                    got[(sname, cname)]["ack"] = client.alert_op(
                        "ack", "onesweep_ran")
                    got[(sname, cname)]["bad"] = _raised(
                        lambda: client.alert_op("ack", "nope"))
                finally:
                    client.close()
        finally:
            srv.shutdown()
    first = got[("jax", "jax")]
    for pair, res in got.items():
        assert res == first, pair
    (series,) = first["query"]["series"]
    assert series["points"][-1][1] == 128.0
    assert first["alertz"]["snapshot"]["counts"] == {"firing": 1}
    assert first["alerts"][0] == 0 and "FIRING onesweep_ran" in \
        first["alerts"][1]
    assert first["status"][0] == 0
    assert [ln for ln in first["status"][1] if ln.startswith("history:")]
    assert first["status"][1][0].startswith("alerts: 1 rule(s)")
    assert first["ack"] == {"rule": "onesweep_ran", "acked_instances": 1}
    assert "unknown alert rule" in first["bad"][1]


# -- the SIGKILL failover acceptance run (port counterpart) ------------------

LEASE = 1.0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get_json(port: int, path: str, timeout: float = 0.5):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return json.loads(r.read())
    except Exception:
        return None


def _spawn_docserver(port: int, ha_dir: str, extra=()):
    return subprocess.Popen(
        [sys.executable, "-m", "mapreduce_tpu_torch.cli", "docserver",
         "--host", "127.0.0.1", "--port", str(port),
         "--ha-dir", ha_dir, "--ha-lease", str(LEASE)] + list(extra),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=REPO)


def _wait(pred, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.05)
    raise TimeoutError(what)


@pytest.mark.chaos
def test_alert_fires_exactly_once_across_failover(tmp_path):
    """Two port docservers over one HA dir: a threshold rule goes
    pending on the primary, the primary is SIGKILLed mid-window, and the
    promoted standby replays the shared alert log, resumes the pending
    timer and fires exactly once (one webhook delivery); resolved is
    delivered once when the window drains, and ``cli alerts`` against
    the standby shows the lifecycle."""
    with _webhook() as (hook_addr, hits):
        def delivered(to):
            return sum(1 for x in hits if x.get("to") == to)

        ha_dir = str(tmp_path / "ha")
        p1, p2 = _free_port(), _free_port()
        alert_args = [
            "--alert",
            "probe:increase(mrtpu_torch_alertchaos_probe_total[6]):>:4:2",
            "--alert-webhook", f"pager={hook_addr}",
            "--alert-interval", "0.25", "--alert-damp", "0.5"]
        procs = [_spawn_docserver(p1, ha_dir, alert_args),
                 _spawn_docserver(p2, ha_dir, alert_args)]
        reg = tmetrics.Registry()
        probe = reg.counter("mrtpu_torch_alertchaos_probe_total",
                            "failover-spanning alert probe")
        pusher = tcollector.TelemetryPusher(
            f"127.0.0.1:{p1},127.0.0.1:{p2}", role="alertchaos",
            interval=60.0, registry=reg)
        try:
            for port in (p1, p2):
                _wait(lambda port=port: _get_json(port, "/healthz"), 30,
                      f"docserver on {port} never served /healthz")
            roles = _wait(
                lambda: ({p: (_get_json(p, "/healthz") or {}).get("primary")
                          for p in (p1, p2)}
                         if any((_get_json(p, "/healthz") or {}).get(
                             "primary") for p in (p1, p2)) else None),
                30, "no replica ever took the board lease")
            prim_port = p1 if roles[p1] else p2
            stby_port = p2 if prim_port == p1 else p1
            prim = procs[0] if prim_port == p1 else procs[1]
            probe.inc(9)
            _wait(pusher.flush, 30, "telemetry push never succeeded")
            _wait(lambda: (((_get_json(prim_port, "/alertz") or {})
                            .get("snapshot") or {}).get("counts") or {})
                  .get("pending"),
                  20, "the rule never went pending on the primary")
            os.kill(prim.pid, signal.SIGKILL)
            prim.wait(timeout=10)
            assert delivered("firing") == 0, hits
            _wait(lambda: (_get_json(stby_port, "/healthz") or {}).get(
                "primary"), 30, "standby never took over after SIGKILL")
            _wait(lambda: delivered("firing") >= 1, 30,
                  "promoted standby never fired the alert")
            (firing,) = [x for x in hits if x["to"] == "firing"]
            assert firing["rule"] == "probe" and firing["seq"] >= 1
            _wait(lambda: delivered("resolved") >= 1, 40,
                  "resolved was never delivered after the window drained")
            assert delivered("firing") == 1, hits
            assert delivered("resolved") == 1, hits
            out = subprocess.run(
                [sys.executable, "-m", "mapreduce_tpu_torch.cli", "alerts",
                 f"http://127.0.0.1:{stby_port}"],
                stdout=subprocess.PIPE, timeout=30,
                cwd=REPO).stdout.decode()
            assert "alerts: 1 rule(s)" in out and "resolved=1" in out, out
            snap = (_get_json(stby_port, "/alertz") or {}).get(
                "snapshot") or {}
            assert snap["log"]["generation"] >= 2
            assert snap["counts"] == {"resolved": 1}
        finally:
            pusher.stop(flush=False)
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)
