"""The operator commands and surfaces of the port on the CPU: ``status``,
``profile`` and ``diagnose`` against an in-process port docserver,
``/statusz`` and every JAX docserver path, ``--slo`` on ``docserver``
and ``runner``, the history and alert flags and commands, and the flight recorder that
``--trace-out`` arms (one SIGTERMed child process, under a hard
timeout).  Every wait has a deadline.
"""

import http.client
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading

import pytest

from mapreduce_tpu.obs import profile as jprofile
from mapreduce_tpu_torch import cli as tcli
from mapreduce_tpu_torch.coord import docserver as tdocserver
from mapreduce_tpu_torch.coord.docserver import DocServer, HttpDocStore
from mapreduce_tpu_torch.obs import flight as tflight
from mapreduce_tpu_torch.obs import profile as tprofile
from mapreduce_tpu_torch.obs import slo as tslo
from mapreduce_tpu_torch.obs.metrics import REGISTRY, parse_prometheus
from mapreduce_tpu_torch.obs.trace import TRACER

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: seconds a child process may take, start to exit
CHILD_TIMEOUT = 60


@pytest.fixture
def board():
    """A port docserver with one task's docs on its board and a
    breaching queue-wait objective observed in this process."""
    srv = DocServer().start_background()
    url = f"http://{srv.host}:{srv.port}"
    store = HttpDocStore(f"{srv.host}:{srv.port}")
    store.insert("opwc.task", {"_id": "unique", "status": 2,
                               "iteration": 1, "device": True})
    store.insert("opwc.map_jobs", {"_id": "m0", "status": 0})
    store.close()
    with TRACER.span("job", worker="w-op", phase="map"):
        pass
    saved = list(tslo.PLANE.objectives)
    tslo.configure([tslo.parse_objective("queue_wait:p99:0.000001")])
    tslo.observe_queue_wait("op-tenant", 0.25)
    yield srv, url
    tslo.configure(saved)
    srv.shutdown()


def _get(srv, path):
    cnn = http.client.HTTPConnection(srv.host, srv.port, timeout=10)
    try:
        cnn.request("GET", path)
        r = cnn.getresponse()
        return r.status, r.read()
    finally:
        cnn.close()


def test_statusz_is_served(board):
    srv, _ = board
    status, body = _get(srv, "/statusz")
    assert status == 200
    snap = json.loads(body)
    assert snap["tasks"]["opwc"]["phases"]["map"] == {"WAITING": 1}
    assert snap["slo"]["tenants"]["op-tenant"]["queue_wait"]["breaching"]
    assert "telemetry" in snap and "build" in snap


@pytest.mark.parametrize("path", ["/queryz", "/alertz"])
def test_history_paths_answer_404_naming_their_item(board, path):
    """On a board without the history plane (or without alert rules)
    the path answers 404 with the JAX docserver's body, which names the
    flag that arms it."""
    from mapreduce_tpu.coord import docserver as jds

    srv, _ = board
    status, body = _get(srv, path)
    jsrv = jds.DocServer().start_background()
    try:
        assert (status, body) == _get(jsrv, path)
    finally:
        jsrv.shutdown()
    flag = {"/queryz": "--history-dir", "/alertz": "--alert"}[path]
    assert status == 404 and flag in json.loads(body)["error"]


def _jax_docserver_paths():
    """Every path the JAX docserver answers, read as text from its
    source: the GET allow-list and the POST branches."""
    src = (ROOT / "mapreduce_tpu" / "coord" / "docserver.py").read_text()
    get = re.search(r'if path not in \(("/metrics".*?)\):', src, re.S)
    paths = set(re.findall(r'"(/[a-z]+)"', get.group(1)))
    paths |= set(re.findall(r'if self\.path == "(/[a-z]+)"', src))
    return paths


def test_every_jax_docserver_path_is_served_or_named(board):
    srv, _ = board
    paths = _jax_docserver_paths()
    assert {"/metrics", "/statusz", "/tracez", "/clusterz", "/healthz",
            "/tasks", "/queryz", "/alertz", "/telemetry"} <= paths
    served = set(tdocserver.GET_PATHS) | {"/rpc", "/telemetry", "/tasks"}
    assert not hasattr(tdocserver, "NOT_PORTED")
    for path in paths:
        assert path in served, path
        if path in ("/queryz", "/alertz"):
            # served, and 404 on this board: it has no history plane
            # and no alert rules (test_history_paths_answer_404_...)
            assert _get(srv, path)[0] == 404, path
        elif path in tdocserver.GET_PATHS:
            assert _get(srv, path)[0] == 200, path


def test_status_renders_the_live_board(board, capsys):
    _, url = board
    assert tcli.main(["status", url]) == 0
    out = capsys.readouterr().out
    assert out.startswith("build: mrtpu ")
    assert "[opwc]  status=2  iteration=1  (device plane)" in out
    assert "serving SLOs (queue_wait p99<1e-06s/600s+60s):" in out
    assert "tenant op-tenant p99 queue_wait" in out and "BREACHING" in out
    assert tcli.main(["status", url, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["tasks"]["opwc"]


def test_status_refuses_a_board_without_a_wire(capsys):
    assert tcli.main(["status", "mem://nowhere"]) == 2
    assert "docserver address" in capsys.readouterr().err


def test_profile_bundle_reloads_in_both_packages(board, tmp_path, capsys):
    _, url = board
    out = str(tmp_path / "bundle")
    assert tcli.main(["profile", url, "--out", out]) == 0
    assert "profile bundle written to" in capsys.readouterr().out
    b = tprofile.load_bundle(out)
    assert b["statusz"]["tasks"]["opwc"]["status"] == 2
    assert {"cluster_trace.json", "diagnosis.json", "slo.json"} \
        <= set(b["manifest"]["files"])
    assert b["slo"]["snapshot"]["tenants"]["op-tenant"]
    assert b["diagnosis"]["slo"]["objectives"][0]["breaching"]
    jb = jprofile.load_bundle(out)
    assert jb["cluster_trace"] == b["cluster_trace"]
    assert jb["slo"] == b["slo"]


def test_diagnose_live_and_from_a_file(board, tmp_path, capsys):
    _, url = board
    assert tcli.main(["diagnose", url, "--json"]) == 0
    live = json.loads(capsys.readouterr().out)
    assert "op-tenant" in {e["tenant"] for e in live["slo"]["objectives"]}
    assert any(n.startswith("tenant op-tenant p99 queue_wait")
               for n in live["notes"])
    path = tmp_path / "cluster_trace.json"
    assert tcli.main(["timeline", url, "--out", str(path)]) == 0
    capsys.readouterr()
    assert tcli.main(["diagnose", str(path)]) == 0
    text = capsys.readouterr().out
    assert text.startswith("cluster diagnosis (")
    assert "serving SLOs:" in text and "BREACHING" in text


class _Served(Exception):
    """Ends a command where it would start serving."""


def test_docserver_accepts_slo(monkeypatch):
    seen = {}

    class Stub:
        ha = history = alerts = None
        host, port = "127.0.0.1", 0

        def __init__(self, *a, **kw):
            pass

        def serve_forever(self):
            seen["objectives"] = list(tslo.PLANE.objectives)
            raise KeyboardInterrupt

    saved = list(tslo.PLANE.objectives)
    monkeypatch.setattr(tdocserver, "DocServer", Stub)
    try:
        assert tcli.main(["docserver", "--port", "0",
                          "--slo", "submit_first_result:p99:120",
                          "--slo", "queue_wait:p99:0.000001"]) == 0
    finally:
        tslo.configure(saved)
    assert [(o.name, o.threshold_s) for o in seen["objectives"]] == [
        ("submit_first_result", 120.0), ("queue_wait", 1e-06)]


def test_runner_accepts_slo(monkeypatch):
    from mapreduce_tpu_torch.sched import service

    seen = {}

    def start(self):
        seen["objectives"] = list(tslo.PLANE.objectives)
        raise _Served

    saved = list(tslo.PLANE.objectives)
    monkeypatch.setattr(service.TaskRunner, "start", start)
    try:
        with pytest.raises(_Served):
            tcli.main(["runner", "mem://op-runner", "--workers", "1",
                       "--torch-device", "cpu", "--telemetry-interval",
                       "0", "--no-compile-cache",
                       "--slo", "queue_wait:p50:2:30"])
    finally:
        tslo.configure(saved)
    (obj,) = seen["objectives"]
    assert (obj.name, obj.percentile, obj.threshold_s,
            obj.long_window_s) == ("queue_wait", 0.5, 2.0, 30.0)


class _Serving(Exception):
    """Raised by a stubbed ``serve_forever``: the docserver was built."""


@pytest.mark.parametrize("flag", ["--history-dir", "--alert"])
def test_docserver_still_refuses_the_history_flags(flag, tmp_path,
                                                    monkeypatch, capsys):
    """The flag is accepted and reaches its plane: ``--history-dir``
    arms the durable history on that directory, ``--alert`` the alert
    plane with that rule; the banner names the surface."""
    value = {"--history-dir": str(tmp_path / "hist"),
             "--alert": "r:increase(mrtpu_x_total[60]):gt:0"}[flag]
    built = []

    def serve_forever(self):
        # serve in a thread, so that shutdown() has a loop to stop
        built.append(self.start_background())
        raise _Serving

    monkeypatch.setattr(tdocserver.DocServer, "serve_forever",
                        serve_forever)
    try:
        with pytest.raises(_Serving):
            tcli.main(["docserver", "--host", "127.0.0.1", "--port", "0",
                       flag, value])
        (srv,) = built
        out = capsys.readouterr().out
        if flag == "--history-dir":
            assert srv.history.dir == value and srv.alerts is None
            assert f"durable history at /queryz ({value})" in out
        else:
            assert srv.history is None
            assert [r.name for r in srv.alerts.rules] == ["r"]
            assert "alerting at /alertz (1 rule(s))" in out
    finally:
        for srv in built:
            srv.shutdown()


@pytest.mark.parametrize("cmd", ["history", "top", "alerts"])
def test_history_commands_exit_2_naming_their_item(cmd, tmp_path, capsys):
    """The command runs against a board with the history and one rule,
    fed one push: exit 0 and its output."""
    srv = DocServer(history_dir=str(tmp_path / "hist"),
                    alert_rules=["r:increase(mrtpu_x_total[60]):gt:0"],
                    alert_interval=3600.0).start_background()
    url = f"http://{srv.host}:{srv.port}"
    try:
        srv.collector.push({"proc": "p-op", "role": "runner",
                            "metrics": "mrtpu_x_total 3\n"})
        argv = {"history": ["--metric", "mrtpu_x_total"],
                "top": [], "alerts": []}[cmd]
        capsys.readouterr()
        assert tcli.main([cmd, url] + argv) == 0
        out = capsys.readouterr().out
        want = {"history": "mrtpu_x_total [counter] fn=increase",
                "top": "top 1 counter series",
                "alerts": "alerts: 1 rule(s), all inactive"}[cmd]
        assert want in out, out
    finally:
        srv.shutdown()


def test_not_ported_commands_are_the_fleet_and_the_history():
    """Nothing is left: the fleet's ``drain``, the history's and the
    alert plane's commands are all served."""
    assert tcli.NOT_PORTED_COMMANDS == {}
    assert {"status", "profile", "diagnose", "history", "top",
            "alerts", "drain"} <= set(tcli.COMMANDS)


# -- the flight recorder ------------------------------------------------------


def test_flight_recorder_dumps_once(tmp_path):
    rec = tflight.FlightRecorder(str(tmp_path / "t.json"))
    with TRACER.span("flight-probe"):
        pass
    assert rec.dump() == (rec.trace_path, rec.metrics_path)
    os.remove(rec.trace_path)
    assert rec.dump() is None  # the atexit hook after a SIGTERM
    assert not os.path.exists(rec.trace_path)
    parse_prometheus(open(rec.metrics_path, encoding="utf-8").read())
    rec2 = tflight.FlightRecorder(str(tmp_path / "u.json"),
                                  registry=REGISTRY)
    rec2.disarm()
    assert rec2.dump() is None
    assert not os.path.exists(rec2.metrics_path)


def test_normal_exit_disarms_the_recorder(tmp_path):
    """A command that exports --trace-out leaves no flight files (their
    presence is the abnormal-exit signal)."""
    out = tmp_path / "n.json"
    prev = signal.getsignal(signal.SIGTERM)
    try:
        assert tcli.main(["worker", "mem://op-flight", "db",
                          "--max-iter", "1", "--no-compile-cache",
                          "--trace-out", str(out)]) == 0
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert out.exists()
    assert not os.path.exists(f"{out}.flight.trace.json")
    assert not os.path.exists(f"{out}.flight.metrics.prom")


def test_sigterm_leaves_the_flight_files(tmp_path):
    """A SIGTERMed worker exits 143 and leaves a flight trace that both
    packages' validators accept and a metrics snapshot of its
    registry."""
    from mapreduce_tpu.obs.profile import validate_trace as jvalidate

    out = tmp_path / "w.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mapreduce_tpu_torch.cli", "worker",
         f"dir://{tmp_path}/board", "flightdb", "--max-iter", "100000",
         "--no-compile-cache", "--trace-out", str(out)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    started = threading.Event()

    def reader():
        for line in proc.stderr:
            if "starting" in line:
                started.set()

    threading.Thread(target=reader, daemon=True).start()
    try:
        assert started.wait(CHILD_TIMEOUT), "the worker never started"
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=CHILD_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert rc == 143
    with open(f"{out}.flight.trace.json", encoding="utf-8") as f:
        doc = json.load(f)
    tprofile.validate_trace(doc)
    jvalidate(doc)
    with open(f"{out}.flight.metrics.prom", encoding="utf-8") as f:
        text = f.read()
    parse_prometheus(text)
    assert "mrtpu_worker_claims_total" in text
    assert not out.exists()
