"""The always-on service through the port's command line: the HA
docserver pair, ``submit``, ``tasks`` and ``runner`` (JAX
``cli.py:1835``, ``:1915``, ``:1964``), and the flags and commands that
were once refused by name (ROADMAP A.7, A.8, A.11) and now run.  Every
process binds port 0, waits with a timeout and is killed after it."""

import contextlib
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request
import uuid
from collections import Counter

import pytest

from mapreduce_tpu_torch import cli as tcli
from mapreduce_tpu_torch.coord.docserver import DocServer
from mapreduce_tpu_torch.sched.scheduler import (
    DONE, SchedulerClient, SchedulerConfig)
from mapreduce_tpu_torch.sched.service import wait_for_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60
MOD = "mapreduce_tpu_torch.examples.wordcount"


def _main(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tcli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _env(token):
    return dict(os.environ, MAPREDUCE_TPU_AUTH=token,
                PYTHONPATH=REPO + os.pathsep + os.environ.get(
                    "PYTHONPATH", ""))


def _cli(*args, env, log):
    """A CLI process: its first stdout lines are read here, its log goes
    to the file *log* (a pipe nobody reads could fill)."""
    with open(log, "w") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "mapreduce_tpu_torch.cli", *args],
            env=env, stdout=subprocess.PIPE, stderr=err, text=True)


def _reap(procs, sig=signal.SIGTERM):
    for p in procs:
        if p.poll() is None:
            p.send_signal(sig)
    for p in procs:
        try:
            p.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


def _healthz(addr):
    with urllib.request.urlopen(f"http://{addr}/healthz",
                                timeout=10) as r:
        return json.loads(r.read())


def test_submit_and_tasks_against_a_docserver():
    srv = DocServer(auth_token="tok", scheduler_config=SchedulerConfig(
        tenant_max_queued_tasks=1)).start_background()
    try:
        url = f"http://{srv.host}:{srv.port}"
        rc, out, _ = _main(["submit", url, "acme", MOD, MOD, MOD, MOD,
                            "--auth", "tok", "--device",
                            "--est-jobs", "3", "--init-args",
                            json.dumps({"device_sort_impl": "radix"})])
        assert rc == 0
        doc = json.loads(out)
        assert doc["state"] == "QUEUED" and doc["tenant"] == "acme"
        assert doc["params"]["device"] is True
        assert doc["params"]["finalfn"] == MOD
        assert doc["params"]["init_args"] == {"device_sort_impl": "radix"}
        rc, _, err = _main(["submit", url, "acme", MOD, MOD, MOD, MOD,
                            "--auth", "tok"])
        assert rc == 3 and "REJECTED (queued_tasks)" in err
        rc, _, err = _main(["tasks", url])
        assert rc == 2 and "auth" in err
        rc, out, _ = _main(["tasks", url, "--json", "--auth", "tok"])
        listing = json.loads(out)
        assert rc == 0 and [t["_id"] for t in listing["tasks"]] == [
            doc["_id"]]
        assert listing["sched"]["tenants"]["acme"]["queued_jobs"] == 3
        rc, out, _ = _main(["tasks", url, "--auth", "tok"])
        assert rc == 0 and "tenant acme: queued=1" in out
        assert f"QUEUED    {doc['_id']}" in out
        rc, out, _ = _main(["tasks", url, "--auth", "tok", "--cancel",
                            doc["_id"]])
        assert rc == 0 and json.loads(out)["state"] == "CANCELLED"
        rc, _, err = _main(["tasks", url, "--auth", "tok", "--cancel",
                            doc["_id"]])
        assert rc == 1 and "already terminal" in err
    finally:
        srv.shutdown()


def test_ha_docserver_pair_and_runner_processes(tmp_path):
    """Two ``docserver --ha-dir`` processes (one primary by /healthz),
    one ``runner`` over both with ``--torch-device cpu``, a device task
    and a host task submitted with ``submit``; SIGKILL of the primary
    while they are queued; the standby promotes and both reach DONE."""
    token = uuid.uuid4().hex
    env = _env(token)
    words = Counter()
    files = []
    for i in range(3):
        text = f"alpha beta p{i} gamma alpha delta\n" * 30
        p = tmp_path / f"f{i}.txt"
        p.write_text(text)
        files.append(str(p))
        words.update(text.split())
    ha = str(tmp_path / "ha")
    boards = [_cli("docserver", "--host", "127.0.0.1", "--port", "0",
                   "--ha-dir", ha, "--ha-lease", "0.8", "--max-inflight",
                   "2", env=env, log=tmp_path / f"board{i}.err")
              for i in range(2)]
    procs = list(boards)
    try:
        addrs = [re.search(r"job board at http://([\d.]+:\d+)",
                           p.stdout.readline()).group(1) for p in boards]
        deadline = time.monotonic() + 20
        roles = []
        while time.monotonic() < deadline:
            roles = [_healthz(a)["primary"] for a in addrs]
            if sum(roles) == 1:
                break
            time.sleep(0.05)
        assert sum(roles) == 1, roles
        prim = roles.index(True)
        url = "http://" + ",".join(addrs)
        storage = f"shared:{tmp_path / 'st'}"
        init = {"files": files, "num_reducers": 3, "keep_results": True,
                "device_chunk_len": 1024, "device_local_capacity": 512,
                "device_exchange_capacity": 256,
                "device_out_capacity": 512, "device_sort_impl": "radix"}
        ids = []
        for tenant, extra in (("dev", ["--device"]), ("host", [])):
            rc, out, err = _main(
                ["submit", url, tenant, MOD, MOD, MOD, MOD, MOD, storage,
                 "--db", f"cli_{tenant}", "--init-args", json.dumps(init),
                 "--auth", token] + extra)
            assert rc == 0, err
            ids.append(json.loads(out)["_id"])
        boards[prim].kill()
        boards[prim].wait(timeout=TIMEOUT)
        runner = _cli("runner", url, "--workers", "2", "--max-inflight",
                      "2", "--partitions", "2", "--torch-device", "cpu",
                      "--telemetry-interval", "0.5", env=env,
                      log=tmp_path / "runner.err")
        procs.append(runner)
        banner = runner.stdout.readline()
        # the runner's engines run over the partitions it was given
        assert "runner serving" in banner and "2 partition(s)" in banner, \
            banner
        client = SchedulerClient(",".join(addrs), auth_token=token)

        class _Sched:  # wait_for_state's view of the /tasks listing
            @staticmethod
            def get(tid):
                return next((t for t in client.list()["tasks"]
                             if t["_id"] == tid), None)

        for tid in ids:
            wait_for_state(_Sched, tid, DONE, timeout=TIMEOUT, poll=0.1)
            # the runner's admission advisor routed each task to the
            # placement it registered: its own host id
            assert _Sched.get(tid)["mesh"] == \
                f"{socket.gethostname()}:{runner.pid}"
        assert _healthz(addrs[1 - prim]) == {"ok": True, "role": "primary",
                                             "primary": True}
        from mapreduce_tpu_torch.utils.serialization import parse_record

        for tenant in ("dev", "host"):
            got = Counter()
            for f in (tmp_path / "st").glob(f"cli_{tenant}.result.P*"):
                for line in f.read_text().splitlines():
                    k, v = parse_record(line)
                    got[k] += v[0]
            assert got == words, tenant
        client.close()
        _reap([runner], signal.SIGINT)
        assert runner.returncode == 0, (
            tmp_path / "runner.err").read_text()[-2000:]
    finally:
        _reap(procs)


@pytest.mark.parametrize("argv,item", [
    (["docserver", "--alert-rules", "rules.json"], "A.8c-2"),
    # runner --compile-cache is ported (ROADMAP A.8b;
    # tests/test_torch_compile.py takes it), and --slo on runner and
    # docserver (A.8c-1; tests/test_torch_operator_cli.py takes it)
    (["docserver", "--alert-interval", "5"], "A.8c-2"),
    (["docserver", "--history-dir", "/x"], "A.8c-2"),
    (["docserver", "--alert", "r:e:gt:1"], "A.8c-2"),
])
def test_service_flags_still_refused_by_name(monkeypatch, argv, item):
    """The service flags once refused as ROADMAP *item* are ported: the
    port's ``docserver`` hands its ``DocServer`` what the JAX CLI hands
    the JAX one (both constructors stubbed)."""
    from mapreduce_tpu import cli as jcli
    from mapreduce_tpu.coord import docserver as jds
    from mapreduce_tpu_torch.coord import docserver as tds

    class Built(Exception):
        pass

    seen = {}
    for name, cli_mod, ds_mod in (("port", tcli, tds), ("jax", jcli, jds)):
        def build(*a, _name=name, **kw):
            seen[_name] = kw
            raise Built

        monkeypatch.setattr(ds_mod, "DocServer", build)
        with pytest.raises(Built):
            cli_mod.main(argv + ["--port", "0"])
    assert seen["port"] == seen["jax"]
    flag = argv[1].lstrip("-").replace("-", "_")
    got = {"alert_rules": seen["port"].get("alert_rules_file"),
           "alert_interval": seen["port"]["alert_interval"],
           "history_dir": seen["port"]["history_dir"],
           "alert": seen["port"]["alert_rules"]}[flag]
    assert got in (argv[2], float(argv[2]) if flag == "alert_interval"
                   else None, [argv[2]]), (flag, got)
    assert item == "A.8c-2"


@pytest.mark.parametrize("cmd,item", [("drain", "A.11"),
                                      ("alerts", "A.8c-2")])
def test_unported_commands_refused_by_name(tmp_path, cmd, item):
    """Both were refused by name before the port had them: ``drain``
    (ROADMAP A.11) now answers a board that has no such fleet host with
    exit 2 and the JAX message, ``alerts`` (A.8c-2) runs against a board
    with one rule."""
    assert cmd not in tcli.NOT_PORTED_COMMANDS, item
    if cmd == "drain":
        board = DocServer().start_background()
        try:
            rc, _, err = _main([cmd, f"http://{board.host}:{board.port}",
                                "nohost:1", "--timeout", "0"])
        finally:
            board.shutdown()
        assert rc == 2 and "no such fleet host: 'nohost:1'" in err, err
        return
    board = DocServer(history_dir=str(tmp_path / "hist"),
                      alert_rules=["r:increase(mrtpu_x_total[60]):gt:0"],
                      alert_interval=3600.0).start_background()
    try:
        rc, out, err = _main([cmd, f"http://{board.host}:{board.port}"])
    finally:
        board.shutdown()
    assert rc == 0 and "alerts: 1 rule(s)" in out, err


def test_submit_program_lands_in_the_task_params():
    """``submit --program`` (once refused as ROADMAP A.7) stores the
    admission advisor's key in the task's params; without it the task
    carries none."""
    board = DocServer().start_background()
    try:
        url = f"http://{board.host}:{board.port}"
        docs = []
        for extra in (["--program", "wave"], []):
            rc, out, err = _main(["submit", url, "acme", "m", "m", "m",
                                  "m", "--db", f"db{len(docs)}"] + extra)
            assert rc == 0, err
            docs.append(json.loads(out.strip().splitlines()[-1]))
        assert docs[0]["params"]["program"] == "wave"
        assert "program" not in docs[1]["params"]
    finally:
        board.shutdown()


def test_runner_help_names_what_it_leaves_out():
    """The runner's help names nothing that waits any more: not A.7,
    whose advisor it runs, nor A.8, whose SLO objectives it takes with
    --slo, nor A.11, whose fleet it joins (and whose drain it obeys)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        tcli.main(["runner", "--help"])
    text = " ".join(out.getvalue().split())
    assert "--slo" in text and "--partitions" in text
    assert "A.7" not in text and "A.8" not in text and "advisor" in text
    assert "A.11" not in text and "fleet" in text and "drain" in text


def test_docserver_rejects_root_with_ha_dir(tmp_path):
    rc, _, err = _main(["docserver", "--port", "0", "--root",
                        str(tmp_path / "r"), "--ha-dir",
                        str(tmp_path / "h")])
    assert rc == 2 and "mutually exclusive" in err
