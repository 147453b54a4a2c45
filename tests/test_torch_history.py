"""The port's durable telemetry history (``mapreduce_tpu_torch.obs.history``
and the surfaces that serve it) held against the JAX package's.

Every case of ``tests/test_history.py`` runs through BOTH packages on the
same inputs — explicit ``t=`` / ``now=`` stamps, both packages'
``coord.docstore.now`` monkeypatched to one settable clock — in the same
directory path (wiped between the two runs, so the ``dir`` a snapshot
names is the same), and the two results must be equal: floats with
``==``, bit for bit, and the segment files byte for byte.  Each test
then makes the JAX test's own assertions on the port's result.

Beyond the mirrored cases: segments written by either package are
``load``ed by the other with equal answers, both validators refuse the
same malformed entries, a port bundle's ``history/`` is read by the JAX
``read_history``, and the SIGKILL board-failover acceptance run of
``tests/test_ha_chaos.py`` has its port counterpart.  Every server binds
port 0 (or a probed free port) and every wait has a deadline.
"""

import http.client
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
import types
import urllib.request

import pytest

from mapreduce_tpu import cli as jcli
from mapreduce_tpu.coord import docserver as jds
from mapreduce_tpu.coord import docstore as jdocstore
from mapreduce_tpu.obs import analysis as janalysis
from mapreduce_tpu.obs import collector as jcollector
from mapreduce_tpu.obs import control as jcontrol
from mapreduce_tpu.obs import history as jhistory
from mapreduce_tpu.obs import metrics as jmetrics
from mapreduce_tpu.obs import profile as jprofile
from mapreduce_tpu.obs import slo as jslo
from mapreduce_tpu_torch import cli as tcli
from mapreduce_tpu_torch.coord import docserver as tds
from mapreduce_tpu_torch.coord import docstore as tdocstore
from mapreduce_tpu_torch.obs import analysis as tanalysis
from mapreduce_tpu_torch.obs import collector as tcollector
from mapreduce_tpu_torch.obs import control as tcontrol
from mapreduce_tpu_torch.obs import history as thistory
from mapreduce_tpu_torch.obs import metrics as tmetrics
from mapreduce_tpu_torch.obs import profile as tprofile
from mapreduce_tpu_torch.obs import slo as tslo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": types.SimpleNamespace(
        cli=jcli, ds=jds, docstore=jdocstore, analysis=janalysis,
        collector=jcollector, control=jcontrol, history=jhistory,
        metrics=jmetrics, profile=jprofile, slo=jslo),
    "port": types.SimpleNamespace(
        cli=tcli, ds=tds, docstore=tdocstore, analysis=tanalysis,
        collector=tcollector, control=tcontrol, history=thistory,
        metrics=tmetrics, profile=tprofile, slo=tslo),
}

#: the settable wall clock both packages' ``docstore.now`` read
T_START = 1_000_000.0


class _Clock:
    def __init__(self) -> None:
        self.t = T_START

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


def _hist(P, d, **kw):
    return P.history.MetricHistory(str(d / "hist"), **kw)


def _raised(fn):
    """The class name and message *fn* raises (None when it returns)."""
    try:
        fn()
    except Exception as exc:  # the class and text are the answer here
        return [type(exc).__name__, str(exc)]
    return None


def _segments(h):
    """Every segment file's bytes, by file name."""
    out = {}
    for path in h.segment_paths():
        with open(path, "rb") as f:
            out[os.path.basename(path)] = f.read()
    return out


def _both(case, tmp_path, clock=None, *args):
    """Run *case* once per package in the same directory (wiped between
    the runs, the clock reset) and require equal results."""
    out = {}
    for name, P in PKGS.items():
        d = tmp_path / "run"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir()
        if clock is not None:
            clock.t = T_START
        out[name] = case(P, d, *args)
    assert out["port"] == out["jax"], (out["port"], out["jax"])
    return out["port"]


# -- the append/replay substrate ---------------------------------------------

GOOD = {"v": 1, "proc": "p", "seq": 1, "t": 10.0,
        "s": [["mrtpu_x_total", {"a": "b"}, 2.0, 2.0, "c"]]}

#: malformed entries, one per branch of validate_history
MALFORMED = (
    lambda e: e.pop("proc"),
    lambda e: e.__setitem__("seq", 0),
    lambda e: e.__setitem__("t", "soon"),
    lambda e: e.__setitem__("s", "rows"),
    lambda e: e["s"][0].__setitem__(4, "z"),
    lambda e: e["s"][0].__setitem__(1, ["a", "b"]),
    lambda e: e.__setitem__("v", 2),
    lambda e: e.__setitem__("proc", ""),
    lambda e: e.__setitem__("seq", "1"),
    lambda e: e.__setitem__("t", 0),
    lambda e: e.__setitem__("off", "late"),
    lambda e: e.__setitem__("s", []),
    lambda e: e["s"].append(["mrtpu_y_total", {}, 1.0]),
    lambda e: e["s"][0].__setitem__(0, "other_total"),
    lambda e: e["s"][0].__setitem__(1, {"a": 3}),
    lambda e: e["s"][0].__setitem__(3, "9"),
    lambda e: e["s"][0].__setitem__(2, -1.0),
    lambda e: e["s"][0].__setitem__(4, "g"),
)


def _case_validate(P, d):
    P.history.validate_history(json.loads(json.dumps(GOOD)))
    out = []
    for mutate in MALFORMED[:6]:
        bad = json.loads(json.dumps(GOOD))
        mutate(bad)
        out.append(_raised(lambda: P.history.validate_history(bad)))
    return out


def test_validate_rejects_malformed_entries(tmp_path):
    got = _both(_case_validate, tmp_path)
    assert all(r is not None and r[0] == "HistoryCorruptError"
               for r in got)


def test_validate_history_refuses_the_same_entries(tmp_path):
    """Every branch of the validator, both packages: the same entries
    refused with the same class name and message."""
    def case(P, d):
        out = []
        for mutate in MALFORMED:
            bad = json.loads(json.dumps(GOOD))
            mutate(bad)
            out.append(_raised(lambda: P.history.validate_history(bad)))
        out.append(_raised(lambda: P.history.validate_history([GOOD])))
        return out

    got = _both(case, tmp_path)
    assert got[:-1] == [r for r in got[:-1] if r is not None]
    assert all(r[0] == "HistoryCorruptError" for r in got)


def _case_append(P, d):
    h = _hist(P, d)
    snap = {_k("mrtpu_wc_total", task="wc"): 5.0}
    out = [h.append_snapshot("p0", snap, t=1000.0),
           h.append_snapshot("p0", snap, t=1001.0),
           h.append_snapshot(
               "p0", {_k("mrtpu_wc_total", task="wc"): 9.0}, t=1002.0),
           h.window_increase("mrtpu_wc_total", 999.0, 1003.0),
           _segments(h)]
    h.close()
    return out


def test_append_is_delta_encoded_and_resend_idempotent(tmp_path):
    a1, a2, a3, inc, _segs = _both(_case_append, tmp_path)
    assert (a1, a2, a3) == (True, False, True)
    assert inc == 9.0


def _case_reset(P, d):
    h = _hist(P, d)
    h.append_snapshot("p0", {_k("mrtpu_wc_total"): 9.0}, t=1000.0)
    h.append_snapshot("p0", {_k("mrtpu_wc_total"): 2.0}, t=1010.0)
    out = [h.window_increase("mrtpu_wc_total", 999.0, 1011.0),
           h.window_increase("mrtpu_wc_total", 1005.0, 1011.0),
           _segments(h)]
    h.close()
    return out


def test_counter_reset_is_detected_not_negative(tmp_path):
    whole, tail, _segs = _both(_case_reset, tmp_path)
    assert (whole, tail) == (11.0, 2.0)


def _case_replay(P, d):
    h = _hist(P, d)
    h.append_snapshot("p0", {_k("mrtpu_wc_total"): 5.0}, t=1000.0)
    h.append_snapshot("p0", {_k("mrtpu_wc_total"): 9.0}, t=1010.0)
    h.close()
    h2 = _hist(P, d)
    out = [h2.load(), h2.load(),
           h2.window_increase("mrtpu_wc_total", 0.0, 2000.0)]
    h2.close()
    return out


def test_replay_reproduces_state_and_never_double_counts(tmp_path):
    assert _both(_case_replay, tmp_path) == [2, 0, 9.0]


def _case_two_writers(P, d):
    a = _hist(P, d)
    b = _hist(P, d)
    a.append_snapshot("pa", {_k("mrtpu_wc_total"): 3.0}, t=1000.0)
    b.append_snapshot("pb", {_k("mrtpu_wc_total"): 4.0}, t=1001.0)
    a.append_snapshot("pa", {_k("mrtpu_wc_total"): 5.0}, t=1002.0)
    out = [h.window_increase("mrtpu_wc_total", 0.0, 2000.0)
           for h in (a, b)]
    a.close()
    b.close()
    return out


def test_two_writers_one_dir_converge_without_double_count(tmp_path):
    assert _both(_case_two_writers, tmp_path) == [9.0, 9.0]


def _case_size_rotation(P, d):
    reg = P.metrics.REGISTRY
    r0 = reg.sum("mrtpu_history_retired_segments_total")
    s0 = reg.sum("mrtpu_history_rotations_total", reason="size")
    h = _hist(P, d, max_segment_bytes=1, keep_segments=3)
    pad = "x" * 5000
    for i in range(1, 7):
        h.append_snapshot("p0", {_k("mrtpu_wc_total", pad=pad): float(i)},
                          t=1000.0 + i)
    h2 = _hist(P, d)
    h2.load()
    out = [len(h.segment_paths()),
           reg.sum("mrtpu_history_retired_segments_total") - r0,
           reg.sum("mrtpu_history_rotations_total", reason="size") - s0,
           h2.window_increase("mrtpu_wc_total", 0.0, 2000.0),
           _segments(h)]
    h.close()
    h2.close()
    return out


def test_size_rotation_and_keep_n_retention(tmp_path):
    n_segs, retired, rotations, inc, _ = _both(_case_size_rotation,
                                               tmp_path)
    assert n_segs <= 3 and retired > 0 and rotations > 0
    assert 0 < inc <= 6.0


def _case_age_rotation(P, d):
    reg = P.metrics.REGISTRY
    a0 = reg.sum("mrtpu_history_rotations_total", reason="age")
    h = _hist(P, d, max_segment_age_s=5.0)
    h.append_snapshot("p0", {_k("mrtpu_wc_total"): 1.0}, t=1000.0)
    h.append_snapshot("p0", {_k("mrtpu_wc_total"): 2.0}, t=1010.0)
    out = [len(h.segment_paths()),
           reg.sum("mrtpu_history_rotations_total", reason="age") - a0]
    h.close()
    return out


def test_age_rotation(tmp_path):
    n_segs, rotated = _both(_case_age_rotation, tmp_path)
    assert n_segs == 2 and rotated > 0


def _case_corrupt(P, d):
    h = _hist(P, d)
    h.append_snapshot("p0", {_k("mrtpu_wc_total"): 5.0}, t=1000.0)
    seg = h.segment_paths()[0]
    h.close()
    with open(seg, "a") as f:
        f.write('{"v":1,"proc":"p0","seq":2')
    h2 = _hist(P, d)
    loaded = h2.load()
    h2.close()
    with open(seg, "a") as f:
        f.write('}garbage{\n')
    return [loaded, _raised(lambda: _hist(P, d).load()),
            _raised(lambda: P.history.read_history(str(d / "hist")))]


def test_corrupt_segment_refuses_loudly_torn_tail_tolerated(tmp_path):
    loaded, on_load, on_read = _both(_case_corrupt, tmp_path)
    assert loaded == 1
    assert on_load[0] == on_read[0] == "HistoryCorruptError"


# -- the query surface -------------------------------------------------------

def _seeded(P, d):
    h = _hist(P, d)
    for i, t in enumerate((1000.0, 1030.0, 1060.0, 1090.0)):
        h.append_snapshot(
            "p0", {_k("mrtpu_wc_total", task="wc"): 10.0 * (i + 1),
                   _k("mrtpu_depth", task="wc"): 5.0 + i}, t=t)
    h.append_snapshot(
        "p1", {_k("mrtpu_wc_total", task="wc"): 7.0}, t=1060.0)
    return h


def _case_query_raw(P, d):
    h = _seeded(P, d)
    res = h.query("mrtpu_wc_total", fn="raw", start=1.0, now=1100.0)
    h.close()
    return res


def test_query_raw_is_per_proc_cumulative(tmp_path):
    res = _both(_case_query_raw, tmp_path)
    procs = {s["labels"]["proc"]: s["points"] for s in res["series"]}
    assert [v for _t, v in procs["p0"]] == [10.0, 20.0, 30.0, 40.0]
    assert [v for _t, v in procs["p1"]] == [7.0]


def _case_query_increase(P, d):
    h = _seeded(P, d)
    out = [h.query("mrtpu_wc_total", fn="increase", start=1.0,
                   now=1100.0),
           h.query("mrtpu_wc_total", fn="increase", start=960.0,
                   end=1100.0, step=60.0, now=1100.0),
           h.query("mrtpu_wc_total", fn="increase", start=1.0,
                   by_proc=True, now=1100.0)]
    h.close()
    return out


def test_query_increase_sums_procs_and_steps_align(tmp_path):
    res, stepped, by_proc = _both(_case_query_increase, tmp_path)
    (series,) = res["series"]
    assert sum(v for _t, v in series["points"]) == 47.0
    (s,) = stepped["series"]
    assert all(t % 60.0 == 0 for t, _v in s["points"])
    assert sum(v for _t, v in s["points"]) == 47.0
    got = {s["labels"]["proc"]: sum(v for _t, v in s["points"])
           for s in by_proc["series"]}
    assert got == {"p0": 40.0, "p1": 7.0}


def _case_query_rate(P, d):
    h = _seeded(P, d)
    out = [h.query("mrtpu_wc_total", fn="rate", start=1000.0,
                   end=1100.0, now=1100.0),
           h.query("mrtpu_depth", fn="delta", start=1.0, now=1100.0),
           h.query("mrtpu_wc_total", matchers={"task": "nope"},
                   start=1.0, now=1100.0),
           _raised(lambda: h.query("mrtpu_wc_total", fn="median")),
           _raised(lambda: h.query("mrtpu_wc_total", start=50.0,
                                   end=40.0))]
    h.close()
    return out


def test_query_rate_gauges_matchers_and_errors(tmp_path, clock):
    rate, gauge, none, bad_fn, bad_range = _both(_case_query_rate,
                                                 tmp_path, clock)
    (s,) = rate["series"]
    assert sum(v for _t, v in s["points"]) == pytest.approx(0.37)
    (gs,) = gauge["series"]
    assert gs["points"][-1][1] == 3.0
    assert none["series"] == []
    assert bad_fn[0] == bad_range[0] == "ValueError"


def _case_top(P, d):
    h = _hist(P, d)
    h.append_snapshot("p0", {_k("mrtpu_a_total"): 100.0,
                             _k("mrtpu_b_total"): 3.0,
                             _k("mrtpu_depth"): 9.0}, t=1000.0)
    rows = h.top_series(k=5, window_s=300.0, now=1100.0)
    h.close()
    return rows


def test_top_series_ranks_by_windowed_increase(tmp_path):
    rows = _both(_case_top, tmp_path)
    assert [r["name"] for r in rows] == ["mrtpu_a_total", "mrtpu_b_total"]
    assert rows[0]["increase"] == 100.0


# -- trends ------------------------------------------------------------------

def _case_trends_rates(P, d):
    h = _hist(P, d)
    h.append_snapshot("p0", {
        _k("mrtpu_http_retries_total", endpoint="x"): 1.0}, t=700.0)
    h.append_snapshot("p0", {
        _k("mrtpu_http_retries_total", endpoint="x"): 6.0,
        _k("mrtpu_worker_lease_lost_total", worker="w"): 2.0},
        t=1150.0)
    tr = h.trends(window_s=300.0, now=1200.0, objectives=())
    h.close()
    return tr


def test_trends_flag_rate_regressions_and_from_zero_bursts(tmp_path):
    tr = _both(_case_trends_rates, tmp_path)
    rates = {r["name"]: r for r in tr["rates"]}
    assert rates["mrtpu_http_retries_total"]["ratio"] == 5.0
    burst = rates["mrtpu_worker_lease_lost_total"]
    assert burst["ratio"] is None and burst["rate_new"] > 0


def _case_trends_wave(P, d):
    h = _hist(P, d)
    h.append_snapshot("p0", {
        _k("mrtpu_device_seconds_total", stage="compute"): 1.0,
        _k("mrtpu_device_waves_total", task="wc"): 10.0},
        t=700.0, offset_s=0.001)
    h.append_snapshot("p0", {
        _k("mrtpu_device_seconds_total", stage="compute"): 4.0,
        _k("mrtpu_device_waves_total", task="wc"): 20.0},
        t=1100.0, offset_s=0.5)
    tr = h.trends(window_s=300.0, now=1200.0, objectives=())
    h.close()
    return tr


def test_trends_compute_per_wave_and_offset_jumps(tmp_path):
    tr = _both(_case_trends_wave, tmp_path)
    assert tr["compute_s_per_wave"]["ratio"] == pytest.approx(3.0)
    assert tr["offset_jumps"]["p0"]["jump_s"] == pytest.approx(0.499)


def _case_trends_burn(P, d):
    obj = P.slo.SLOObjective(name="snap", family="mrtpu_slo_op_seconds",
                             percentile=0.9, threshold_s=0.5)
    h = _hist(P, d)
    fam = "mrtpu_slo_op_seconds_bucket"
    h.append_snapshot("p0", {
        _k(fam, tenant="t0", le="0.5"): 4.0,
        _k(fam, tenant="t0", le="+Inf"): 10.0}, t=1150.0)
    tr = h.trends(window_s=300.0, now=1200.0, objectives=(obj,))
    h.close()
    return tr


def test_trends_burn_reads_persisted_bucket_windows(tmp_path):
    tr = _both(_case_trends_burn, tmp_path)
    (burn,) = tr["burn"]
    assert burn["tenant"] == "t0" and burn["window_n"] == 10
    assert burn["burn"] == pytest.approx(6.0)


def _case_seed(P, d):
    obj = P.slo.SLOObjective(name="snap", family="mrtpu_slo_op_seconds",
                             percentile=0.9, threshold_s=0.5,
                             long_window_s=600)
    h = _hist(P, d)
    fam = "mrtpu_slo_op_seconds_bucket"
    h.append_snapshot("p0", {_k(fam, tenant="t0", le="0.5"): 4.0,
                             _k(fam, tenant="t0", le="+Inf"): 10.0},
                      t=1100.0)
    plane = P.slo.SloPlane()
    plane.configure([obj])
    out = [plane.seed_from_history(h, now=50.0, wall_now=1200.0),
           plane.seed_from_history(h, now=50.0, wall_now=1200.0),
           list(plane._windows[("snap", "t0")]),
           h.bucket_windows("mrtpu_slo_op_seconds")]
    h.close()
    return out


def test_slo_seed_from_history_restores_empty_windows(tmp_path):
    first, second, win, windows = _both(_case_seed, tmp_path)
    assert (first, second) == (1, 0)
    (mono_t, cums) = win[-1]
    assert mono_t == pytest.approx(50.0 - 100.0)
    assert cums[float("inf")] == 10.0
    assert windows["t0"][-1] == (1100.0, {0.5: 4.0, float("inf"): 10.0})


def _case_control(P, d, clock):
    h = _hist(P, d)
    led = P.control.ControlLedger()
    led.bind_history(h)
    did = led.record("capacity", "wc", {"seen": 1}, {"halve": True},
                     outcome="applied")
    clock.t = T_START + 1.0
    h.append_snapshot("p0", {
        _k("mrtpu_device_retries_total", task="wc"): 3.0},
        t=P.docstore.now())
    clock.t = T_START + 2.0
    h.append_snapshot("p0", {
        _k("mrtpu_device_retries_total", task="wc"): 5.0},
        t=P.docstore.now())
    clock.t = T_START + 3.0
    resolved = led.resolve(did, "improved")
    dec = led.snapshot()["decisions"][-1]
    led.unbind_history(h)
    unbound = led._history
    h.close()
    return [resolved, dec["outcome_evidence"], unbound]


def test_control_ledger_resolution_reads_history_evidence(tmp_path, clock):
    resolved, ev, unbound = _both(_case_control, tmp_path, clock, clock)
    assert resolved is True and unbound is None
    hw = ev["history_window"]
    assert hw["increase"]["mrtpu_device_retries_total"] == 5.0
    assert (hw["t0"], hw["t1"]) == (T_START, T_START + 3.0)


# -- the wire: /queryz, statusz, CLI, bundles --------------------------------

def _case_queryz_http(P, d, capsys):
    reg = P.metrics.Registry()
    probe = reg.counter("mrtpu_histtest_probe_total", "history test probe")
    srv = P.ds.DocServer(history_dir=str(d / "hist")).start_background()
    addr = f"{srv.host}:{srv.port}"
    pusher = P.collector.TelemetryPusher(addr, role="histtest",
                                         interval=60.0, registry=reg)
    out = {}
    try:
        probe.inc(0)
        assert pusher.flush()
        probe.inc(3)
        assert pusher.flush()
        client = P.ds.HttpDocStore(addr)
        try:
            res = client.queryz({"metric": "mrtpu_histtest_probe_total",
                                 "fn": "increase", "start": -3600})
            out["query"] = res
            out["total"] = sum(v for s in res["series"]
                               for _t, v in s["points"])
            out["top"] = client.queryz({"op": "top", "k": 3,
                                        "window": 3600})
            out["trends"] = client.queryz({"op": "trends"})
            out["bad_fn"] = _raised(lambda: client.queryz(
                {"metric": "mrtpu_histtest_probe_total",
                 "fn": "median"}))
            out["bad_window"] = _raised(lambda: client.queryz(
                {"op": "top", "window": "soon"}))
            # the pusher's clock offset (a monotonic difference) is
            # persisted in each entry, so the byte count may differ
            row = dict(client.statusz()["history"])
            row.pop("bytes")
            out["row"] = row
            out["row_text"] = [line for line in P.cli.render_status(
                {"tasks": {}, "history": row}).splitlines()
                if line.startswith("history:")]
        finally:
            client.close()
        capsys.readouterr()
        out["history_rc"] = P.cli.main(
            ["history", f"http://{addr}", "--metric",
             "mrtpu_histtest_probe_total"])
        out["history_out"] = capsys.readouterr().out
        out["top_rc"] = P.cli.main(["top", f"http://{addr}", "--k", "3"])
        out["top_out"] = capsys.readouterr().out
    finally:
        pusher.stop(flush=False)
        srv.shutdown()
    return out


def test_queryz_over_http_and_statusz_row(tmp_path, clock, capsys):
    """A pusher over a registry of its own (the probe alone), so both
    packages' histories hold the same rows; only the proc id differs,
    and it has the same length in both (host, pid, 6 hex)."""
    got = _both(_case_queryz_http, tmp_path, clock, capsys)
    assert got["total"] == 3.0
    assert got["top"]["series"][0]["name"] == "mrtpu_histtest_probe_total"
    assert "rates" in got["trends"]["trends"]
    assert "HTTP 400" in got["bad_fn"][1] and "HTTP 400" in \
        got["bad_window"][1]
    assert got["row"]["entries"] >= 1 and got["row"]["segments"] >= 1
    assert got["row_text"] and got["history_rc"] == got["top_rc"] == 0
    assert "mrtpu_histtest_probe_total" in got["history_out"]
    assert "/s" in got["top_out"]


def _case_queryz_404(P, d):
    srv = P.ds.DocServer().start_background()
    client = P.ds.HttpDocStore(f"{srv.host}:{srv.port}")
    try:
        return _raised(lambda: client.queryz({"metric": "mrtpu_wc_total"}))
    finally:
        client.close()
        srv.shutdown()


def test_queryz_404_without_history_plane(tmp_path):
    got = _both(_case_queryz_404, tmp_path)
    assert got[0] == "OSError" and "404" in got[1]


def _case_bundle(P, d):
    h = _hist(P, d)
    h.append_snapshot("p0", {_k("mrtpu_wc_total"): 5.0}, t=1000.0)
    out = str(d / "bundle")
    P.profile.write_bundle(out, history=h)
    loaded = P.profile.load_bundle(out)["history"]
    seg = os.path.join(out, "history",
                       os.path.basename(h.segment_paths()[0]))
    with open(seg, "rb") as f:
        seg_bytes = f.read()
    with open(seg, "a") as f:
        f.write("}garbage{\n")
    refused = _raised(lambda: P.profile.load_bundle(out))
    h.close()
    return [loaded, seg_bytes, refused[0]]


def test_bundle_round_trip_carries_history(tmp_path):
    loaded, _seg, refused = _both(_case_bundle, tmp_path)
    assert loaded["entries"] == 1 and loaded["procs"] == {"p0": 1}
    assert refused == "HistoryCorruptError"


def test_port_bundle_history_is_read_by_jax(tmp_path):
    """The port's bundle ``history/`` and manifest, read by the JAX
    ``read_history`` and ``load_bundle``: the same summary the port's
    own loader gives."""
    h = thistory.MetricHistory(str(tmp_path / "hist"))
    h.append_snapshot("p0", {_k("mrtpu_wc_total"): 5.0}, t=1000.0)
    h.append_snapshot("p1", {_k("mrtpu_kernel_launches_total",
                                kernel="radix_onesweep"): 16.0}, t=1001.0)
    out = str(tmp_path / "bundle")
    tprofile.write_bundle(out, history=h)
    h.close()
    mine = tprofile.load_bundle(out)["history"]
    assert jhistory.read_history(os.path.join(out, "history")) == mine
    assert jprofile.load_bundle(out)["history"] == mine
    assert mine["procs"] == {"p0": 1, "p1": 1} and mine["series"] == 2


def _diag_doc():
    return {"traceEvents": [],
            "mrtpuCluster": {"procs": {}, "history": {
                "window_s": 300.0, "t_end": 1200.0, "entries": 4,
                "procs": 1, "span_s": 450.0,
                "rates": [{"name": "mrtpu_http_retries_total",
                           "rate_old": 0.0, "rate_new": 0.5,
                           "ratio": None}],
                "compute_s_per_wave": {"old": 0.1, "new": 0.3,
                                       "ratio": 3.0},
                "offset_jumps": {"p0": {"old": 0.0, "new": 0.5,
                                        "jump_s": 0.5}},
                "burn": [{"objective": "snap", "tenant": "t0",
                          "threshold_s": 0.5, "window_n": 10,
                          "burn": 6.0}]}}}


def _case_diagnose(P, d):
    report = P.analysis.diagnose(_diag_doc())
    return [report["trends"], [n for n in report["notes"] if "trend:" in n],
            P.analysis.render_diagnosis(report)]


def test_diagnose_renders_trend_findings(tmp_path):
    trends, notes, text = _both(_case_diagnose, tmp_path)
    kinds = {f["kind"] for f in trends["findings"]}
    assert kinds == {"rate_trend", "compute_drift", "offset_jump",
                     "persisted_burn"}
    assert "HISTORY TRENDS" in text and notes


# -- query edge validation, tie-breaks, GC accounting, tail mode -------------

def _case_query_edges(P, d):
    h = _hist(P, d)
    h.append_snapshot("p0", {_k("mrtpu_wc_total"): 5.0}, t=1000.0)
    out = [_raised(lambda s=step: h.query(
        "mrtpu_wc_total", fn="increase", step=s, now=1100.0))
        for step in (0, -5, 0.0)]
    out.append(_raised(lambda: h.query("mrtpu_wc_total", start=900.0,
                                       end=800.0, now=1100.0)))
    out.append(_raised(lambda: h.query("mrtpu_wc_total", start=900.0,
                                       end=900.0, now=1100.0)))
    h.close()
    return out


def test_query_rejects_nonpositive_step_and_inverted_range(tmp_path):
    got = _both(_case_query_edges, tmp_path)
    assert all("bad queryz step" in r[1] for r in got[:3])
    assert all("empty history range" in r[1] for r in got[3:])


def _case_tie_break(P, d):
    h = _hist(P, d)
    h.append_snapshot("p0", {_k("mrtpu_bb_total", task="z"): 5.0,
                             _k("mrtpu_bb_total", task="a"): 5.0,
                             _k("mrtpu_aa_total", task="m"): 5.0},
                      t=1000.0)
    rows = h.top_series(k=5, window_s=300.0, now=1100.0)
    h2 = _hist(P, d)
    again = h2.top_series(k=5, window_s=300.0, now=1100.0)
    h2.close()
    h.close()
    return [rows, again]


def test_top_series_tie_break_is_deterministic(tmp_path):
    rows, again = _both(_case_tie_break, tmp_path)
    assert [(r["name"], r["labels"]["task"]) for r in rows] == [
        ("mrtpu_aa_total", "m"), ("mrtpu_bb_total", "a"),
        ("mrtpu_bb_total", "z")]
    assert again == rows


def _case_gc(P, d):
    reg = P.metrics.REGISTRY
    gc0 = reg.sum("mrtpu_history_gc_total", reason="size")
    h = _hist(P, d, max_segment_bytes=1, keep_segments=2)
    pad = "x" * 5000
    for i in range(1, 7):
        h.append_snapshot("p0", {_k("mrtpu_wc_total", pad=pad): float(i)},
                          t=1000.0 + i)
    snap = h.snapshot()
    out = [snap, reg.sum("mrtpu_history_gc_total", reason="size") - gc0,
           P.cli._render_history(snap)]
    h.close()
    return out


def test_gc_counter_and_snapshot_rotation_accounting(tmp_path):
    snap, gc, (line,) = _both(_case_gc, tmp_path)
    assert snap["rotations"] >= 4 and snap["gc_segments"] >= 1
    assert snap["segments"] <= 3 and gc == snap["gc_segments"]
    assert "rotation(s)" in line and "gc'd" in line


def _case_http_400(P, d):
    srv = P.ds.DocServer(history_dir=str(d / "hist")).start_background()
    out = []
    try:
        for qs in ("metric=mrtpu_wc_total&step=0",
                   "metric=mrtpu_wc_total&step=-5",
                   "metric=mrtpu_wc_total&start=900&end=800"):
            cnn = http.client.HTTPConnection(srv.host, srv.port,
                                             timeout=10)
            cnn.request("GET", f"/queryz?{qs}")
            resp = cnn.getresponse()
            out.append([resp.status, json.loads(resp.read())])
            cnn.close()
    finally:
        srv.shutdown()
    return out


def test_queryz_http_400_bodies_are_typed(tmp_path):
    got = _both(_case_http_400, tmp_path)
    for (status, body), frag in zip(got, ("step", "step",
                                          "empty history range")):
        assert status == 400 and body["ok"] is False
        assert body["type"] == "ValueError" and frag in body["error"]


def _case_follow(P, d, capsys):
    series = [{"labels": {"task": "wc"},
               "points": [[10.0, 1.0], [20.0, 2.0]]}]
    capsys.readouterr()
    out = [P.cli._print_history_points(series, float("-inf")),
           capsys.readouterr().out]
    series[0]["points"].append([30.0, 3.0])
    out += [P.cli._print_history_points(series, out[0]),
            capsys.readouterr().out,
            P.cli._print_history_points(series, 30.0),
            capsys.readouterr().out,
            P.cli.main(["history", "http://127.0.0.1:1", "--metric", "m",
                        "--follow", "--interval", "0"])]
    return out


def test_cli_history_follow_tail_cursor(tmp_path, capsys):
    (last, out1, last2, out2, last3, out3, rc) = _both(
        _case_follow, tmp_path, None, capsys)
    assert last == 20.0 and "10.000" in out1 and "20.000" in out1
    assert last2 == 30.0 and "30.000" in out2 and "10.000" not in out2
    assert last3 == 30.0 and out3 == "" and rc == 2


# -- segments across the packages --------------------------------------------

def _write_mixed(P, root, proc, base):
    """A history with counters (the card's device and kernel families
    among them), a gauge, a reset and SLO buckets, written by *P*."""
    h = P.history.MetricHistory(str(root), max_segment_bytes=4096)
    fam = "mrtpu_slo_queue_wait_seconds_bucket"
    for i in range(12):
        t = 1000.0 + 25.0 * i + base
        snap = {
            _k("mrtpu_kernel_launches_total",
               kernel="radix_onesweep"): 8.0 * (i + 1),
            _k("mrtpu_kernel_launches_total",
               kernel="radix_upfront"): float(i + 1),
            _k("mrtpu_device_waves_total", task="wc"): 2.0 * (i + 1),
            _k("mrtpu_device_seconds_total", stage="compute"):
                0.125 * (i + 1) * (1 + i % 3),
            _k("mrtpu_exchange_records_total", src="0", dst="1"):
                1000.0 * (i % 5 + 1),   # resets twice
            _k("mrtpu_device_memory_bytes", device="0"): 1e9 + i,
            _k(fam, tenant="acme", le="0.5"): float(3 * i),
            _k(fam, tenant="acme", le="+Inf"): float(4 * i),
            _k("mrtpu_http_retries_total"): float(i * i),
        }
        h.append_snapshot(proc, snap, t=t, offset_s=0.001 * i,
                          role="runner")
    return h


def _answers(h):
    obj = jslo.SLOObjective(name="queue_wait",
                            family="mrtpu_slo_queue_wait_seconds",
                            percentile=0.99, threshold_s=0.5)
    now = 1400.0
    out = {"snapshot": {k: v for k, v in h.snapshot().items()
                        if k in ("segments", "bytes", "entries", "series",
                                 "procs", "oldest_t", "newest_t")}}
    for fam in ("mrtpu_kernel_launches_total", "mrtpu_device_waves_total",
                "mrtpu_exchange_records_total",
                "mrtpu_device_memory_bytes"):
        for fn in ("raw", "rate", "increase", "delta"):
            out[f"{fam}:{fn}"] = h.query(fam, fn=fn, start=900.0, now=now)
        out[f"{fam}:step"] = h.query(fam, fn="increase", start=900.0,
                                     step=50.0, by_proc=True, now=now)
    out["match"] = h.query("mrtpu_kernel_launches_total",
                           matchers={"kernel": "radix_onesweep"},
                           fn="increase", start=900.0, now=now)
    out["window_increase"] = [
        h.window_increase("mrtpu_kernel_launches_total", lo, hi,
                          matchers={"kernel": "radix_onesweep"})
        for lo, hi in ((900.0, 1400.0), (1100.0, 1200.0))]
    out["top"] = h.top_series(k=20, window_s=300.0, now=now)
    out["trends"] = h.trends(window_s=150.0, now=now, objectives=(obj,))
    out["buckets"] = h.bucket_windows("mrtpu_slo_queue_wait_seconds")
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_segments_written_by_one_package_load_in_the_other(
        tmp_path, writer, reader):
    """Segments a package writes (rotated by size) are ``load``ed by the
    other, whose answers equal the writer's own; then the reader appends
    as a second proc into the same directory and both packages, loading
    the mixed directory afresh, answer alike."""
    root = tmp_path / "hist"
    w = _write_mixed(PKGS[writer], root, "pw", 0.0)
    mine = _answers(w)
    w.close()
    assert len(os.listdir(root)) > 1    # rotated: several segments
    r = PKGS[reader].history.MetricHistory(str(root))
    assert r.load() == 12
    assert _answers(r) == mine
    r.close()
    _write_mixed(PKGS[reader], root, "pr", 3.0).close()
    fresh = {}
    for name, P in PKGS.items():
        h = P.history.MetricHistory(str(root))
        assert h.load() == 24
        fresh[name] = _answers(h)
        h.close()
    assert fresh["port"] == fresh["jax"]
    launches = fresh["port"]["match"]["series"][0]["points"][-1][1]
    assert launches == 2 * 8.0 * 12


# -- the SIGKILL failover acceptance run (port counterpart) ------------------

LEASE = 1.0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _healthz(port: int, timeout: float = 0.5):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=timeout) as r:
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
def test_history_survives_board_failover(tmp_path):
    """Two port docserver processes over one HA dir: pushes land on the
    primary's history segments (``<ha-dir>/history``), the primary is
    SIGKILLed, and the promoted standby serves ``/queryz`` over the same
    segments — the probe's increase equals the pusher's registry
    exactly (no gap, no double count) — and its trend summary carries
    a regression finding (the failover burst)."""
    ha_dir = str(tmp_path / "ha")
    p1, p2 = _free_port(), _free_port()
    procs = [_spawn_docserver(p1, ha_dir), _spawn_docserver(p2, ha_dir)]
    probe = tmetrics.counter("mrtpu_torch_hachaos_probe_total",
                             "failover-spanning history probe")
    base = tmetrics.REGISTRY.sum("mrtpu_torch_hachaos_probe_total")
    pusher = tcollector.TelemetryPusher(
        f"127.0.0.1:{p1},127.0.0.1:{p2}", role="hachaos", interval=60.0)
    try:
        for port in (p1, p2):
            _wait(lambda port=port: _healthz(port) is not None, 30,
                  f"docserver on {port} never served /healthz")
        roles = _wait(
            lambda: ({p: (_healthz(p) or {}).get("primary")
                      for p in (p1, p2)}
                     if any((_healthz(p) or {}).get("primary")
                            for p in (p1, p2)) else None),
            30, "no replica ever took the board lease")
        prim_port = p1 if roles[p1] else p2
        stby_port = p2 if prim_port == p1 else p1
        prim = procs[0] if prim_port == p1 else procs[1]
        for _ in range(3):
            probe.inc()
            _wait(pusher.flush, 30, "pre-kill telemetry push failed")
            time.sleep(0.05)
        os.kill(prim.pid, signal.SIGKILL)
        prim.wait(timeout=10)
        for _ in range(2):
            probe.inc()
            pusher.flush()
            time.sleep(0.05)
        _wait(lambda: (_healthz(stby_port) or {}).get("primary"), 30,
              "standby never took over after SIGKILL")
        probe.inc()
        _wait(pusher.flush, 30,
              "no telemetry push succeeded after promotion")
        want = tmetrics.REGISTRY.sum("mrtpu_torch_hachaos_probe_total")
        assert want - base == 6.0
        client = tds.HttpDocStore(f"127.0.0.1:{stby_port}")
        try:
            res = client.queryz({"metric": "mrtpu_torch_hachaos_probe_total",
                                 "fn": "increase", "start": -3600})
            got = sum(v for s in res["series"] for _t, v in s["points"])
            assert got == want, (got, want)
            row = client.statusz().get("history") or {}
            assert row.get("entries", 0) >= 2, row
            doc = client.clusterz()
        finally:
            client.close()
        report = tanalysis.diagnose(doc)
        assert (report.get("trends") or {}).get("findings"), \
            report.get("trends")
    finally:
        pusher.stop(flush=False)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
