"""The port's ``train_digits`` (distributed SGD through the job board) and
its ``train`` command, against the JAX package's, on the CPU.

The example's module state (``_conf``, ``HISTORY``, ``_data_cache``) and
both packages' ``spec`` caches are reset before every test: workers are
threads of this process, and another test file may have run the JAX
example in it.  ``Server.loop`` runs in a thread joined under a timeout
(its phase polling has no deadline).

Tolerances: ``reducefn`` is float64 numpy in both packages and equal bit
for bit; one ``mapfn`` (the default bf16 MLP) gives the JAX gradients
within 2e-2 of each leaf's norm (measured up to 8.4e-3: bf16 products
round at other places in the two frameworks) and the loss within 1e-3.
"""

import json
import os
import subprocess
import sys
import threading
import uuid

import numpy as np
import pytest

import mapreduce_tpu.examples.train_digits as jtd
from mapreduce_tpu import spec as jspec

import mapreduce_tpu_torch.examples.train_digits as ttd
from mapreduce_tpu_torch import cli as tcli
from mapreduce_tpu_torch import spec as tspec
from mapreduce_tpu_torch.coord import Connection, TrainerLease
from mapreduce_tpu_torch.models import trainer as ttrainer
from mapreduce_tpu_torch.server import Server
from mapreduce_tpu_torch.worker import spawn_worker_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TMOD = "mapreduce_tpu_torch.examples.train_digits"
LOOP_TIMEOUT = 120
#: both examples' defaults, as a fresh process has them
CONF = dict(storage=None, n_shards=4, bunch_size=128, learning_rate=0.01,
            momentum=0.02, weight_decay=1e-4, max_iterations=3,
            target_val_loss=0.0, smoothing=False, sizes=(256, 128, 10),
            seed=7)


@pytest.fixture(autouse=True)
def fresh_modules():
    for mod, extra in ((jtd, {}), (ttd, {"device": None})):
        mod._conf.clear()
        mod._conf.update(CONF, **extra)
        mod.HISTORY.clear()
        mod._data_cache.clear()
    jspec.clear_caches()
    tspec.clear_caches()
    yield
    jspec.clear_caches()
    tspec.clear_caches()


def _in_thread(fn, timeout=LOOP_TIMEOUT):
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


def test_three_iterations_through_the_server():
    connstr = f"mem://{uuid.uuid4().hex}"
    params = {r: TMOD for r in ("taskfn", "mapfn", "partitionfn",
                                "reducefn", "finalfn")}
    params["storage"] = f"mem:{uuid.uuid4().hex}"
    params["init_args"] = {
        "storage": params["storage"], "n_shards": 4, "bunch_size": 64,
        "learning_rate": 0.3, "momentum": 0.5, "max_iterations": 3,
        "sizes": (256, 32, 10), "device": "cpu"}
    threads = spawn_worker_threads(connstr, "sgd", 2)
    server = Server(connstr, "sgd")
    server.configure(params)
    stats = _in_thread(server.loop)
    for t in threads:
        t.join(timeout=LOOP_TIMEOUT)
        assert not t.is_alive()
    hist = ttd.HISTORY
    assert [h["iteration"] for h in hist] == [1, 2, 3]
    assert hist[-1]["val_loss"] < hist[0]["val_loss"], hist
    assert stats["iteration"] == 3
    assert stats["map"]["count"] == 4 and stats["map"]["failed"] == 0


def _configure_both(storage, **over):
    for mod in (jtd, ttd):
        mod.init(dict(storage=storage, **over))
    ttd.init({"device": "cpu"})


def test_model_blob_crosses_both_ways(tmp_path):
    _configure_both(f"shared:{tmp_path}", sizes=(256, 32, 10))
    jtd._save_model(jtd._init_model())
    got = ttd._load_model()
    assert got == jtd._load_model()
    assert got["iteration"] == 0 and set(got) >= {"w0", "b1", "vel_w1"}
    got["iteration"] = 5
    ttd._save_model(got)
    assert jtd._load_model()["iteration"] == 5
    assert ttd._init_model() == jtd._init_model()


def test_mapfn_matches_jax_and_reducefn_is_equal(tmp_path):
    _configure_both(f"shared:{tmp_path}", sizes=(256, 32, 10),
                    bunch_size=64)
    jtd._save_model(jtd._init_model())
    j_out, t_out = [], []
    for mod, out in ((jtd, j_out), (ttd, t_out)):
        mod.mapfn(2, {"shard": 2}, lambda k, v, out=out: out.append((k, v)))
    assert [k for k, _ in t_out] == [k for k, _ in j_out]
    assert sorted(k for k, _ in t_out) == ["TR_LOSS", "b0", "b1", "w0",
                                           "w1"]
    for (k, (tg, tc)), (_, (jg, jc)) in zip(t_out, j_out):
        assert tc == jc == 64
        if k == "TR_LOSS":
            assert abs(tg - jg) < 1e-3
            continue
        tg, jg = np.asarray(tg), np.asarray(jg)
        err = np.linalg.norm(tg - jg) / np.linalg.norm(jg)
        assert err < 2e-2, (k, err)
    values = [v for k, v in t_out if k == "w1"] + \
        [v for k, v in j_out if k == "w1"]
    assert ttd.reducefn("w1", values) == jtd.reducefn("w1", values)
    loss = [[0.5, 3], [1.0, 1]]
    assert ttd.reducefn("TR_LOSS", loss) == jtd.reducefn("TR_LOSS", loss)
    for key in ("w0", "b12", "TR_LOSS"):
        assert ttd.partitionfn(key) == jtd.partitionfn(key)


def _train(*argv):
    return subprocess.run(
        [sys.executable, "-m", "mapreduce_tpu_torch.cli", "train", *argv],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT))


def test_train_cli_resumes_at_a_higher_generation(tmp_path):
    board, store = f"dir://{tmp_path / 'b'}", f"shared:{tmp_path / 'ck'}"
    common = ["--storage", store, "--bunch", "8", "--lease", "10",
              "--device", "cpu"]
    first = _train(board, "db", "--epochs", "2", *common)
    assert first.returncode == 0, first.stderr
    assert "generation 1" in first.stderr
    out = json.loads(first.stdout.strip().splitlines()[-1])
    assert out["epochs_run"] == 2 and out["checkpoints"] == [1, 2]
    second = _train(board, "db", "--epochs", "4", *common)
    assert second.returncode == 0, second.stderr
    assert "generation 2" in second.stderr
    assert "restored checkpoint step 2" in second.stderr
    out = json.loads(second.stdout.strip().splitlines()[-1])
    assert out["restored"] and out["start_epoch"] == 3
    assert out["epochs_run"] == 2 and out["checkpoints"][-1] == 4
    assert set(out) == {"epochs_run", "start_epoch", "restored",
                        "best_epoch", "best_val_loss", "checkpoints",
                        "best", "storage"}


def test_train_cli_exit_codes(tmp_path, monkeypatch, capsys):
    board = f"mem://{uuid.uuid4().hex}"
    argv = ["train", board, "db", "--storage", f"shared:{tmp_path}",
            "--epochs", "3", "--bunch", "64", "--lease", "5",
            "--device", "cpu"]
    holder = TrainerLease(Connection(board, "db"), holder="other",
                          lease=30.0)
    holder.acquire(timeout=1)
    # 2: the lease is held past --acquire-timeout
    assert tcli.main(argv + ["--acquire-timeout", "0.2"]) == 2
    assert "not acquired" in capsys.readouterr().err
    holder.release()

    # 3: after the first epoch a successor takes the lease (its expiry
    # forced on the board), so the trainer fences at its next gate and
    # keeps nothing it held
    real = ttrainer.DistributedTrainer._train_epoch
    thief = TrainerLease(Connection(board, "db"), holder="thief", lease=30)

    def epoch_then_steal(self, *a):
        out = real(self, *a)
        Connection(board, "db").connect().update(
            thief.ns, {"_id": TrainerLease.SINGLETON_ID},
            {"$set": {"lease_expires": 0.0}})
        assert thief.try_acquire()
        return out

    monkeypatch.setattr(ttrainer.DistributedTrainer, "_train_epoch",
                        epoch_then_steal)
    assert tcli.main(argv) == 3
    err = capsys.readouterr().err
    assert "FENCED" in err and "generation 2" in err
    assert thief.peek()["holder"] == "thief"
    assert thief.generation == 3

    # a crash after the acquire releases the lease before it propagates
    thief.release()

    def crash(self, *a):
        raise OSError("disk gone")

    monkeypatch.setattr(ttrainer.DistributedTrainer, "_train_epoch", crash)
    with pytest.raises(OSError, match="disk gone"):
        tcli.main(argv)
    assert thief.peek()["holder"] is None
