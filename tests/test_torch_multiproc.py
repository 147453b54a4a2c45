"""The port's engine and MLP step over a mesh that spans processes.

The JAX package runs its engine and a train step over a
``jax.distributed`` mesh of 2 processes x 4 CPU devices
(``tests/test_multiproc.py``).  The port's counterpart: 2 processes,
each ``Partitions(8, "cpu", group=WORLD)`` over a gloo group and so 4 of
the 8 partitions, every rank given the identical corpus.  Held here:

* the word count's ``DeviceResult`` (keys, values, payload, valid) and
  its traffic matrix are bit-equal on both ranks, to a one-process
  ``Partitions(8, "cpu")`` run and to the JAX ``lax`` engine on its
  8-device CPU mesh (tolerance: none), for the variadic and the radix
  paths and for a configuration whose capacities overflow, so that the
  capacity retries are decided from all-reduced needs; the counts equal
  ``Counter``;
* one f32 MLP step of ``DistributedTrainer(n_data=8, group=WORLD)``:
  the loss is the same float on both ranks, within 1e-6 relative of the
  one-process ``n_data=8`` step and of the JAX ``DistributedTrainer``
  step on the same parameters, and the updated parameters within atol
  1e-6 of the one-process step's (the halves' gradients are summed in
  another order than the whole batch's);
* the combined topology of ``tests/multiproc_runner2.py``: the
  two-process engine with its job on an ``http://`` docserver and every
  byte on a blob server;
* a group of another backend, or a world size that does not divide the
  partition count (or ``n_data``), raises by name, and so do a pipeline
  layout that is neither the stages nor the data across the ranks and
  a trainer lease given to a rank other than 0.  The resident session
  and its fleet moves, ``fit``, the transformer and the pipeline over a
  group run in ``tests/test_torch_multiproc_session.py`` and
  ``tests/test_torch_multiproc_train.py``, whose rank bodies
  :func:`test_rank_body_imports_no_jax` checks too.

The rank body lives in this module (``python -m tests.test_torch_multiproc
RANK ...``); it imports nothing of JAX.  Every rank gives
``init_process_group`` a timeout and every ``communicate`` has one.
"""

import datetime
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a collective may wait for the other rank before it fails
GROUP_TIMEOUT_S = 60
#: seconds the parent waits for a rank to finish
RANK_TIMEOUT_S = 120
#: torch threads a rank uses (two ranks share the host's cores)
RANK_THREADS = 2
#: the MLP of tests/multiproc_runner.py, computed in f32 here (the
#: default bf16 products would hold the two-rank gradient sum only to
#: bf16's rounding of each half)
MLP_SIZES = (32, 16, 10)
BUNCH = 4
N_DATA = 8


# -- the rank body (run as a module in each child) ----------------------------


def _init_group(rank: int, world: int, port: int):
    import torch.distributed as dist

    torch.set_num_threads(RANK_THREADS)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return dist


def _rank_engine(rank, world, port, cases_json, out_path):
    """Each case's word count over the group (its corpus read from the
    case's file, on the case's ``device``, the CPU by default), then one
    MLP step; every array, the step's loss and each case's kernel
    launches and plain calls saved to *out_path* (npz, and a JSON
    beside it)."""
    from mapreduce_tpu_torch.engine import device_engine as tde
    from mapreduce_tpu_torch.engine import wordcount as twc
    from mapreduce_tpu_torch.models import (
        DistributedTrainer, MLPConfig, TrainConfig)
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.parallel.mesh import Partitions

    dist = _init_group(rank, world, port)
    try:
        cases = json.loads(cases_json)
        out, meta = {}, {}
        for name, case in cases.items():
            parts = Partitions(8, case.get("device", "cpu"),
                               group=dist.group.WORLD)
            assert (parts.n_local, parts.lo) == (8 // world,
                                                 rank * 8 // world)
            with open(case["corpus"], "rb") as f:
                data = f.read()
            wc = twc.DeviceWordCount(parts, chunk_len=case["chunk"],
                                     config=tde.EngineConfig(**case["cfg"]))
            chunks, L = wc._to_chunks(data)
            tm = {}
            kc.reset_counts()
            res = wc._engine_for(L).run(chunks, timings=tm,
                                        waves=case["waves"])
            assert twc.materialize_counts(chunks, res) == \
                Counter(data.split()), name
            for f in ("keys", "values", "payload", "valid"):
                out[f"{name}.{f}"] = getattr(res, f).numpy()
            out[f"{name}.matrix"] = np.asarray(tm["exchange"]["matrix"])
            meta[name] = {"retries": tm["retries"], "waves": tm["waves"],
                          "overflow": res.overflow,
                          "launches": dict(kc.LAUNCHES),
                          "plain_calls": dict(kc.PLAIN_CALLS)}
        tr = DistributedTrainer(MLPConfig(sizes=MLP_SIZES,
                                          dtype=torch.float32),
                                TrainConfig(bunch_size=BUNCH, max_epochs=1),
                                n_data=N_DATA, device="cpu",
                                group=dist.group.WORLD)
        params, opt = tr.init_state()
        x, y = _mlp_batch()
        xd, yd = tr.place_batch(x, y)
        params, opt, loss = tr.step(params, opt, xd, yd)
        out["loss"] = np.asarray([float(loss)], np.float32)
        for n, t in params.items():
            out[f"param.{n}"] = t.detach().numpy()
        np.savez(out_path, **out)
        with open(out_path + ".json", "w") as f:
            json.dump(meta, f)
    finally:
        dist.destroy_process_group()


def _rank_combined(rank, world, port, doc_connstr, blob_addr):
    """tests/multiproc_runner2.py's roles: rank 0 claims the job over
    http, runs the engine, publishes the result to the blob server and
    marks the job WRITTEN; rank 1 runs the same engine and verifies the
    published result through the two network planes."""
    from mapreduce_tpu_torch.coord import docstore
    from mapreduce_tpu_torch.engine import DeviceWordCount
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.storage.httpstore import HttpStorage
    from mapreduce_tpu_torch.utils.serialization import (
        parse_record, serialize_record)

    dist = _init_group(rank, world, port)
    try:
        board = docstore.connect(doc_connstr)
        blobs = HttpStorage(blob_addr)
        corpus = blobs.read("corpus").encode("utf-8")
        wc = DeviceWordCount(Partitions(8, "cpu", group=dist.group.WORLD),
                             chunk_len=512)
        counts = wc.count_bytes(corpus)
        print(f"MARKER engine ok uniques={len(counts)}", flush=True)
        if rank == 0:
            claimed = board.find_and_modify(
                "xhost.jobs", {"_id": "wc", "status": "ENQUEUED"},
                {"$set": {"status": "RUNNING", "worker": "p0"}})
            assert claimed is not None, "claim failed"
            lines = [serialize_record(k.decode("utf-8"), [v])
                     for k, v in sorted(counts.items())]
            blobs.write("result", "\n".join(lines) + "\n")
            assert board.update("xhost.jobs", {"_id": "wc"},
                                {"$set": {"status": "WRITTEN"}}) == 1
            print("MARKER served ok", flush=True)
        else:
            deadline = time.monotonic() + RANK_TIMEOUT_S
            while time.monotonic() < deadline:
                docs = board.find("xhost.jobs", {"_id": "wc"})
                if docs and docs[0]["status"] == "WRITTEN":
                    break
                time.sleep(0.1)
            else:
                raise AssertionError("job never reached WRITTEN")
            got = dict(parse_record(ln) for ln in
                       blobs.read("result").splitlines() if ln)
            mine = {k.decode("utf-8"): [v] for k, v in counts.items()}
            assert got == mine, (len(got), len(mine))
            print("MARKER verified ok", flush=True)
        # neither rank leaves before the other is done with the group
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _mlp_batch():
    batch = BUNCH * N_DATA
    x = np.random.default_rng(0).normal(
        size=(batch, MLP_SIZES[0])).astype(np.float32)
    y = (np.arange(batch) % MLP_SIZES[-1]).astype(np.int32)
    return x, y


def _main(argv) -> int:
    mode, rank, world, port = argv[0], int(argv[1]), int(argv[2]), \
        int(argv[3])
    if mode == "engine":
        _rank_engine(rank, world, port, *argv[4:6])
    else:
        _rank_combined(rank, world, port, *argv[4:6])
    return 0


# -- the parent side ----------------------------------------------------------


def _start(mode, *extra, module="tests.test_torch_multiproc"):
    """Start two ranks of *mode* of *module*'s ``_main`` (an extra
    argument may be a function of the rank)."""
    from chip_smoke import free_port

    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    return [subprocess.Popen(
        [sys.executable, "-m", module, mode,
         str(r), "2", str(port), *[e(r) if callable(e) else e
                                   for e in extra]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for r in range(2)]


def _wait(procs):
    """The ranks' (returncode, output) pairs, each waited for under
    :data:`RANK_TIMEOUT_S`; a rank still running after that is killed."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    return outs


def _jax_lax_count(jcfg, data, chunk, waves):
    """The JAX lax engine on its 8-device CPU mesh: ``(result arrays,
    traffic matrix)``."""
    from mapreduce_tpu.engine import wordcount as jwc
    from mapreduce_tpu.parallel import make_mesh

    wc = jwc.DeviceWordCount(make_mesh(), chunk_len=chunk, config=jcfg)
    chunks, L = wc._to_chunks(data)
    tm = {}
    res = wc._engine_for(L).run(chunks, timings=tm, waves=waves)
    return ([np.asarray(a) for a in res[:4]],
            np.asarray(tm["exchange"]["matrix"]))


def test_two_process_count_and_mlp_step_match_one_process_and_jax(tmp_path):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from mapreduce_tpu.engine import device_engine as jde
    from mapreduce_tpu.models import (DistributedTrainer as JTrainer,
                                      MLPConfig as JMLPConfig,
                                      TrainConfig as JTrainConfig)
    from mapreduce_tpu.parallel import make_mesh
    from mapreduce_tpu_torch import convert
    from mapreduce_tpu_torch.engine import device_engine as tde
    from mapreduce_tpu_torch.engine import wordcount as twc
    from mapreduce_tpu_torch.models import (
        DistributedTrainer, MLPConfig, TrainConfig)
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from tests.test_torch_wordcount import CFG, CHUNK, DATA, _corpus

    small = _corpus(n_words=600)
    radix_cfg = jde.EngineConfig(local_capacity=1 << 9,
                                 exchange_capacity=1 << 7,
                                 out_capacity=1 << 9)
    # name: (JAX config, the port's overrides, corpus, waves); the retry
    # case overflows the local, exchange and output stages once, so its
    # retry is decided from the all-reduced needs; the radix one runs on
    # a short corpus (the radix kernels' plain versions are slow on the
    # CPU)
    retry_cfg = dataclasses.replace(CFG, local_capacity=32,
                                    exchange_capacity=8, out_capacity=32)
    cases = {"variadic": (CFG, {}, DATA, 3),
             "retry": (retry_cfg, {}, DATA, 3),
             "radix": (radix_cfg, {"sort_impl": "radix"}, small, 2)}
    spec = {}
    for name, (jcfg, over, data, waves) in cases.items():
        path = tmp_path / f"{name}.corpus"
        path.write_bytes(data)
        spec[name] = {"corpus": str(path), "chunk": CHUNK, "waves": waves,
                      "cfg": dataclasses.asdict(dataclasses.replace(
                          convert.engine_config_from_jax(
                              dataclasses.asdict(jcfg)), **over))}
    procs = _start("engine", json.dumps(spec),
                   lambda r: str(tmp_path / f"rank{r}.npz"))
    # the references run while the ranks do
    refs = {}
    for name, (jcfg, over, data, waves) in cases.items():
        wc = twc.DeviceWordCount(Partitions(8, "cpu"), chunk_len=CHUNK,
                                 config=tde.EngineConfig(
                                     **spec[name]["cfg"]))
        chunks, L = wc._to_chunks(data)
        tm = {}
        res = wc._engine_for(L).run(chunks, timings=tm, waves=waves)
        refs[name] = (_jax_lax_count(jcfg, data, CHUNK, waves), res, tm)
    outs = _wait(procs)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out}"
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    metas = [json.loads((tmp_path / f"rank{r}.npz.json").read_text())
             for r in range(2)]
    assert metas[0] == metas[1]
    assert metas[0]["retry"]["retries"] >= 1
    assert metas[0]["radix"]["plain_calls"]["radix_plan"] > 0
    for name, ((jarrs, jmatrix), res, tm) in refs.items():
        one = convert.device_result_to_numpy(res)
        for i, f in enumerate(("keys", "values", "payload", "valid")):
            assert np.array_equal(one[i], jarrs[i]), (name, f)
            for rk in ranks:
                assert np.array_equal(rk[f"{name}.{f}"],
                                      getattr(res, f).numpy()), (name, f)
        matrix = np.asarray(tm["exchange"]["matrix"])
        assert np.array_equal(matrix, jmatrix), name
        for rk in ranks:
            assert np.array_equal(rk[f"{name}.matrix"], matrix), name
        assert metas[0][name]["retries"] == tm["retries"], name

    # the MLP step: the same loss on both ranks, the one-process step's
    # and the JAX trainer's on the same parameters
    losses = [float(rk["loss"][0]) for rk in ranks]
    assert losses[0] == losses[1]
    one = DistributedTrainer(MLPConfig(sizes=MLP_SIZES,
                                       dtype=torch.float32),
                             TrainConfig(bunch_size=BUNCH, max_epochs=1),
                             n_data=N_DATA, device="cpu")
    params, opt = one.init_state()
    init = {n: t.detach().numpy().copy() for n, t in params.items()}
    x, y = _mlp_batch()
    params, opt, loss = one.step(params, opt, *one.place_batch(x, y))
    assert losses[0] == pytest.approx(float(loss), rel=1e-6)
    for n, t in params.items():
        for rk in ranks:
            np.testing.assert_allclose(rk[f"param.{n}"], t.detach().numpy(),
                                       rtol=0, atol=1e-6)
    mesh = make_mesh()
    jt = JTrainer(mesh, JMLPConfig(sizes=MLP_SIZES, dtype=jnp.float32),
                  JTrainConfig(bunch_size=BUNCH, max_epochs=1))
    assert mesh.shape["data"] == N_DATA
    # the port's initial parameters in the JAX trainer's placement (its
    # fresh optimizer state is a zero trace, as the port's)
    jp, jo = jt.init_state()
    jp = {n: jax.device_put(init[n], a.sharding) for n, a in jp.items()}
    _, _, jloss = jt._train_step(jp, jo, *jt.place_batch(x, y))
    assert losses[0] == pytest.approx(float(jloss), rel=1e-6)


def test_combined_topology_over_http_planes():
    """The two-process engine while the job rides an http docserver and
    every byte an http blob server (no shared filesystem)."""
    import tempfile

    from mapreduce_tpu_torch.coord.docserver import DocServer
    from mapreduce_tpu_torch.storage.httpstore import BlobServer, HttpStorage

    doc = DocServer(host="127.0.0.1", port=0).start_background()
    blob = BlobServer(tempfile.mkdtemp(prefix="xhost_"), host="127.0.0.1",
                      port=0).start_background()
    try:
        text = ("the quick brown fox jumps over the lazy dog " * 40
                + "pack my box with five dozen liquor jugs " * 25)
        HttpStorage(blob.address).write("corpus", text)
        doc.store.insert("xhost.jobs", {"_id": "wc", "status": "ENQUEUED"})
        outs = _wait(_start("combined", f"http://{doc.host}:{doc.port}",
                            blob.address))
        for r, (rc, out) in enumerate(outs):
            assert rc == 0, f"rank {r} failed:\n{out}"
            assert "MARKER engine ok" in out, out
        assert "MARKER served ok" in outs[0][1]
        assert "MARKER verified ok" in outs[1][1]
        final = doc.store.find("xhost.jobs", {"_id": "wc"})[0]
        assert (final["status"], final["worker"]) == ("WRITTEN", "p0")
    finally:
        doc.shutdown()
        blob.shutdown()


def test_other_backends_and_uneven_splits_are_refused(monkeypatch):
    import torch.distributed as dist

    from mapreduce_tpu_torch.models import DistributedTrainer, MLPConfig
    from mapreduce_tpu_torch.parallel.mesh import Partitions

    group = object()
    monkeypatch.setattr(dist, "get_backend", lambda g=None: "nccl")
    with pytest.raises(NotImplementedError, match="gloo"):
        Partitions(8, "cpu", group=group)
    with pytest.raises(NotImplementedError, match="gloo"):
        DistributedTrainer(MLPConfig(sizes=MLP_SIZES), n_data=8,
                           device="cpu", group=group)
    monkeypatch.setattr(dist, "get_backend", lambda g=None: "gloo")
    monkeypatch.setattr(dist, "get_world_size", lambda g=None: 3)
    monkeypatch.setattr(dist, "get_rank", lambda g=None: 1)
    with pytest.raises(ValueError, match="world size"):
        Partitions(8, "cpu", group=group)
    monkeypatch.setattr(dist, "get_world_size", lambda g=None: 2)
    parts = Partitions(8, "cpu", group=group)
    assert (parts.world, parts.rank, parts.n_local, parts.lo) == (2, 1, 4, 4)
    # a pipeline grid that splits neither its stages nor its data over
    # the ranks raises by name
    from mapreduce_tpu_torch.models.pipeline import PipelinedTrainer
    from mapreduce_tpu_torch.models.transformer import (
        TransformerConfig, TransformerTrainer)

    with pytest.raises(ValueError, match=r"n_stages=3, n_data=2"):
        PipelinedTrainer(n_stages=3, n_data=2, device="cpu", group=group)
    with pytest.raises(ValueError, match="world size"):
        DistributedTrainer(MLPConfig(sizes=MLP_SIZES), n_data=3,
                           device="cpu", group=group)
    # the lease is rank 0's alone (this process is rank 1)
    tr = DistributedTrainer(MLPConfig(sizes=MLP_SIZES), n_data=8,
                            device="cpu", group=group)
    x, y = _mlp_batch()
    with pytest.raises(ValueError, match="rank 0's alone"):
        tr.fit(x, y, x, y, lease=object())
    with pytest.raises(ValueError, match="world size"):
        TransformerTrainer(TransformerConfig(), n_data=3, device="cpu",
                           group=group)


def test_cross_process_pairs_are_host_links():
    from mapreduce_tpu_torch.parallel.mesh import (
        device_link_matrix, partition_devices)

    links = device_link_matrix(partition_devices(4, "cpu", world=2))
    assert links == [["self", "host", "host", "host"],
                     ["host", "self", "host", "host"],
                     ["host", "host", "self", "host"],
                     ["host", "host", "host", "self"]]
    cuda = device_link_matrix(partition_devices(4, "cuda", world=2))
    assert cuda[0][:2] == ["self", "self"] and cuda[0][2:] == ["host"] * 2


#: each rank module's functions that run in a child (the rest is the
#: parent's side, which may import JAX)
RANK_BODIES = {
    "test_torch_multiproc.py": {"_init_group", "_rank_engine",
                                "_rank_combined", "_main", "_mlp_batch"},
    "test_torch_multiproc_session.py": {
        "records_map_fn", "chunk_stream", "run_scenarios", "run_moves",
        "_rank_session", "_main"},
    "test_torch_multiproc_train.py": {
        "_init_group", "pinned_route", "tf_tokens", "fit_data", "_trainer",
        "_fit_record", "_rank_fit", "_rank_transformer", "pipe_batch",
        "pipe_trainer", "_rank_pipeline", "_rank_train", "ring_inputs",
        "_rank_ring", "_rank_pipe", "_main"},
}


def test_rank_body_imports_no_jax():
    """Each rank module's own imports and its rank body's import nothing
    of JAX (the children run them without the JAX package)."""
    import ast

    for module, child in RANK_BODIES.items():
        path = os.path.join(os.path.dirname(__file__), module)
        tree = ast.parse(open(path).read())
        nodes = [n for n in tree.body if isinstance(n, (ast.Import,
                                                        ast.ImportFrom))]
        defined = set()
        for fn in tree.body:
            if isinstance(fn, ast.FunctionDef) and fn.name in child:
                defined.add(fn.name)
                nodes += [n for n in ast.walk(fn)
                          if isinstance(n, (ast.Import, ast.ImportFrom))]
        assert defined == child, (module, child - defined)
        names = [a.name for n in nodes if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in nodes
                  if isinstance(n, ast.ImportFrom)]
        assert names and not [n for n in names if n.split(".")[0] in
                              ("jax", "mapreduce_tpu")], module


if __name__ == "__main__":
    raise SystemExit(_main(sys.argv[1:]))
