"""The port's device word count — the slice end to end — against the JAX
package's, bit for bit.

``DeviceWordCount(Partitions(8, "cpu"), chunk_len=1024)`` runs the same
corpus as the JAX ``DeviceWordCount(make_mesh(), chunk_len=1024)`` with
the lax formulations, over three waves: the ``DeviceResult`` arrays,
the count dicts (and ``Counter(data.split())``) and the exchange traffic
matrix (and ``host_exchange_matrix``) must be equal, including through a
capacity retry.  The port's radix engine (``sort_impl='radix'``: the
radix sorts and the radix exchange plan) must give the same bits as the
JAX lax engine, and so must a partition-map run under the identity
table and under a ``plan_rebalance`` table.  Also here: collision-verify
mode, ``convert``'s round trips, the import lint that keeps JAX out of
the port, and the CUDA-by-default rule of the entry points.
"""

import ast
import dataclasses
import pathlib
from collections import Counter

import numpy as np
import pytest
import torch

from mapreduce_tpu.engine import device_engine as jde
from mapreduce_tpu.engine import wordcount as jwc
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.engine import device_engine as tde
from mapreduce_tpu_torch.engine import wordcount as twc
from mapreduce_tpu_torch.engine.autotune import plan_rebalance
from mapreduce_tpu_torch.ops import kernel_compat as kc
from mapreduce_tpu_torch.parallel.mesh import Partitions

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHUNK = 1024
WAVES = 3
#: the JAX lax-formulation configs (the port converts them)
CFG = jde.EngineConfig(local_capacity=1 << 12, exchange_capacity=1 << 10,
                       out_capacity=1 << 12, combine_in_scan=True)
#: absurd capacities that overflow every stage and force retries
TINY = jde.EngineConfig(local_capacity=4, exchange_capacity=2,
                        out_capacity=4, combine_in_scan=True)


def _corpus(seed=0, n_words=3300):
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, int(rng.integers(1, 10)))
                   .astype(np.uint8)) for _ in range(400)]
    vocab += ["données".encode(), "€".encode(), b"q" * 140, b"hot"]
    ids = rng.zipf(1.3, n_words) % len(vocab)
    seps = [b" ", b"\n", b"  ", b"\t"]
    return b"".join(vocab[i] + seps[int(rng.integers(0, 4))] for i in ids)


DATA = _corpus()


def _jax_run(cfg):
    wc = jwc.DeviceWordCount(make_mesh(), chunk_len=CHUNK, config=cfg)
    chunks, L = wc._to_chunks(DATA)
    tm = {}
    res = wc._engine_for(L).run(chunks, timings=tm, waves=WAVES)
    return wc, chunks, res, tm


def _port_run(cfg, partition_map=None, **over):
    tcfg = convert.engine_config_from_jax(dataclasses.asdict(cfg))
    wc = twc.DeviceWordCount(Partitions(8, "cpu"), chunk_len=CHUNK,
                             config=dataclasses.replace(tcfg, **over),
                             partition_map=partition_map)
    chunks, L = wc._to_chunks(DATA)
    tm = {}
    res = wc._engine_for(L).run(chunks, timings=tm, waves=WAVES)
    return wc, chunks, res, tm


@pytest.fixture(scope="module")
def jax_ref():
    return _jax_run(CFG)


def _pin_result(port_res, jax_res):
    ref = convert.device_result_from_numpy(*jax_res)
    for f in ("keys", "values", "payload", "valid"):
        assert torch.equal(getattr(port_res, f), getattr(ref, f)), f
    assert port_res.overflow == ref.overflow == 0


@pytest.mark.parametrize("cfg_name", ["fitting", "retry"])
def test_wordcount_slice_matches_jax_engine(jax_ref, cfg_name):
    jwc_, jchunks, jres, jtm = jax_ref
    wc, chunks, res, tm = _port_run(CFG if cfg_name == "fitting" else TINY)
    assert np.array_equal(chunks, jchunks)
    assert tm["waves"] == jtm["waves"] == WAVES
    _pin_result(res, jres)
    counts = twc.materialize_counts(chunks, res)
    assert counts == jwc.materialize_counts(jchunks, jres)
    assert counts == Counter(DATA.split())
    matrix = np.asarray(tm["exchange"]["matrix"])
    assert np.array_equal(matrix, wc.host_exchange_matrix(DATA,
                                                          waves=WAVES))
    assert np.array_equal(matrix, np.asarray(jtm["exchange"]["matrix"]))
    if cfg_name == "retry":
        assert tm["retries"] >= 1
    else:
        assert tm["retries"] == 0 and jtm["retries"] == 0


@pytest.mark.parametrize("cfg_name", ["fitting", "retry"])
def test_radix_slice_matches_jax_lax_engine(jax_ref, cfg_name):
    """P = 8, three waves, every sort on the radix versions and the
    exchange on the radix plan: the JAX lax/variadic engine's bits."""
    jwc_, jchunks, jres, jtm = jax_ref
    kc.reset_counts()
    wc, chunks, res, tm = _port_run(CFG if cfg_name == "fitting" else TINY,
                                    sort_impl="radix")
    assert kc.PLAIN_CALLS["radix_plan"] >= WAVES
    assert kc.PLAIN_CALLS["radix_onesweep"] > 0
    _pin_result(res, jres)
    assert twc.materialize_counts(chunks, res) == Counter(DATA.split())
    assert tm["exchange"]["matrix"] == jtm["exchange"]["matrix"]
    assert np.array_equal(np.asarray(tm["exchange"]["matrix"]),
                          wc.host_exchange_matrix(DATA, waves=WAVES))
    assert tm["retries"] >= (1 if cfg_name == "retry" else 0)


def _rebalanced_table(B):
    """A plan_rebalance table from the corpus's own bucket weights (word
    occurrences per bucket ``k1 % B``)."""
    from mapreduce_tpu_torch.ops.tokenize import word_hashes_host

    hashes = word_hashes_host(DATA)
    w = np.zeros(B, dtype=np.int64)
    for word, c in Counter(DATA.split()).items():
        w[hashes[word][0] % B] += c
    return plan_rebalance(w, 8)


@pytest.mark.parametrize("sort_impl", ["variadic", "radix"])
@pytest.mark.parametrize("table", ["identity", "rebalanced"])
def test_partition_map_matches_jax_lax_engine(table, sort_impl):
    """The same table in both engines: the JAX lax engine's bits, and a
    traffic matrix that the host recompute routes through the table."""
    B = jde.PARTITION_MAP_GRANULARITY * 8
    pmap = (jde.identity_pmap(B, 8) if table == "identity"
            else _rebalanced_table(B))
    jcfg = dataclasses.replace(CFG, partition_map=True)
    jwc_ = jwc.DeviceWordCount(make_mesh(), chunk_len=CHUNK, config=jcfg)
    jchunks, L = jwc_._to_chunks(DATA)
    jeng = jwc_._engine_for(L)
    jeng.set_partition_map(pmap)
    jtm = {}
    jres = jeng.run(jchunks, timings=jtm, waves=WAVES)
    wc, chunks, res, tm = _port_run(
        CFG, partition_map=convert.partition_map_from_numpy(pmap, B, 8),
        sort_impl=sort_impl)
    assert np.array_equal(wc._engine_for(L).partition_map(), pmap)
    _pin_result(res, jres)
    assert twc.materialize_counts(chunks, res) == Counter(DATA.split())
    matrix = np.asarray(tm["exchange"]["matrix"])
    assert np.array_equal(matrix, np.asarray(jtm["exchange"]["matrix"]))
    assert np.array_equal(matrix, wc.host_exchange_matrix(DATA,
                                                          waves=WAVES))
    if table == "rebalanced":  # the table moved traffic off k1 % P
        assert not np.array_equal(pmap, jde.identity_pmap(B, 8))
        assert not np.array_equal(
            matrix, twc.DeviceWordCount(
                Partitions(8, "cpu"), chunk_len=CHUNK).host_exchange_matrix(
                    DATA, waves=WAVES))


def test_capacity_retry_matches_jax_retry():
    """Both engines converge from the same absurd capacities to the same
    result (the JAX retry path here is the lax formulation)."""
    _, _, jres, jtm = _jax_run(TINY)
    _, _, res, tm = _port_run(TINY)
    assert jtm["retries"] >= 1 and tm["retries"] >= 1
    _pin_result(res, jres)
    assert tm["exchange"]["matrix"] == jtm["exchange"]["matrix"]


def test_count_bytes_and_verify_collisions():
    want = Counter(DATA.split())
    parts = Partitions(8, "cpu")
    tm = {}
    assert twc.DeviceWordCount(parts, chunk_len=CHUNK).count_bytes(
        DATA, timings=tm) == want
    assert {"compute_s", "upload_s", "materialize_s", "waves"} <= set(tm)
    vwc = twc.DeviceWordCount(parts, chunk_len=CHUNK, verify_collisions=True)
    assert vwc.config.reduce_op == twc.VERIFY_REDUCE_OP
    assert vwc.count_bytes(DATA, waves=2) == want


def test_verify_mode_detects_a_merged_collision():
    """Two distinct words forced onto one key leave min(h3) != max(h3)."""
    chunks = np.frombuffer(b"aa bb ", dtype=np.uint8).reshape(1, -1).copy()
    res = tde.DeviceResult(
        keys=torch.zeros((1, 1, 2), dtype=torch.int32),
        values=torch.tensor([[[2, 5, 9]]], dtype=torch.int32),
        payload=torch.zeros((1, 1, 1), dtype=torch.int32),
        valid=torch.ones((1, 1), dtype=torch.bool), overflow=0)
    with pytest.raises(RuntimeError, match="collision"):
        twc.materialize_counts(chunks, res)


def test_convert_round_trips(jax_ref):
    fields = dataclasses.asdict(jwc.bench_engine_config())
    cfg = convert.engine_config_from_jax(fields)
    assert cfg == twc.bench_engine_config()
    assert dataclasses.asdict(cfg) == fields
    with pytest.raises(ValueError):
        convert.engine_config_from_jax(dict(fields, reduce_op=max))
    with pytest.raises(ValueError):
        convert.engine_config_from_jax(dict(fields, not_a_field=1))
    _, _, jres, _ = jax_ref
    back = convert.device_result_to_numpy(
        convert.device_result_from_numpy(*jres))
    for a, b in zip(back, jres):
        assert np.array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def _port_sources():
    files = sorted((ROOT / "mapreduce_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "probe_plan.py",
                    ROOT / "probe_feeder.py"]


def test_port_imports_no_jax():
    """An AST walk over the port, chip_smoke.py and the probes: no
    ``import jax``, no
    ``from jax...``, nothing of the JAX package ``mapreduce_tpu``."""
    def banned(name):
        top = name.split(".")[0]
        return top == "jax" or top == "mapreduce_tpu"

    files = _port_sources()
    assert len(files) > 30
    walked = {str(f.relative_to(ROOT)) for f in files}
    for module in ("storage/base", "storage/memory", "storage/localdir",
                   "storage/router", "models/checkpoint", "engine/spill",
                   "engine/session", "engine/topk"):
        assert f"mapreduce_tpu_torch/{module}.py" in walked, module
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not banned(name), f"{path.name} imports {name}"


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        twc.DeviceWordCount()
    with pytest.raises(RuntimeError, match="CUDA"):
        Partitions(1)
    assert kc.resolve_device("cpu").type == "cpu"


def test_leftover_engine_options_raise():
    """Unknown formulations are refused; 'radix', partition maps and the
    tiered policies, once refused, now build, and a table is checked
    against the bucket and partition counts."""
    parts = Partitions(8, "cpu")
    for impl in ("tiered", "tiered-radix"):
        eng = tde.DeviceEngine(parts, twc._wordcount_map_fn,
                               tde.EngineConfig(sort_impl=impl))
        assert eng.config.sort_impl == impl
    for bad in (dict(segment_impl="mosaic"), dict(sort_impl="bitonic"),
                dict(sort_impl="tiered-bitonic"),
                dict(partition_map=True, partition_buckets=12)):
        with pytest.raises(ValueError):
            tde.DeviceEngine(parts, twc._wordcount_map_fn,
                             tde.EngineConfig(**bad))
    tde.DeviceEngine(parts, twc._wordcount_map_fn,
                     tde.EngineConfig(sort_impl="radix"))
    eng = tde.DeviceEngine(parts, twc._wordcount_map_fn,
                           tde.EngineConfig(partition_map=True))
    assert eng.partition_buckets == 64
    assert np.array_equal(eng.partition_map(), np.arange(64) % 8)
    with pytest.raises(ValueError, match="outside"):
        eng.set_partition_map(np.full(64, 8))
    with pytest.raises(ValueError, match="buckets"):
        eng.set_partition_map(np.zeros(32))
    with pytest.raises(ValueError, match="partition_map=True"):
        tde.DeviceEngine(parts, twc._wordcount_map_fn).set_partition_map(
            np.zeros(64))
    back = convert.partition_map_to_numpy(
        convert.partition_map_from_numpy(np.arange(64) % 8, 64, 8))
    assert back.dtype == np.int32 and np.array_equal(back, np.arange(64) % 8)
