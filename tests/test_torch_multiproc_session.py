"""The port's resident session over a process group.

The JAX ``EngineSession`` runs on a mesh that spans ``jax.distributed``
processes, every host readback all-gathered (``DeviceEngine._host``).
The port's counterpart: two gloo rank processes on the CPU (``python -m
tests.test_torch_multiproc_session session RANK 2 PORT ROOT OUT
[DEVICE]``, no JAX in the rank body; ``tests/test_torch_cuda.py`` runs
them on the card), each ``EngineSession(Partitions(8, "cpu",
group=WORLD), ...)`` holding 4 of the 8 partitions and fed the identical
chunks, run every scenario in one spawn while the parent computes the
references.  Held (tolerance: none):

* every snapshot, through several uneven feeds, on the variadic and the
  radix paths, is bit-equal on both ranks, to a one-process
  ``EngineSession(Partitions(8, "cpu"))`` fed the same chunks and to the
  JAX session on its 8-device CPU mesh (the lax formulations);
* a feed that overflows raises ``SessionOverflowError`` on both ranks
  with the same count, and a counted overflow is the one-process and
  the JAX session's loss;
* a mid-stream rebalance under a ``plan_rebalance`` table of the
  gathered bucket histogram: the histogram, the traffic matrix and the
  snapshots are the one-process session's and the JAX session's;
* an evict and a lazy restore mid-stream end bit-equal to the
  uninterrupted stream; the group's spill is a one-process spill's
  files, and it restores bit-equal in one process and through the JAX
  ``SessionSpillStore``;
* the skew controller (``AutoTuner``) rebalances a skewed stream on both
  ranks alike, from the traffic window and the gathered histogram: the
  same tables, snapshots and control decisions as in one process;
* a resident cap of one evicts the colder stream on both ranks, from
  the ranks' gathered ages, and its lazy restore reads as in one
  process.
"""

import datetime
import json
import os
import sys

import numpy as np
import torch

from tests.test_torch_multiproc import RANK_THREADS, _start, _wait

#: seconds a collective may wait for the other rank before it fails
GROUP_TIMEOUT_S = 60
P = 8
K = 2
#: the small config of tests/test_session.py, as the port spells it
CFG = dict(local_capacity=256, exchange_capacity=128, out_capacity=256,
           tile=64, tile_records=64, reduce_op="sum")
TINY = dict(CFG, local_capacity=8, exchange_capacity=4, out_capacity=8)
FIELDS = ("keys", "values", "payload", "valid")


def records_map_fn(chunk, chunk_index, cfg):
    """``tests.test_torch_session.records_map_fn`` (the torch twin of the
    JAX tests' ``_records_map_fn``), here so the ranks import no JAX."""
    c = chunk.to(torch.int64)
    k1 = (c % 23).to(torch.int32)
    k2 = (c % 5).to(torch.int32)
    keys = torch.stack([k1, k2], dim=-1)
    vals = (c % 101).to(torch.int32) + 1
    pay = (k1 * 7 + k2)[:, None]
    valid = (c % 7) != 0
    return keys, vals, pay, valid, torch.zeros((), dtype=torch.int32)


def skew_map_fn(chunk, chunk_index, cfg):
    """``tests.test_torch_autotune.skew_map_fn_t``: every key congruent
    to partition 5 under the identity map, spread over the buckets."""
    c = chunk.to(torch.int64)
    k1 = (c % 8) * 8 + 5
    keys = torch.stack([k1, c % 5], dim=-1).to(torch.int32)
    return (keys, torch.ones_like(c, dtype=torch.int32),
            k1.to(torch.int32)[:, None], torch.ones_like(c, dtype=torch.bool),
            torch.zeros((), dtype=torch.int32))


def chunk_stream(seed, s, r=32):
    return np.random.default_rng(seed).integers(
        0, 1 << 14, size=(s, r)).astype(np.int32)


#: the feeds of the variadic and radix streams (cut uneven)
STREAM = chunk_stream(10, 5 * K * P)
STREAM_CUTS = (0, 2 * K * P - 3, 5 * K * P)
#: the rebalanced stream, fed in two halves
REBALANCE = chunk_stream(16, 4 * K * P)
#: the spilled stream (k = 1): evicted after the first half
SPILL = chunk_stream(7, 48)
SPILL_HALF = 24
OVERFLOW = chunk_stream(11, P, r=256)
#: the skewed stream the controllers rebalance (tests/test_control.py's
#: PMAP_CFG, the port's spelling), fed three times
SKEW = chunk_stream(3, 48)
SKEW_CFG = dict(local_capacity=512, exchange_capacity=512,
                out_capacity=512, tile=64, tile_records=32,
                partition_map=True)


# -- the scenarios, each run alike by a rank and by the parent ---------------


def run_scenarios(parts, root, store_of):
    """Every scenario on sessions over *parts*: ``(arrays, meta)``, each
    snapshot's fields under ``<scenario>.<n>.<field>``.  *store_of* maps
    a spill directory to a spill store; the rebalance uses the table
    ``plan_rebalance`` makes of the gathered histogram."""
    from mapreduce_tpu_torch.engine import device_engine as tde
    from mapreduce_tpu_torch.engine import session as tsession
    from mapreduce_tpu_torch.engine.autotune import AutoTuner, plan_rebalance
    from mapreduce_tpu_torch.obs.control import ControlLedger
    from mapreduce_tpu_torch.engine.spill import SpillPolicy

    out, meta = {}, {}

    def keep(label, snap):
        for f in FIELDS:
            out[f"{label}.{f}"] = getattr(snap, f).numpy()
        meta[f"{label}.overflow"] = snap.overflow

    def session(cfg, k=K, **kw):
        return tsession.EngineSession(parts, records_map_fn,
                                      tde.EngineConfig(**cfg), k=k, **kw)

    for name, cfg in (("variadic", CFG), ("radix", dict(CFG,
                                                        sort_impl="radix"))):
        s = session(cfg)
        for i, (lo, hi) in enumerate(zip(STREAM_CUTS, STREAM_CUTS[1:])):
            assert s.feed(STREAM[lo:hi], task="t") == 0
            keep(f"{name}.{i}", s.snapshot("t"))
        meta[f"{name}.stats"] = s.stats("t")

    s = session(TINY, k=1)
    try:
        s.feed(OVERFLOW, task="t")
        meta["overflow.raised"] = None
    except tsession.SessionOverflowError as exc:
        meta["overflow.raised"] = str(exc)
    meta["overflow.stats"] = s.stats("t")
    meta["overflow.counted"] = s.feed(OVERFLOW, task="t2",
                                      on_overflow="count")
    keep("overflow.0", s.snapshot("t2"))

    s = session(dict(CFG, partition_map=True))
    half = REBALANCE.shape[0] // 2
    s.feed(REBALANCE[:half], task="t")
    hist = s.bucket_histogram("t")
    out["rebalance.hist"] = hist
    table = plan_rebalance(np.arange(hist.size) % 5 + hist, P)
    s.rebalance("t", table)
    out["rebalance.table"] = s.partition_map("t")
    keep("rebalance.0", s.snapshot("t"))
    s.feed(REBALANCE[half:], task="t")
    keep("rebalance.1", s.snapshot("t"))
    out["rebalance.traffic"] = s.traffic_matrix("t")
    meta["rebalance.stats"] = s.stats("t")

    s = session(CFG, k=1, spill=store_of(os.path.join(root, "spill")))
    s.feed(SPILL[:SPILL_HALF])
    meta["spill.evicted"] = s.evict()
    meta["spill.resident"] = s.tasks()
    s.feed(SPILL[SPILL_HALF:])  # the lazy restore, then the rest
    keep("spill.0", s.snapshot())
    meta["spill.step"] = s.spill_stream()
    meta["spill.stats"] = s.stats()

    # the controllers: the skew controller reads the (global) traffic
    # window and the gathered histogram, the capacity one the all-reduced
    # overflow, so every rank records the same decisions
    ledger = ControlLedger()
    s = tsession.EngineSession(
        parts, skew_map_fn, tde.EngineConfig(**SKEW_CFG), k=K,
        autotune=AutoTuner(ledger=ledger, min_records=64))
    for i in range(3):
        s.feed(SKEW, task="zipf")
        out[f"skew.{i}.table"] = s.partition_map("zipf")
        keep(f"skew.{i}", s.snapshot("zipf"))
    meta["skew.stats"] = s.stats("zipf")
    meta["skew.decisions"] = [
        {k: v for k, v in d.items() if k not in ("time", "monotonic",
                                                 "age_s")}
        for d in ledger.decisions()]

    # a resident cap of one: the colder stream is evicted on every rank
    s = session(CFG, k=1, spill=store_of(os.path.join(root, "policy")),
                spill_policy=SpillPolicy(max_resident=1))
    s.feed(SPILL[:P], task="a")
    s.feed(SPILL[P:2 * P], task="b")
    meta["policy.resident"] = s.tasks()
    keep("policy.0", s.snapshot("a"))  # restored lazily
    return out, meta


# -- the rank body (run as a module in each child) ----------------------------


def _rank_session(rank, world, port, root, out_path, device="cpu"):
    import torch.distributed as dist

    from mapreduce_tpu_torch.engine import spill as tspill
    from mapreduce_tpu_torch.ops import kernel_compat as kc
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.storage.router import router

    torch.set_num_threads(RANK_THREADS)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        parts = Partitions(P, device, group=dist.group.WORLD)
        assert (parts.n_local, parts.lo) == (P // world, rank * P // world)
        kc.reset_counts()
        out, meta = run_scenarios(parts, os.path.join(root, "group"),
                                  lambda d: tspill.SessionSpillStore(
                                      router(f"shared:{d}")))
        meta["plain_calls"] = dict(kc.PLAIN_CALLS)
        meta["launches"] = dict(kc.LAUNCHES)
        dist.barrier()
        np.savez(out_path, **out)
        with open(out_path + ".json", "w") as f:
            json.dump(meta, f)
    finally:
        dist.destroy_process_group()


def _main(argv) -> int:
    _rank_session(int(argv[1]), int(argv[2]), int(argv[3]), *argv[4:7])
    return 0


# -- the parent side ----------------------------------------------------------


def _jax_references():
    """The JAX session on its 8-device CPU mesh through the same feeds:
    ``{label: (keys, values, payload, valid, overflow)}`` and extras."""
    from mapreduce_tpu.engine import device_engine as jde
    from mapreduce_tpu.engine import session as jsession
    from mapreduce_tpu.parallel import make_mesh
    from tests.test_fused_engine import _records_map_fn

    mesh = make_mesh()
    snaps, extra = {}, {}

    def session(cfg, k=K, **kw):
        return jsession.EngineSession(mesh, _records_map_fn,
                                      jde.EngineConfig(**cfg), k=k, **kw)

    s = session(CFG)
    for i, (lo, hi) in enumerate(zip(STREAM_CUTS, STREAM_CUTS[1:])):
        s.feed(STREAM[lo:hi], task="t")
        snaps[f"variadic.{i}"] = snaps[f"radix.{i}"] = s.snapshot("t")
    s = session(TINY, k=1)
    extra["overflow.counted"] = s.feed(OVERFLOW, task="t2",
                                       on_overflow="count")
    snaps["overflow.0"] = s.snapshot("t2")
    return mesh, session, snaps, extra


def _held(label, rank_arrays, rank_meta, want):
    """Each rank's snapshot *label* bit-equal to *want* (a port
    ``DeviceResult`` or a JAX result tuple)."""
    from mapreduce_tpu_torch import convert

    if not isinstance(want.keys, torch.Tensor):  # a JAX result
        want = convert.device_result_from_numpy(*want)
    for arrays, meta in zip(rank_arrays, rank_meta):
        for f in FIELDS:
            assert np.array_equal(arrays[f"{label}.{f}"],
                                  getattr(want, f).numpy()), (label, f)
        assert meta[f"{label}.overflow"] == want.overflow, label


def test_group_session_matches_one_process_and_jax(tmp_path):
    from mapreduce_tpu.engine import spill as jspill
    from mapreduce_tpu.storage.router import router as jopen
    from mapreduce_tpu_torch.engine import spill as tspill
    from mapreduce_tpu_torch.engine import device_engine as tde
    from mapreduce_tpu_torch.engine import session as tsession
    from mapreduce_tpu_torch.parallel.mesh import Partitions
    from mapreduce_tpu_torch.storage.router import router as topen

    procs = _start("session", str(tmp_path),
                   lambda r: str(tmp_path / f"rank{r}.npz"),
                   module="tests.test_torch_multiproc_session")
    # the references run while the ranks do, on as few threads as a
    # rank (the suite's other workers share the host)
    threads = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    try:
        one, one_meta = run_scenarios(
            Partitions(P, "cpu"), str(tmp_path / "one"),
            lambda d: tspill.SessionSpillStore(topen(f"shared:{d}")))
        mesh, jax_session, jsnaps, jextra = _jax_references()
        outs = _wait(procs)
    finally:
        torch.set_num_threads(threads)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out}"
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    metas = [json.loads((tmp_path / f"rank{r}.npz.json").read_text())
             for r in range(2)]
    one_meta = json.loads(json.dumps(one_meta))  # tuples as lists

    # every array and every counter: both ranks, and one process
    assert set(ranks[0]) == set(ranks[1]) == set(one)
    for name, a in one.items():
        for rk in ranks:
            assert np.array_equal(rk[name], a), name
    plain = [m.pop("plain_calls") for m in metas]
    assert not any(v for m in metas for v in m.pop("launches").values())
    assert metas[0] == metas[1] == one_meta
    # the radix path ran its kernels' plain versions on both ranks
    assert all(p["radix_plan"] > 0 and p["radix_onesweep"] > 0
               for p in plain)
    meta = metas[0]
    assert meta["variadic.stats"] == {"chunks": 5 * K * P, "waves": 6,
                                      "feeds": 2, "overflow": 0}
    # the overflow raised on both ranks with the same count
    assert "overflowed" in meta["overflow.raised"]
    assert meta["overflow.stats"]["overflow"] > 0
    assert meta["overflow.counted"] == jextra["overflow.counted"] > 0
    assert meta["policy.resident"] == ["b"]
    assert meta["skew.stats"]["rebalances"] >= 1
    assert [d["outcome"] for d in meta["skew.decisions"]
            if d["controller"] == "repartition"][:1] == ["improved"]

    # the JAX session: each stream's snapshots
    for label, want in jsnaps.items():
        _held(label, ranks, metas, want)
    js = jax_session(dict(CFG, partition_map=True))
    half = REBALANCE.shape[0] // 2
    js.feed(REBALANCE[:half], task="t")
    assert np.array_equal(js.bucket_histogram("t"), ranks[0]["rebalance.hist"])
    js.rebalance("t", ranks[0]["rebalance.table"])
    _held("rebalance.0", ranks, metas, js.snapshot("t"))
    js.feed(REBALANCE[half:], task="t")
    _held("rebalance.1", ranks, metas, js.snapshot("t"))
    assert np.array_equal(js.traffic_matrix("t"),
                          ranks[0]["rebalance.traffic"])
    whole = jax_session(CFG, k=1)
    whole.feed(SPILL)
    _held("spill.0", ranks, metas, whole.snapshot())

    # the group's spill: a one-process spill's files ...
    gdir, odir = tmp_path / "group" / "spill", tmp_path / "one" / "spill"
    assert sorted(os.listdir(gdir)) == sorted(os.listdir(odir))
    for name in os.listdir(gdir):
        if (gdir / name).is_file():
            assert (gdir / name).read_bytes() == (odir / name).read_bytes()
    # ... restored in one process ...
    back = tsession.EngineSession(
        Partitions(P, "cpu"), records_map_fn, tde.EngineConfig(**CFG), k=1,
        spill=tspill.SessionSpillStore(topen(f"shared:{gdir}")))
    _held("spill.0", ranks, metas, back.snapshot())
    assert back.stats() == meta["spill.stats"]
    # ... and in the JAX package
    jback = jax_session(CFG, k=1, spill=jspill.SessionSpillStore(
        jopen(f"shared:{gdir}")))
    _held("spill.0", ranks, metas, jback.snapshot())
    assert jback.stats() == meta["spill.stats"]


if __name__ == "__main__":
    raise SystemExit(_main(sys.argv[1:]))
