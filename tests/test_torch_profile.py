"""The port's cost model, peak table, memory model and profile bundles
against the JAX package's, on the CPU.

``analytic_costs`` must equal the JAX function bit for bit over a grid
of its arguments at its default radix pass count (16), and halve the
radix lane bytes at the port's 8 passes; ``record_run`` must derive the
same fields (MFU, roofline share, intensity) for the same costs and
``device_peaks`` the same peaks for the same fake devices (``h100``,
``v5e``, the CPU, an unknown kind, the env overrides).  A bundle written
by either package loads in the other, and ``validate_trace`` rejects
what the JAX one rejects.  Also: the device bucket ladder, the overlap
interval arithmetic, the analytic program footprint, the memory sample
and the capacity-retry classification.
"""

import os
import types

import numpy as np
import pytest
import torch

from mapreduce_tpu.obs import comms as jcomms
from mapreduce_tpu.obs import memory as jmemory
from mapreduce_tpu.obs import metrics as jmetrics
from mapreduce_tpu.obs import profile as jprofile
from mapreduce_tpu_torch.obs import comms as tcomms
from mapreduce_tpu_torch.obs import memory as tmemory
from mapreduce_tpu_torch.obs import metrics as tmetrics
from mapreduce_tpu_torch.obs import profile as tprofile
from mapreduce_tpu_torch.obs.trace import TRACER as TTRACER


def test_device_buckets_equal_jax():
    assert tmetrics.DEVICE_BUCKETS == jmetrics.DEVICE_BUCKETS
    h = tmetrics.REGISTRY.histogram("mrtpu_device_wave_seconds",
                                    buckets=tmetrics.DEVICE_BUCKETS)
    assert h.buckets == jmetrics.DEVICE_BUCKETS


GRID = [(ib, n, rb, fold)
        for ib in (0, 4096, 50_331_648)
        for n in (1, 2, 1000, 10_223_616)
        for rb in (1, 17, 40)
        for fold in (0, 1, 65_536)]


@pytest.mark.parametrize("sort_impl,segment_impl,argsort", [
    (None, "lax", False), ("variadic", "lax", False),
    ("variadic", "pallas", False), ("argsort", "lax", True),
    ("argsort", "pallas", True), ("radix", "lax", False),
    ("radix", "pallas", False), ("radix", "lax", True)])
def test_analytic_costs_equal_jax(sort_impl, segment_impl, argsort):
    for ib, n, rb, fold in GRID:
        kw = dict(fold_records=fold, argsort=argsort,
                  segment_impl=segment_impl, sort_impl=sort_impl)
        got = tprofile.analytic_costs(ib, n, rb, **kw)
        assert got == jprofile.analytic_costs(ib, n, rb, **kw), (ib, n, rb)
        assert got == tprofile.analytic_costs(ib, n, rb, radix_passes=16,
                                              **kw)


def test_port_radix_passes_halve_the_lane_terms():
    kw = dict(fold_records=0, segment_impl="pallas", sort_impl="radix")
    n, rb = 1_000_000, 17
    jx = tprofile.analytic_costs(0, n, rb, **kw)
    port = tprofile.analytic_costs(0, n, rb, radix_passes=8, **kw)
    lane16 = 2 * 12 * 16 * n
    assert jx["bytes"] - port["bytes"] == lane16 // 2
    assert jx["flops"] - port["flops"] == 8 * (16 + 8) * n


class FakeDevice:
    def __init__(self, kind, platform):
        self.device_kind = kind
        self.platform = platform


DEVICES = [FakeDevice("NVIDIA H100 80GB HBM3", "gpu"),
           FakeDevice("TPU v5 lite", "tpu"), FakeDevice("cpu", "cpu"),
           FakeDevice("mystery", "mystery"), None]


@pytest.mark.parametrize("env", [
    {}, {"MAPREDUCE_TPU_PEAK_FLOPS": "1e15"},
    {"MAPREDUCE_TPU_PEAK_BYTES_PER_S": "2e12"},
    {"MAPREDUCE_TPU_PEAK_FLOPS": "1e15",
     "MAPREDUCE_TPU_PEAK_BYTES_PER_S": "2e12"}])
def test_device_peaks_and_record_run_equal_jax(monkeypatch, env):
    for k in ("MAPREDUCE_TPU_PEAK_FLOPS", "MAPREDUCE_TPU_PEAK_BYTES_PER_S"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    costs = {"flops": 3.5e10, "bytes": 8.25e9, "source": "analytic"}
    for dev in DEVICES:
        assert tprofile.device_peaks(dev) == jprofile.device_peaks(dev)
        for compute_s in (0.0, 0.0394, 2.5):
            for n_dev in (1, 8):
                args = dict(waves=2, compute_s=compute_s, n_dev=n_dev,
                            device=dev, task="cmp")
                assert tprofile.record_run(costs, **args) == \
                    jprofile.record_run(costs, **args)
    if not env:
        h100 = tprofile.device_peaks(DEVICES[0])
        assert h100 == {"flops_per_s": 989e12, "bytes_per_s": 3350e9,
                        "peak_source": "kind:h100"}


def test_describe_device_reads_the_torch_device():
    kind = tprofile.describe_device(torch.device("cpu"))
    assert (kind.device_kind, kind.platform) == ("cpu", "cpu")
    assert tprofile.device_peaks(kind)["peak_source"] == "platform:cpu"


def test_device_snapshot_has_the_jax_keys():
    assert set(tprofile.device_snapshot()) == set(jprofile.device_snapshot())


# -- bundles -------------------------------------------------------------------


def test_port_bundle_loads_in_jax_and_back(tmp_path):
    with TTRACER.span("bundle-probe", attempt=0):
        pass
    tmemory.sample_device_memory([torch.device("cpu")],
                                 analytic_bytes_in_use=1234)
    prof = tmp_path / "torch_trace"
    prof.mkdir()
    out = tprofile.write_bundle(str(tmp_path / "b"),
                                torch_trace_dir=str(prof))
    b = jprofile.load_bundle(out)
    assert b["manifest"]["torch_version"] == torch.__version__
    assert b["manifest"]["torch_trace_dir"] == "../torch_trace"
    assert set(b["statusz"]) >= {"tasks", "device", "memory"}
    assert any(e["name"] == "bundle-probe"
               for e in b["trace"]["traceEvents"])
    again = tprofile.load_bundle(out)
    assert again["metrics"] == b["metrics"]
    assert sorted(os.listdir(out)) == sorted(again["manifest"]["files"]
                                             + ["manifest.json"])


def test_jax_bundle_loads_in_the_port(tmp_path):
    out = jprofile.write_bundle(str(tmp_path / "jb"))
    b = tprofile.load_bundle(out)
    assert b["manifest"]["kind"] == "mrtpu-profile-bundle"
    assert "device" in b["statusz"]


def test_write_bundle_refuses_a_bad_trace(tmp_path):
    with pytest.raises(ValueError):
        tprofile.write_bundle(str(tmp_path / "x"),
                              trace_doc={"traceEvents": [{"ph": "X"}]})
    with pytest.raises(ValueError):
        tprofile.write_bundle(str(tmp_path / "y"),
                              metrics_text="not a metric line\n")


BAD_TRACES = [
    [], {"events": []}, {"traceEvents": {}}, {"traceEvents": [1]},
    {"traceEvents": [{"ph": "M", "name": "n"}]},
    {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "dur": 0,
                      "pid": 1}]},
    {"traceEvents": [{"name": "a", "ph": "B", "ts": 0, "dur": 0,
                      "pid": 1, "tid": 1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "ts": -1, "dur": 0,
                      "pid": 1, "tid": 1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "ts": "0", "dur": 0,
                      "pid": 1, "tid": 1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "dur": -2,
                      "pid": 1, "tid": 1}]},
]
GOOD_TRACES = [
    {"traceEvents": []},
    {"traceEvents": [{"name": "p", "ph": "M", "pid": 1},
                     {"name": "a", "ph": "X", "ts": 0.5, "dur": 0,
                      "pid": 1, "tid": 1}]},
]


@pytest.mark.parametrize("doc", BAD_TRACES + GOOD_TRACES)
def test_validate_trace_agrees_with_jax(doc):
    def verdict(fn):
        try:
            fn(doc)
        except ValueError as exc:
            return str(exc)
        return None

    got = verdict(tprofile.validate_trace)
    assert got == verdict(jprofile.validate_trace)
    assert (got is None) == (doc in GOOD_TRACES)


# -- overlap and memory ----------------------------------------------------------


def test_overlap_arithmetic_equals_jax():
    rng = np.random.default_rng(7)
    for _ in range(200):
        def ivals():
            t0 = rng.uniform(0, 0.1, int(rng.integers(0, 6)))
            return [(float(a), float(a + d)) for a, d in
                    zip(t0, rng.uniform(-0.001, 0.02, t0.size))]

        up, busy = ivals(), ivals()
        assert tcomms._union_length(up) == jcomms._union_length(up)
        assert tcomms._intersect(up, busy) == jcomms._intersect(up, busy)
        assert tcomms.overlap_fraction(up, busy) == \
            jcomms.overlap_fraction(up, busy)
    assert tcomms.record_upload_overlap(1.7) == 1.0
    assert tmetrics.REGISTRY.value("mrtpu_upload_overlap_frac") == 1.0
    assert tcomms.record_upload_overlap(-0.2) == 0.0


def test_analytic_program_memory_equals_jax():
    arrs = [np.zeros((16, 1024), np.uint8), np.zeros((8, 4096, 2), np.int32),
            np.zeros((8, 4096), np.bool_), np.zeros(()), np.zeros(3, np.int64)]
    assert tmemory.analytic_program_memory(arrs, arrs[:2]) == \
        jmemory.analytic_program_memory(arrs, arrs[:2])
    tensors = [torch.from_numpy(a) for a in arrs]
    assert tmemory.analytic_program_memory(tensors) == \
        jmemory.analytic_program_memory(arrs)


def test_cpu_memory_sample_equals_jax_on_one_device():
    import jax

    got = tmemory.sample_device_memory([torch.device("cpu")],
                                       analytic_bytes_in_use=4096)
    want = jmemory.sample_device_memory([jax.devices("cpu")[0]],
                                        analytic_bytes_in_use=4096)
    assert got == want == {"devices": {"0": {"bytes_in_use": 4096}},
                           "source": "analytic"}
    assert tmemory.sample_device_memory([torch.device("cpu")]) == {
        "devices": {}, "source": "analytic"}
    tmemory.record_program_memory("wave", {"total": 10, "source": "analytic"})
    snap = tmemory.memory_snapshot()
    assert snap["programs"]["wave"]["total"] == 10


@pytest.mark.parametrize("in_use,footprint,want", [
    (10 << 30, 0, "capacity"), (70 << 30, 0, "hbm"),
    (1 << 30, 72 << 30, "hbm"), (0, 0, "capacity")])
def test_capacity_retry_classification_equals_jax(monkeypatch, in_use,
                                                  footprint, want):
    """The same device-memory state classifies the same in both
    packages: a fake card (80 GiB) for the port's allocator read, a
    fake JAX device with ``memory_stats()`` for the JAX one."""
    stats = {"bytes_in_use": in_use, "peak_bytes_in_use": in_use,
             "bytes_limit": 80 << 30}
    monkeypatch.setattr(tmemory, "_cuda_stats", lambda index: dict(stats))
    card = types.SimpleNamespace(type="cuda", index=0)
    jdev = types.SimpleNamespace(id=0, platform="gpu",
                                 memory_stats=lambda: dict(stats))
    args = dict(task="cls", attempt=0, overflow_rows=5,
                program_memory_doc={"total": footprint},
                old_capacities={"out_capacity": 4},
                new_capacities={"out_capacity": 32})
    got = tmemory.capacity_retry_event(devices=[card], **args)
    assert got == jmemory.capacity_retry_event(devices=[jdev], **args) \
        == want
    ev = [e for e in TTRACER.events() if e["name"] == "capacity_retry"][-1]
    assert ev["args"]["bound"] == want
    assert ev["args"]["device_memory"]["devices"]["0"] == stats
