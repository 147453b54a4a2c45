"""The port's tier policy (``sort_impl='tiered'`` / ``'tiered-radix'``)
against the JAX package, and the build plane's lock.

Every tiered run here is held bit for bit (tolerance: none) against the
JAX ``lax`` engine's ``'variadic'`` run of the same corpus, three waves
over ``Partitions(8, "cpu")`` at ``chunk_len=1024``: the
``DeviceResult`` and the traffic matrix, whichever tier served which
wave.  The JAX tiers themselves (``'argsort'`` and ``'variadic'``) give
the same bits.  On the CPU a tiered run is warm unless
``tiering.force_cold()`` is in effect; the specializer's one step,
``tiering.specialize``, is replaced here to block on an event (always
with a timeout) or to raise, so when the swap happens is fixed by the
test.
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

from mapreduce_tpu.engine import device_engine as jde
from mapreduce_tpu.engine import wordcount as jwc
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.engine import device_engine as tde
from mapreduce_tpu_torch.engine import tiering
from mapreduce_tpu_torch.engine import wordcount as twc
from mapreduce_tpu_torch.ops import kernel_compat as kc
from mapreduce_tpu_torch.parallel.mesh import Partitions
from mapreduce_tpu_torch.utils import compile_cache
from tests.test_torch_wordcount import (
    CFG, CHUNK, DATA, TINY, WAVES, _jax_run, _pin_result, _port_run)

#: seconds any wait of these tests may take before it fails
TIMEOUT = 60


@pytest.fixture(scope="module")
def jax_ref():
    return _jax_run(CFG)


def _pin(res, tm, jax_ref):
    _, _, jres, jtm = jax_ref
    _pin_result(res, jres)
    assert tm["exchange"]["matrix"] == jtm["exchange"]["matrix"]


def test_jax_tiers_are_bit_identical(jax_ref):
    """The JAX tier-0 formulation ('argsort') gives the 'variadic' bits
    the port's tiers are held to."""
    _, _, jres, jtm = jax_ref
    wc = jwc.DeviceWordCount(make_mesh(), chunk_len=CHUNK,
                             config=dataclasses.replace(
                                 CFG, sort_impl="argsort"))
    chunks, L = wc._to_chunks(DATA)
    tm = {}
    res = wc._engine_for(L).run(chunks, timings=tm, waves=WAVES)
    for f in ("keys", "values", "payload", "valid"):
        assert np.array_equal(getattr(res, f), getattr(jres, f)), f
    assert res.overflow == jres.overflow == 0
    assert tm["exchange"]["matrix"] == jtm["exchange"]["matrix"]
    assert jde._tier_cfgs(dataclasses.replace(CFG, sort_impl="tiered"))[
        0].sort_impl == "argsort"


@pytest.mark.parametrize("policy,label", [("tiered", "1"),
                                          ("tiered-radix", "radix")])
def test_warm_tiered_serves_tier1_and_matches_jax(jax_ref, policy, label):
    kc.reset_counts()
    before = dict(tiering.TIER_COUNTS)
    _, _, res, tm = _port_run(CFG, sort_impl=policy)
    _pin(res, tm, jax_ref)
    assert (tm["serving_tier"], tm["tier_cold_start"], tm["tier_swaps"]) \
        == (label, False, 0)
    assert tm["tier_specialize_failed"] is None
    assert tiering.TIER_COUNTS == before
    # tier 1 of 'tiered-radix' sorts on the radix versions
    assert (kc.PLAIN_CALLS["radix_onesweep"] > 0) == (policy
                                                      == "tiered-radix")


def _held_build(monkeypatch):
    """Replace the specializer's step with one that waits for the
    returned event (at most TIMEOUT seconds)."""
    go = threading.Event()

    def held(names, device, foreground=()):
        if not go.wait(TIMEOUT):
            raise TimeoutError("the test never released the build")

    monkeypatch.setattr(tiering, "specialize", held)
    return go


def _engine(policy, cfg=CFG):
    tcfg = convert.engine_config_from_jax(dataclasses.asdict(cfg))
    wc = twc.DeviceWordCount(
        Partitions(8, "cpu"), chunk_len=CHUNK,
        config=dataclasses.replace(tcfg, sort_impl=policy))
    chunks, L = wc._to_chunks(DATA)
    return wc._engine_for(L), chunks


def test_forced_cold_held_build_serves_tier0_to_the_end(jax_ref,
                                                        monkeypatch):
    go = _held_build(monkeypatch)
    eng, chunks = _engine("tiered-radix")
    cold = tiering.TIER_COUNTS["cold_starts"]
    kc.reset_counts()
    tm = {}
    with tiering.force_cold():
        res = eng.run(chunks, timings=tm, waves=WAVES)
    _pin(res, tm, jax_ref)
    assert (tm["serving_tier"], tm["tier_cold_start"], tm["tier_swaps"]) \
        == ("0", True, 0)
    assert kc.PLAIN_CALLS["radix_onesweep"] == 0  # tier 0 never sorted radix
    assert tiering.TIER_COUNTS["cold_starts"] == cold + 1
    key = ("tokenize", "segreduce", "radix")
    assert eng.specializer.target_key() == key
    go.set()
    assert eng.specializer.wait(key, TIMEOUT)
    assert eng.specializer.ready(key)


@pytest.mark.parametrize("policy,label", [("tiered", "1"),
                                          ("tiered-radix", "radix")])
def test_build_released_between_waves_swaps_once(jax_ref, monkeypatch,
                                                 policy, label):
    """The build lands after wave 0: wave 1 is the boundary where the
    run swaps, exactly once, and the carry threads through."""
    go = _held_build(monkeypatch)
    eng, chunks = _engine(policy)
    served = []
    real_wave = eng._wave

    def wave_then_release(cfg, *args):
        out = real_wave(cfg, *args)
        served.append(cfg.sort_impl)
        if len(served) == 1:
            go.set()
            assert eng.specializer.wait(
                kc.sources_for(tde._tier_cfgs(eng.config)[1]), TIMEOUT)
        return out

    monkeypatch.setattr(eng, "_wave", wave_then_release)
    swaps = tiering.TIER_COUNTS["swaps"]
    tm = {}
    with tiering.force_cold():
        res = eng.run(chunks, timings=tm, waves=WAVES)
    _pin(res, tm, jax_ref)
    steady = "radix" if policy == "tiered-radix" else "variadic"
    assert served == ["argsort", steady, steady]
    assert (tm["serving_tier"], tm["tier_cold_start"], tm["tier_swaps"]) \
        == (label, True, 1)
    assert tiering.TIER_COUNTS["swaps"] == swaps + 1


def test_failed_build_is_counted_and_tier0_finishes(jax_ref, monkeypatch,
                                                    caplog):
    def broken(names, device, foreground=()):
        raise RuntimeError("nvcc exploded")

    monkeypatch.setattr(tiering, "specialize", broken)
    eng, chunks = _engine("tiered-radix")
    key = ("tokenize", "segreduce", "radix")
    real_wave = eng._wave

    def wave_then_wait(cfg, *args):
        out = real_wave(cfg, *args)
        assert eng.specializer.wait(key, TIMEOUT)
        return out

    monkeypatch.setattr(eng, "_wave", wave_then_wait)
    failed = tiering.TIER_COUNTS["specialize_failed"]
    tm = {}
    with tiering.force_cold(), caplog.at_level("WARNING"):
        res = eng.run(chunks, timings=tm, waves=WAVES)
    _pin(res, tm, jax_ref)
    assert tiering.TIER_COUNTS["specialize_failed"] == failed + 1
    assert "nvcc exploded" in tm["tier_specialize_failed"]
    assert (tm["serving_tier"], tm["tier_swaps"]) == ("0", 0)
    assert eng.specializer.failed(key) and not eng.specializer.ready(key)
    assert "tier 0 keeps serving" in caplog.text


def test_capacity_retry_under_cold_policy_reenters_tier0(jax_ref,
                                                         monkeypatch):
    """A retry's fresh dispatcher re-probes: with the build still held,
    every attempt starts cold on tier 0, and the result converges to the
    JAX bits."""
    go = _held_build(monkeypatch)
    eng, chunks = _engine("tiered-radix", TINY)
    cold = tiering.TIER_COUNTS["cold_starts"]
    tm = {}
    with tiering.force_cold():
        res = eng.run(chunks, timings=tm, waves=WAVES)
    _pin(res, tm, jax_ref)
    assert tm["retries"] >= 1
    assert (tm["serving_tier"], tm["tier_cold_start"], tm["tier_swaps"]) \
        == ("0", True, 0)
    assert tiering.TIER_COUNTS["cold_starts"] == cold + tm["retries"] + 1
    go.set()
    assert eng.specializer.wait(("tokenize", "segreduce", "radix"),
                                TIMEOUT)


def test_specializer_threads_are_daemons(monkeypatch):
    go = _held_build(monkeypatch)
    spec = tiering.TierSpecializer()
    spec.submit(("radix",), kc.resolve_device("cpu"))
    assert spec.target_key() == ("radix",)
    assert spec._thread.daemon
    assert not spec.wait(("radix",), 0.05)
    go.set()
    assert spec.wait(("radix",), TIMEOUT) and spec.ready(("radix",))
    assert spec.seconds[("radix",)] >= 0


def test_library_lock_builds_once(monkeypatch, tmp_path):
    """Eight threads asking for one unbuilt library: one build, one
    load, every thread the same library."""
    monkeypatch.setattr(compile_cache, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(kc, "_LIBS", {})
    calls = {"start": 0, "finish": 0, "load": 0}

    def start(name, defines=()):
        calls["start"] += 1
        time.sleep(0.05)  # widen the window a racing thread would use
        return "proc"

    def finish(name, proc, defines=()):
        assert proc == "proc"
        calls["finish"] += 1

    class FakeLib:
        def __init__(self, path):
            calls["load"] += 1

    monkeypatch.setattr(kc, "_start_build", start)
    monkeypatch.setattr(kc, "_finish_build", finish)
    monkeypatch.setattr(kc.ctypes, "CDLL", FakeLib)
    libs = []
    barrier = threading.Barrier(8)

    def ask():
        barrier.wait(TIMEOUT)
        libs.append(kc.library("segreduce", {}))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"start": 1, "finish": 1, "load": 1}
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)


def test_build_plane_probes(monkeypatch, tmp_path):
    """sources_for names a config's libraries; is_built reads the
    process's loaded libraries and the build cache."""
    cfg = tde.EngineConfig()
    assert kc.sources_for(cfg) == ("tokenize", "segreduce")
    assert kc.sources_for(dataclasses.replace(cfg, sort_impl="radix")) \
        == ("tokenize", "segreduce", "radix")
    monkeypatch.setattr(compile_cache, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(kc, "_LIBS", {})
    assert not kc.is_built("radix")
    kc._lib_path("radix").write_bytes(b"")
    assert kc.is_built("radix") and not kc.is_built("tokenize")
    kc._LIBS[("tokenize", ())] = object()
    assert kc.is_built("tokenize")
    eng = tde.DeviceEngine(Partitions(8, "cpu"), lambda *a: None,
                           dataclasses.replace(cfg,
                                               sort_impl="tiered-radix"))
    assert eng._libraries(eng.config) == ("tokenize", "segreduce", "radix")

