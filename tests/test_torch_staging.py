"""The port's staged ingest and wave feeder against the JAX package's.

``DeviceWordCount.stage`` + ``count_staged`` (``DeviceEngine.
stage_inputs`` + ``run(staged=...)``) over ``Partitions(8, "cpu")`` at
``chunk_len=1024`` must give the JAX ``lax`` engine's staged run bit
for bit (tolerance: none): the ``DeviceResult``, the count dict (and
``Counter(data.split())``) and the traffic matrix, also through a
capacity retry that re-uploads.  The handle is single-use and emptied in
place; a streaming run holds at most ``STREAM_PREFETCH`` waves; misuse
raises.  On the CPU the feeder pins nothing and uses no stream, so what
these tests pin is the wave split, the handle's lifecycle and the byte
accounting; the card tests (``test_torch_cuda.py``) repeat the streaming
and staged runs through pinned buffers and the copy stream.
"""

import dataclasses
import gc
import weakref
from collections import Counter

import numpy as np
import pytest

from mapreduce_tpu.engine import wordcount as jwc
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu_torch import convert
from mapreduce_tpu_torch.engine import device_engine as tde
from mapreduce_tpu_torch.engine import wordcount as twc
from mapreduce_tpu_torch.ops import kernel_compat as kc
from mapreduce_tpu_torch.parallel.mesh import Partitions
from tests.test_torch_wordcount import (
    CFG, CHUNK, DATA, TINY, _corpus, _pin_result)

WAVES = 3


def _jax_staged(cfg, data=DATA, waves=WAVES):
    wc = jwc.DeviceWordCount(make_mesh(), chunk_len=CHUNK, config=cfg)
    chunks, L, staged = wc.stage(data, waves=waves)
    tm = {}
    res = wc._engine_for(L).run(chunks, timings=tm, staged=staged)
    return chunks, res, tm


def _port_wc(cfg):
    return twc.DeviceWordCount(
        Partitions(8, "cpu"), chunk_len=CHUNK,
        config=convert.engine_config_from_jax(dataclasses.asdict(cfg)))


@pytest.fixture(scope="module")
def jax_staged():
    return _jax_staged(CFG)


def test_staged_run_matches_jax_staged_run(jax_staged):
    jchunks, jres, jtm = jax_staged
    wc = _port_wc(CFG)
    chunks, L, staged = wc.stage(DATA, waves=WAVES)
    assert np.array_equal(chunks, jchunks)
    assert len(staged[0]) == WAVES and staged[1] == chunks.shape[0]
    tm = {}
    res = wc._engine_for(L).run(chunks, timings=tm, staged=staged)
    _pin_result(res, jres)
    assert tm["waves"] == jtm["waves"] == WAVES
    assert tm["retries"] == jtm["retries"] == 0
    # staged runs charge no upload and report no engine total
    assert not {"upload_s", "total_s", "retry_upload_s"} & set(tm)
    assert {"compute_s", "readback_s", "first_dispatch_s"} <= set(tm)
    assert tm["exchange"]["matrix"] == jtm["exchange"]["matrix"]
    assert np.array_equal(np.asarray(tm["exchange"]["matrix"]),
                          wc.host_exchange_matrix(DATA, waves=WAVES))
    want = Counter(DATA.split())
    assert twc.materialize_counts(chunks, res) == want
    # the user surface: count_staged's dict, as the JAX one's
    jw = jwc.DeviceWordCount(make_mesh(), chunk_len=CHUNK, config=CFG)
    ctm = {}
    got = wc.count_staged(wc.stage(DATA, waves=WAVES), timings=ctm)
    assert got == jw.count_staged(jw.stage(DATA, waves=WAVES)) == want
    assert "materialize_s" in ctm and "upload_s" not in ctm


def test_staged_handle_consumed_and_freed():
    """run() empties the handle's wave list in place, so freeing each
    wave after its fold works while the caller still holds the handle."""
    wc = _port_wc(CFG)
    handle = wc.stage(DATA, waves=WAVES)
    staged_list, _n_real = handle[2]
    refs = [weakref.ref(t) for t in staged_list]
    assert len(refs) == WAVES
    assert wc.count_staged(handle) == Counter(DATA.split())
    assert staged_list == []
    del handle, staged_list
    gc.collect()
    assert all(r() is None for r in refs)


def test_staged_capacity_retry_reuploads(jax_staged):
    """TINY capacities overflow every stage: the retry re-uploads from
    the chunks passed beside the consumed handle, reports it as
    ``retry_upload_s``, and converges to the JAX engine's bits."""
    _, jres, _ = jax_staged
    jchunks, jres_tiny, jtm = _jax_staged(TINY)
    wc = _port_wc(TINY)
    chunks, L, staged = wc.stage(DATA, waves=WAVES)
    tm = {}
    res = wc._engine_for(L).run(chunks, timings=tm, staged=staged)
    assert tm["retries"] >= 1 and jtm["retries"] >= 1
    assert "retry_upload_s" in tm and "upload_s" not in tm
    assert tm["peak_input_wave_bytes"] > 0  # the retry's feeder
    _pin_result(res, jres)
    _pin_result(res, jres_tiny)
    assert tm["exchange"]["matrix"] == jtm["exchange"]["matrix"]


def test_staged_handle_misuse_raises():
    wc = _port_wc(CFG)
    chunks, L, staged = wc.stage(DATA, waves=WAVES)
    eng = wc._engine_for(L)
    with pytest.raises(ValueError, match="wave split"):
        eng.run(chunks, staged=staged, waves=2)
    eng.run(chunks, staged=staged)
    with pytest.raises(RuntimeError, match="already consumed"):
        eng.run(chunks, staged=staged)
    # a retry needs the source array once the handle is consumed
    tiny = _port_wc(TINY)
    chunks, L, staged = tiny.stage(DATA, waves=WAVES)
    with pytest.raises(RuntimeError, match="re-uploaded"):
        tiny._engine_for(L).run(None, staged=staged)


def test_streaming_run_bounds_live_waves(monkeypatch):
    """Five waves, never more than STREAM_PREFETCH of them held: the
    feeder's own ledger and a spy on its uploads and releases agree."""
    live, max_live = set(), [0]

    class Spy(tde._WaveFeeder):
        def _put_wave(self, w):
            out = super()._put_wave(w)
            live.add(w)
            max_live[0] = max(max_live[0], len(live))
            return out

        def release(self, w):
            live.discard(w)
            super().release(w)

    monkeypatch.setattr(tde, "_WaveFeeder", Spy)
    data = _corpus(seed=1, n_words=5000)
    wc = _port_wc(CFG)
    chunks, _ = wc._to_chunks(data)
    tm = {}
    assert wc.count_bytes(data, timings=tm, waves=5) == Counter(data.split())
    assert tm["waves"] == 5
    prefetch = tde.DeviceEngine.STREAM_PREFETCH
    wave_bytes = chunks.nbytes // 5
    assert max_live[0] <= prefetch
    assert tm["peak_input_wave_bytes"] == prefetch * wave_bytes
    assert tm["input_bytes"] == chunks.nbytes
    assert tm["upload_s"] >= 0 and tm["total_s"] >= tm["compute_s"]


def test_feeder_wave_split_and_padding():
    """``k`` chunks per partition a wave, all-pad waves dropped, the last
    wave zero-padded, full waves views of the caller's array."""
    wc = _port_wc(CFG)
    chunks, L = wc._to_chunks(DATA)  # 24 rows
    eng = wc._engine_for(L)
    feeder = tde._WaveFeeder(eng, chunks, waves=5, prefetch=2)
    try:
        assert (feeder.rpw, feeder.waves) == (8, 3)
        first = feeder.get(0)
        assert np.shares_memory(first.numpy(), chunks)
        assert feeder.held_bytes == 2 * 8 * L
        feeder.release(0)
        assert feeder.held_bytes == 8 * L
    finally:
        feeder.close()
    odd = chunks[:20]
    feeder = tde._WaveFeeder(eng, odd, k=1)
    try:
        assert feeder.waves == 3
        last = feeder.get(2).numpy()
        assert np.array_equal(last[:4], odd[16:]) and not last[4:].any()
    finally:
        feeder.close()
    assert feeder.held_bytes == 0


def test_count_files_warm_and_engine(tmp_path, monkeypatch):
    """count_files joins the files with a newline; warm() returns its
    seconds and builds nothing on the CPU."""
    parts = [DATA[:7000], DATA[7000:]]
    paths = []
    for i, part in enumerate(parts):
        p = tmp_path / f"part{i}.txt"
        p.write_bytes(part)
        paths.append(str(p))
    wc = _port_wc(CFG)
    joined = b"\n".join(parts)
    assert wc.count_files(paths) == wc.count_bytes(joined) \
        == Counter(joined.split())

    def no_build(*args, **kwargs):
        raise AssertionError("warm() started a build on the CPU")

    monkeypatch.setattr(kc, "_start_build", no_build)
    fresh = _port_wc(CFG)
    s = fresh.warm()
    assert s >= 0
    assert fresh.engine is fresh._engine_for(fresh._row_len())
