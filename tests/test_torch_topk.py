"""The port's streaming top-K against ``host_topk`` and the JAX package's
``TopKWords`` (8-device CPU mesh, lax formulations), over
``Partitions(8, "cpu")``: the same words and counts in the same order
(tolerance: none), across feeds, with the count-then-word tie-break, in
hash-only mode, at a ``chunk_len`` that is not a tile multiple, with the
int32 offset-wrap refusal, and for the batch ``topk_bytes`` through a
capacity retry.
"""

import numpy as np
import pytest
import torch

from mapreduce_tpu.engine import device_engine as jde
from mapreduce_tpu.engine import topk as jtopk
from mapreduce_tpu.parallel import make_mesh
from mapreduce_tpu_torch.engine import device_engine as tde
from mapreduce_tpu_torch.engine import topk as ttopk
from mapreduce_tpu_torch.parallel.mesh import Partitions
from tests.test_torch_wordcount import _corpus

_CORPUS_A = b"apple banana apple cherry apple banana date elder " * 40
_CORPUS_B = b"cherry cherry elder apple fig grape grape " * 25
#: the small top-K capacities of tests/test_session.py
_FIELDS = dict(local_capacity=1 << 11, exchange_capacity=1 << 9,
               out_capacity=1 << 12, combine_in_scan=True,
               combine_capacity=1 << 9, unit_values=True, reduce_op="sum")
JCFG = jde.EngineConfig(**_FIELDS)
TCFG = tde.EngineConfig(**_FIELDS)
PARTS = Partitions(8, "cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def test_streaming_topk_matches_host_and_jax(mesh):
    tk = ttopk.TopKWords(PARTS, k=4, chunk_len=512, config=TCFG)
    jk = jtopk.TopKWords(mesh, k=4, chunk_len=512, config=JCFG)
    tk.feed(_CORPUS_A)
    jk.feed(_CORPUS_A)
    assert tk.topk() == jk.topk() == ttopk.host_topk(_CORPUS_A, 4)
    tk.feed(_CORPUS_B)  # the stream goes on across feeds
    jk.feed(_CORPUS_B)
    both = _CORPUS_A + b" " + _CORPUS_B
    assert tk.topk() == jk.topk() == ttopk.host_topk(both, 4)
    assert tk.topk(k=7) == ttopk.host_topk(both, 7)
    assert tk.stats() == jk.stats()
    assert tk.stats()["bytes_fed"] == len(_CORPUS_A) + len(_CORPUS_B)


def test_zipf_stream_in_feeds_matches_host(mesh):
    """A skewed vocabulary (long words, multi-byte UTF-8) fed in three
    parts: every mid-stream poll equals the host answer for the bytes
    fed so far, and the JAX stream's."""
    data = _corpus(seed=4, n_words=3000)
    parts, lo = [], 0
    for hi in (len(data) // 3, 2 * len(data) // 3, len(data)):
        while hi < len(data) and data[hi:hi + 1] not in b" \n\t":
            hi += 1  # cut between words
        parts.append(data[lo:hi])
        lo = hi
    tk = ttopk.TopKWords(PARTS, k=20, chunk_len=512, config=TCFG)
    jk = jtopk.TopKWords(mesh, k=20, chunk_len=512, config=JCFG)
    fed = b""
    for part in parts:
        tk.feed(part)
        jk.feed(part)
        fed += part
        assert tk.topk() == jk.topk() == ttopk.host_topk(fed, 20)


def test_non_tile_multiple_chunk_len(mesh):
    """``shard_text`` rounds the row up to a tile multiple (1512 ->
    1536); materialisation uses the width it made."""
    tk = ttopk.TopKWords(PARTS, k=3, chunk_len=1000, config=TCFG)
    jk = jtopk.TopKWords(mesh, k=3, chunk_len=1000, config=JCFG)
    for corpus in (_CORPUS_A, _CORPUS_B):
        tk.feed(corpus)
        jk.feed(corpus)
    assert tk._L == jk._L and tk._L % tk.config.tile == 0
    want = ttopk.host_topk(_CORPUS_A + b" " + _CORPUS_B, 3)
    assert tk.topk() == jk.topk() == want


def test_materializing_stream_refuses_offset_wrap():
    """Payload offsets are int32: a materialising stream that would wrap
    them refuses; a hash-only stream is unbounded."""
    tk = ttopk.TopKWords(PARTS, k=2, chunk_len=512, config=TCFG)
    tk.feed(_CORPUS_A)
    tk._L = 2 ** 30  # as if ~2 GiB in
    with pytest.raises(OverflowError, match="int32"):
        tk.feed(_CORPUS_A)
    nk = ttopk.TopKWords(PARTS, k=2, chunk_len=512, materialize=False,
                         config=TCFG)
    nk.feed(_CORPUS_A)
    nk._L = 2 ** 30
    nk.feed(_CORPUS_A)
    assert nk.stats()["feeds"] == 2


def test_tie_break_is_deterministic(mesh):
    corpus = b"zeta alpha mid mid " * 10  # zeta == alpha == 10, mid 20
    tk = ttopk.TopKWords(PARTS, k=2, chunk_len=512, config=TCFG)
    tk.feed(corpus)
    assert tk.topk() == [(b"mid", 20), (b"alpha", 10)]
    jk = jtopk.TopKWords(mesh, k=2, chunk_len=512, config=JCFG)
    jk.feed(corpus)
    assert jk.topk() == tk.topk()


def test_hash_only_mode(mesh):
    """``materialize=False`` keeps no host bytes: the counts are exact
    and the JAX ones, the words unresolved."""
    tk = ttopk.TopKWords(PARTS, k=3, chunk_len=512, materialize=False,
                         config=TCFG)
    jk = jtopk.TopKWords(mesh, k=3, chunk_len=512, materialize=False,
                         config=JCFG)
    tk.feed(_CORPUS_A)
    jk.feed(_CORPUS_A)
    got = tk.topk()
    assert got == jk.topk()
    assert [c for _w, c in got] == [
        c for _w, c in ttopk.host_topk(_CORPUS_A, 3)]
    assert all(w is None for w, _c in got) and tk._chunks == []


def test_topk_bytes_rides_capacity_retry(mesh):
    """The batch form retries right-sized from absurd capacities and
    ends at the host answer and the JAX one."""
    tiny = dict(local_capacity=64, exchange_capacity=32, out_capacity=64,
                tile=512, tile_records=16, combine_in_scan=True,
                combine_capacity=16, unit_values=True, reduce_op="sum")
    got = ttopk.topk_bytes(PARTS, _CORPUS_A, k=3, chunk_len=512,
                           config=tde.EngineConfig(**tiny))
    assert got == ttopk.host_topk(_CORPUS_A, 3)
    assert got == jtopk.topk_bytes(mesh, _CORPUS_A, k=3, chunk_len=512,
                                   config=jde.EngineConfig(**tiny))
    data = _corpus(seed=5, n_words=2000)
    assert (ttopk.topk_bytes(PARTS, data, k=10, chunk_len=512)
            == ttopk.host_topk(data, 10))


def test_select_topk_and_candidate_rows_match_jax():
    """The two host helpers on hand-made inputs: the selection (ties at
    the K boundary, hash-only) and the candidate-row gather."""
    rng = np.random.default_rng(2)
    vals = rng.integers(1, 6, size=(2, 12)).astype(np.int32)
    valid = rng.random((2, 12)) < 0.8
    pay = rng.integers(0, 1000, size=(2, 12, 1)).astype(np.int32)
    res = tde.DeviceResult(torch.zeros((2, 12, 2), dtype=torch.int32),
                           torch.from_numpy(vals), torch.from_numpy(pay),
                           torch.from_numpy(valid), 0)
    jres = jde.DeviceResult(np.zeros((2, 12, 2), np.uint32), vals, pay,
                            valid, 0)
    for k in (1, 3, 5, 30):
        assert (ttopk._select_topk(res, k)
                == jtopk._select_topk(jres, k))
        assert (ttopk._select_topk(res, k, resolve=lambda g: list(g))
                == jtopk._select_topk(jres, k, resolve=lambda g: list(g)))
    chunks = [rng.integers(0, 255, size=(n, 16)).astype(np.uint8)
              for n in (3, 1, 4)]
    g = np.array([5, 40, 17, 127, 40, 64], dtype=np.int64)
    for a, b in zip(ttopk._gather_candidate_rows(chunks, g, 16),
                    jtopk._gather_candidate_rows(chunks, g, 16)):
        assert np.array_equal(a, b)
    assert ttopk.default_topk_config(1 << 14) == tde.EngineConfig(
        **{f: getattr(jtopk.default_topk_config(1 << 14), f)
           for f in tde.EngineConfig.__dataclass_fields__})
