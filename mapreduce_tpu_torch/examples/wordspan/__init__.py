"""Word-span index: the second device-hooks workload (port of
``mapreduce_tpu/examples/wordspan``, single-module form).

For every word of the corpus: ``[count, first_offset, last_offset]``,
the word's occurrence count and the byte offsets of its first and last
occurrence in the files' concatenated bytes (files joined with ``\\n``
in task-key order, the same stream the device plane shards).  An
inverted-index-shaped workload: multi-lane values reduced by a non-sum
monoid (elementwise ``[sum, min, max]``), run through
``Server(device=True)`` on the port's engine and as an ordinary ACI
``reducefn`` on the host plane, with identical results.

The monoid is a callable, as in the JAX module (``_span_reduce_op``,
:data:`SPAN_REDUCE_OP`), on torch tensors: on the card the engine
lowers it into the combine of the segmented-reduce kernel's monoid
build (``ops/monoid.py``, ``csrc/segreduce.cuh``; launches counted as
``segreduce_monoid``), three lanes in one launch.  The per-lane codes
``("sum", "min", "max")`` spell the same monoid for the codes kernel
(``csrc/segreduce.cu``), with the same spans.

``init`` takes ``{"files": [...], "num_reducers": N}`` and the device
knobs ``device_chunk_len``, ``device_{local,exchange,out}_capacity``
(small by default: a corpus with more uniques runs through the engine's
capacity retries) and ``device_sort_impl`` (the port's; ``'radix'``
runs every sort and the exchange plan on the radix kernels).
Offsets are int32 on the device: :func:`device_prepare` refuses a
padded stream of more than 2**31 bytes (about 2.1 GB; the full 49M-word
``corpus.make_corpus()`` is about 300 MB).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List

import numpy as np

from ...utils.hashing import fnv1a32

_conf: Dict[str, Any] = {"files": [], "num_reducers": 8}
#: finalfn deposits {word: [count, first, last]} here (wordcount.RESULT
#: pattern)
RESULT: Dict[str, List[int]] = {}

associative_reducer = True
commutative_reducer = True
idempotent_reducer = True



def _span_reduce_op(a, b):
    """The span monoid: lane 0 sums counts, lane 1 takes the min first
    offset, lane 2 the max last offset.  Associative and commutative —
    the compiler-visible form of the ACI flags above."""
    import torch

    return torch.stack([a[..., 0] + b[..., 0],
                        torch.minimum(a[..., 1], b[..., 1]),
                        torch.maximum(a[..., 2], b[..., 2])], dim=-1)


#: the span monoid the device config takes
SPAN_REDUCE_OP = _span_reduce_op
#: the largest padded stream device offsets address (int32)
MAX_STREAM_BYTES = 2 ** 31
_INT32_MAX = 2 ** 31 - 1


def init(args: Any) -> None:
    if args:
        _conf.update(args)
    # base offset of each file in the concatenated stream ("\n"-joined in
    # task-key order: the exact stream device_prepare builds)
    bases = []
    off = 0
    for path in _conf["files"]:
        bases.append(off)
        off += os.path.getsize(path) + 1  # +1: the join separator
    _conf["bases"] = bases


def taskfn(emit) -> None:
    # zero-padded keys: task-key string order == file order, so host and
    # device planes agree on the concatenation (device_prepare sorts by
    # str(key))
    for i, path in enumerate(_conf["files"]):
        emit(f"{i:04d}", path)


def mapfn(key: str, path: str, emit) -> None:
    base = _conf["bases"][int(key)]
    with open(path, "rb") as f:
        data = f.read()
    for m in re.finditer(rb"\S+", data):
        off = base + m.start()
        emit(m.group().decode("utf-8", "replace"), [1, off, off])


def partitionfn(key: str) -> int:
    return fnv1a32(key.encode("utf-8")) % _conf["num_reducers"]


def _fold(values: List[List[int]]) -> List[int]:
    count = sum(v[0] for v in values)
    return [count, min(v[1] for v in values), max(v[2] for v in values)]


def reducefn(key: str, values: List[List[int]]) -> List[int]:
    return _fold(values)


def combinerfn(key: str, values: List[List[int]]) -> List[int]:
    return _fold(values)


def finalfn(pairs) -> bool:
    RESULT.clear()
    for key, values in pairs:
        RESULT[key] = list(values[0])
    return True


# -- device fast path hooks (spec.DEVICE_HOOKS) ------------------------------

def device_config():
    """The JAX module's capacities, tiles and callable monoid, and the
    port's sort knob."""
    from ...engine import EngineConfig

    return EngineConfig(
        local_capacity=int(_conf.get("device_local_capacity", 1 << 15)),
        exchange_capacity=int(_conf.get("device_exchange_capacity",
                                        1 << 13)),
        out_capacity=int(_conf.get("device_out_capacity", 1 << 15)),
        tile=512, tile_records=128,
        reduce_op=SPAN_REDUCE_OP, unit_values=False,
        sort_impl=str(_conf.get("device_sort_impl", "variadic")))


def device_prepare(pairs, parts):
    """Concatenate the taskfn-emitted files and shard them over the
    partitions, remembering each chunk's origin so that device offsets
    (padded-chunk space) map back to stream offsets in
    :func:`device_result`."""
    from ...ops.tokenize import shard_text

    ordered = sorted(pairs, key=lambda kv: str(kv[0]))
    parts_bytes = []
    for _, path in ordered:
        with open(path, "rb") as f:
            parts_bytes.append(f.read())
    data = b"\n".join(parts_bytes)
    chunk_len = int(_conf.get("device_chunk_len", 1 << 22))
    n_dev = parts.n
    n_chunks = max(1, -(-len(data) // chunk_len))
    n_chunks = -(-n_chunks // n_dev) * n_dev
    chunks, L, starts = shard_text(data, n_chunks, pad_multiple=512,
                                   return_offsets=True)
    padded = chunks.shape[0] * L
    if padded > MAX_STREAM_BYTES:  # an assert that -O cannot remove
        raise AssertionError(
            f"wordspan's device offsets are int32: the padded stream of "
            f"{chunks.shape[0]} chunks x {L} bytes = {padded} bytes must "
            f"stay within {MAX_STREAM_BYTES} (the full 49M-word "
            "make_corpus() is about 300 MB)")
    _conf["chunk_starts"] = starts
    return chunks


def device_map(chunk, chunk_index, cfg):
    """The engine's map: tokenize + hash + compact one byte chunk,
    emitting values ``[1, gstart, gstart]`` for the span monoid (gstart
    in padded space; :func:`device_result` converts).  Invalid rows get
    ``INT32_MAX`` and ``-1``, so they cannot win the min or max lane."""
    import torch

    from ...ops.compaction import tile_compact
    from ...ops.tokenize import tokenize_hash

    L = chunk.shape[0]
    toks = tokenize_hash(chunk, impl=cfg.tokenize_impl)
    # device_prepare bounds the padded stream, so this fits int32
    gstart = (toks.start.to(torch.int64) + chunk_index * L).to(torch.int32)
    tc = tile_compact(toks.is_end, cfg.tile, cfg.tile_records,
                      toks.keys[:, 0], toks.keys[:, 1], gstart)
    k1, k2, gs = tc.arrays
    keys = torch.stack([k1, k2], dim=-1)
    values = torch.stack(
        [tc.valid.to(torch.int32), torch.where(tc.valid, gs, _INT32_MAX),
         torch.where(tc.valid, gs, -1)], dim=-1)
    return keys, values, gs[:, None], tc.valid, tc.overflow


def device_result(chunks, result):
    """Host materialisation: unique hashed words -> ``(word, [[count,
    first, last]])``, offsets mapped back from padded-chunk space to the
    concatenated-stream space the host plane reports."""
    from ...engine.wordcount import gather_words

    _S, L = chunks.shape
    starts = np.asarray(_conf["chunk_starts"], dtype=np.int64)
    valid = result.valid.numpy().reshape(-1)
    live = np.nonzero(valid)[0]
    if live.size == 0:
        return
    pay = result.payload.numpy().reshape(-1, result.payload.shape[-1])
    vals = result.values.numpy().reshape(-1, 3)[live].astype(np.int64)
    words = gather_words(chunks, pay[live, 0].astype(np.int64))

    def to_stream(padded):
        return starts[padded // L] + padded % L

    first, last = to_stream(vals[:, 1]), to_stream(vals[:, 2])
    agg: Dict[str, List[int]] = {}
    for word, count, f, la in zip(words, vals[:, 0].tolist(),
                                  first.tolist(), last.tolist()):
        key = word.decode("utf-8", "replace")
        got = agg.get(key)
        if got is None:
            agg[key] = [count, f, la]
        else:  # two byte strings that decode alike fold, as on the host
            agg[key] = [got[0] + count, min(got[1], f), max(got[2], la)]
    for key, span in agg.items():
        yield key, [span]
