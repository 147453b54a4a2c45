"""WordCount, single-module form (reference examples/WordCount/init.lua:
one module exporting every role, init.lua:47-63; port of
``mapreduce_tpu/examples/wordcount``).

``init`` takes ``{"files": [...], "num_reducers": N}`` (and
``keep_results``: finalfn then leaves the result files in storage, the
port's addition); a thread driving a task through ``Server.loop`` reads
that task's own init_args instead (:func:`~...spec.task_args`: one
runner process serves several tasks of this module).  taskfn emits one
job per file (taskfn.lua:8-11), mapfn tokenizes on whitespace and emits
``(word, 1)`` (mapfn.lua:4-7), partitionfn is FNV-1a mod num_reducers (the
reference's bit32 rolling hash, init.lua:2-33), reducefn sums and declares
the ACI flags so it doubles as combiner and unlocks the fast paths
(reducefn.lua:10-14).
"""

from __future__ import annotations

from typing import Any, Dict, List

from ... import spec
from ...utils.hashing import fnv1a32

_DEFAULTS: Dict[str, Any] = {"files": [], "num_reducers": 15}
_conf: Dict[str, Any] = dict(_DEFAULTS)
#: finalfn deposits {word: count} here so in-process callers (tests, the
#: CLI) can read the result; the reference prints to stdout instead
#: (finalfn.lua:3-8).
RESULT: Dict[str, int] = {}

associative_reducer = True
commutative_reducer = True
idempotent_reducer = True


def init(args: Any) -> None:
    if args:
        _conf.update(args)


def _args() -> Dict[str, Any]:
    """The driving task's init_args over the defaults, else the
    process's (``init``)."""
    scoped = spec.task_args()
    return {**_DEFAULTS, **scoped} if scoped else _conf


def taskfn(emit) -> None:
    for i, path in enumerate(_args()["files"]):
        emit(i, path)


def mapfn(key: Any, value: str, emit) -> None:
    with open(value, "r") as f:
        for line in f:
            for word in line.split():
                emit(word, 1)


def partitionfn(key: str) -> int:
    return fnv1a32(key.encode("utf-8")) % _args()["num_reducers"]


def reducefn(key: str, values: List[int]) -> int:
    return sum(values)


def combinerfn(key: str, values: List[int]) -> int:
    return sum(values)


def finalfn(pairs) -> bool:
    RESULT.clear()
    for key, values in pairs:
        RESULT[key] = values[0]
    return not _args().get("keep_results", False)


# -- device fast path hooks (spec.DEVICE_HOOKS) ------------------------------
# With ``device=True`` in Server.configure, the SAME module runs its fused
# map+shuffle+reduce on the port's engine: taskfn still plans the file
# splits above, finalfn still consumes the merged result pairs — only the
# middle is replaced by one engine run over the server's Partitions.

def device_config():
    """Capacities default to the JAX module's natural-language sizing
    (vocabulary up to ~1M uniques with the 3-retry right-sizing
    headroom) and are overridable through init_args for small corpora;
    the keys are the JAX module's.  The formulation names are kept for
    the config's identity: on the card the CUDA kernels run whatever
    they say."""
    from ...engine import EngineConfig

    conf = _args()
    return EngineConfig(
        local_capacity=int(conf.get("device_local_capacity", 1 << 17)),
        exchange_capacity=int(conf.get("device_exchange_capacity",
                                        1 << 15)),
        out_capacity=int(conf.get("device_out_capacity", 1 << 17)),
        tile=512, tile_records=128, reduce_op="sum", unit_values=True,
        sort_impl=str(conf.get("device_sort_impl", "variadic")),
        segment_impl=str(conf.get("device_segment_impl", "lax")),
        tokenize_impl=str(conf.get("device_tokenize_impl", "lax")))


def device_prepare(pairs, parts):
    """Read the taskfn-emitted files and shard their bytes over the
    partitions (words never split across chunks): the JAX module's
    chunks, byte for byte."""
    from ...ops.tokenize import shard_text

    ordered = sorted(pairs, key=lambda kv: str(kv[0]))
    data = b"\n".join(open(path, "rb").read() for _, path in ordered)
    chunk_len = int(_args().get("device_chunk_len", 1 << 22))
    n_dev = parts.n
    n_chunks = max(1, -(-len(data) // chunk_len))
    n_chunks = -(-n_chunks // n_dev) * n_dev
    chunks, _L = shard_text(data, n_chunks, pad_multiple=512)
    return chunks


def device_map(chunk, chunk_index, cfg):
    """The engine's map: tokenize + hash + compact one byte chunk (the
    engine contract form of ``mapfn`` above)."""
    from ...engine.wordcount import _wordcount_map_fn

    return _wordcount_map_fn(chunk, chunk_index, cfg)


def device_result(chunks, result):
    """Host materialisation: unique hashed words -> (word, [count])."""
    from ...engine import materialize_counts

    for word, count in materialize_counts(chunks, result).items():
        yield word.decode("utf-8", "replace"), [count]
