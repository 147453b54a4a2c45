"""WordCount with the native (C++) tokenizer in the map body, inputs as
storage blobs: the host-plane benchmark's workload (port of
``mapreduce_tpu/examples/wordcount_native``).

The reference's WordCountBig deploy (taskfn lists pre-split Europarl
files, execute_BIG_server.sh:3-9; map and reduce are the WordCount
ones): the corpus lives in the job's storage backend as split blobs,
taskfn emits one job per split, and each map job runs the one-pass C++
tokenizer and pre-aggregator (:mod:`...native`) over its split, emitting
ALREADY-AGGREGATED ``(word, count)`` pairs: the combiner pushed into
native code (SURVEY.md §2.10 strategy 3).  reduce sums per-split counts;
final fills :data:`RESULT`.

``init`` takes ``{"blobs": [...], "storage": DSL, "num_reducers": N}``;
the storage handle comes from the port's ``storage.router``.  The
library is built with ``g++`` at first use; a failed build raises (the
port has no quiet fallback to the Python twin).
"""

from __future__ import annotations

from typing import Any, Dict, List

_conf: Dict[str, Any] = {"blobs": [], "num_reducers": 15, "storage": None}
RESULT: Dict[str, int] = {}

#: reduce(x) == reduce(reduce(x1), reduce(x2)) and order-free: the server
#: may stream-combine and skip idempotency re-runs (job.lua ACI flags)
associative_reducer = True
commutative_reducer = True
idempotent_reducer = True

_handle = None  # storage handle cached per worker process


def init(args: Any) -> None:
    global _handle
    if args:
        _conf.update(args)
        _handle = None


def _storage():
    global _handle
    if _handle is None:
        from ...storage.router import router

        _handle = router(_conf["storage"])
    return _handle


def taskfn(emit) -> None:
    assert _conf["blobs"], "wordcount_native needs init_args['blobs']"
    for i, name in enumerate(_conf["blobs"]):
        emit(i, name)


def mapfn(key: Any, blobname: str, emit) -> None:
    from ... import native

    data = _storage().read(blobname).encode("utf-8")
    for word, count in native.wordcount_bytes(data).items():
        emit(word.decode("utf-8", "replace"), count)


def partitionfn(key: str) -> int:
    from ...utils.hashing import fnv1a32

    return fnv1a32(key.encode("utf-8")) % _conf["num_reducers"]


def reducefn(key: str, values: List[int]) -> int:
    return sum(values)


def combinerfn(key: str, values: List[int]) -> int:
    return sum(values)


def finalfn(pairs) -> bool:
    RESULT.clear()
    for key, values in pairs:
        RESULT[key] = values[0]
    return True
