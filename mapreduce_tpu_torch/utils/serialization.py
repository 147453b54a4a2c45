"""Record (key, values) serialization for intermediate and final results
(port of ``mapreduce_tpu/utils/serialization.py``: a record line is
byte-identical to the JAX package's for the same key and values).

The reference moves every intermediate key/value pair between processes as a
line of *loadable Lua source* -- ``return k,{v1,v2}\\n`` -- written sorted by
key (mapreduce/job.lua:196-215, mapreduce/utils.lua:100-120) and re-parsed
with ``load()`` per line during the reduce merge (utils.lua:214-247).

The rebuild keeps the same shape -- a text line per key holding the key and
its value *list*, files sorted by key so reduce can k-way merge -- but the
payload is a Python literal parsed with :func:`ast.literal_eval` (safe, no
code execution, unlike the reference's ``load``).  The fast/device path never
touches this format; it exists for the *general* path where keys and values
are arbitrary Python objects (SURVEY.md §7 hard-part (c)).
"""

from __future__ import annotations

import ast
import json
from typing import Any, Tuple

# types a key/value may contain, transitively (reference restricts to what
# its Lua-source escape supports: numbers, strings, booleans, flat tables --
# utils.lua:100-120 `escape`/`serialize_table_ipairs`; we additionally allow
# None, tuples, dicts since literal_eval round-trips them).
_LITERAL_TYPES = (str, bytes, int, float, bool, type(None))


def check_serializable(obj: Any, _depth: int = 0) -> None:
    """Validate that *obj* round-trips through the record format.

    Parity with the reference's JSON-compat checker ``utils.assert_check``
    (utils.lua:313-333), which the server applies to taskfn emissions.
    Raises ``TypeError`` on unsupported content.
    """
    if _depth > 32:
        raise TypeError("record nesting too deep (>32)")
    if isinstance(obj, _LITERAL_TYPES):
        return
    if isinstance(obj, (list, tuple)):
        for item in obj:
            check_serializable(item, _depth + 1)
        return
    if isinstance(obj, dict):
        for k, v in obj.items():
            check_serializable(k, _depth + 1)
            check_serializable(v, _depth + 1)
        return
    # numpy / torch scalars quack like Python numbers: accept anything with
    # .item() by converting at serialization time (see normalize()).
    if hasattr(obj, "item") and callable(obj.item):
        return
    raise TypeError(
        f"unserializable object of type {type(obj).__name__!r}: {obj!r}"
    )


def normalize(obj: Any) -> Any:
    """Convert numpy/torch scalars & arrays into plain Python literals."""
    if isinstance(obj, _LITERAL_TYPES):
        # collapse subclasses (np.str_, np.float64, IntEnum, ...) whose repr
        # is not a parseable literal down to the base builtin type
        for base in (bool, int, float, str, bytes):
            if isinstance(obj, base):
                return obj if type(obj) is base else base(obj)
        return obj  # None
    if isinstance(obj, (list, tuple)):
        # subclasses (e.g. InternedTuple) collapse to the base builtin so
        # interned keys stay tuples through a round-trip
        t = tuple if isinstance(obj, tuple) else list
        return t(normalize(x) for x in obj)
    if isinstance(obj, dict):
        return {normalize(k): normalize(v) for k, v in obj.items()}
    if hasattr(obj, "tolist") and callable(obj.tolist):  # ndarray
        return normalize(obj.tolist())
    if hasattr(obj, "item") and callable(obj.item):  # 0-d scalar
        return obj.item()
    raise TypeError(f"cannot normalize {type(obj).__name__!r}")


#: scalar types that round-trip through JSON unchanged (json.dumps emits
#: Infinity/NaN tokens and json.loads reads them back, so floats qualify)
_JSON_SCALARS = (str, int, float, bool, type(None))


def serialize_record(key: Any, values: Any) -> str:
    """One ``(key, value_list)`` record -> one text line.

    Mirrors the reference's ``"return <escaped_k>,{v,...}\\n"`` writer
    (job.lua:209-215).  The common shape — scalar key, list of scalars —
    is written as a JSON array (``json.loads`` parses ~10x faster than
    the ast path, and the reduce merge parses EVERY map record); richer
    records (bytes, tuples, dicts) fall back to ``repr``.  The two are
    unambiguous at parse time: JSON lines start with ``[``, repr tuples
    with ``(``.  Both escape newlines, so line framing is safe either
    way.
    """
    key = normalize(key)
    values = normalize(values)
    if type(key) in _JSON_SCALARS or key is None:
        if isinstance(values, list) and all(
                type(v) in _JSON_SCALARS or v is None for v in values):
            # ensure_ascii: lone surrogates (surrogateescape'd input,
            # os.fsdecode'd names) must reach storage as ASCII escapes —
            # a raw '\ud800' kills the backend's utf-8 file write
            return json.dumps([key, values], check_circular=False)
    return repr((key, values))


def _eval_literal(node: ast.AST) -> Any:
    """Evaluate the literal subset we emit -- ``ast.literal_eval`` plus the
    ``inf``/``nan`` names that ``repr(float)`` produces (an SGD workload
    emitting a diverged loss must round-trip, not crash the reduce merge)."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        if node.id == "inf":
            return float("inf")
        if node.id == "nan":
            return float("nan")
        raise ValueError(f"illegal name {node.id!r} in record")
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        val = _eval_literal(node.operand)
        if not isinstance(val, (int, float, complex)):
            raise ValueError("unary +/- on non-number in record")
        return -val if isinstance(node.op, ast.USub) else +val
    if isinstance(node, ast.Tuple):
        return tuple(_eval_literal(x) for x in node.elts)
    if isinstance(node, ast.List):
        return [_eval_literal(x) for x in node.elts]
    if isinstance(node, ast.Dict):
        return {
            _eval_literal(k): _eval_literal(v)
            for k, v in zip(node.keys, node.values)
        }
    raise ValueError(f"illegal node {type(node).__name__} in record")


def parse_record(line: str) -> Tuple[Any, Any]:
    """Inverse of :func:`serialize_record` (reference: ``load(line)()``,
    utils.lua:233-236 -- but safe: no code execution is possible on
    either path — json.loads is data-only and the ast path evaluates
    literals)."""
    line = line.strip()
    if line.startswith("["):  # the JSON fast path's unambiguous marker
        key, values = json.loads(line)
        return key, values
    tree = ast.parse(line, mode="eval")
    key, values = _eval_literal(tree.body)
    return key, values


# --- total order over mixed-type keys --------------------------------------

def sort_key(key: Any):
    """A sort key giving a total order over every legal record key.

    The reference sorts Lua values with ``table.sort`` under ``<`` which
    requires same-type keys (job.lua:194, utils.lua:123-128); mixed types
    crash it.  We instead rank by type then value so any task's keyspace has
    one deterministic global order -- required for the k-way merge.
    """
    if key is None:
        return (-1, 0)
    if isinstance(key, bool):
        return (0, key)
    if isinstance(key, (int, float)):
        return (1, key)
    if isinstance(key, str):
        return (2, key)
    if isinstance(key, bytes):
        return (3, key)
    if isinstance(key, tuple):
        return (4, tuple(sort_key(k) for k in key))
    raise TypeError(f"unorderable record key type {type(key).__name__!r}")
