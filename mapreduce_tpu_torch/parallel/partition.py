"""Regex partition rules over flat leaf names (port of
``mapreduce_tpu/parallel/partition.py``).

One declarative table maps leaf names to partition specs across params
AND optimizer state:

  * a leaf's name is its ``/``-joined path (``params/w0``,
    ``opt/1/0/trace/w0``: the JAX package's names), so a parameter and
    its momentum mirror match the SAME trailing-name rule;
  * scalar and single-element leaves pass through replicated (``[]``)
    without consulting the rules — optimizer step counters must never be
    sharded by an over-eager regex;
  * an unmatched non-scalar leaf is a LOUD :class:`UnmatchedLeafError`
    naming every offender.

One card has no mesh, so nothing here places an array (the JAX
``shard_tree`` has no counterpart).  A spec is the JAX spelling: a list
of mesh axis names (``None`` for an unsharded dimension, ``[]`` for
replicated).  That spelling is what ``models/checkpoint.save(spec=...)``
writes into a manifest, so a JAX trainer restores a port checkpoint onto
its own mesh with the same layout.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: a spec: one mesh axis name (or None) per dimension; () is replicated
Spec = Tuple[Optional[str], ...]
#: a rule table: ``(regex, spec)`` pairs, first match wins (``re.search``
#: semantics — anchor with ``$`` to match trailing leaf names so the
#: table covers optimizer mirrors for free).
Rules = Sequence[Tuple[str, Spec]]


class UnmatchedLeafError(ValueError):
    """A non-scalar leaf matched no partition rule.  Loud by design:
    falling back to replicated would silently change the memory story
    of every mesh the state lands on."""


def leaf_path(path: Sequence[Any]) -> str:
    """``/``-joined path name of a leaf (``("opt", 1, 0, "trace", "w0")``
    -> ``"opt/1/0/trace/w0"``)."""
    return "/".join(str(e) for e in path)


def resolve_spec(rules: Rules, name: str, leaf: Any) -> List[Optional[str]]:
    """The spec for ONE named leaf (anything with a ``shape``), in the
    JAX spelling: scalar passthrough, then the first matching rule, else
    :class:`UnmatchedLeafError`."""
    shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
    if len(shape) == 0 or int(np.prod(shape)) == 1:
        return []  # scalars/singletons (optimizer counts) always replicate
    for rx, spec in rules:
        if re.search(rx, name) is not None:
            return list(spec)
    raise UnmatchedLeafError(
        f"no partition rule matches leaf {name!r} (shape {shape}); "
        "add a rule (or an explicit catch-all) — silent replication "
        "is not a default")


def match_partition_rules(rules: Rules, tree: Dict[str, Any]
                          ) -> Dict[str, List[Optional[str]]]:
    """``{name: spec}`` for a flat ``{name: leaf}`` tree.  Raises
    :class:`UnmatchedLeafError` naming EVERY unmatched leaf at once."""
    specs: Dict[str, List[Optional[str]]] = {}
    unmatched: List[str] = []
    for name, leaf in tree.items():
        try:
            specs[name] = resolve_spec(rules, name, leaf)
        except UnmatchedLeafError:
            unmatched.append(name)
    if unmatched:
        raise UnmatchedLeafError(
            "no partition rule matches: " + ", ".join(unmatched))
    return specs
