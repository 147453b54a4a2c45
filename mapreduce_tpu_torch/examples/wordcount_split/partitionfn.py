"""Reference examples/WordCount/partitionfn.lua:2-15: rolling byte hash
mod num_reducers (FNV-1a here, same role)."""

from ...utils.hashing import fnv1a32
from .common import conf, init  # noqa: F401


def partitionfn(key: str) -> int:
    return fnv1a32(key.encode("utf-8")) % conf["num_reducers"]
