"""Reference examples/WordCount/reducefn2.lua: the same sum *without* the
ACI flags — exercises the general-reducer path (ordered fold, no
single-value skip, never used as a combiner)."""

from .common import init  # noqa: F401


def reducefn(key, values) -> int:
    total = 0
    for v in values:
        total += v
    return total
