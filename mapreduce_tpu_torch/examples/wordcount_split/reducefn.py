"""Reference examples/WordCount/reducefn.lua: sum, declared associative +
commutative + idempotent (reducefn.lua:10-14) so it doubles as the combiner
and takes the ACI fast path."""

from .common import init  # noqa: F401

associative_reducer = True
commutative_reducer = True
idempotent_reducer = True


def reducefn(key, values) -> int:
    return sum(values)


# the reference wires the same module as combiner (reducefn.lua doubles as
# combinerfn in test.sh config (a))
def combinerfn(key, values) -> int:
    return sum(values)
