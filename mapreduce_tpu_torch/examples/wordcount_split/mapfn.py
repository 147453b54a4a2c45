"""Reference examples/WordCount/mapfn.lua:4-7: tokenize, emit (word, 1)."""

from .common import init  # noqa: F401


def mapfn(key, value, emit) -> None:
    with open(value, "r") as f:
        for line in f:
            for word in line.split():
                emit(word, 1)
