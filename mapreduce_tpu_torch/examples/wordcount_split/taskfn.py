"""Reference examples/WordCount/taskfn.lua:8-11: one job per input file."""

from .common import conf, init  # noqa: F401


def taskfn(emit) -> None:
    for i, path in enumerate(conf["files"]):
        emit(i, path)
