"""WordCountBig: the reference's large-corpus config (port of
``mapreduce_tpu/examples/wordcountbig``; reference examples/WordCountBig/
taskfn.lua:6-11 lists the Europarl split files with ``io.popen("ls
...")`` and reuses the WordCount map/partition/reduce fns,
execute_BIG_server.sh:3-9).  Here taskfn globs ``init_args["glob"]``;
every other role is re-exported from the port's WordCount example."""

from __future__ import annotations

import glob as _glob
from typing import Any, Dict

from ..wordcount import (  # noqa: F401  (role re-exports)
    RESULT, associative_reducer, commutative_reducer, idempotent_reducer,
    combinerfn, finalfn, mapfn, partitionfn, reducefn)
from ..wordcount import _conf as _wc_conf

_big_conf: Dict[str, Any] = {"glob": None}


def init(args: Any) -> None:
    if args:
        _big_conf.update(args)
        _wc_conf.update({k: v for k, v in args.items() if k != "glob"})


def taskfn(emit) -> None:
    assert _big_conf["glob"], "wordcountbig needs init_args['glob']"
    for i, path in enumerate(sorted(_glob.glob(_big_conf["glob"]))):
        emit(i, path)
