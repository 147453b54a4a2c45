"""Reference examples/WordCount/finalfn.lua:3-8: collect the counts and
finish.  The counts land in common.RESULT for in-process callers; with
``keep_results`` the result files stay in storage for the others."""

from .common import RESULT, conf, init  # noqa: F401


def finalfn(pairs) -> bool:
    RESULT.clear()
    for key, values in pairs:
        RESULT[key] = values[0]
    return not conf["keep_results"]
