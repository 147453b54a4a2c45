"""Shared config + result sink for the split-module WordCount example.

``keep_results`` (default False) makes ``finalfn`` keep the result
partition files in the task's storage (the reference keeps them when
finalfn returns false, server.lua:403-410): a caller in another process
than the ``cli server`` reads them back from there."""

from typing import Any, Dict

conf: Dict[str, Any] = {"files": [], "num_reducers": 15,
                        "keep_results": False}
RESULT: Dict[str, int] = {}


def init(args: Any) -> None:
    if args:
        conf.update(args)
