"""Storage DSL parsing and backend routing (port of ``mapreduce_tpu/
storage/router.py``): ``"mem[:NAME]" | "shared:PATH" | "local:PATH" |
"http:[TOKEN@]HOST:PORT"`` (``local`` is an alias of ``shared``;
``http`` is the blob service of :mod:`.httpstore`)."""

from __future__ import annotations

import tempfile
from typing import Optional, Tuple

from .base import Storage
from .localdir import LocalDirStorage
from .memory import MemoryStorage

DEFAULT_STORAGE = "mem"


def get_storage_from(storage: Optional[str] = None) -> Tuple[str, str]:
    """Parse the DSL string into ``(backend, path)``: ``mem`` defaults
    to the name ``default``, ``shared`` to a fresh temporary
    directory; ``http`` needs its ``HOST:PORT``."""
    storage = storage or DEFAULT_STORAGE
    backend, sep, path = storage.partition(":")
    backend = backend.strip()
    if backend == "local":
        backend = "shared"
    if backend not in ("mem", "shared", "http"):
        raise ValueError(f"unknown storage backend {backend!r} "
                         "(want mem|shared|local|http)")
    if backend == "http" and (not sep or not path):
        raise ValueError("http storage wants http:HOST:PORT")
    if not sep or not path:
        path = ("default" if backend == "mem"
                else tempfile.mkdtemp(prefix="mr_torch_storage_"))
    return backend, path


def router(storage: Optional[str] = None, auth: Optional[str] = None,
           retry=None) -> Storage:
    """Open the backend named by a DSL string.

    ``auth`` is the bearer token of an auth-required blob server behind
    ``http:`` (ignored by the local backends); it can also be embedded
    as ``http:TOKEN@HOST:PORT`` or come from $MAPREDUCE_TPU_AUTH — but
    the DSL string is persisted verbatim in the task document on the
    board, so prefer the env var or this parameter.  ``retry`` is the
    :class:`~..utils.httpclient.RetryPolicy` of the blob plane; an
    unreachable blob server raises once it is spent."""
    backend, path = get_storage_from(storage)
    if backend == "mem":
        return MemoryStorage.named(path)
    if backend == "http":
        from .httpstore import HttpStorage
        return HttpStorage(path, auth_token=auth, retry=retry)
    return LocalDirStorage(path)
