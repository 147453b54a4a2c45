"""Storage DSL parsing and backend routing (port of ``mapreduce_tpu/
storage/router.py``): ``"mem[:NAME]" | "shared:PATH" | "local:PATH"``
(``local`` is an alias of ``shared``).  ``http:HOST:PORT`` is the JAX
package's blob service, not ported yet (ROADMAP A.4b): it raises."""

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
    directory."""
    storage = storage or DEFAULT_STORAGE
    backend, sep, path = storage.partition(":")
    backend = backend.strip()
    if backend == "local":
        backend = "shared"
    if backend == "http":
        raise ValueError("http storage (the blob service) is not ported "
                         "yet (ROADMAP A.4b); use mem or shared:PATH")
    if backend not in ("mem", "shared"):
        raise ValueError(f"unknown storage backend {backend!r} "
                         "(want mem|shared|local)")
    if not sep or not path:
        path = ("default" if backend == "mem"
                else tempfile.mkdtemp(prefix="mr_torch_storage_"))
    return backend, path


def router(storage: Optional[str] = None) -> Storage:
    """Open the backend named by a DSL string."""
    backend, path = get_storage_from(storage)
    if backend == "mem":
        return MemoryStorage.named(path)
    return LocalDirStorage(path)
