"""Where the port's built libraries live (port of
``mapreduce_tpu/utils/compile_cache.py``).

The JAX package persists XLA executables; the port has no JIT, and what
a process acquires before it can run is shared libraries: ``nvcc``
builds of ``csrc/*.cu`` (:mod:`..ops.kernel_compat`) and the ``g++``
build of the host core (:mod:`..native`).  Both go to one **build
directory**, named by a hash of their sources and flags, so a later
process loads them instead of compiling again.  The directory is, in
this order:

1. the one given to :func:`enable_compile_cache` (``--compile-cache
   DIR`` on the command line);
2. ``$MAPREDUCE_TPU_CACHE``;
3. the package-adjacent ``build/kernels`` (:data:`DEFAULT_DIR`, listed
   in ``.gitignore``);
4. the user cache directory (:data:`USER_DIR`), for a read-only install.

A library process that enables nothing builds into
:func:`build_dir` (2 or 3) all the same, but keeps no shape registry:
as in the JAX package, the compile ledger (:mod:`..obs.compile`) writes
its registry only next to a cache that was *enabled*
(:func:`cache_dir`).  :func:`disable_compile_cache`
(``--no-compile-cache``) builds into a temporary directory of the
process's own, removed at exit: every build is then ``compiled``, and
each counts toward ``mrtpu_compile_cache_disabled_total``.

Pure Python: the host plane's processes call this without torch.
"""

from __future__ import annotations

import atexit
import logging
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional

#: the package-adjacent build directory (the repo's ``build/kernels``)
DEFAULT_DIR = str(Path(__file__).resolve().parent.parent.parent
                  / "build" / "kernels")
#: the fallback for read-only installs: a user cache directory
USER_DIR = os.path.join(
    os.environ.get("XDG_CACHE_HOME",
                   os.path.join(os.path.expanduser("~"), ".cache")),
    "mapreduce_tpu_torch", "kernels")

#: ``dir``: the enabled cache (None: none enabled); ``temp``: the
#: process's own directory under --no-compile-cache
_STATE: Dict[str, Any] = {"dir": None, "temp": None}


def writable_dir(path: str) -> bool:
    """True when *path* exists (or can be created) and accepts writes:
    the check ``warmup`` fails on, because a warmup that persists
    nothing leaves every later process to build again."""
    try:
        os.makedirs(path, exist_ok=True)
        # pid-suffixed: concurrent probers must not race on one name
        probe = os.path.join(path, f".write_probe.{os.getpid()}")
        with open(probe, "w"):
            pass
        try:
            os.remove(probe)
        except FileNotFoundError:
            pass
        return True
    except OSError:
        return False


def resolve_dir(path: Optional[str] = None) -> str:
    """*path*, else ``$MAPREDUCE_TPU_CACHE``, else the first writable of
    :data:`DEFAULT_DIR` and :data:`USER_DIR` (the latter, with a
    warning, when neither is)."""
    path = path or os.environ.get("MAPREDUCE_TPU_CACHE")
    if path:
        return str(path)
    for cand in (DEFAULT_DIR, USER_DIR):
        if writable_dir(cand):
            return cand
    logging.getLogger("mapreduce_tpu_torch.compile_cache").warning(
        "no writable build dir (tried %s, %s): every process will build "
        "its libraries again; set $MAPREDUCE_TPU_CACHE to a writable "
        "path", DEFAULT_DIR, USER_DIR)
    return USER_DIR


def enable_compile_cache(path: Optional[str] = None) -> str:
    """Build into, and keep the shape registry in, the directory
    :func:`resolve_dir` picks for *path*; returns it."""
    path = resolve_dir(path)
    _STATE["dir"] = path
    _STATE["temp"] = None
    return path


def _remove(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)


def disable_compile_cache() -> str:
    """Build into a fresh temporary directory of this process (removed
    at exit) and keep no registry; returns the directory."""
    path = tempfile.mkdtemp(prefix="mrtorch-build-")
    atexit.register(_remove, path)
    _STATE["dir"] = None
    _STATE["temp"] = path
    return path


def cache_dir() -> Optional[str]:
    """The enabled cache directory, or None (none enabled, or disabled):
    where the compile ledger keeps its shape registry."""
    return _STATE["dir"]


def disabled() -> bool:
    """True under :func:`disable_compile_cache`."""
    return _STATE["temp"] is not None


def build_dir() -> str:
    """Where libraries are built now: the enabled or temporary
    directory, else ``$MAPREDUCE_TPU_CACHE`` or :data:`DEFAULT_DIR`.
    The one source of the choice: ``kernel_compat`` and ``native`` call
    this at every build and load."""
    return (_STATE["dir"] or _STATE["temp"]
            or os.environ.get("MAPREDUCE_TPU_CACHE") or DEFAULT_DIR)


def save_state() -> Dict[str, Any]:
    """The current choice, for :func:`restore_state` (a command run in
    process, as the tests and the smoke run them, leaves the process as
    it found it)."""
    return dict(_STATE)


def restore_state(saved: Dict[str, Any]) -> None:
    _STATE.update(saved)
