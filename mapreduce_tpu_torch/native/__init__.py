"""ctypes binding of the host core (``mr_native.cpp``; port of
``mapreduce_tpu/native/__init__.py``).

``g++`` builds the library from this package's source at first use, into
the build directory (:func:`..utils.compile_cache.build_dir`, the
``build/kernels`` of ``kernel_compat``'s ``nvcc`` builds by default),
under a file name that carries a hash of the source and the flags, so an
edited source builds again and a later process loads the built one.  The
build is a compile-ledger acquisition (``g++:mr_native``): ``compiled``
when ``g++`` ran, ``persistent_hit`` when the ``.so`` was already built,
``cached`` when :func:`load_library` finds it loaded.

The port's one rule holds here too: a failed build raises, naming the
compiler's output; nothing falls back quietly.  The Python twins
(:func:`tokenize_count_py`, :func:`fnv1a32_batch_py`) are the plain
versions; a caller takes one only by calling it by name.

Pure Python and numpy: the host plane's workers load this without torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..obs.compile import LEDGER
from ..obs.trace import TRACER
from ..utils import compile_cache

#: the tokenizer's hash multipliers (ops/tokenize.py's HASH_A1, HASH_A2)
HASH_A1 = 16777619
HASH_A2 = 0x85EBCA6B

SOURCE = Path(__file__).resolve().parent / "mr_native.cpp"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
PROGRAM = "g++:mr_native"

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
#: seconds of the last g++ run of this process (None: none ran)
BUILD_SECONDS: Optional[float] = None


def lib_path() -> Path:
    """The library for the current source and flags in the build dir."""
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return (Path(compile_cache.build_dir())
            / f"mr_native-{h.hexdigest()[:12]}.so")


def _build(out: Path) -> float:
    """g++ into *out* (through a temporary file, replaced atomically);
    returns its seconds, raising with the compiler's output on failure."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp)]
    t0 = time.monotonic()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"g++ could not build {SOURCE.name}: {e}") from e
    t1 = time.monotonic()
    TRACER.record("g++", t0, t1, library="mr_native", exit=proc.returncode)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return t1 - t0


def load_library() -> ctypes.CDLL:
    """The loaded library, built first when its ``.so`` is missing; every
    call is an acquisition in the compile ledger."""
    global _LIB, BUILD_SECONDS
    with _LOCK:
        if _LIB is not None:
            LEDGER.observe(PROGRAM, "cached")
            return _LIB
        path = lib_path()
        stages: Dict[str, float] = {}
        with TRACER.span("compile", program=PROGRAM) as sp:
            if path.exists():
                outcome = "persistent_hit"
            else:
                outcome = "compiled"
                stages["g++"] = BUILD_SECONDS = _build(path)
            t0 = time.monotonic()
            with TRACER.span("load", library="mr_native"):
                lib = ctypes.CDLL(str(path))
            stages["load"] = time.monotonic() - t0
            sp.args["outcome"] = outcome
        lib.mr_fnv1a32_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.mr_fnv1a32_batch.restype = None
        lib.mr_tokenize_count.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]
        lib.mr_tokenize_count.restype = ctypes.c_int64
        _LIB = lib
        LEDGER.observe(PROGRAM, outcome, stages)
        return lib


def _lib() -> ctypes.CDLL:
    """The hot path's handle: the loaded library, acquired once."""
    return _LIB if _LIB is not None else load_library()


def fnv1a32_batch(tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """FNV-1a of each row of ``[N, W]`` uint8 *tokens* over its
    ``lengths[i]`` live bytes (the twin: :func:`fnv1a32_batch_py`)."""
    lib = _lib()
    tokens = np.ascontiguousarray(tokens, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    n, w = tokens.shape
    out = np.empty((n,), dtype=np.uint32)
    lib.mr_fnv1a32_batch(tokens.ctypes.data, n, w, lengths.ctypes.data,
                         out.ctypes.data)
    return out


def fnv1a32_batch_py(tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The plain version of :func:`fnv1a32_batch`."""
    from ..utils.hashing import fnv1a32_np

    return fnv1a32_np(tokens, lengths)


def tokenize_count(data: bytes, capacity: int = 1 << 17):
    """One-pass tokenize + aggregate: ``(hashes u64 [U], starts int64
    [U], lengths int32 [U], counts int64 [U])`` for the unique words of
    *data*.  A result over *capacity* uniques (or a saturated table)
    doubles the capacity and runs again."""
    lib = _lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    while True:
        h = np.empty(capacity, dtype=np.uint64)
        st = np.empty(capacity, dtype=np.int64)
        ln = np.empty(capacity, dtype=np.int32)
        ct = np.empty(capacity, dtype=np.int64)
        n = lib.mr_tokenize_count(buf.ctypes.data, len(data),
                                  h.ctypes.data, st.ctypes.data,
                                  ln.ctypes.data, ct.ctypes.data, capacity)
        if 0 <= n <= capacity:
            return h[:n], st[:n], ln[:n], ct[:n]
        capacity *= 2  # saturated (-1) or truncated (n > capacity)


def tokenize_count_py(data: bytes):
    """The plain version of :func:`tokenize_count`, uniques in order of
    first occurrence (the library's come in table order)."""
    agg: Dict[int, list] = {}
    pos = 0
    for word in data.split():
        start = data.find(word, pos)
        pos = start + len(word)
        h1 = h2 = 0
        for b in word:
            h1 = (h1 * HASH_A1 + b + 1) & 0xFFFFFFFF
            h2 = (h2 * HASH_A2 + b + 1) & 0xFFFFFFFF
        h = (h1 << 32) | h2
        if h == 0xFFFFFFFFFFFFFFFF:
            h = 0  # the library reserves the all-ones hash as its sentinel
        e = agg.get(h)
        if e is None:
            agg[h] = [start, len(word), 1]
        else:
            e[2] += 1
    n = len(agg)
    hs = np.fromiter(agg.keys(), dtype=np.uint64, count=n)
    st = np.fromiter((v[0] for v in agg.values()), dtype=np.int64, count=n)
    ln = np.fromiter((v[1] for v in agg.values()), dtype=np.int32, count=n)
    ct = np.fromiter((v[2] for v in agg.values()), dtype=np.int64, count=n)
    return hs, st, ln, ct


def _as_dict(data: bytes, counted) -> Dict[bytes, int]:
    _hs, st, ln, ct = counted
    return {data[int(s):int(s) + int(n)]: int(c)
            for s, n, c in zip(st, ln, ct)}


def wordcount_bytes(data: bytes) -> Dict[bytes, int]:
    """``Counter(data.split())`` through the library."""
    return _as_dict(data, tokenize_count(data))


def wordcount_bytes_py(data: bytes) -> Dict[bytes, int]:
    """The plain version of :func:`wordcount_bytes`."""
    return _as_dict(data, tokenize_count_py(data))


def _forget() -> None:
    """Tests only: drop the loaded handle (a fresh process's state)."""
    global _LIB
    with _LOCK:
        _LIB = None
