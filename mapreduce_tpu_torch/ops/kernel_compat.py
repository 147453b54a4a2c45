"""Shared kernel plumbing: ONE rule for kernel vs plain, the build, counters.

The counterpart of ``mapreduce_tpu/ops/pallas_compat.py``.  Every
hand-written CUDA kernel of this package is reached through the same
three pieces of glue:

* **the rule** — :func:`use_kernel`: a tensor on the CPU takes the
  kernel's plain PyTorch version; a tensor on a CUDA device launches the
  kernel, and anything that stops the launch raises.  There is no
  ``try`` that falls back: a card run that silently ran the plain
  version would measure the wrong program.
* **the build** — :func:`library`: ``nvcc`` compiles
  ``mapreduce_tpu_torch/csrc/<name>.cu`` into a shared library with a
  plain C interface under ``build/kernels/`` at first use (the file name
  carries a hash of the sources, so an edited kernel rebuilds), and
  ``ctypes`` loads it.  :func:`build_all` starts one ``nvcc`` per source
  at once, so a fresh checkout pays the slowest build, not the sum.  A
  *variant* is a source built with extra ``-D`` defines into a library of
  its own (a timed A/B of a compile-time constant); the package's
  wrappers load only the default build.  Each ``(source, defines)``
  build-and-load holds a lock of its own, so threads that want one
  library build it once (the others wait), while different libraries
  build in parallel: the tier specializer (``engine/tiering.py``) builds
  on a thread of its own while the wave loop loads on the main one.
  :func:`sources_for` names the libraries a config's path launches,
  :func:`is_built` says whether one needs no ``nvcc`` (loaded, or its
  hashed ``.so`` already in :data:`BUILD_DIR`, the persistent cache),
  and :func:`load` builds and loads a set of them.
  Every pointer and the stream cross as ``ctypes.c_void_p``; every C
  entry returns ``cudaGetLastError()`` and :func:`check` raises on a
  non-zero code.  ``nvcc`` runs with ``-Xptxas -v``: :data:`BUILD_LOGS`
  keeps each build's output and :func:`ptxas_usage` reads every
  kernel's registers and spill bytes from it.
* **the counters** — :data:`LAUNCHES` counts the launches of each
  kernel (one per wrapper call that launched it) and
  :data:`PLAIN_CALLS` the calls of each plain version, so a run can show
  which path it took.  They are plain ints, the package's only global
  state; :func:`reset_counts` zeroes both.

It also holds the uint32 arithmetic the plain versions share.  torch's
``uint32`` supports few operations, and an int64 product of two 32-bit
values overflows, so a uint32 lane is held as int64 in ``[0, 2**32)``
and multiplied by splitting one factor into 16-bit halves
(:func:`mul_u32`).
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

#: the kernels of this package, by the name their counters use
KERNELS = ("tokenize", "segreduce", "radix_plan", "radix_upfront",
           "radix_onesweep", "flash_fwd", "flash_dq", "flash_dkv")
#: the kernel sources, ``csrc/<name>.cu``: one shared library each
#: (``radix.cu`` holds the sort's upfront and onesweep kernels and the
#: exchange plan's kernel, ``flash_attention.cu`` the three
#: flash-attention kernels)
SOURCES = ("tokenize", "segreduce", "radix", "flash_attention")
#: the ops module that wraps each source (its ``_SIGNATURES`` are the
#: library's C entries)
_WRAPPERS = {"tokenize": "tokenize", "segreduce": "segscan",
             "radix": "radix_sort", "flash_attention": "flash_attention"}
#: kernel launches per kernel (one per wrapper call that launched it)
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
#: plain-version calls per kernel
PLAIN_CALLS: Dict[str, int] = {k: 0 for k in KERNELS}

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
#: where the shared libraries are built (listed in .gitignore)
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: ``-D`` defines of a variant build, as ``((name, value), ...)``
Defines = Tuple[Tuple[str, int], ...]

_LIBS: Dict[Tuple[str, Defines], ctypes.CDLL] = {}
#: one lock per ``(source, defines)``, held around its build and load
_BUILD_LOCKS: Dict[Tuple[str, Defines], threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()
#: the output of each build's nvcc, for the builds this process made, by
#: :func:`build_label`
BUILD_LOGS: Dict[str, str] = {}
#: wall seconds of each build's nvcc (start to exit), by :func:`build_label`
BUILD_SECONDS: Dict[str, float] = {}

MASK32 = 0xFFFFFFFF


def reset_counts() -> None:
    """Zero every launch and plain-call counter."""
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


def resolve_device(device=None) -> torch.device:
    """An entry point's device: ``None`` means ``"cuda"``.  Raises
    ``RuntimeError`` when CUDA is asked for and absent — the port never
    falls back to the CPU quietly; the caller asks for it by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def use_kernel(t: torch.Tensor, kernel: str) -> bool:
    """THE rule: True (launch the kernel) for a CUDA tensor, False (take
    the plain version, counted) for a CPU tensor; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        PLAIN_CALLS[kernel] += 1
        return False
    raise ValueError(f"{kernel}: no kernel or plain version for a tensor "
                     f"on {t.device}")


# -- the build -----------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels are built from source at first use")
    return str(path)


def _sources(name: str):
    """The kernel's own source plus every shared header, in a fixed
    order (all of them feed the build hash)."""
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def build_label(name: str, defines: Defines = ()) -> str:
    """``name``, or ``name[K=V,...]`` for a variant build."""
    if not defines:
        return name
    return f"{name}[{','.join(f'{k}={v}' for k, v in defines)}]"


def _flags(defines: Defines):
    return NVCC_FLAGS + tuple(f"-D{k}={v}" for k, v in defines)


def _lib_path(name: str, defines: Defines = ()) -> Path:
    h = hashlib.sha1()
    for src in _sources(name):
        h.update(src.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _build_lock(key: Tuple[str, Defines]) -> threading.Lock:
    with _LOCKS_LOCK:
        return _BUILD_LOCKS.setdefault(key, threading.Lock())


def _start_build(name: str, defines: Defines = ()
                 ) -> Optional[subprocess.Popen]:
    out = _lib_path(name, defines)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # named by process and thread: two threads building one source never
    # share a temporary file
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.mr_tmp, proc.mr_t0 = tmp, time.monotonic()
    return proc


def _finish_build(name: str, proc: Optional[subprocess.Popen],
                  defines: Defines = ()) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    label = build_label(name, defines)
    BUILD_SECONDS[label] = time.monotonic() - proc.mr_t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(proc.mr_tmp, _lib_path(name, defines))
    BUILD_LOGS[label] = log


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PROPS = re.compile(r"Function properties for (\w+)")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def _demangle(names):
    """``kernel<args>`` for each mangled name, through ``c++filt`` (the
    mangled names where it is missing)."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout.split("\n")
    return [re.sub(r"\w+::", "", n.split("(")[0]).replace("void ", "")
            for n in out[:len(names)]]


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """``{kernel: {"registers", "spill_stores", "spill_loads"}}`` (spills
    in bytes) from an ``nvcc -Xptxas -v`` log, one entry per kernel
    instantiation."""
    usage: Dict[str, Dict[str, int]] = {}
    entry = props = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
            usage[entry] = {}
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        m = _SPILLS.search(line)
        if m and entry is not None and props == entry:
            usage[entry]["spill_stores"] = int(m.group(1))
            usage[entry]["spill_loads"] = int(m.group(2))
            continue
        m = _REGS.search(line)
        if m and entry is not None:
            usage[entry]["registers"] = int(m.group(1))
    names = list(usage)
    return dict(zip(_demangle(names), (usage[n] for n in names)))


def sources_for(cfg) -> Tuple[str, ...]:
    """The libraries an engine config's path launches on CUDA:
    ``tokenize`` and ``segreduce`` always, and ``radix`` when every sort
    and the exchange plan run on the radix kernels (``sort_impl ==
    'radix'``)."""
    names = ("tokenize", "segreduce")
    return names + ("radix",) if cfg.sort_impl == "radix" else names


def is_built(name: str, defines: Defines = ()) -> bool:
    """The warmness probe: True when source *name*'s library needs no
    ``nvcc`` — loaded in this process, or its ``.so`` for the current
    sources and flags already in :data:`BUILD_DIR`."""
    key = (name, tuple(defines))
    return key in _LIBS or _lib_path(*key).exists()


def build_all(variants: Sequence[Tuple[str, Defines]] = (),
              names: Iterable[str] = SOURCES) -> None:
    """Build each library of *names* (every source by default) and each
    ``(source, defines)`` of *variants* that is not built yet: one
    ``nvcc`` per build, all started together.  Holds each build's lock
    (taken in sorted order) until every ``nvcc`` has exited."""
    builds = sorted({(n, ()) for n in names}
                    | {(n, tuple(d)) for n, d in variants})
    locks = [_build_lock(b) for b in builds]
    for lock in locks:
        lock.acquire()
    try:
        procs = [_start_build(n, d) for n, d in builds]
        errors = []
        for (n, d), proc in zip(builds, procs):
            try:
                _finish_build(n, proc, d)
            except RuntimeError as e:  # collect: every nvcc must be waited on
                errors.append(str(e))
    finally:
        for lock in locks:
            lock.release()
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str, signatures: Dict[str, tuple],
            defines: Defines = ()) -> ctypes.CDLL:
    """The loaded shared library of source *name* (built with *defines*,
    a variant, when given), built on first use.  *signatures* maps each
    C entry to ``(restype, [argtypes])``, set once at load (ctypes would
    otherwise pass pointers as 32-bit ints).  One thread builds and
    loads a library; others asking for it meanwhile wait for it."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    with _build_lock(key):
        lib = _LIBS.get(key)
        if lib is None:
            _finish_build(name, _start_build(name, key[1]), key[1])
            lib = ctypes.CDLL(str(_lib_path(name, key[1])))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[key] = lib
    return lib


def load(names: Iterable[str]) -> None:
    """Build the libraries of *names* not built yet (in parallel, as
    :func:`build_all`) and load each: after this, their wrappers launch
    without waiting for ``nvcc``."""
    names = [n for n in names if (n, ()) not in _LIBS]
    if not names:
        return
    build_all(names=names)
    for n in names:
        mod = importlib.import_module(f"{__package__}.{_WRAPPERS[n]}")
        library(n, mod._SIGNATURES)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(kernel: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error (its launches were
    refused or an earlier asynchronous fault surfaced)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")


def require(t: torch.Tensor, kernel: str, what: str, dtype: torch.dtype,
            device: torch.device, shape=None) -> None:
    """The wrapper's argument check before pointers cross to C (and the
    shape, where the kernel writes by offsets the wrapper computed)."""
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{kernel}: {what} must be a contiguous {dtype} "
                         f"tensor on {device}, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {what} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


# -- uint32 arithmetic for the plain versions ------------------------------------

def u32(x: torch.Tensor) -> torch.Tensor:
    """A uint32 lane as int64 in ``[0, 2**32)`` (from int32 bit patterns
    or any integer tensor)."""
    return x.to(torch.int64) & MASK32


def mul_u32(x: torch.Tensor, a) -> torch.Tensor:
    """``(x * a) mod 2**32`` for uint32 values held as int64, *a* a
    tensor of the same kind or a Python int: *a* splits into 16-bit
    halves so no partial product leaves int64."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held as int64 -> their int32 bit patterns."""
    return (((x & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)
