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
  A user's callable monoid (``ops/monoid.py``) gets a library of its
  own, :func:`monoid_library`: a source generated into the build
  directory from its IR (the combine) and ``csrc/segreduce.cuh`` (the
  kernel), named and keyed by the IR's typed hash (an int32 body and a
  float32 body are two libraries), never by the callable's name, and by
  the headers' bytes, so an edited template rebuilds.
  :func:`sources_for` names the libraries a config's path launches,
  :func:`is_built` says whether one needs no ``nvcc`` (loaded, or its
  hashed ``.so`` already in the build directory, the persistent cache,
  which ``utils/compile_cache.build_dir`` names),
  and :func:`load` builds and loads a set of them.
  Every pointer and the stream cross as ``ctypes.c_void_p``; every C
  entry returns ``cudaGetLastError()`` and :func:`check` raises on a
  non-zero code.  ``nvcc`` runs with ``-Xptxas -v``: :data:`BUILD_LOGS`
  keeps each build's output and :func:`ptxas_usage` reads every
  kernel's registers and spill bytes from it.
* **the counters** — :data:`LAUNCHES` counts the launches of each
  kernel (one per wrapper call that launched it) and
  :data:`PLAIN_CALLS` the calls of each plain version, so a run can show
  which path it took.  Wrappers add to them only through
  :func:`count_launch` and :func:`count_plain`, under one lock, so
  threads driving two engines at once lose no count (a call on a stream
  being captured counts at each replay instead);
  :func:`reset_counts` zeroes both.

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
from typing import (Dict, Iterable, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from ..obs.compile import LEDGER
from ..obs.metrics import counter
from ..obs.trace import TRACER
from ..utils import compile_cache as _compile_cache
from . import monoid as _monoid

#: the kernels of this package, by the name their counters use
#: (``segreduce_monoid``: the segmented reduce with a user's callable
#: monoid, from a library of its own per monoid)
KERNELS = ("tokenize", "segreduce", "radix_plan", "radix_upfront",
           "radix_onesweep", "flash_fwd", "flash_dq", "flash_dkv",
           "segreduce_monoid")
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

#: guards every change to :data:`LAUNCHES` and :data:`PLAIN_CALLS`
_COUNT_LOCK = threading.Lock()
#: the same counts in the registry, so another process reads them
#: through ``/metrics``, a telemetry push or a flight dump (never reset:
#: :func:`reset_counts` zeroes only the dicts)
_LAUNCH_TOTAL = counter(
    "mrtpu_kernel_launches_total",
    "kernel launches by the port's wrappers (labels: kernel); the "
    "process's kernel_compat.LAUNCHES since it started")
_PLAIN_TOTAL = counter(
    "mrtpu_kernel_plain_calls_total",
    "calls of a kernel's plain PyTorch version (labels: kernel); the "
    "process's kernel_compat.PLAIN_CALLS since it started")
#: per stream being captured into a :class:`CapturedGraph`: the
#: kernels recorded into it (a capture's calls may run on other threads,
#: as autograd's backward does, but they enqueue on the capture stream)
_CAPTURES: Dict[int, Dict[str, int]] = {}


def reset_counts() -> None:
    """Zero every launch and plain-call counter."""
    with _COUNT_LOCK:
        for k in KERNELS:
            LAUNCHES[k] = 0
            PLAIN_CALLS[k] = 0


def count_launch(kernel: str, n: int = 1) -> None:
    """Add *n* launches of *kernel* (a wrapper, where it launches).  A
    call on a stream that a :class:`CapturedGraph` is capturing only
    records its kernel: it goes to that capture's tally instead, and
    counts at each replay."""
    if _CAPTURES and torch.cuda.is_current_stream_capturing():
        key = torch.cuda.current_stream().cuda_stream
        with _COUNT_LOCK:
            tally = _CAPTURES.get(key)
            if tally is None:
                # a stream forked into the capture: with one capture
                # under way, it is that capture's
                tally = (next(iter(_CAPTURES.values()))
                         if len(_CAPTURES) == 1
                         else _CAPTURES.setdefault(key, {}))
            tally[kernel] = tally.get(kernel, 0) + n
        return
    with _COUNT_LOCK:
        LAUNCHES[kernel] += n
    _LAUNCH_TOTAL.inc(n, kernel=kernel)


def count_plain(kernel: str, n: int = 1) -> None:
    """Add *n* calls of *kernel*'s plain version."""
    with _COUNT_LOCK:
        PLAIN_CALLS[kernel] += n
    _PLAIN_TOTAL.inc(n, kernel=kernel)


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
        count_plain(kernel)
        return False
    raise ValueError(f"{kernel}: no kernel or plain version for a tensor "
                     f"on {t.device}")


class CapturedGraph:
    """*fn* (kernel wrapper calls among other CUDA work) captured once
    into a CUDA graph; :meth:`replay` runs it again.

    A wrapper adds to :data:`LAUNCHES` when it launches, but a call under
    capture only records its kernel, which launches at each replay.  So
    the calls that enqueue on the capture stream, from any thread, are
    tallied for the capture (:attr:`launches`) and not counted, while
    other streams' launches during the capture count as ever; each
    replay adds the tally once: the counters keep counting launches.
    ``out`` is what *fn* returned: tensors of the graph's pool, which each
    replay overwrites."""

    def __init__(self, fn) -> None:
        self.graph = torch.cuda.CUDAGraph()
        key = None
        try:
            with torch.cuda.graph(self.graph):
                key = torch.cuda.current_stream().cuda_stream
                with _COUNT_LOCK:
                    _CAPTURES[key] = {}
                self.out = fn()
        finally:
            with _COUNT_LOCK:
                tally = _CAPTURES.pop(key, {})
        self.launches = {k: tally.get(k, 0) for k in KERNELS}

    def replay(self) -> None:
        self.graph.replay()
        with _COUNT_LOCK:
            for k, n in self.launches.items():
                LAUNCHES[k] += n
        for k, n in self.launches.items():
            if n:
                _LAUNCH_TOTAL.inc(n, kernel=k)


def capture_steps(step, n: int, state: Sequence[torch.Tensor]
                  ) -> CapturedGraph:
    """A training loop as one graph: ``step(i)`` for ``i < n``, each an
    in-place update of *state* that returns a scalar loss tensor, captured
    whole; the graph's ``out`` is the ``[n]`` losses.  ``step(0)`` runs
    twice on a side stream first (lazy initialisations and the gradients'
    allocation happen outside the capture), and *state* is put back
    afterwards, so the capture starts from the state the caller passed."""
    saved = [t.detach().clone() for t in state]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step(0)
    torch.cuda.current_stream().wait_stream(side)
    with torch.no_grad():
        for t, s in zip(state, saved):
            t.copy_(s)
    del saved
    losses = torch.empty(n, device=state[0].device)

    def run():
        for i in range(n):
            losses[i].copy_(step(i))
        return losses

    return CapturedGraph(run)


class StepsGraph:
    """S training steps captured whole (:func:`capture_steps`) on fixed
    tensors: *state*, whose owners (the caller's state objects) are kept
    in :attr:`owners`, and ``[S, ...]`` slots for the stacked batch, which
    ``step(x, y)`` reads one step's rows of.  :meth:`run` copies a batch
    into the slots and replays."""

    def __init__(self, step, xs: torch.Tensor, ys: torch.Tensor,
                 state: Sequence[torch.Tensor], owners: Sequence,
                 program: str = "steps") -> None:
        self.owners = tuple(owners)
        self.xs, self.ys = xs.clone(), ys.clone()

        def capture():
            with TRACER.span("capture", program=program):
                return capture_steps(
                    lambda i: step(self.xs[i], self.ys[i]), xs.shape[0],
                    state)

        # a compile-ledger acquisition under *program* (the JAX
        # trainers' program names): always ``compiled`` and never in the
        # shape registry, since a capture is this process's own
        self.graph, _, _ = LEDGER.acquire(program, capture, avals=[xs, ys],
                                          stage="capture", registry={},
                                          persist=False)

    def fits(self, owners: Sequence, xs: torch.Tensor) -> bool:
        """Whether this graph runs *owners*' state (the same objects) on a
        batch of *xs*' shape; otherwise the caller captures anew."""
        owners = tuple(owners)
        return (len(owners) == len(self.owners)
                and all(a is b for a, b in zip(owners, self.owners))
                and self.xs.shape == xs.shape)

    def run(self, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
        """The S losses of one replay on *xs*, *ys* (a copy)."""
        self.xs.copy_(xs)
        self.ys.copy_(ys)
        self.graph.replay()
        return self.graph.out.clone()


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


#: a user monoid's library name: this prefix, ``-`` and the first 16
#: hex digits of its IR's hash (:func:`.monoid.ir_hash`)
MONOID = "segreduce_monoid"


class _Build(NamedTuple):
    """What builds and binds one library."""

    #: the kernel's own source, a file of ``csrc``; None for a generated
    #: one, written beside its library at the build
    path: Optional[Path]
    #: the generated source (None: ``path`` holds it)
    text: Optional[str]
    #: the ops module whose ``_SIGNATURES``-style table the library
    #: binds, and the table's name
    signatures: Tuple[str, str]
    #: what a failed ``nvcc`` names
    what: str

    def source(self) -> bytes:
        return (self.path.read_bytes() if self.path is not None
                else self.text.encode())


#: the generated libraries this process has named (:func:`monoid_library`)
_GENERATED: Dict[str, _Build] = {}
#: the library name of each IR :func:`monoid_library` named, by the IR's
#: id (the IR kept beside it, so that its id is not reused)
_MONOID_NAMES: Dict[int, Tuple["_monoid.MonoidIR", str]] = {}


def monoid_library(ir: "_monoid.MonoidIR") -> str:
    """The library name of the monoid kernel for *ir*, registered on the
    first call for this IR (so that :func:`library`, :func:`load` and
    :func:`build_all` can build it); later calls are one dict lookup."""
    got = _MONOID_NAMES.get(id(ir))
    if got is not None:
        return got[1]
    name = f"{MONOID}-{_monoid.ir_hash(ir)[:16]}"
    _GENERATED.setdefault(name, _Build(
        None, monoid_source(ir), ("segscan", "_MONOID_SIGNATURES"),
        f"{name} (the monoid kernel of reduce_op {ir.name})"))
    _MONOID_NAMES[id(ir)] = (ir, name)
    return name


def monoid_source(ir: "_monoid.MonoidIR") -> str:
    """The generated source of *ir*'s library: the kernel template, the
    combine :func:`.monoid.emit_cuda` writes, and the C entries.  The
    combine lies in an anonymous namespace, so every instantiation over
    it (the kernel, ``launch`` and its static flag of the shared-memory
    attribute) is the library's own: with one name in every library, a
    process that loads two monoids would otherwise share one flag (the
    loader merges such statics), and the second library's kernel would
    launch without its attribute set."""
    return ("// Generated by mapreduce_tpu_torch/ops/kernel_compat.py: a "
            "user monoid's\n// combine (ops/monoid.py) in the segmented-"
            "reduce kernel (csrc/segreduce.cuh).\n"
            '#include "segreduce.cuh"\n\nnamespace {\n\n'
            "// the value ops the lowering emits (mr_fmin, mr_floordiv, ...)\n"
            "using namespace mr_segreduce_kernels;\n\n"
            + _monoid.emit_cuda(ir) + "\n}  // namespace\n\n"
            "MR_MONOID_ENTRIES(MrUserCombine)\n")


def _build_of(name: str) -> _Build:
    """How library *name* is built: a source of ``csrc`` or one this
    process generated."""
    got = _GENERATED.get(name)
    if got is not None:
        return got
    if name not in _WRAPPERS:
        raise KeyError(f"{name}: neither a source of {CSRC} nor a library "
                       "this process generated (monoid_library names a "
                       "monoid's)")
    return _Build(CSRC / f"{name}.cu", None, (_WRAPPERS[name], "_SIGNATURES"),
                  name)


def _source_bytes(name: str):
    """The bytes that make library *name*: the kernel's own source plus
    every shared header, in a fixed order (all of them feed the build
    hash)."""
    return [_build_of(name).source()] + [
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]


def build_label(name: str, defines: Defines = ()) -> str:
    """``name``, or ``name[K=V,...]`` for a variant build."""
    if not defines:
        return name
    return f"{name}[{','.join(f'{k}={v}' for k, v in defines)}]"


def _flags(defines: Defines):
    return NVCC_FLAGS + tuple(f"-D{k}={v}" for k, v in defines)


def _lib_path(name: str, defines: Defines = ()) -> Path:
    h = hashlib.sha1()
    for src in _source_bytes(name):
        h.update(src)
    h.update(" ".join(_flags(defines)).encode())
    # the build directory as utils/compile_cache chooses it now
    # (``build/kernels`` by default, listed in .gitignore)
    return (Path(_compile_cache.build_dir())
            / f"{name}-{h.hexdigest()[:12]}.so")


def _build_lock(key: Tuple[str, Defines]) -> threading.Lock:
    with _LOCKS_LOCK:
        return _BUILD_LOCKS.setdefault(key, threading.Lock())


def _start_build(name: str, defines: Defines = ()
                 ) -> Optional[subprocess.Popen]:
    out = _lib_path(name, defines)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    # named by process and thread: two threads building one source never
    # share a temporary file
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    nvcc, build = _nvcc(), _build_of(name)
    src = build.path
    if src is None:  # generated: written beside its library
        src = out.with_suffix(".cu")
        src_tmp = tmp.with_suffix(".cu")
        src_tmp.write_text(build.text)
        os.replace(src_tmp, src)
    cmd = [nvcc, *_flags(defines), "-I", str(CSRC), "-o", str(tmp),
           str(src)]
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
    t1 = time.monotonic()
    BUILD_SECONDS[label] = t1 - proc.mr_t0
    TRACER.record("nvcc", proc.mr_t0, t1, library=label,
                  exit=proc.returncode)
    if proc.returncode != 0:
        what = _build_of(name).what + label[len(name):]
        raise RuntimeError(f"nvcc failed for {what} "
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


def sources_for(cfg, device=None,
                value_dtype: Optional[torch.dtype] = None
                ) -> Tuple[str, ...]:
    """The libraries an engine config's path launches on CUDA:
    ``tokenize`` and ``segreduce`` always, ``radix`` when every sort and
    the exchange plan run on the radix kernels (``sort_impl ==
    'radix'``), and a callable ``reduce_op``'s monoid library, typed by
    *value_dtype*, the dtype of the value lanes the map emits
    (:func:`monoid_library` of :func:`.monoid.lower`; lowering it here
    raises for a monoid the kernel cannot take).  The monoid library is
    named only where *value_dtype* is given, and never under
    ``unit_values``, which leaves the op unused.  For an engine on a CPU
    *device* (None: CUDA) the callable is not lowered and names no
    library: the CPU launches none, and runs every callable through the
    plain ladder."""
    names = ("tokenize", "segreduce")
    if (callable(cfg.reduce_op) and not cfg.unit_values
            and value_dtype is not None
            and (device is None or torch.device(device).type == "cuda")):
        names += (monoid_library(_monoid.lower(cfg.reduce_op,
                                               value_dtype)),)
    return names + ("radix",) if cfg.sort_impl == "radix" else names


def is_built(name: str, defines: Defines = ()) -> bool:
    """The warmness probe: True when source *name*'s library needs no
    ``nvcc`` — loaded in this process, or its ``.so`` for the current
    sources and flags already in the build directory
    (``utils/compile_cache.build_dir``)."""
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
            label = build_label(name, key[1])
            program = f"nvcc:{label}"
            with TRACER.span("compile", program=program) as sp:
                _finish_build(name, _start_build(name, key[1]), key[1])
                t0 = time.monotonic()
                with TRACER.span("load", library=label):
                    lib = ctypes.CDLL(str(_lib_path(name, key[1])))
                t_load = time.monotonic() - t0
                # nvcc ran for it in this process (here or in a
                # build_all), or its .so was already in the build dir
                outcome = ("compiled" if label in BUILD_SECONDS
                           else "persistent_hit")
                sp.args["outcome"] = outcome
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[key] = lib
            stages = {"load": t_load}
            if outcome == "compiled":
                stages["nvcc"] = BUILD_SECONDS[label]
            LEDGER.observe(program, outcome, stages)
    return lib


def load(names: Iterable[str], observe: bool = False) -> None:
    """Build the libraries of *names* not built yet (in parallel, as
    :func:`build_all`) and load each: after this, their wrappers launch
    without waiting for ``nvcc``.  Each fresh load is a compile-ledger
    acquisition (``compiled`` or ``persistent_hit``); with *observe*
    (the engine's program acquisitions), a library already loaded
    counts as ``cached``."""
    names = list(names)
    if observe:
        for n in names:
            if (n, ()) in _LIBS:
                LEDGER.observe(f"nvcc:{n}", "cached")
    names = [n for n in names if (n, ()) not in _LIBS]
    if not names:
        return
    build_all(names=names)
    for n in names:
        library(n, _signatures(n))


def _signatures(name: str) -> Dict[str, tuple]:
    """The C entries of library *name*, from the ops module that wraps
    it."""
    module, table = _build_of(name).signatures
    return getattr(importlib.import_module(f"{__package__}.{module}"),
                   table)


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
