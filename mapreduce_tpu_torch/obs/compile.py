"""Compile observability: the build ledger and the shape registry (port of
``mapreduce_tpu/obs/compile.py``).

The JAX package routes every ``lower()``/``compile()`` through one
ledger.  The port has no JIT; what a process acquires before it can run
is, by program name:

* ``nvcc:<library>`` — a shared library of ``csrc/`` (``kernel_compat``:
  ``nvcc`` for ``sm_90a``, then ``ctypes`` loads it), and ``g++:mr_native``,
  the host core (:mod:`..native`);
* ``wave`` — the device engine's wave program at one configuration and
  input shape: the libraries its path launches, loaded
  (``DeviceEngine.precompile`` and the run's first wave of a config),
  keyed as the JAX engine keys its wave program: map_fn, the config's
  cache key, the partitions;
* ``mlp_epoch`` / ``tf_steps`` — the trainers' CUDA-graph captures.

Each acquisition counts in ``mrtpu_compile_total{program, outcome}``:

* ``cached`` — already acquired in this process (a library in
  ``kernel_compat``'s loaded set; a wave program whose key an earlier
  engine acquired): no build, no load;
* ``persistent_hit`` — a library whose ``.so`` for the current sources
  and flags was already in the build directory (loaded, not built); a
  wave program whose bucket the enabled cache's shape registry already
  holds;
* ``compiled`` — ``nvcc`` / ``g++`` ran, a wave bucket new to the
  registry, or a capture; under ``--no-compile-cache`` each also counts
  ``mrtpu_compile_cache_disabled_total``.

Its seconds land in ``mrtpu_compile_seconds{program, stage}`` (stages
``nvcc``, ``g++``, ``load``, ``build`` — a wave's libraries — and
``capture``), and each acquisition that did work emits a ``compile`` span
on the tracer with children named for those steps.

The **shape registry** (``mrtpu_shape_registry.json``, the JAX name) is
kept in the enabled cache directory (:func:`..utils.compile_cache.
cache_dir`), beside the libraries, in the JAX record schema: per bucket
``program``, ``avals``, ``mesh``, ``extra``, ``compile_s``,
``lowering_s`` (0: nothing is lowered), ``memory``, ``torch`` (the JAX
record's ``jax``), ``count``, ``outcomes``, ``best_compile_s``, the
wave's ``tier`` and its ``replay`` spec ``{kind: "device_engine",
map_fn, config, n_dev, row_shape, row_dtype, k}`` (``n_dev`` the
partition count), or, for a run that cannot replay (a callable reduce
op, as the JAX engine records no replay spec for one), its ``sizing``
``{map_fn, config}`` (the capacities alone).  Bucket ids are the
port's own fingerprints.  Writes read, merge and atomically replace the
file, so processes share a directory.  ``cli warmup --replay`` (:func:`..engine.device_engine.
replay_registry`) and the capacity controller (``engine/autotune``)
read it.  Library acquisitions stay in the process's ledger only: their
``.so`` files are their own record.  The JAX record's ``donation`` is
left out (PyTorch donates no buffers; ROADMAP A.8a's queue).

Pure Python and monotonic-only: every clock read feeds a span or a
compile-seconds histogram.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import compile_cache as _cache
from .memory import analytic_program_memory
from .metrics import counter, gauge, histogram
from .trace import TRACER

logger = logging.getLogger("mapreduce_tpu_torch.obs.compile")

#: the shape-bucket registry file, kept inside the enabled cache dir
REGISTRY_BASENAME = "mrtpu_shape_registry.json"

#: compile-seconds histogram ladder (the JAX package's)
COMPILE_BUCKETS: Tuple[float, ...] = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0, float("inf"))

_COMPILES = counter(
    "mrtpu_compile_total",
    "instrumented program and library acquisitions (labels: program, "
    "outcome=cached [already acquired in this process] | persistent_hit "
    "[a library's .so already built / a wave bucket already in the "
    "shape registry] | compiled [nvcc or g++ ran, a new bucket, a "
    "capture])")
_COMPILE_SECONDS = histogram(
    "mrtpu_compile_seconds",
    "per-program acquisition seconds (labels: program, "
    "stage=nvcc|g++|load|build|capture)",
    buckets=COMPILE_BUCKETS)
_CACHE_DISABLED = counter(
    "mrtpu_compile_cache_disabled_total",
    "builds executed under --no-compile-cache: every one is paid again "
    "by the next process (labels: program)")
_BUCKET_GAUGE = gauge(
    "mrtpu_compile_shape_buckets",
    "shape buckets known to the compile ledger (labels: "
    "scope=memory|disk)")


def cache_dir() -> Optional[str]:
    """The enabled cache directory (where the registry lives), or None."""
    return _cache.cache_dir()


def registry_path(dir: Optional[str] = None) -> Optional[str]:
    d = dir or cache_dir()
    return os.path.join(d, REGISTRY_BASENAME) if d else None


# -- fingerprints ------------------------------------------------------------


def _aval_doc(a: Any) -> Dict[str, Any]:
    """``{"shape", "dtype"}`` of a shaped leaf (a tensor, an array or a
    ``(shape, dtype)`` record); dtypes spelled as numpy spells them."""
    dtype = str(getattr(a, "dtype", "?")).replace("torch.", "")
    return {"shape": [int(d) for d in a.shape], "dtype": dtype}


def _torch_version() -> Optional[str]:
    mod = sys.modules.get("torch")
    return getattr(mod, "__version__", None)


def bucket_id(program: str, avals: Sequence[Any], extra: Sequence[Any] = (),
              mesh: Optional[Dict[str, Any]] = None) -> str:
    """Stable cross-process identity of one bucket: the program, every
    leaf's shape and dtype, the caller's extra tokens (map_fn, config
    key), the partitions and device, and the torch version."""
    doc = {"program": program, "avals": [_aval_doc(a) for a in avals],
           "extra": [str(x) for x in extra], "mesh": mesh or {},
           "torch": _torch_version()}
    blob = json.dumps(doc, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def op_token(op: Any) -> str:
    """Stable spelling of a reduce op or map fn: strings pass through,
    functions become ``module:qualname``."""
    if isinstance(op, str):
        return op
    mod = getattr(op, "__module__", None)
    qual = getattr(op, "__qualname__", None)
    if mod and qual:
        return f"{mod}:{qual}"
    return repr(op)


def fn_path(fn: Any) -> Optional[str]:
    """``module:qualname`` when *fn* is importable from its module (the
    replay contract); None for lambdas and locals, which cannot replay."""
    mod = getattr(fn, "__module__", None)
    qual = getattr(fn, "__qualname__", None)
    if not mod or not qual or "<" in qual:
        return None
    return f"{mod}:{qual}"


def resolve_fn(path: str) -> Any:
    """Inverse of :func:`fn_path` (``warmup --replay``)."""
    mod_name, _, qual = path.partition(":")
    obj: Any = importlib.import_module(mod_name)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


# -- the ledger --------------------------------------------------------------


class CompileLedger:
    """Process-wide accounting of builds, loads and captures."""

    def __init__(self, tracer=TRACER) -> None:
        self._tracer = tracer
        self._lock = threading.Lock()
        #: (program, key) pairs acquired in this process
        self._keys: set = set()
        self._records: Dict[str, Dict[str, Any]] = {}
        self._disk_count_cache: Optional[Tuple[str, int, int]] = None
        self._disk_buckets_cache: Optional[
            Tuple[str, int, Dict[str, Dict[str, Any]]]] = None

    # -- disk registry -----------------------------------------------------

    def _load_disk(self, path: str) -> Dict[str, Dict[str, Any]]:
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return {}
        buckets = doc.get("buckets")
        return buckets if isinstance(buckets, dict) else {}

    def _persist(self, path: str, bucket: str,
                 record: Dict[str, Any]) -> None:
        """Read-merge-write the registry (atomic replace; a concurrent
        writer's losing bucket re-appends at its next acquisition: best
        effort, never a failed run)."""
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            buckets = self._load_disk(path)
            prev = buckets.get(bucket) or {}
            merged = dict(record)
            merged["count"] = int(prev.get("count", 0)) + 1
            best = float(record["compile_s"])
            if prev.get("best_compile_s") is not None:
                best = min(float(prev["best_compile_s"]), best)
            merged["best_compile_s"] = best
            buckets[bucket] = merged
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"kind": "mrtpu-shape-registry", "version": 2,
                           "buckets": buckets}, f, indent=1,
                          default=float)
            os.replace(tmp, path)
            _BUCKET_GAUGE.set(len(buckets), scope="disk")
            with self._lock:
                self._disk_count_cache = (
                    path, os.stat(path).st_mtime_ns, len(buckets))
        except OSError as exc:
            logger.warning("shape registry %s not updated: %s", path,
                           str(exc))

    def disk_buckets(self, dir: Optional[str] = None
                     ) -> Dict[str, Dict[str, Any]]:
        """The shape registry of the given (or enabled) cache directory;
        empty when none is enabled.  Mtime-cached: the capacity
        controller reads it at every autotuned run entry (callers treat
        the result as read-only)."""
        path = registry_path(dir)
        if not path:
            return {}
        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            return {}
        with self._lock:
            cached = self._disk_buckets_cache
        if cached and cached[0] == path and cached[1] == mtime:
            return cached[2]
        buckets = self._load_disk(path)
        with self._lock:
            self._disk_buckets_cache = (path, mtime, buckets)
        return buckets

    def _disk_count(self, cdir: str) -> int:
        path = registry_path(cdir)
        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            return 0
        with self._lock:
            cached = self._disk_count_cache
        if cached and cached[0] == path and cached[1] == mtime:
            return cached[2]
        n = len(self._load_disk(path))
        with self._lock:
            self._disk_count_cache = (path, mtime, n)
        return n

    # -- accounting --------------------------------------------------------

    def observe(self, program: str, outcome: str,
                stages: Optional[Dict[str, float]] = None, *,
                bucket: Optional[str] = None, avals: Sequence[Any] = (),
                extra: Sequence[Any] = (),
                mesh: Optional[Dict[str, Any]] = None,
                replay: Optional[Dict[str, Any]] = None,
                sizing: Optional[Dict[str, Any]] = None,
                tier: Optional[int] = None, persist: bool = False) -> str:
        """Count one acquisition of *program* with *outcome* and its
        seconds by stage; update its in-process record (bucket *bucket*,
        default: the program's own), and with *persist* the enabled
        cache's registry.  Returns the bucket id."""
        stages = dict(stages or {})
        _COMPILES.inc(program=program, outcome=outcome)
        if outcome == "compiled" and _cache.disabled():
            _CACHE_DISABLED.inc(program=program)
        bucket = bucket or bucket_id(program, avals, extra, mesh)
        if outcome == "cached":
            with self._lock:
                rec = self._records.get(bucket)
                if rec is not None:
                    rec["count"] += 1
                    rec["outcomes"]["cached"] = (
                        rec["outcomes"].get("cached", 0) + 1)
            return bucket
        for stage, secs in stages.items():
            _COMPILE_SECONDS.observe(secs, program=program, stage=stage)
        record: Dict[str, Any] = {
            "program": program,
            "avals": [_aval_doc(a) for a in avals],
            "mesh": mesh or {},
            "extra": [str(x) for x in extra],
            "compile_s": round(sum(stages.values()), 4),
            "lowering_s": 0.0,
            "memory": analytic_program_memory(list(avals)),
            "torch": _torch_version(),
            "count": 1,
            "outcomes": {outcome: 1},
        }
        if tier is not None:
            record["tier"] = int(tier)
        if replay is not None:
            record["replay"] = replay
        if sizing is not None:
            record["sizing"] = sizing
        with self._lock:
            prev = self._records.get(bucket)
            if prev is not None:
                record["count"] = prev["count"] + 1
                outs = dict(prev["outcomes"])
                outs[outcome] = outs.get(outcome, 0) + 1
                record["outcomes"] = outs
            self._records[bucket] = record
            n_mem = len(self._records)
        _BUCKET_GAUGE.set(n_mem, scope="memory")
        cdir = cache_dir()
        if persist and cdir:
            self._persist(registry_path(cdir), bucket, record)
        return bucket

    def acquire(self, program: str, build: Callable[[], Any], *,
                key: Any = None, avals: Sequence[Any] = (),
                extra: Sequence[Any] = (),
                mesh: Optional[Dict[str, Any]] = None,
                replay: Optional[Dict[str, Any]] = None,
                sizing: Optional[Dict[str, Any]] = None,
                tier: Optional[int] = None,
                stage: str = "build",
                registry: Optional[Dict[str, Any]] = None,
                persist: bool = True) -> Tuple[Any, str, str]:
        """Acquire *program*: run *build* under a ``compile`` span and
        account for it.  With a *key* (everything the program depends
        on), a second acquisition of the key in this process is
        ``cached`` and builds nothing (returns None); otherwise the
        outcome is ``persistent_hit`` when the bucket is in *registry*
        (default: the enabled cache's shape registry on disk; pass
        ``{}`` for a program that is this process's own, such as a
        CUDA-graph capture), else ``compiled``.  With *persist* the
        bucket is written to the enabled cache's registry now (see
        :meth:`persist`); without it the caller persists it later, or
        never.  Returns ``(build's result, outcome, bucket id)``."""
        if key is not None:
            with self._lock:
                hit = (program, key) in self._keys
        else:
            hit = False
        bucket = bucket_id(program, avals, extra, mesh)
        if hit:
            self.observe(program, "cached", bucket=bucket)
            if persist:
                self.persist(bucket, "cached")
            return None, "cached", bucket
        if registry is None:
            cdir = cache_dir()
            registry = self.disk_buckets(cdir) if cdir else {}
        outcome = "persistent_hit" if bucket in registry else "compiled"
        t0 = time.monotonic()
        with self._tracer.span("compile", program=program) as sp:
            out = build()
            secs = time.monotonic() - t0
            sp.args.update(outcome=outcome, seconds=round(secs, 4))
        if key is not None:
            with self._lock:
                self._keys.add((program, key))
        self.observe(program, outcome, {stage: secs}, bucket=bucket,
                     avals=avals, extra=extra, mesh=mesh, replay=replay,
                     sizing=sizing,
                     tier=tier, persist=persist)
        return out, outcome, bucket

    def persist(self, bucket: str, outcome: str) -> None:
        """Write *bucket*'s in-process record to the enabled cache's
        registry after an acquisition with *outcome*: always after a
        build or a load, after a ``cached`` one only when the registry
        lacks the bucket (acquired before this cache was enabled: the
        registry still learns that it ran here)."""
        cdir = cache_dir()
        if not cdir or (outcome == "cached"
                        and bucket in self.disk_buckets(cdir)):
            return
        with self._lock:
            rec = dict(self._records.get(bucket) or {})
        if rec:
            self._persist(registry_path(cdir), bucket, rec)

    # -- snapshots ---------------------------------------------------------

    def buckets(self) -> List[Dict[str, Any]]:
        """The in-process ledger's buckets (id + record), for the
        profile bundle's ``compile_ledger.json``."""
        with self._lock:
            return [dict(rec, bucket=b) for b, rec in self._records.items()]

    def snapshot(self) -> Dict[str, Any]:
        """Per-program acquisition counts, outcomes and seconds, and where
        the persistent artifacts live (the JAX snapshot's keys)."""
        with self._lock:
            records = [dict(r) for r in self._records.values()]
        programs: Dict[str, Dict[str, Any]] = {}
        for rec in records:
            p = programs.setdefault(rec["program"], {
                "buckets": 0, "compiled": 0, "cached": 0,
                "persistent_hit": 0, "compile_s": 0.0,
                "last_compile_s": 0.0})
            p["buckets"] += 1
            outs = rec.get("outcomes") or {}
            for o in ("compiled", "cached", "persistent_hit"):
                p[o] += int(outs.get(o, 0))
            secs = float(rec.get("compile_s", 0.0)) \
                + float(rec.get("lowering_s", 0.0))
            p["compile_s"] = round(p["compile_s"] + secs, 4)
            p["last_compile_s"] = round(secs, 4)
        out: Dict[str, Any] = {}
        if programs:
            out["programs"] = programs
            out["buckets"] = len(records)
            out["total_compile_s"] = round(
                sum(p["compile_s"] for p in programs.values()), 4)
        cdir = cache_dir()
        if cdir:
            out["cache_dir"] = cdir
            out["registry_path"] = registry_path(cdir)
            out["disk_buckets"] = self._disk_count(cdir)
        return out

    def reset(self) -> None:
        """Tests only: forget keys and records (disk untouched)."""
        with self._lock:
            self._keys.clear()
            self._records.clear()


#: the process-global ledger
LEDGER = CompileLedger()


def validate_compile_ledger(doc: Any) -> None:
    """Strict structural check of a bundle's ``compile_ledger.json`` (the
    JAX package's rules): every bucket names its program and carries
    numeric seconds, its avals and a memory footprint."""
    if not isinstance(doc, dict) or doc.get("kind") != \
            "mrtpu-compile-ledger":
        raise ValueError("compile ledger: not a mrtpu-compile-ledger "
                         "document")
    buckets = doc.get("buckets")
    if not isinstance(buckets, list):
        raise ValueError("compile ledger: buckets is not a list")
    for i, b in enumerate(buckets):
        if not isinstance(b, dict):
            raise ValueError(f"compile ledger bucket {i}: not an object")
        if not b.get("program"):
            raise ValueError(f"compile ledger bucket {i}: no program")
        for field in ("compile_s", "lowering_s"):
            if not isinstance(b.get(field), (int, float)):
                raise ValueError(f"compile ledger bucket {i}: bad {field} "
                                 f"{b.get(field)!r}")
        if not isinstance(b.get("avals"), list):
            raise ValueError(f"compile ledger bucket {i}: no avals")
        if not isinstance(b.get("memory"), dict):
            raise ValueError(
                f"compile ledger bucket {i}: no memory footprint")
