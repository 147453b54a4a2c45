"""Manifest-committed checkpoints on the blob storage planes (port of
``mapreduce_tpu/models/checkpoint.py``), in the JAX package's format:
a checkpoint written by either package restores in the other.

Layout (one checkpoint = one directory-shaped blob prefix)::

    <prefix>ckpt-00000012/<quoted leaf name>.<shard>.npy   # np.save bytes
    <prefix>ckpt-00000012/MANIFEST.json                    # written LAST
    <prefix>BEST                                           # best-step tag

* **Shards, then the manifest.**  The manifest names every leaf's
  shape, dtype, ``spec`` and shards, each shard with its global
  ``index`` ranges, ``nbytes`` and ``sha256``.  It is written last and
  is the commit: a checkpoint without a parseable manifest does not
  exist, so a kill mid-save leaves the previous one authoritative.
* **One shard a leaf here.**  The JAX package writes a leaf as its
  device shards; the port holds a leaf in one tensor and writes it as
  one shard covering the whole array.  :func:`assemble_leaf` reads
  either form.
* **Verified reads.**  Every shard is checked against its size and
  digest; a bad or missing shard fails that checkpoint with
  :class:`CheckpointCorruptError`, and :func:`restore_latest` falls
  back to the previous complete one.
* **Retention.**  :class:`CheckpointManager` keeps the newest ``keep_n``
  plus the step marked best.

A tree is a flat ``{name: array}`` dict (numpy arrays or tensors; a
tensor is copied to the host).  The JAX package's placement rules are
not needed here: *spec* is written into the manifest for operators, and
a restore ignores it.  The metrics are the JAX package's
(``mrtpu_ckpt_*``: saves, restores by outcome, corrupt shards,
fallbacks, gc by reason, shard bytes, the last step); a port shard is
one a leaf, so its byte counts differ from a JAX checkpoint's of the
same state by the npy headers of the JAX package's extra shards.
"""

from __future__ import annotations

import hashlib
import io
import json
import re
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..obs import metrics as _metrics
from ..storage.base import Storage

MANIFEST = "MANIFEST.json"
BEST_TAG = "BEST"
FORMAT = 1

_SAVES = _metrics.counter(
    "mrtpu_ckpt_saves_total",
    "sharded checkpoints committed (manifest written)")
_RESTORES = _metrics.counter(
    "mrtpu_ckpt_restores_total",
    "checkpoint restore attempts (labels: outcome=ok|corrupt)")
_CORRUPT_SHARDS = _metrics.counter(
    "mrtpu_ckpt_corrupt_shards_total",
    "shards that failed digest/size/decode validation on restore")
_FALLBACKS = _metrics.counter(
    "mrtpu_ckpt_fallbacks_total",
    "restores that fell back past a bad/incomplete checkpoint to an "
    "older complete one")
_GC = _metrics.counter(
    "mrtpu_ckpt_gc_total",
    "checkpoint data removed by gc (labels: reason=retention for "
    "whole checkpoints beyond keep-N, reason=orphan for manifestless "
    "shard dirs left by aborted commits)")
_BYTES = _metrics.counter(
    "mrtpu_ckpt_bytes_total",
    "checkpoint shard payload bytes (labels: direction=save|restore)")
_LAST_STEP = _metrics.gauge(
    "mrtpu_ckpt_last_step",
    "step of the newest committed checkpoint this process wrote or "
    "restored (labels: op=save|restore)")


class CheckpointError(ValueError):
    """Typed checkpoint failure: missing or mismatched leaves, no
    complete checkpoint, an unusable manifest."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint's payload failed validation (a truncated, garbled or
    missing shard, a digest mismatch, an unparseable manifest): restore
    falls back to the previous complete checkpoint."""


# --- naming -----------------------------------------------------------------


def checkpoint_dir(prefix: str, step: int) -> str:
    return f"{prefix}ckpt-{int(step):08d}"


def manifest_name(prefix: str, step: int) -> str:
    return f"{checkpoint_dir(prefix, step)}/{MANIFEST}"


def _shard_blob(dirname: str, leaf: str, j: int) -> str:
    return f"{dirname}/{urllib.parse.quote(leaf, safe='')}.{j}.npy"


def list_steps(storage: Storage, prefix: str = "") -> List[int]:
    """Steps with a manifest present under *prefix*, ascending (presence
    is the commit; parseability is checked at restore)."""
    rx = (f"^{re.escape(prefix)}ckpt-(\\d{{8}})/"
          f"{re.escape(MANIFEST)}$")
    steps = []
    for name in storage.list(rx):
        m = re.search(rx, name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(set(steps))


# --- save -------------------------------------------------------------------


def _host(leaf: Any) -> np.ndarray:
    """A leaf as a host array (a tensor is copied off its device)."""
    if hasattr(leaf, "detach"):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    # order="C", not ascontiguousarray, which makes a 0-d array 1-d
    np.save(buf, np.asarray(arr, order="C"), allow_pickle=False)
    return buf.getvalue()


#: a leaf's name and host array -> the ``spec`` entry its manifest holds
SpecFn = Callable[[str, np.ndarray], Optional[list]]


def save(storage: Storage, step: int, tree: Dict[str, Any],
         spec: Optional[SpecFn] = None, prefix: str = "",
         meta: Optional[Dict[str, Any]] = None,
         precommit: Optional[Callable[[], None]] = None) -> str:
    """Write one checkpoint of the flat *tree* and return its manifest's
    blob name: each leaf as one full-extent shard, then the manifest.

    *spec* (when given) maps ``(name, array)`` to the ``spec`` entry the
    manifest records for the leaf (the JAX spelling: a list of axis
    names, ``[]`` replicated); without it the entry is null.

    *precommit* (when given) is called immediately before the manifest
    is published, after the shard writes, and aborts the commit by
    raising: the fenced trainer passes its lease gate here."""
    dirname = checkpoint_dir(prefix, step)
    leaves = {}
    for name in sorted(tree):
        arr = _host(tree[name])
        data = _npy_bytes(arr)
        blob = _shard_blob(dirname, name, 0)
        storage.write_bytes(blob, data)
        _BYTES.inc(len(data), direction="save")
        leaves[name] = {
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "spec": None if spec is None else spec(name, arr),
            "shards": [{
                "blob": blob,
                "index": [[0, int(d)] for d in arr.shape],
                "nbytes": len(data),
                "sha256": hashlib.sha256(data).hexdigest(),
            }],
        }
    doc = {"format": FORMAT, "step": int(step), "meta": meta or {},
           "leaves": leaves}
    mname = manifest_name(prefix, step)
    if precommit is not None:
        precommit()  # the last abort point before the checkpoint exists
    storage.write(mname, json.dumps(doc, sort_keys=True))  # the commit
    _SAVES.inc()
    _LAST_STEP.set(int(step), op="save")
    return mname


# --- restore ----------------------------------------------------------------


def load_manifest(storage: Storage, prefix: str, step: int,
                  ) -> Dict[str, Any]:
    """Read and structurally check one manifest; a missing, unparseable
    or malformed one raises :class:`CheckpointCorruptError`."""
    mname = manifest_name(prefix, step)
    try:
        doc = json.loads(storage.read(mname))
    except (FileNotFoundError, KeyError) as exc:
        raise CheckpointCorruptError(
            f"checkpoint step {step}: manifest missing ({exc})") from exc
    except (json.JSONDecodeError, UnicodeDecodeError) as exc:
        raise CheckpointCorruptError(
            f"checkpoint step {step}: manifest unparseable "
            f"({exc})") from exc
    if (not isinstance(doc, dict) or doc.get("format") != FORMAT
            or doc.get("step") != int(step)
            or not isinstance(doc.get("meta"), dict)
            or not isinstance(doc.get("leaves"), dict)):
        raise CheckpointCorruptError(
            f"checkpoint step {step}: manifest malformed")
    name = "?"
    try:
        for name, entry in doc["leaves"].items():
            shape = tuple(int(d) for d in entry["shape"])
            np.dtype(entry["dtype"])
            for sh in entry["shards"]:
                if not isinstance(sh["blob"], str):
                    raise TypeError(f"blob {sh['blob']!r}")
                str(sh["sha256"])
                int(sh["nbytes"])
                idx = [(int(a), int(b)) for a, b in sh["index"]]
                if len(idx) != len(shape) or any(
                        not 0 <= a <= b <= d
                        for (a, b), d in zip(idx, shape)):
                    raise ValueError(
                        f"shard index {idx} outside shape {shape}")
    except (KeyError, TypeError, ValueError) as exc:
        raise CheckpointCorruptError(
            f"checkpoint step {step}: manifest structurally invalid "
            f"(leaf {name!r}: {exc!r})") from exc
    return doc


def _read_shard(storage: Storage, name: str,
                sh: Dict[str, Any]) -> Tuple[np.ndarray, int]:
    """Fetch, verify and decode one shard: ``(array, nbytes)``; any
    failure is :class:`CheckpointCorruptError`."""
    try:
        data = storage.read_bytes(sh["blob"])
    except (FileNotFoundError, KeyError) as exc:
        _CORRUPT_SHARDS.inc()
        raise CheckpointCorruptError(
            f"leaf {name!r}: shard {sh['blob']!r} missing") from exc
    if (len(data) != sh["nbytes"]
            or hashlib.sha256(data).hexdigest() != sh["sha256"]):
        _CORRUPT_SHARDS.inc()
        raise CheckpointCorruptError(
            f"leaf {name!r}: shard {sh['blob']!r} failed digest/size "
            f"validation ({len(data)} bytes)")
    try:
        return np.load(io.BytesIO(data), allow_pickle=False), len(data)
    except ValueError as exc:
        _CORRUPT_SHARDS.inc()
        raise CheckpointCorruptError(
            f"leaf {name!r}: shard {sh['blob']!r} undecodable "
            f"({exc})") from exc


def assemble_leaf(storage: Storage, name: str,
                  entry: Dict[str, Any]) -> np.ndarray:
    """Read, verify and place every shard of one leaf into its global
    array (one shard from the port, one per device from the JAX
    package)."""
    shape = tuple(int(d) for d in entry["shape"])
    dtype = np.dtype(entry["dtype"])
    out = np.empty(shape, dtype)
    covered = 0
    for sh in entry["shards"]:
        arr, nbytes = _read_shard(storage, name, sh)
        idx = tuple(slice(int(a), int(b)) for a, b in sh["index"])
        extent = tuple(int(b) - int(a) for a, b in sh["index"])
        if arr.shape != extent or arr.dtype != dtype:
            _CORRUPT_SHARDS.inc()
            raise CheckpointCorruptError(
                f"leaf {name!r}: shard {sh['blob']!r} is "
                f"{arr.shape}/{arr.dtype}, manifest says "
                f"{extent}/{dtype}")
        out[idx] = arr
        covered += int(np.prod(extent)) if extent else 1
        _BYTES.inc(nbytes, direction="restore")
    total = int(np.prod(shape)) if shape else 1
    if covered != total:
        raise CheckpointCorruptError(
            f"leaf {name!r}: shards cover {covered} of {total} elements")
    return out


def note_restore(outcome: str, step: Optional[int] = None,
                 fell_past: int = 0) -> None:
    """Metric hook of restore flows built on :func:`assemble_leaf` (the
    spill store's, the transformer's): count one restore attempt.  With
    ``ok``, *step* records the restored step and *fell_past* how many
    corrupt candidates the restore skipped (fallbacks count only when
    something was fallen back TO)."""
    _RESTORES.inc(outcome=outcome)
    if outcome == "ok":
        if fell_past:
            _FALLBACKS.inc(fell_past)
        if step is not None:
            _LAST_STEP.set(int(step), op="restore")


def validate_manifest_against(manifest: Dict[str, Any],
                              template: Dict[str, Any]) -> None:
    """Every leaf of *template* (``{name: array}``) present in the
    manifest with its shape and dtype, and no other: the check a restore
    makes before it reads any payload."""
    want = {name: (tuple(np.shape(leaf)), np.dtype(leaf.dtype))
            for name, leaf in ((n, _host(v)) for n, v in template.items())}
    got = manifest["leaves"]
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise CheckpointError(
            "checkpoint state does not match: "
            + (f"missing leaves {missing}" if missing else "")
            + (" " if missing and extra else "")
            + (f"unexpected leaves {extra}" if extra else ""))
    bad = [f"{name} {tuple(got[name]['shape'])}/{got[name]['dtype']} vs "
           f"{shape}/{dtype}" for name, (shape, dtype) in want.items()
           if (tuple(int(d) for d in got[name]["shape"]) != shape
               or np.dtype(got[name]["dtype"]) != dtype)]
    if bad:
        raise CheckpointError(
            "checkpoint state does not match (shape/dtype): "
            + ", ".join(bad))


def restore(storage: Storage, step: int, prefix: str = "",
            template: Optional[Dict[str, Any]] = None,
            ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Read one checkpoint: ``({name: host array}, manifest)``.  With
    *template*, the leaves are checked against it first."""
    manifest = load_manifest(storage, prefix, step)
    if template is not None:
        validate_manifest_against(manifest, template)
    leaves = {name: assemble_leaf(storage, name, entry)
              for name, entry in manifest["leaves"].items()}
    _RESTORES.inc(outcome="ok")
    _LAST_STEP.set(int(manifest["step"]), op="restore")
    return leaves, manifest


def newest_on_rank0(group, newest: Callable[[], Optional[Tuple[int, Any]]],
                    read: Callable[[int], Any]) -> Any:
    """One step for every rank of *group*: rank 0 runs ``newest()``,
    ``(step, value)`` of its newest complete step or None, and every
    other rank returns ``read(step)`` of the step rank 0 picked (None
    when it found none), or raises what rank 0 raised."""
    from ..parallel.mesh import on_rank0

    picked: list = []

    def pick() -> Optional[int]:
        picked.append(newest())
        return None if picked[0] is None else picked[0][0]

    step = on_rank0(group, pick)
    if picked:
        return None if picked[0] is None else picked[0][1]
    return None if step is None else read(step)


def restore_latest(storage: Storage, prefix: str = "",
                   template: Optional[Dict[str, Any]] = None,
                   group=None,
                   ) -> Optional[Tuple[Dict[str, np.ndarray],
                                       Dict[str, Any]]]:
    """The newest complete checkpoint, falling back past corrupt ones;
    None when none exists.  A template mismatch (a
    :class:`CheckpointError` that is not corruption) does not fall back:
    an older checkpoint cannot fix a wrong template.

    With *group*, rank 0 picks the step and every other rank reads that
    same manifest, so all ranks restore one checkpoint."""
    if group is not None:
        def newest():
            got = restore_latest(storage, prefix, template)
            return None if got is None else (int(got[1]["step"]), got)

        return newest_on_rank0(group, newest, lambda step: restore(
            storage, step, prefix=prefix, template=template))
    steps = list_steps(storage, prefix)
    skipped = 0
    for step in reversed(steps):
        try:
            out = restore(storage, step, prefix=prefix, template=template)
        except CheckpointCorruptError:
            note_restore("corrupt")
            skipped += 1
            continue
        if skipped:
            # counted only now: a fallback is falling back TO something
            _FALLBACKS.inc(skipped)
        return out
    if steps:
        raise CheckpointError(
            f"no complete checkpoint under {prefix!r}: all "
            f"{len(steps)} candidates failed validation")
    return None


# --- retention --------------------------------------------------------------


class CheckpointManager:
    """A retention-managed checkpoint stream on one storage prefix: save
    every step, keep the newest *keep_n* plus the step marked best."""

    def __init__(self, storage: Storage, prefix: str = "",
                 keep_n: int = 3) -> None:
        if keep_n < 1:
            raise ValueError("keep_n must be >= 1")
        self.storage = storage
        self.prefix = prefix
        self.keep_n = keep_n

    def save(self, step: int, tree: Dict[str, Any],
             spec: Optional[SpecFn] = None,
             meta: Optional[Dict[str, Any]] = None,
             precommit: Optional[Callable[[], None]] = None,
             group=None) -> str:
        """:func:`save` one step, then :meth:`gc`.

        With *group* (a ``torch.distributed`` process group whose ranks
        all hold this *tree*, as data parallelism replicates the state,
        or as a session gathers its lanes) rank 0 alone does both
        (retention included), and every rank returns once the manifest
        is committed, or raises what rank 0 raised
        (:func:`..parallel.mesh.on_rank0`): the files are a one-process
        save's.  (The JAX multi-process save writes each process's
        shards and lets the last writer's manifest stand.)"""
        if group is not None:
            from ..parallel.mesh import on_rank0

            return on_rank0(group, lambda: self.save(
                step, tree, spec=spec, meta=meta, precommit=precommit))
        name = save(self.storage, step, tree, spec=spec,
                    prefix=self.prefix, meta=meta, precommit=precommit)
        self.gc()
        return name

    def mark_best(self, step: int) -> None:
        """Tag *step* as best (one atomic publish); retention keeps it."""
        self.storage.write(self.prefix + BEST_TAG, str(int(step)))

    def best_step(self) -> Optional[int]:
        try:
            return int(self.storage.read(self.prefix + BEST_TAG).strip())
        except (FileNotFoundError, KeyError, ValueError):
            return None

    def steps(self) -> List[int]:
        return list_steps(self.storage, self.prefix)

    def gc(self) -> int:
        """Drop checkpoints beyond retention (the manifest first, so the
        checkpoint stops existing at once, then its shards) and return
        how many; also remove shard directories without a manifest below
        the newest committed step (an aborted commit).  Manifestless
        shards above it may be a commit in flight and stay."""
        rx = re.compile(f"^{re.escape(self.prefix)}" + r"ckpt-(\d{8})/")
        by_step: Dict[int, List[str]] = {}
        for name in self.storage.list(rx.pattern):
            m = rx.match(name)
            if m:
                by_step.setdefault(int(m.group(1)), []).append(name)
        steps = sorted(s for s in by_step
                       if manifest_name(self.prefix, s) in by_step[s])
        if not steps:
            return 0
        keep = set(steps[-self.keep_n:])
        best = self.best_step()
        if best is not None:
            keep.add(best)
        removed = 0
        for step in steps:
            if step in keep:
                continue
            mname = manifest_name(self.prefix, step)
            self.storage.remove(mname)
            self.storage.remove_many(
                [n for n in by_step[step] if n != mname])
            removed += 1
            _GC.inc(reason="retention")
        committed = set(steps)
        for s in sorted(by_step):
            if s not in committed and s < steps[-1]:
                self.storage.remove_many(by_step[s])
                _GC.inc(reason="orphan")
        return removed

    def restore_latest(self, template: Optional[Dict[str, Any]] = None,
                       group=None):
        """``({name: host array}, manifest)`` of the newest complete
        step, or None; with *group*, the same step on every rank."""
        return restore_latest(self.storage, prefix=self.prefix,
                              template=template, group=group)
