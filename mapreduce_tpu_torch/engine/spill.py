"""Session spill and restore (port of ``mapreduce_tpu/engine/spill.py``):
a resident stream's accumulator made durable.

A stream of an :class:`~.session.EngineSession` can be **evicted**
(spilled through :mod:`..models.checkpoint` and dropped from device
memory) and **restored lazily** on its next feed or snapshot, on the
same partition count or another:

* **Same count**: the saved ``[P, C, ...]`` lanes go back to the device
  as they were, bit for bit.
* **Another count**: a record's partition is ``key_hi % P`` (the
  exchange's own function), computable on the host from the saved key
  lanes, so :func:`repartition_rows` re-bins every valid row and sorts
  each partition by key: the accumulator an uninterrupted run on the
  new count would hold.  The traffic lane is history under the old
  routing and restarts at zero.

The files are the JAX package's: a spill either package writes restores
in the other.  A session over a process group spills the lanes it
gathered from every rank as rank 0's one-process save, and each rank
restores its own partitions' rows of the manifest rank 0 picks, so a
group's spill restores in one process (and the reverse).  Key lanes are
int32 bit patterns on the device and ``uint32`` in the files (the JAX
dtype); the conversion happens here and in the session, and
:func:`repartition_rows` works on ``uint32`` keys as the JAX function
does.  The spill metrics are the JAX package's (the session counts
spills, restores and their seconds; the shard bytes and
restore outcomes ride the checkpoint metrics).
"""

from __future__ import annotations

import re
import urllib.parse
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import checkpoint as _ckpt
from ..obs import metrics as _metrics

#: lane names, in the accumulator's positional order (traffic only
#: with EngineConfig.exchange_stats)
LANES = ("keys", "vals", "pay", "valid", "traffic")

_SPILLS = _metrics.counter(
    "mrtpu_session_spills_total",
    "session streams checkpointed to the blob plane (labels: task, "
    "reason=explicit|idle|pressure|resident_cap|migration)")
_RESTORES = _metrics.counter(
    "mrtpu_session_restores_total",
    "session stream restores from spilled checkpoints (labels: task, "
    "outcome=ok|resharded: resharded restores re-binned the rows "
    "onto another partition count)")
_SPILL_SECONDS = _metrics.counter(
    "mrtpu_session_spill_seconds_total",
    "wall seconds in session spill/restore (labels: stage=spill|"
    "restore, task)")
_RESIDENT = _metrics.gauge(
    "mrtpu_session_resident_streams",
    "streams holding a resident accumulator in a live session (labels: "
    "task=- whole-session count); spill payload bytes ride the shared "
    "mrtpu_ckpt_bytes_total counter")

#: the mesh axis name the JAX package records in a spilled leaf's spec
AXIS = "data"


class SessionRestoreError(RuntimeError):
    """A spilled stream cannot be restored into this session: another
    config or row shape, or a partition of the target count would
    overflow ``out_capacity``."""


def _leaf_spec(name: str, arr: np.ndarray) -> list:
    """The spec the JAX spill records: ``P(AXIS)`` for a lane, ``P()``
    (replicated) for a scalar or a one-element leaf."""
    return [] if arr.ndim == 0 or arr.size == 1 else [AXIS]


def lanes_to_host(acc: Sequence[torch.Tensor]) -> Dict[str, np.ndarray]:
    """An accumulator's lanes as host arrays by :data:`LANES` name, key
    lanes as ``uint32``.  ``.cpu()`` waits for the work queued on the
    caller's current stream."""
    out = {}
    for name, t in zip(LANES, acc):
        arr = t.cpu().numpy()
        out[name] = arr.view(np.uint32) if name == "keys" else arr
    return out


def lanes_to_device(lanes: Dict[str, np.ndarray], names: Sequence[str],
                    device: torch.device) -> List[torch.Tensor]:
    """Host lanes back on *device* in the order of *names*, key lanes as
    int32 bit patterns."""
    out = []
    for name in names:
        arr = np.ascontiguousarray(lanes[name])
        if name == "keys":
            arr = arr.view(np.int32)
        out.append(torch.from_numpy(arr).to(device))
    return out


class SessionSpillStore:
    """Per-task checkpoint streams on one storage prefix.

    Layout: ``<prefix><quoted task>/ckpt-XXXXXXXX/...``, one
    :class:`~..models.checkpoint.CheckpointManager` stream a task; the
    step is the stream's feed count at spill time."""

    def __init__(self, storage, prefix: str = "sessions/",
                 keep_n: int = 2) -> None:
        self.storage = storage
        self.prefix = prefix
        self.keep_n = max(1, int(keep_n))

    def _task_prefix(self, task: str) -> str:
        return (self.prefix
                + urllib.parse.quote(str(task), safe="") + "/")

    def manager(self, task: str) -> _ckpt.CheckpointManager:
        return _ckpt.CheckpointManager(self.storage,
                                       prefix=self._task_prefix(task),
                                       keep_n=self.keep_n)

    def has(self, task: str) -> bool:
        return bool(_ckpt.list_steps(self.storage,
                                     self._task_prefix(task)))

    def tasks(self) -> List[str]:
        """Every task with spilled history under this prefix."""
        rx = re.compile(f"^{re.escape(self.prefix)}([^/]+)/")
        seen = set()
        for name in self.storage.list(rx.pattern):
            m = rx.match(name)
            if m:
                seen.add(urllib.parse.unquote(m.group(1)))
        return sorted(seen)

    def drop(self, task: str) -> None:
        """Forget a task's spilled history."""
        names = self.storage.list(
            f"^{re.escape(self._task_prefix(task))}")
        if names:
            self.storage.remove_many(names)

    def save_stream(self, task: str, lanes: Dict[str, np.ndarray],
                    meta: Dict[str, Any], group=None) -> int:
        """Checkpoint one stream's host lanes (:func:`lanes_to_host`)
        and return the committed step: shards first, the manifest last,
        so a kill mid-spill leaves the previous spill authoritative.
        With *group* (every rank holding the same all-P lanes), rank 0
        writes them and the other ranks return after its commit: the
        files of a one-process spill."""
        step = int(meta.get("feeds", 0))
        self.manager(task).save(step, lanes, spec=_leaf_spec,
                                meta=dict(meta), group=group)
        return step

    def _load_step(self, prefix: str, step: int,
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        manifest = _ckpt.load_manifest(self.storage, prefix, step)
        lanes = {name: _ckpt.assemble_leaf(self.storage, name, entry)
                 for name, entry in manifest["leaves"].items()}
        return lanes, dict(manifest.get("meta") or {})

    def load_stream(self, task: str, group=None,
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """The newest complete spill as host lanes (keys ``uint32``) and
        its meta, falling back past corrupt steps.  Raises
        :class:`SessionRestoreError` when none survives.  With *group*,
        rank 0 picks the step and every other rank reads that same
        manifest (each rank then keeps its own partitions' rows)."""
        prefix = self._task_prefix(task)
        if group is not None:
            return _ckpt.newest_on_rank0(
                group, lambda: self._newest(task, prefix),
                lambda step: self._load_step(prefix, step))
        return self._newest(task, prefix)[1]

    def _newest(self, task: str, prefix: str):
        """``(step, (lanes, meta))`` of the newest complete spill."""
        steps = _ckpt.list_steps(self.storage, prefix)
        skipped = 0
        for step in reversed(steps):
            try:
                got = self._load_step(prefix, step)
            except _ckpt.CheckpointCorruptError:
                _ckpt.note_restore("corrupt")
                skipped += 1
                continue
            _ckpt.note_restore("ok", step=step, fell_past=skipped)
            return step, got
        raise SessionRestoreError(
            f"stream {task!r}: no complete spilled checkpoint under "
            f"{prefix!r} ({len(steps)} candidates, all corrupt)"
            if steps else
            f"stream {task!r}: nothing spilled under {prefix!r}")


def repartition_rows(lanes: Dict[str, np.ndarray], n_dev_new: int,
                     out_capacity: int, task: str = "-",
                     pmap: Optional[np.ndarray] = None,
                     ) -> Dict[str, np.ndarray]:
    """Re-bin a saved ``[P_old, C, ...]`` accumulator (``uint32`` keys)
    onto *n_dev_new* partitions, as the JAX function does bit for bit:
    destination ``key_hi % P``, or with *pmap* ``pmap[key_hi % B]``;
    rows of a partition sorted by ``(key_hi, key_lo)``, the layout an
    uninterrupted run under the same routing keeps.  A partition that
    would overflow *out_capacity* raises :class:`SessionRestoreError`."""
    keys, vals, pay, valid = (lanes["keys"], lanes["vals"],
                              lanes["pay"], lanes["valid"])

    def flat(a: np.ndarray) -> np.ndarray:
        return a.reshape((-1,) + a.shape[2:])

    mask = flat(valid).astype(bool)
    k = flat(keys)[mask]
    v = flat(vals)[mask]
    p = flat(pay)[mask]
    if pmap is not None:
        pmap = np.asarray(pmap, dtype=np.int32).reshape(-1)
        bucket = (k[:, 0].astype(np.uint64)
                  % np.uint64(pmap.shape[0])).astype(np.int64)
        dest = pmap[bucket].astype(np.uint64)
    else:
        dest = k[:, 0].astype(np.uint64) % np.uint64(n_dev_new)
    out = {
        "keys": np.zeros((n_dev_new, out_capacity) + keys.shape[2:],
                         keys.dtype),
        "vals": np.zeros((n_dev_new, out_capacity) + vals.shape[2:],
                         vals.dtype),
        "pay": np.zeros((n_dev_new, out_capacity) + pay.shape[2:],
                        pay.dtype),
        "valid": np.zeros((n_dev_new, out_capacity), valid.dtype),
    }
    for d in range(n_dev_new):
        rows = np.nonzero(dest == d)[0]
        if rows.size > out_capacity:
            raise SessionRestoreError(
                # the JAX package's words: a refused rebalance records
                # this message in the control ledger
                f"stream {task!r}: partition {d} of the target mesh "
                f"holds {rows.size} unique rows > out_capacity "
                f"{out_capacity} — raise EngineConfig.out_capacity to "
                "restore on this mesh")
        rows = rows[np.lexsort((k[rows, 1], k[rows, 0]))]
        out["keys"][d, :rows.size] = k[rows]
        out["vals"][d, :rows.size] = v[rows]
        out["pay"][d, :rows.size] = p[rows]
        out["valid"][d, :rows.size] = True
    return out


class SpillPolicy:
    """When to evict a resident stream (applied at feed epilogues,
    :meth:`~.session.EngineSession.enforce_spill_policy`):

    * ``max_idle_s`` — a stream with no feed or snapshot for this long
      spills;
    * ``max_resident`` — a cap on resident streams a session; beyond it
      the least recently active spill first;
    * ``hbm_frac`` — when the tensors allocated on the card take this
      fraction of its memory, the coldest stream spills (never on the
      CPU, as the JAX package's clause never fires there).
    """

    def __init__(self, max_idle_s: Optional[float] = None,
                 max_resident: Optional[int] = None,
                 hbm_frac: Optional[float] = None) -> None:
        self.max_idle_s = max_idle_s
        self.max_resident = max_resident
        self.hbm_frac = hbm_frac

    def hbm_pressed(self, device: torch.device) -> bool:
        """``torch.cuda.memory_allocated`` against the total from
        ``torch.cuda.mem_get_info``: live bytes, as the JAX package's
        ``bytes_in_use``, not the allocator's cached reserve."""
        if self.hbm_frac is None or device.type != "cuda":
            return False
        _free, total = torch.cuda.mem_get_info(device)
        return torch.cuda.memory_allocated(device) >= self.hbm_frac * total

    def victims(self, ages: Dict[str, float], hbm_pressed: bool,
                ) -> List[str]:
        """Tasks to evict given per-task idle ages (seconds), coldest
        first within each clause."""
        coldest = sorted(ages, key=lambda t: -ages[t])
        out: List[str] = []
        if self.max_idle_s is not None:
            out.extend(t for t in coldest if ages[t] > self.max_idle_s)
        if (self.max_resident is not None
                and len(ages) - len(out) > self.max_resident):
            for t in coldest:
                if len(ages) - len(out) <= self.max_resident:
                    break
                if t not in out:
                    out.append(t)
        if hbm_pressed and not out and coldest:
            out.append(coldest[0])
        return out
