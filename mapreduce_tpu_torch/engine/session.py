"""Resident engine sessions (port of ``mapreduce_tpu/engine/session.py``):
the batch engine turned into a continuous query.

``DeviceEngine.run`` owns the partitions for one job: it builds an
accumulator, folds every wave, reads the result out, and the aggregate
dies with the call.  An :class:`EngineSession` keeps the accumulator
alive across submissions instead, one per task, so many tenants'
streams multiplex over one device:

  * ``feed(chunks, task=...)`` folds the chunks into that task's
    accumulator through the engine's own wave (``DeviceEngine._wave``:
    the same kernels, the same fold), uploaded by the engine's pinned
    copy-stream feeder;
  * :meth:`EngineSession.snapshot` reads the task's aggregate out
    mid-stream without stopping it; the integer monoids make it
    bit-identical to a batch run over the same records;
  * a stream can be spilled, evicted and restored lazily
    (:mod:`.spill`), and re-routed mid-stream (:meth:`EngineSession.
    rebalance`).

Consistency: feeds, snapshots, spills and rebalances of a session are
serialised by one lock, so a snapshot observes a record-aligned prefix
of the stream: every record of every completed feed, none of a
concurrent one.

Capacity: a stream has no replay (its records are gone once folded),
so a session cannot retry with right-sized capacities as the batch
engine does.  Overflow is counted per stream and raised by default
(:class:`SessionOverflowError`).

Syncs and streams (the differences from the JAX package):

  * The JAX feed reads the overflow back after every wave.  Here a feed
    reads it once, after its last wave: the host queues every wave
    of the feed before it waits.  A failure in any wave, or one the
    device reports at that read, still poisons the stream.
  * The accumulator is written on the caller's current CUDA stream.
    Each write (a feed, a rebalance, a restore) records an event, and
    each later reader or writer makes its own current stream wait on
    it (and, on another stream, records the tensors as used there), so
    a snapshot's readback, a spill's copy to the host, a rebalance and
    the next feed are ordered after the work that wrote the
    accumulator, with no device-wide synchronize.

Control (``autotune=``, an :class:`..autotune.AutoTuner`): the
capacity controller pre-sizes the session at its door (a stream cannot
retry, so learned capacities must land before the first wave), a
stream's first feed is that decision's measurement, and after every
feed the skew controller reads the stream's traffic window and may
rebalance its partition map.  Both run outside the session lock; the
rebalance's reads and writes of the accumulator are ordered after the
feed's waves by the events above.

Over a process group (``Partitions(n, device, group=G)``, gloo) the
session is one controller of a multi-process mesh, as the JAX session
is on a ``jax.distributed`` mesh: every rank feeds the identical chunks
(the SPMD contract of ``DeviceEngine.run`` over a group) and holds only
its ``n_local`` partitions' accumulator.  Every host decision comes from
a value all ranks hold: a feed's overflow is all-reduced (so an
overflow raises on every rank at once), ``snapshot`` and
``bucket_histogram`` gather the lanes (the JAX engine's ``_host``), a
rebalance re-bins the gathered lanes and each rank keeps its own
partitions, a spill is rank 0's write of the gathered lanes (the files
of a one-process spill; the others wait for its commit) and a restore
takes each rank's rows of one manifest, and the spill policy decides
from every rank's ages.  ``stats``, ``traffic_matrix`` and
``partition_map`` read values that are already the same on every rank.
The fleet's hand-off is collective too: every rank calls
``migrate_out`` (rank 0's spill of the gathered lanes is the hand-off,
and every rank marks the stream handed off) and ``adopt``, and
``coldest_task`` picks from every rank's ages.  Tier policies stay
single-process and raise ``NotImplementedError`` over a group.

Telemetry (the JAX session's): the ``mrtpu_session_*`` counters and
gauges below, the device engine's wave and dispatch counters for every
wave a feed folds (no spans, as in JAX), each feed's and snapshot's
latency and each snapshot's staleness in the SLO plane
(:mod:`..obs.slo`), and the stream-age gauges
(:func:`refresh_stream_age_gauges`).
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import metrics as _obs
from ..obs import slo as _slo
from ..ops import kernel_compat as kc
from ..parallel.mesh import Partitions, on_rank0
from ..parallel.shuffle import all_gather_rows
from .autotune import _CAPACITY_FIELDS
from .device_engine import (
    _DISPATCHES, _WAVES, DeviceEngine, DeviceResult, EngineConfig,
    _cfg_token, _is_tiered, _steady_cfg, _WaveFeeder, identity_pmap,
    validate_partition_map)
from .spill import (
    _RESIDENT, _RESTORES, _SPILL_SECONDS, _SPILLS, LANES,
    SessionRestoreError, SessionSpillStore, SpillPolicy, lanes_to_device,
    lanes_to_host, repartition_rows)
from .tiering import TieredWaveDispatcher

_FEEDS = _obs.counter(
    "mrtpu_session_feeds_total",
    "EngineSession.feed calls (labels: task)")
_CHUNKS = _obs.counter(
    "mrtpu_session_chunks_total",
    "input chunks folded into a resident session aggregate "
    "(labels: task)")
_SESSION_WAVES = _obs.counter(
    "mrtpu_session_waves_total",
    "waves the session layer folded (labels: task, tier=0|1|<impl>|-): "
    "device dispatches match this one for one while the session is the "
    "only engine user.  Under a tier policy the tier label attributes "
    "a cold tenant's first waves to tier-0 serving; a non-variadic "
    "steady tier labels as its impl name (e.g. 'radix'); '-' is an "
    "untiered session")
_SNAPSHOTS = _obs.counter(
    "mrtpu_session_snapshots_total",
    "mid-stream consistent reads of a session aggregate (labels: task)")
_SESSION_SECONDS = _obs.counter(
    "mrtpu_session_seconds_total",
    "wall seconds in the session layer (labels: stage=feed|snapshot, "
    "task)")
_LIVE_RECORDS = _obs.gauge(
    "mrtpu_session_records_live",
    "live unique rows in a session's resident accumulator at the last "
    "snapshot (labels: task)")
_OVERFLOWS = _obs.counter(
    "mrtpu_session_overflow_rows_total",
    "rows a session stream dropped for capacity (labels: task); any "
    "nonzero value means that stream's aggregate is truncated")
_BACKPRESSURE = _obs.counter(
    "mrtpu_session_backpressure_total",
    "feeds/snapshots refused with retry-after semantics (labels: "
    "task, reason=feed_queue|migrating): feed_queue, the stream's "
    "bounded pending-feed queue was full; migrating, the stream was "
    "handed off to another host and serves at its new route")
_STREAM_AGE = _obs.gauge(
    "mrtpu_session_stream_age_seconds",
    "seconds since a resident stream's last feed / last snapshot "
    "(labels: task, stamp=feed|snapshot), refreshed whole-family on "
    "every session call: a stalled stream shows even when nobody polls "
    "its snapshots")

#: live sessions, for the whole-family stream-age refresh (weak: a
#: dropped session's streams vanish from the gauge)
_SESSIONS: "weakref.WeakSet[EngineSession]" = weakref.WeakSet()
#: last harvested (task, stamp, monotonic) rows per session: a session
#: whose lock is busy at refresh time contributes its previous stamps
_AGE_STAMPS: "weakref.WeakKeyDictionary[EngineSession, list]" = \
    weakref.WeakKeyDictionary()


def refresh_stream_age_gauges(now: Optional[float] = None) -> None:
    """Swap the whole ``mrtpu_session_stream_age_seconds`` family from
    every live session's stream stamps (called after each session call,
    never while holding a session lock)."""
    now = time.monotonic() if now is None else now
    rows: List[Tuple[Dict[str, str], float]] = []
    for sess in list(_SESSIONS):
        # non-blocking: a session mid-feed holds its lock for the whole
        # wave loop, and another session's epilogue must not wait on
        # it; a busy session's cached stamps stand in
        if sess._lock.acquire(blocking=False):
            try:
                stamps = []
                for task, st in sess._streams.items():
                    if st.last_feed_monotonic is not None:
                        stamps.append((task, "feed",
                                       st.last_feed_monotonic))
                    if st.last_snapshot_monotonic is not None:
                        stamps.append((task, "snapshot",
                                       st.last_snapshot_monotonic))
                _AGE_STAMPS[sess] = stamps
            finally:
                sess._lock.release()
        for task, stamp, t in _AGE_STAMPS.get(sess, []):
            rows.append(({"task": task, "stamp": stamp},
                         round(now - t, 6)))
    _STREAM_AGE.replace(rows)


def _group_max_caps(cfg: EngineConfig, group) -> EngineConfig:
    """*cfg* with each capacity raised to its maximum over *group*'s
    ranks (one all-reduce; *cfg* itself without a group)."""
    if group is None:
        return cfg
    import torch.distributed as dist

    caps = torch.tensor([getattr(cfg, f) for f in _CAPACITY_FIELDS],
                        dtype=torch.int64)
    dist.all_reduce(caps, op=dist.ReduceOp.MAX, group=group)
    return replace(cfg, **dict(zip(_CAPACITY_FIELDS, caps.tolist())))


class SessionOverflowError(RuntimeError):
    """A feed overflowed a static capacity.  A session cannot retry with
    right-sized capacities (streams have no replay), so the stream's
    aggregate is truncated: raise the config's capacities and restart
    the stream, or pass ``on_overflow="count"`` to continue with the
    loss counted."""


class SessionStreamBroken(RuntimeError):
    """An earlier feed on this stream died mid-feed: some of its waves
    were folded, so the aggregate is neither the state before the feed
    nor the one after, and a retried feed would count the folded waves
    twice.  The stream is poisoned: every feed and snapshot raises this
    until ``close(task)`` discards it, or, when it was spilled,
    ``restore(task)`` rolls it back to its last spill (re-feed from the
    spill's ``pos``)."""


class SessionBusyError(RuntimeError):
    """A feed or snapshot refused with retry-after meaning: the task's
    bounded pending-feed queue was full (``max_pending_feeds``), or the
    stream was handed off to another host (:meth:`EngineSession.
    migrate_out`) and is served at its new route.  Never a sign that the
    stream died (that is :class:`SessionStreamBroken`)."""


class _Stream:
    """One task's resident state: its accumulator and counters.  ``pos``
    is the global chunk index, so payload offsets (word count's byte
    positions) stay stream-global across feeds.  ``acc`` is None before
    the first wave, and after a feed died (then ``broken`` is set)."""

    __slots__ = ("acc", "pos", "waves", "feeds", "overflow", "broken",
                 "last_feed_monotonic", "last_snapshot_monotonic",
                 "pmap", "pmap_dev", "rebalances", "written")

    def __init__(self, acc=None) -> None:
        self.acc = acc
        self.pos = 0
        self.waves = 0
        self.feeds = 0
        self.overflow = 0
        self.broken = False
        #: this stream's bucket->partition table (partition_map configs):
        #: per stream, since a rebalance re-bins one tenant's rows
        self.pmap: Optional[np.ndarray] = None
        self.pmap_dev: Optional[torch.Tensor] = None
        self.rebalances = 0
        #: when the newest folded record arrived (its feed completed):
        #: the reference point of a snapshot's staleness
        self.last_feed_monotonic: Optional[float] = None
        self.last_snapshot_monotonic: Optional[float] = None
        #: on CUDA, ``(event, stream)`` of the last write of ``acc``
        self.written = None


class EngineSession:
    """A resident :class:`DeviceEngine` multiplexing task streams over
    the partitions *parts* (``Partitions(n, "cpu")`` runs the plain
    versions; otherwise CUDA, which raises when absent).

    ``map_fn`` and ``config`` follow the engine's contract; *k* (chunks
    per partition per wave) is latched from the first feed when omitted,
    and every later feed of any task waves the same way (a short final
    wave is padded and masked by ``n_real``, as in a batch run).
    *spill* is the store evicted streams go to, *spill_policy* when they
    go, and *max_pending_feeds* (0: unbounded) how many feeds of one task
    may wait for the session lock before the next is refused.
    *autotune* attaches the controllers (module docstring); the session
    stays weak-referenceable, since the skew controller keys its window
    state on it."""

    def __init__(self, parts: Partitions, map_fn: Callable,
                 config: EngineConfig = EngineConfig(),
                 k: Optional[int] = None, task: str = "-",
                 spill: Optional[SessionSpillStore] = None,
                 spill_policy: Optional[SpillPolicy] = None,
                 max_pending_feeds: int = 0, autotune=None) -> None:
        if parts.group is not None and _is_tiered(config.sort_impl):
            raise NotImplementedError(
                f"EngineSession over a process group with the tier policy "
                f"{config.sort_impl!r}: the tier swap is decided by each "
                "process's own background build; pass a concrete "
                "sort_impl over a group")
        #: the process group (None: one process) and this rank's
        #: partitions [lo, lo + n_local)
        self.group = parts.group
        #: the engine's task label is the session default; per-feed
        #: labels ride the streams
        self.engine = DeviceEngine(parts, map_fn, config, task=task)
        if autotune is not None:
            # capacity pre-sizing at the door: sessions cannot retry, so
            # learned capacities must land before the first wave
            # (autotune_key ignores capacities, so the probe engine's
            # key IS the tuned one's); over a group every rank takes the
            # largest capacity any rank learned
            tuned = _group_max_caps(autotune.recommend_config(
                config, self.engine.autotune_key(), task=task), parts.group)
            if tuned != config:
                config = tuned
                self.engine = DeviceEngine(parts, map_fn, config,
                                           task=task)
        #: the observe->act loop (None: no decision is ever recorded)
        self.autotune = autotune
        self.device = self.engine.device
        self.config = config
        self.k = int(k) if k else None
        self.default_task = task
        self._row_shape: Optional[tuple] = None
        self._row_dtype = None
        self._streams: Dict[str, _Stream] = {}
        #: tasks handed off to another host (:meth:`migrate_out`): their
        #: spills belong to the destination, so a lazy restore here
        #: would fork the stream.  Lifted by :meth:`restore`,
        #: :meth:`adopt` or :meth:`close`.
        self._handed_off: set = set()
        self._lock = threading.Lock()
        self.spill = spill
        self.spill_policy = spill_policy
        self.max_pending_feeds = int(max_pending_feeds)
        self._pending: Dict[str, int] = {}
        self._pending_lock = threading.Lock()
        #: one tier dispatcher for the session's life (tier policies):
        #: the swap happens once, between feeds or at a wave boundary
        #: inside one, and every tenant gains from it
        self._dispatcher: Optional[TieredWaveDispatcher] = None
        _SESSIONS.add(self)

    # -- shape latching ----------------------------------------------------

    def _latch(self, chunks: np.ndarray) -> None:
        if self._row_shape is None:
            self._row_shape = tuple(chunks.shape[1:])
            self._row_dtype = chunks.dtype
            if self.k is None:
                row_bytes = max(1, chunks.nbytes // max(1, len(chunks)))
                self.k = max(1, min(
                    self.engine._rows_per_wave(row_bytes),
                    -(-chunks.shape[0] // self.engine.n_dev)))
        elif (tuple(chunks.shape[1:]) != self._row_shape
                or chunks.dtype != self._row_dtype):
            raise ValueError(
                f"session rows are fixed at shape {self._row_shape} "
                f"dtype {self._row_dtype} (got {tuple(chunks.shape[1:])} "
                f"{chunks.dtype}); one row shape per session")

    def warm(self) -> float:
        """Build and load the session's kernel libraries (needs the row
        shape: feed once first); returns the seconds spent."""
        if self._row_shape is None:
            raise RuntimeError("warm() needs the row shape: feed once "
                               "first (the shape is latched there)")
        return self.engine.precompile(self._row_shape, self._row_dtype,
                                      k=self.k)

    # -- accumulator ordering ----------------------------------------------

    def _await_acc(self, st: _Stream) -> None:
        """Order the caller's current stream after the last write of
        *st*'s accumulator (no host wait)."""
        if st.written is None or st.acc is None:
            return
        event, stream = st.written
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(event)
        if cur != stream:  # the allocator must not reuse them early
            for t in st.acc:
                t.record_stream(cur)

    def _note_written(self, st: _Stream) -> None:
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            event = torch.cuda.Event()
            event.record(cur)
            st.written = (event, cur)

    def _acc(self, st: _Stream) -> tuple:
        """*st*'s accumulator; for a stream that never folded a wave, an
        all-invalid one made by one fully masked wave (its shapes come
        from ``map_fn``)."""
        if st.acc is None:
            block = torch.zeros((self.engine.n_local,) + self._row_shape,
                                dtype=torch.from_numpy(
                                    np.zeros(0, self._row_dtype)).dtype,
                                device=self.device)
            st.acc = self.engine._wave(_steady_cfg(self.config), block, 0,
                                       1, 0, None, self._pmap(st)).acc
            self._note_written(st)
        return st.acc

    # -- the lanes over all P partitions -------------------------------------

    def _host_lanes(self, acc: tuple) -> Dict[str, np.ndarray]:
        """*acc*'s lanes on the host over all P partitions
        (:func:`~.spill.lanes_to_host`): over a group the key, value,
        payload and valid lanes are all-gathered from every rank (the
        traffic lane is global on each already)."""
        if self.group is None:
            return lanes_to_host(acc)
        return lanes_to_host(tuple(all_gather_rows(acc[:4], self.group))
                             + tuple(acc[4:]))

    def _own_rows(self, lanes: Dict[str, np.ndarray],
                  ) -> Dict[str, np.ndarray]:
        """This rank's partitions' rows of all-P host lanes (every row
        without a group; the traffic lane stays whole)."""
        if self.group is None:
            return lanes
        lo, n = self.engine.p_lo, self.engine.n_local
        return {name: a[lo:lo + n] if name in LANES[:4] else a
                for name, a in lanes.items()}

    # -- the stream --------------------------------------------------------

    def tasks(self) -> List[str]:
        with self._lock:
            return sorted(self._streams)

    def _stream(self, task: str) -> _Stream:
        st = self._streams.get(task)
        if st is None:
            self._refuse_handed_off(task)
            # lazy restore: an evicted stream comes back on its next
            # touch, on these partitions whatever it was saved under
            if self.spill is not None and self.spill.has(task):
                st = self._restore_locked(task)
            else:
                st = self._streams[task] = _Stream()
            self._refresh_resident()
        return st

    def _refresh_resident(self) -> None:
        _RESIDENT.set(len(self._streams), task="-")

    def _refuse_handed_off(self, task: str) -> None:
        """A stream handed to another host must not restore here (call
        under the lock)."""
        if task in self._handed_off:
            _BACKPRESSURE.inc(task=task, reason="migrating")
            raise SessionBusyError(
                f"stream {task!r} was migrated off this host; its spill "
                "belongs to the destination now: re-resolve the task's "
                "route and retry there")

    def _wave_cfg(self) -> EngineConfig:
        """The concrete config of the next wave: the session's, or under
        a tier policy the session-lifetime dispatcher's choice."""
        if not _is_tiered(self.config.sort_impl):
            return self.config
        if self._dispatcher is None:
            self._dispatcher = TieredWaveDispatcher(self.engine,
                                                    self.config)
        return self._dispatcher.next_cfg()

    def _pmap(self, st: _Stream) -> Optional[torch.Tensor]:
        """The stream's bucket->partition table on the device (None
        without ``partition_map``); identity until a rebalance."""
        if not self.config.partition_map:
            return None
        if st.pmap is None:
            st.pmap = identity_pmap(self.engine.partition_buckets,
                                    self.engine.n_dev)
        if st.pmap_dev is None:
            st.pmap_dev = torch.from_numpy(st.pmap.copy()).to(self.device)
        return st.pmap_dev

    def feed(self, chunks: np.ndarray, task: Optional[str] = None,
             on_overflow: str = "raise") -> int:
        """Fold *chunks* (``[S, ...row]`` host array) into *task*'s
        resident aggregate, one wave a ``k * P`` chunk block, this
        task's accumulator carried through.  Returns the rows this feed
        overflowed (0: exact)."""
        if on_overflow not in ("raise", "count"):
            raise ValueError("on_overflow must be 'raise' or 'count', "
                             f"got {on_overflow!r}")
        task = self.default_task if task is None else str(task)
        chunks = np.ascontiguousarray(chunks)
        t0 = time.monotonic()
        # the bounded queue counts waiters only: a feed leaves it when it
        # takes the session lock, so N admits N feeds queued behind the
        # one that runs
        slot = [False]  # True while this feed holds a waiter slot
        if self.max_pending_feeds > 0:
            with self._pending_lock:
                if self._pending.get(task, 0) >= self.max_pending_feeds:
                    _BACKPRESSURE.inc(task=task, reason="feed_queue")
                    raise SessionBusyError(
                        f"stream {task!r}: {self.max_pending_feeds} "
                        "feeds already pending; the device is behind "
                        "this stream's arrival rate: shed or slow")
                self._pending[task] = self._pending.get(task, 0) + 1
                slot[0] = True
        try:
            feed_oflow, st = self._feed_locked(chunks, task, slot, t0)
        finally:
            if slot[0]:  # died before it took the session lock
                self._pending_done(task)
        refresh_stream_age_gauges()
        # housekeeping outside the lock: an eviction this feed causes
        # must not lengthen its critical section
        self.enforce_spill_policy()
        # the observe->act loop, also outside the lock: the skew
        # controller reads this feed's traffic window and may rebalance
        # the stream (its own lock acquisitions; a decision, applied or
        # refused, lands in the control ledger)
        if self.autotune is not None:
            if st.feeds == 1:
                # a pre-sized stream's FIRST feed is the capacity
                # decision's measurement window
                self.autotune.note_session_feed(
                    self.engine.autotune_key(), feed_oflow, task=task)
            self.autotune.after_feed(self, task)
        if feed_oflow and on_overflow == "raise":
            raise SessionOverflowError(
                f"session stream {task!r} overflowed {feed_oflow} rows "
                f"(cumulative {st.overflow}); streams cannot retry: "
                "raise EngineConfig capacities and restart the stream")
        return feed_oflow

    def _pending_done(self, task: str) -> None:
        with self._pending_lock:
            n = self._pending.get(task, 1) - 1
            if n > 0:
                self._pending[task] = n
            else:
                self._pending.pop(task, None)

    def _broken_error(self, task: str, what: str) -> SessionStreamBroken:
        restorable = self.spill is not None and self.spill.has(task)
        return SessionStreamBroken(
            f"stream {task!r} broke in an earlier feed; {what}: "
            + ("restore(task) rolls it back to its last spilled "
               "checkpoint" if restorable else
               "close(task) and restart it from the source"))

    def _feed_locked(self, chunks: np.ndarray, task: str, slot: list,
                     t0: float):
        with self._lock:
            if slot[0]:  # this feed runs now: free its waiter slot
                self._pending_done(task)
                slot[0] = False
            self._latch(chunks)
            eng = self.engine
            st = self._stream(task)
            if st.broken:
                raise self._broken_error(task, "feed refused")
            S = chunks.shape[0]
            rpw = self.k * eng.n_dev
            # the mask bound: chunk indices >= n_real are padding
            n_real = st.pos + S
            pmap = self._pmap(st)
            cuda = self.device.type == "cuda"
            feeder = _WaveFeeder(eng, chunks, k=self.k,
                                 prefetch=eng.STREAM_PREFETCH)
            oflows, needs = [], []
            wave_tiers: Dict[str, int] = {}
            try:
                self._await_acc(st)
                feeder.start()
                for w in range(feeder.waves):
                    cfg = self._wave_cfg()
                    if cuda:  # built at the first wave, found later
                        kc.load(kc.sources_for(cfg, self.device))
                    block = feeder.get(w)
                    out = eng._wave(cfg, block, st.pos + w * rpw, self.k,
                                    n_real, st.acc, pmap)
                    _DISPATCHES.inc(1, program="wave", task=task)
                    # the serving tier of this wave ("-" untiered): a
                    # feed across the swap counts under both labels
                    tier = (self._dispatcher.tier_label
                            if self._dispatcher is not None else "-")
                    wave_tiers[tier] = wave_tiers.get(tier, 0) + 1
                    del block
                    feeder.release(w)
                    # the old accumulator's last reference goes here,
                    # before the next wave allocates
                    st.acc = out.acc
                    oflows.append(out.overflow)
                    needs.append(out.needs)
                    del out
                # the feed's one readback: waits for its waves (over a
                # group, all-reduced: every rank holds the same total)
                feed_oflow = (eng._attempt_overflow(oflows, needs)[0]
                              if oflows else 0)
            except BaseException:
                # waves before the failure are folded and pos did not
                # move: a retry would count them twice, so poison
                st.broken = True
                st.acc = None
                raise
            finally:
                feeder.close()
            self._note_written(st)
            st.pos += S
            st.waves += feeder.waves
            st.feeds += 1
            st.overflow += feed_oflow
            st.last_feed_monotonic = time.monotonic()
            _WAVES.inc(feeder.waves, task=task)
            for tier, n in wave_tiers.items():
                _SESSION_WAVES.inc(n, task=task, tier=tier)
            _FEEDS.inc(task=task)
            _CHUNKS.inc(S, task=task)
            if feed_oflow:
                _OVERFLOWS.inc(feed_oflow, task=task)
            feed_s = time.monotonic() - t0
            _SESSION_SECONDS.inc(feed_s, stage="feed", task=task)
            _slo.observe_session_op("feed", task, feed_s)
            return feed_oflow, st

    def snapshot(self, task: Optional[str] = None) -> DeviceResult:
        """A consistent mid-stream read of *task*'s aggregate: the batch
        engine's sliced readback over the live accumulator (the stream
        goes on).  ``overflow`` carries the stream's cumulative dropped
        rows (0: exact)."""
        task = self.default_task if task is None else str(task)
        t0 = time.monotonic()
        with self._lock:
            st = self._streams.get(task)
            if st is None:
                self._refuse_handed_off(task)
                if self.spill is not None and self.spill.has(task):
                    # an evicted stream still serves: restore lazily
                    st = self._restore_locked(task)
                    self._refresh_resident()
            if st is None:
                raise KeyError(f"no stream {task!r} in this session "
                               f"(known: {sorted(self._streams)})")
            if st.broken:
                raise self._broken_error(task, "its aggregate is unusable")
            acc = self._acc(st)
            self._await_acc(st)
            if self.group is not None:
                # every rank's live prefix, all-gathered (the JAX _host)
                result, _, n_live = self.engine._gather_result(
                    acc, self.config, st.overflow)
            else:
                keys, vals, pay, valid = acc[:4]
                n_live = valid.sum(dim=1).cpu()
                width = max(1, int(n_live.max()))
                result = DeviceResult(keys[:, :width].cpu(),
                                      vals[:, :width].cpu(),
                                      pay[:, :width].cpu(),
                                      valid[:, :width].cpu(), st.overflow)
            _SNAPSHOTS.inc(task=task)
            _LIVE_RECORDS.set(int(n_live.sum()), task=task)
            done = time.monotonic()
            if st.last_feed_monotonic is not None:
                # staleness: the age of the newest record the snapshot
                # reflects (feeds and snapshots are serialised, so the
                # last completed feed holds it)
                _slo.observe_staleness(task, done - st.last_feed_monotonic)
            st.last_snapshot_monotonic = done
            _SESSION_SECONDS.inc(done - t0, stage="snapshot", task=task)
            _slo.observe_session_op("snapshot", task, done - t0)
        refresh_stream_age_gauges()
        return result

    def stats(self, task: Optional[str] = None) -> Dict[str, object]:
        """Stream counters for *task* (the JAX package's keys), with the
        formulation names when they are not the defaults."""
        task = self.default_task if task is None else str(task)
        with self._lock:
            st = self._streams.get(task)
            if st is None:
                return {}
            out = {"chunks": st.pos, "waves": st.waves,
                   "feeds": st.feeds, "overflow": st.overflow}
            if self.config.partition_map:
                out["rebalances"] = st.rebalances
            if (self.config.segment_impl != "lax"
                    or self.config.tokenize_impl != "lax"):
                out["segment_impl"] = self.config.segment_impl
                out["tokenize_impl"] = self.config.tokenize_impl
            if self.config.sort_impl != "variadic":
                out["sort_impl"] = self.config.sort_impl
            return out

    def coldest_task(self) -> Optional[str]:
        """The resident stream touched (fed or read) longest ago; broken
        streams are skipped.  None when nothing is resident.  Over a
        group every rank calls it and gets the same stream: the oldest
        of the ranks' gathered ages (:meth:`_group_ages`)."""
        now = time.monotonic()
        with self._lock:
            ages = {task: now - max(st.last_feed_monotonic or 0.0,
                                    st.last_snapshot_monotonic or 0.0)
                    for task, st in self._streams.items() if not st.broken}
        if self.group is not None:
            ages, _ = self._group_ages(ages, False)
        best, best_age = None, None
        for task, age in ages.items():
            if best_age is None or age > best_age:
                best, best_age = task, age
        return best

    # -- routing: traffic, buckets, rebalance --------------------------------

    def traffic_matrix(self, task: Optional[str] = None,
                       ) -> Optional[np.ndarray]:
        """*task*'s cumulative ``[P, P]`` exchange traffic (src x dst
        rows routed), host copy; None without ``exchange_stats`` or for
        an unknown or broken stream."""
        task = self.default_task if task is None else str(task)
        with self._lock:
            st = self._streams.get(task)
            if (st is None or st.broken
                    or not self.config.exchange_stats):
                return None
            acc = self._acc(st)
            self._await_acc(st)
            return acc[4].cpu().numpy()

    def bucket_histogram(self, task: Optional[str] = None,
                         ) -> Optional[np.ndarray]:
        """Resident unique rows per hash bucket (``key_hi % B``) of
        *task*'s accumulator: the weights a rebalance bins onto
        partitions.  Needs ``partition_map``."""
        task = self.default_task if task is None else str(task)
        if not self.config.partition_map:
            return None
        B = self.engine.partition_buckets
        with self._lock:
            st = self._streams.get(task)
            if st is None or st.broken:
                return None
            acc = self._acc(st)
            self._await_acc(st)
            lanes = self._host_lanes(acc[:4])
        k_hi = lanes["keys"][..., 0].reshape(-1).astype(np.uint64)
        mask = lanes["valid"].reshape(-1).astype(bool)
        return np.bincount((k_hi[mask] % np.uint64(B)).astype(np.int64),
                           minlength=B).astype(np.int64)

    def partition_map(self, task: Optional[str] = None,
                      ) -> Optional[np.ndarray]:
        """*task*'s current bucket->partition table (host copy)."""
        task = self.default_task if task is None else str(task)
        if not self.config.partition_map:
            return None
        with self._lock:
            st = self._streams.get(task)
            if st is None:
                return None
            if st.pmap is None:
                return identity_pmap(self.engine.partition_buckets,
                                     self.engine.n_dev)
            return np.array(st.pmap)

    def rebalance(self, task: Optional[str], pmap) -> None:
        """Install a new bucket->partition table on *task*'s stream
        mid-stream: the resident rows are re-binned on the host under it
        (:func:`~.spill.repartition_rows`) and placed back, and later
        waves route through it, bit-identical to a run under the new
        table from the start.  Raises :class:`~.spill.
        SessionRestoreError` when a partition would overflow
        ``out_capacity``; the stream is then left as it was."""
        if not self.config.partition_map:
            raise ValueError(
                "rebalance needs EngineConfig.partition_map=True")
        task = self.default_task if task is None else str(task)
        eng = self.engine
        pmap = validate_partition_map(pmap, eng.partition_buckets,
                                      eng.n_dev)
        cfg = _steady_cfg(self.config)
        with self._lock:
            st = self._streams.get(task)
            if st is None:
                raise KeyError(f"no resident stream {task!r}")
            if st.broken:
                raise SessionStreamBroken(
                    f"stream {task!r} is poisoned; rebalance refused")
            acc = self._acc(st)
            self._await_acc(st)
            # re-bin first (the gathered lanes: every rank re-bins all P
            # alike): an overflow raises with the stream untouched
            binned = repartition_rows(self._host_lanes(acc[:4]), eng.n_dev,
                                      cfg.out_capacity, task=task,
                                      pmap=pmap)
            # the traffic lane is routing history under the old table;
            # it stays cumulative
            st.acc = tuple(lanes_to_device(self._own_rows(binned),
                                           LANES[:4], self.device)) + acc[4:]
            self._note_written(st)
            st.pmap = pmap
            st.pmap_dev = None  # uploaded at the next feed
            st.rebalances += 1

    # -- spill / evict / restore (engine/spill.py) -------------------------

    def _spill_meta(self, st: _Stream) -> Dict[str, object]:
        meta = {
            "pos": st.pos, "waves": st.waves, "feeds": st.feeds,
            "overflow": st.overflow,
            "k": self.k, "n_dev": self.engine.n_dev,
            "row_shape": list(self._row_shape or ()),
            "row_dtype": (str(np.dtype(self._row_dtype))
                          if self._row_dtype is not None else None),
            "config": _cfg_token(_steady_cfg(self.config)),
        }
        if st.pmap is not None:
            # a rebalanced table is part of the layout: a restore
            # without it would route later waves differently
            meta["pmap"] = [int(v) for v in st.pmap]
            meta["rebalances"] = st.rebalances
        return meta

    def _spill_locked(self, task: str, reason: str) -> int:
        if self.spill is None:
            raise RuntimeError(
                "this session has no spill store: construct with "
                "spill=SessionSpillStore(...)")
        st = self._streams.get(task)
        if st is None:
            raise KeyError(f"no resident stream {task!r}")
        if st.broken:
            raise SessionStreamBroken(
                f"stream {task!r} is poisoned; its accumulator must not "
                "be spilled (restore() rolls back to the last good "
                "spill)")
        t0 = time.monotonic()
        acc = self._acc(st)
        self._await_acc(st)
        # over a group: rank 0 writes the gathered lanes, the others
        # return after its commit
        step = self.spill.save_stream(task, self._host_lanes(acc),
                                      self._spill_meta(st),
                                      group=self.group)
        _SPILLS.inc(task=task, reason=reason)
        _SPILL_SECONDS.inc(time.monotonic() - t0, stage="spill", task=task)
        return step

    def spill_stream(self, task: Optional[str] = None,
                     reason: str = "explicit") -> int:
        """Checkpoint *task*'s accumulator to the spill store (the
        stream stays resident); returns the committed step.  Serialised
        with feeds, so it holds exactly the completed feeds.  *reason*
        labels ``mrtpu_session_spills_total``."""
        task = self.default_task if task is None else str(task)
        with self._lock:
            return self._spill_locked(task, reason)

    def evict(self, task: Optional[str] = None,
              reason: str = "explicit") -> int:
        """Spill *task*, then drop its resident accumulator (its device
        memory frees with the references); the next feed or snapshot
        restores it lazily."""
        task = self.default_task if task is None else str(task)
        with self._lock:
            step = self._spill_locked(task, reason)
            self._streams.pop(task, None)
            self._refresh_resident()
        refresh_stream_age_gauges()
        return step

    def migrate_out(self, task: Optional[str] = None,
                    reason: str = "migration") -> int:
        """The source half of a migration: spill *task*, drop it and
        mark it handed off, so a feed or snapshot that raced the evict
        gets :class:`SessionBusyError` instead of restoring a spill that
        now belongs to the destination.  Returns the spill step (0 when
        the stream was already evicted).  Over a process group every
        rank calls it: rank 0 writes the spill of the gathered lanes,
        which is the hand-off, and every rank marks the stream."""
        task = self.default_task if task is None else str(task)
        with self._lock:
            if task in self._streams:
                step = self._spill_locked(task, reason)
                self._streams.pop(task, None)
            elif self.spill is not None and on_rank0(
                    self.group, lambda: self.spill.has(task)):
                step = 0  # already durable: nothing resident to spill
            else:
                raise KeyError(
                    f"no resident or spilled stream {task!r} to migrate")
            self._handed_off.add(task)
            self._refresh_resident()
        refresh_stream_age_gauges()
        return step

    def _restore_locked(self, task: str) -> _Stream:
        t0 = time.monotonic()
        # over a group: the manifest rank 0 picks, read on every rank
        lanes, meta = self.spill.load_stream(task, group=self.group)
        want = _cfg_token(_steady_cfg(self.config))
        got = meta.get("config")
        if got != want:
            raise SessionRestoreError(
                f"stream {task!r} was spilled under engine config "
                f"{got!r}; this session runs {want!r}: restoring across "
                "configs would change the aggregate")
        row_shape = tuple(meta.get("row_shape") or ())
        row_dtype = (np.dtype(meta["row_dtype"])
                     if meta.get("row_dtype") else None)
        if self._row_shape is None:
            # a fresh session adopts the stream's shape and wave split
            self._row_shape, self._row_dtype = row_shape, row_dtype
            if self.k is None and meta.get("k"):
                self.k = int(meta["k"])
        elif (row_shape != self._row_shape
                or row_dtype != np.dtype(self._row_dtype)):
            raise SessionRestoreError(
                f"stream {task!r} was spilled with row shape "
                f"{row_shape}/{row_dtype}, session latched "
                f"{self._row_shape}/{np.dtype(self._row_dtype)}")
        P = self.engine.n_dev
        n_dev_old = int(meta.get("n_dev") or P)
        cfg = _steady_cfg(self.config)
        resharded = n_dev_old != P
        saved_pmap = meta.get("pmap")
        if resharded:
            # a rebalanced table belongs to the old partition count: the
            # rows re-bin under the new count's identity routing
            saved_pmap = None
            lanes = dict(lanes, **repartition_rows(
                lanes, P, cfg.out_capacity, task=task))
        names = list(LANES[:4])
        if cfg.exchange_stats:
            names.append("traffic")
            if resharded or "traffic" not in lanes:
                # routing history cannot be re-binned: it restarts
                lanes["traffic"] = np.zeros((P, P), np.int32)
        st = _Stream(tuple(lanes_to_device(self._own_rows(lanes), names,
                                           self.device)))
        self._note_written(st)
        st.pos = int(meta.get("pos") or 0)
        st.waves = int(meta.get("waves") or 0)
        st.feeds = int(meta.get("feeds") or 0)
        st.overflow = int(meta.get("overflow") or 0)
        if saved_pmap is not None and self.config.partition_map:
            st.pmap = np.asarray(saved_pmap, dtype=np.int32)
            st.rebalances = int(meta.get("rebalances") or 0)
        # staleness restarts here: the restore is as old as the newest
        # record can be proven to be
        st.last_feed_monotonic = time.monotonic()
        self._streams[task] = st
        _RESTORES.inc(task=task, outcome="resharded" if resharded else "ok")
        _SPILL_SECONDS.inc(time.monotonic() - t0, stage="restore",
                           task=task)
        return st

    def adopt(self, task: Optional[str] = None) -> None:
        """The destination half of a hand-off: lift a handed-off refusal
        for *task*, so its next touch restores the migrated spill (over a
        process group, every rank calls it; the restore reads the
        manifest rank 0 picks)."""
        task = self.default_task if task is None else str(task)
        with self._lock:
            self._handed_off.discard(task)

    def restore(self, task: Optional[str] = None) -> _Stream:
        """Restore *task* from its newest complete spill, also over a
        poisoned stream (re-feed from ``stats(task)['chunks']``: nothing
        the spill folded is folded twice).  A failed restore leaves the
        resident stream as it was."""
        if self.spill is None:
            raise RuntimeError(
                "this session has no spill store: construct with "
                "spill=SessionSpillStore(...)")
        task = self.default_task if task is None else str(task)
        with self._lock:
            st = self._restore_locked(task)
            self._handed_off.discard(task)
            self._refresh_resident()
        refresh_stream_age_gauges()
        return st

    def enforce_spill_policy(self) -> List[str]:
        """Apply the :class:`~.spill.SpillPolicy` (idle age, resident
        cap, device memory): evict the victims and return their tasks.
        Runs at each feed's end; safe from a housekeeping thread."""
        policy = self.spill_policy
        if policy is None or self.spill is None:
            return []
        now = time.monotonic()
        with self._lock:
            ages = {}
            for task, st in self._streams.items():
                if st.broken:
                    continue  # a poisoned stream is restore()'s case
                last = max(st.last_feed_monotonic or 0.0,
                           st.last_snapshot_monotonic or 0.0)
                ages[task] = now - last
        pressed = policy.hbm_pressed(self.device)
        if self.group is not None:
            ages, pressed = self._group_ages(ages, pressed)
        evicted = []
        for task in policy.victims(ages, pressed):
            if (policy.max_idle_s is not None
                    and ages.get(task, 0.0) > policy.max_idle_s):
                reason = "idle"
            elif pressed:
                reason = "pressure"
            else:
                reason = "resident_cap"
            try:
                self.evict(task, reason=reason)
            except (KeyError, SessionStreamBroken):
                continue  # raced a close() or a break: nothing to evict
            evicted.append(task)
        return evicted

    def _group_ages(self, ages: Dict[str, float], pressed: bool):
        """Every rank's idle ages and memory pressure, all-gathered: the
        streams resident and unbroken on every rank, each at its largest
        age, and pressure on any rank, so all ranks pick one victim
        list."""
        import torch.distributed as dist

        seen: List = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(seen, (ages, pressed), group=self.group)
        common = set.intersection(*(set(a) for a, _ in seen))
        return ({t: max(a[t] for a, _ in seen) for t in sorted(common)},
                any(p for _, p in seen))

    def close(self, task: Optional[str] = None,
              drop_spill: bool = True) -> None:
        """Drop one stream's (or every stream's) accumulator.  Closing a
        named task ends the stream: its spilled history goes too, unless
        ``drop_spill=False`` (a hand-off), or a later feed under the name
        would resume it and fold twice.  Closing the whole session is a
        shutdown: spills stay for the next host."""
        with self._lock:
            if task is not None:
                self._streams.pop(str(task), None)
                self._handed_off.discard(str(task))
            else:
                self._streams.clear()
                self._handed_off.clear()
            self._refresh_resident()
        if self.spill is not None and drop_spill and task is not None:
            # over a group: rank 0 drops the shared spill, the others wait
            on_rank0(self.group, lambda: self.spill.drop(str(task)))
        # a closed stream's age series must not linger
        refresh_stream_age_gauges()
