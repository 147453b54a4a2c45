"""Device MapReduce with a monoid reduce (port of ``engine/device_engine.py``).

The user gives ``map_fn(chunk, chunk_index, cfg) -> (keys [T, 2] int32
bits, values, payload [T, Q] int32, valid [T] bool, overflow [] int32)``
— a fixed-capacity batch of hashed records from one input chunk — and a
``reduce_op``: "sum" / "min" / "max", a tuple of those (one per value
lane), or an associative + commutative callable on torch tensors.  On
CUDA a callable is lowered (:mod:`..ops.monoid`) into the combine of a
segmented-reduce kernel of its own, typed by the value lanes the map
emits (int32 or float32).  A monoid that lowers over neither raises
when the engine is built; its library is loaded, through the compile
ledger, once the first wave's map has emitted, before any reduce.

Each wave, for each of the ``P`` partitions (:class:`..parallel.mesh.
Partitions`), runs the JAX wave program's steps in order:

  1. the map loop over the partition's chunks: ``map_fn``, and with
     ``combine_in_scan`` a per-chunk ``sorted_unique_reduce`` (the
     on-device combiner), appended to the partition's record buffer;
  2. the local reduce: one ``sorted_unique_reduce`` over the buffer;
  3. the exchange of the uniques, with the running accumulator carried
     in front of the received rows (``partition_exchange``);
  4. the fold: one more ``sorted_unique_reduce`` into the accumulator.

Capacities are static; overflows are counted, and :meth:`DeviceEngine.
run` retries with capacities right-sized from the failed attempt's
measured needs.  A truncated result never escapes unless asked for.

``sort_impl='radix'`` runs every sort of the wave on the radix kernels
and the exchange on the radix plan; ``'tiered'`` and ``'tiered-radix'``
are policies that serve a cold start on ``'argsort'`` while the steady
tier's libraries build, then swap at a wave boundary
(:mod:`.tiering`).  ``partition_map`` routes the exchange through a
bucket->partition table (:meth:`DeviceEngine.set_partition_map`,
:func:`..autotune.plan_rebalance`), an input of the run rather than a
constant.

Input reaches the device through :class:`_WaveFeeder` (pinned staging
buffers and a copy stream of its own on CUDA, at most
:attr:`DeviceEngine.STREAM_PREFETCH` waves ahead), or all at once
through :meth:`DeviceEngine.stage_inputs`, whose handle
``run(staged=...)`` consumes.

The resident sessions (:mod:`.session`) run the same wave per feed:
:meth:`DeviceEngine._wave` takes the global index of its first chunk,
the mask bound and the partition table, and carries the cumulative
traffic lane in the accumulator.

With ``autotune=`` (:class:`..autotune.AutoTuner`) a run is pre-sized
from what earlier runs of the same program family learned
(:meth:`DeviceEngine.autotune_key`), teaches the controller at every
capacity retry, and resolves its decision after the loop; without it
nothing is recorded and nothing changes.

Telemetry (the JAX engine's instruments): the ``mrtpu_device_*``
counters and the per-wave histogram below, the span timeline
``device_run ⊃ wave ⊃ {upload, compute, readback}`` of every attempt
(:mod:`..obs.wavetrace`: CUDA events on the card, read after the
attempt's one overflow read, so it adds no host wait to the loop), the
result's ``readback`` span, a ``capacity_retry`` forensics event at each
retry (:mod:`..obs.memory`), per-wave device-memory samples from the
allocator's counters, the upload/compute overlap share
(:mod:`..obs.comms`) and the analytic cost model with MFU and the
roofline share (:mod:`..obs.profile`), all in ``timings`` too.

The wave program is a compile-ledger acquisition (:mod:`..obs.compile`,
program ``wave``): :meth:`DeviceEngine.precompile` and the first wave of
each configuration a run serves load the libraries of its path under a
``compile`` span, keyed as the JAX engine keys its wave program (map_fn,
config, partitions and the wave's input shape), and record the bucket,
with the replay spec :func:`replay_registry` primes it from
(``cli warmup --replay``), in the enabled cache's shape registry.  A
callable reduce op records no replay spec, as the JAX engine's: its
bucket keeps the run's capacities alone (``sizing``), from which the
capacity controller pre-sizes the map_fn's next run all the same.

Over a process group (``Partitions(n, device, group=G)``, gloo) the
engine is one controller of a multi-process mesh, as the JAX engine is
under ``jax.distributed``: every rank is given the identical corpus (the
SPMD contract), maps only the chunks of its own partitions and folds only
them; the exchange crosses the group (:func:`..parallel.shuffle.
partition_exchange`); the overflow and the capacity needs are
all-reduced (sum and max) before any host decision, so every retry,
capacity and wave count is one that all ranks take; and the result is
all-gathered, so every rank returns the full :class:`DeviceResult`, as
the JAX engine's ``_host`` does.  Only rank 0 publishes the exchange
matrix's counters.  A mismatch between ranks shows as a collective's
timeout (give ``init_process_group`` one), never as a silent hang.
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from dataclasses import asdict, dataclass, replace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..obs import comms as _comms
from ..obs import compile as _compile_obs
from ..obs.compile import op_token
from ..obs import memory as _memory_obs
from ..obs import metrics as _obs
from ..obs import profile as _profile
from ..obs.trace import TRACER
from ..obs.wavetrace import WaveTimeline
from ..ops import kernel_compat as kc
from ..ops import monoid as _monoid
from ..ops.radix_sort import RADIX_PASSES
from ..ops.segscan import SENTINEL, ReduceOp, sorted_unique_reduce
from ..parallel.mesh import Partitions, partition_devices
from ..parallel.shuffle import partition_exchange
from .tiering import TierSpecializer, TieredWaveDispatcher

# -- device-plane instruments (the JAX engine's): live counters for the
#    exposition plane plus per-wave histograms on DEVICE_BUCKETS ------------
_WAVES = _obs.counter("mrtpu_device_waves_total",
                      "device-engine waves executed (labels: task)")
_DISPATCHES = _obs.counter(
    "mrtpu_device_dispatches_total",
    "wave programs dispatched by the device engine (labels: program, "
    "task): one program=wave a wave, as in the JAX engine; the kernel "
    "launches of a wave are counted in kernel_compat.LAUNCHES")
_RETRIES = _obs.counter("mrtpu_device_retries_total",
                        "capacity-overflow retries (labels: task)")
_STAGE_SECONDS = _obs.counter(
    "mrtpu_device_seconds_total",
    "device-engine host wall seconds by stage (labels: stage, task)")
_WAVE_SECONDS = _obs.histogram(
    "mrtpu_device_wave_seconds",
    "per-wave stage seconds on the DEVICE_BUCKETS preset (labels: "
    "stage=wave|upload|compute|readback): the durations of the "
    "timeline's spans.  On CUDA upload (the feeder's copy) and compute "
    "(first to last launch of the wave) are device time from CUDA "
    "events, wave and readback host-clock intervals; on the CPU all "
    "host time.  Task-agnostic: per-task accounting rides the counters",
    buckets=_obs.DEVICE_BUCKETS)
#: per-partition skew inputs: live unique rows (and approximate bytes)
#: of each partition after the last run's exchange and fold
_PARTITION_RECORDS = _obs.gauge(
    "mrtpu_device_partition_records",
    "live unique rows per partition after the last device run "
    "(labels: task, partition)")
_PARTITION_BYTES = _obs.gauge(
    "mrtpu_device_partition_bytes",
    "approximate bytes of live rows per partition after the last "
    "device run (labels: task, partition)")


@dataclass(frozen=True)
class EngineConfig:
    """Static capacities (each a per-partition row bound) and the JAX
    package's formulation knobs, with the same names and defaults so a
    configuration carries over (``convert.engine_config_from_jax``)."""

    local_capacity: int = 1 << 16     # unique keys per partition, pre-shuffle
    exchange_capacity: int = 1 << 14  # rows per (src, dst) pair
    out_capacity: int = 1 << 16       # unique keys per partition
    tile: int = 512                   # positions per compaction tile
    tile_records: int = 128           # record slots per tile (map side)
    reduce_op: ReduceOp = "sum"
    unit_values: bool = False         # values are all 1: count runs instead
    #: on-device combiner: pre-reduce each chunk's records in the map
    #: loop (valid only because reduce_op declares an ACI monoid)
    combine_in_scan: bool = False
    #: record slots one chunk is combined into (0 = auto: T//4, at least
    #: 256, at most T); per-chunk uniques beyond it count as overflow
    combine_capacity: int = 0
    #: JAX formulation knob, kept for convert.py; unused here
    rank_sort: bool = True
    #: accumulate the src x dst exchange traffic matrix into timings
    exchange_stats: bool = True
    #: 'variadic' or 'argsort' (torch.sort) or 'radix' (the radix
    #: kernels, with the radix exchange plan); all give one permutation.
    #: 'tiered' / 'tiered-radix': serve 'argsort' while 'variadic' /
    #: 'radix' is not built, then swap (engine/tiering.py)
    sort_impl: str = "variadic"
    #: route the exchange through a [B] int32 bucket->partition table
    #: (identity until DeviceEngine.set_partition_map installs another)
    partition_map: bool = False
    #: buckets in the table (0 = auto: PARTITION_MAP_GRANULARITY per
    #: partition); a multiple of the partition count
    partition_buckets: int = 0
    #: JAX formulation knobs, kept for convert.py; the device picks the
    #: route (kernels on CUDA, plain versions on the CPU)
    segment_impl: str = "lax"
    segment_block: int = 4096
    tokenize_impl: str = "lax"
    tokenize_block: int = 4096

    def cache_key(self) -> tuple:
        """Every field, in the JAX package's ``cache_key`` order: a
        spill's ``meta["config"]`` (:func:`_cfg_token`) must spell the
        same string in both packages for the same config."""
        return (self.local_capacity, self.exchange_capacity,
                self.out_capacity, self.tile, self.tile_records,
                self.reduce_op, self.unit_values, self.combine_in_scan,
                self.combine_capacity, self.rank_sort,
                self.exchange_stats, self.sort_impl,
                self.partition_map, self.partition_buckets,
                self.segment_impl, self.segment_block,
                self.tokenize_impl, self.tokenize_block)

    def scan_combine_slots(self, T: int) -> int:
        """Buffer slots one chunk's pre-reduced records occupy when the
        combiner is on, clamped to [1, T]."""
        cap = self.combine_capacity or max(T // 4, 256)
        return max(1, min(T, cap))


#: auto bucket count per partition for the partition-map table
PARTITION_MAP_GRANULARITY = 8


def partition_buckets_for(cfg: EngineConfig, n_dev: int) -> int:
    """The table's bucket count B (a multiple of the partition count, so
    the identity table reproduces ``key_hi % P``)."""
    B = cfg.partition_buckets or PARTITION_MAP_GRANULARITY * n_dev
    if B % n_dev:
        raise ValueError(
            f"partition_buckets {B} must be a multiple of the partition "
            f"count {n_dev} (the identity table's bit-identity to "
            "key_hi % P depends on P | B)")
    return B


def identity_pmap(B: int, n_dev: int) -> np.ndarray:
    """The identity table ``pmap[b] = b % P``: the same routing as
    ``key_hi % P``."""
    return (np.arange(B, dtype=np.int64) % n_dev).astype(np.int32)


def validate_partition_map(pmap, buckets: int, n_dev: int) -> np.ndarray:
    """Normalise and check a bucket->partition table; the int32 host
    copy.  A malformed table would route records into partitions that do
    not exist, so both faults raise."""
    pmap = np.asarray(pmap, dtype=np.int32).reshape(-1)
    if pmap.shape[0] != buckets:
        raise ValueError(f"partition map has {pmap.shape[0]} buckets, "
                         f"config says {buckets}")
    if pmap.size and (pmap.min() < 0 or pmap.max() >= n_dev):
        raise ValueError(
            f"partition map routes outside [0, {n_dev})")
    return pmap


def _stage_ops(cfg: EngineConfig):
    """``(local_op, local_unit, fin_op)`` — the per-stage reduce algebra.
    With the combiner on, buffer rows are already per-chunk partial
    reductions, so the local stage combines them (unit-value run counts
    combine by sum) instead of counting rows again."""
    if cfg.combine_in_scan and cfg.unit_values:
        local_op, local_unit = "sum", False
    else:
        local_op, local_unit = cfg.reduce_op, cfg.unit_values
    fin_op = "sum" if cfg.unit_values else cfg.reduce_op
    return local_op, local_unit, fin_op


class DeviceResult(NamedTuple):
    keys: torch.Tensor     # [P, width, 2] int32 bits (uint32 key lanes)
    values: torch.Tensor   # [P, width, ...]
    payload: torch.Tensor  # [P, width, Q]
    valid: torch.Tensor    # [P, width] bool
    overflow: int          # total dropped rows across all stages (0 = exact)


class _Wave(NamedTuple):
    #: fin (keys, values, payload, valid), [P, C, ...], then with
    #: exchange_stats the cumulative [P, P] int32 traffic lane
    acc: tuple
    overflow: torch.Tensor    # [P] int32 rows dropped in this wave
    needs: torch.Tensor       # [P, 5] int32 measured capacity needs
    records: int              # record slots map_fn emits a chunk (T)


class _Aval(NamedTuple):
    """A tensor's shape and dtype: what the cost and memory models read
    of a wave's arrays, without keeping them alive."""

    shape: tuple
    dtype: torch.dtype

    @classmethod
    def of(cls, t: torch.Tensor) -> "_Aval":
        return cls(tuple(t.shape), t.dtype)


def _is_tiered(sort_impl: str) -> bool:
    """True for the tier policies, which the engine resolves into a
    concrete config per wave."""
    return sort_impl in ("tiered", "tiered-radix")


def _tier_cfgs(cfg: EngineConfig):
    """``(tier-0 config, tier-1 config)`` of a tier policy: 'argsort',
    then 'variadic' under 'tiered' or 'radix' under 'tiered-radix'.
    Their accumulator layouts are equal, so the carry threads through a
    swap."""
    steady = "radix" if cfg.sort_impl == "tiered-radix" else "variadic"
    return (replace(cfg, sort_impl="argsort"),
            replace(cfg, sort_impl=steady))


def _steady_cfg(cfg: EngineConfig) -> EngineConfig:
    """The steady-state config: a tier policy's steady tier, else *cfg*
    (what a session's spill token and accumulator are keyed by)."""
    return _tier_cfgs(cfg)[1] if _is_tiered(cfg.sort_impl) else cfg


def _capacities(cfg: EngineConfig) -> dict:
    """The static capacities a retry right-sizes: the before/after
    payload of the capacity-retry forensics the autotuner learns from."""
    return {"local_capacity": cfg.local_capacity,
            "exchange_capacity": cfg.exchange_capacity,
            "out_capacity": cfg.out_capacity,
            "tile_records": cfg.tile_records,
            "combine_capacity": cfg.combine_capacity}


def _cfg_token(cfg: EngineConfig) -> str:
    """The config's cache key as one string, spelled as the JAX package
    spells it (callables by :func:`op_token`, everything else by
    ``repr``)."""
    return "|".join(op_token(v) if callable(v) else repr(v)
                    for v in cfg.cache_key())


#: the compile tier of each concrete sort (the registry's schema-v2
#: ``tier``: 0 the argsort serving tier, 1 variadic, 2 radix)
_TIERS = {"argsort": 0, "variadic": 1, "radix": 2}


def _check_impls(cfg: EngineConfig) -> None:
    if cfg.sort_impl not in ("variadic", "argsort", "radix", "tiered",
                             "tiered-radix"):
        raise ValueError(f"unknown sort_impl {cfg.sort_impl!r}")
    for field in ("segment_impl", "tokenize_impl"):
        if getattr(cfg, field) not in ("lax", "pallas"):
            raise ValueError(f"EngineConfig.{field} must be 'lax' or "
                             f"'pallas', got {getattr(cfg, field)!r}")


class _WaveFeeder:
    """Streams the chunk batch to the device wave by wave (the JAX
    engine's ``_WaveFeeder``).

    Waves are contiguous blocks of ``rpw = k * P`` rows (``k`` from
    *k*, or from *waves*); a wave that would hold only padding is
    dropped, and the final partial wave is zero-padded (its rows are
    masked later by chunk index).  The JAX feeder uploads each wave's
    global chunk indices beside it; a port wave carries its first index
    as a Python int, so there is no index tensor.

    ``get(w)`` returns wave *w* on the device, submitting uploads for at
    most *prefetch* waves ahead to one worker thread.  ``release(w)``
    drops the feeder's reference to wave *w*, ``reset()`` forgets every
    wave so a capacity retry re-uploads, and ``close()`` cancels the
    outstanding uploads and joins the worker.  ``held_bytes`` /
    ``peak_held_bytes`` count the bytes of waves submitted and not yet
    released: the input's device-memory bound (~*prefetch* waves, never
    the corpus).

    On CUDA the worker copies each wave into one of
    :attr:`STAGING_BUFFERS` pinned host buffers (after the buffer's
    previous host-to-device copy has finished: ``event.synchronize()``)
    and from there to the device on a copy stream of its own.  ``get``
    makes the caller's current stream (the kernels') wait on that copy's
    event, with no host block, and records the wave as used on that
    stream: the wave was allocated on the copy stream, and without the
    record the allocator could hand its memory to a later wave's copy
    while the kernels still read it.  Each copy lies between two timing
    events on the copy stream, which :meth:`copy_events` hands to the
    engine's timeline.  On the CPU nothing is pinned and no stream is
    used; the wave split and the byte accounting are the same.
    """

    #: pinned host buffers a CUDA feeder cycles through
    STAGING_BUFFERS = 2

    def __init__(self, engine: "DeviceEngine", chunks: np.ndarray,
                 waves: Optional[int] = None, prefetch: Optional[int] = None,
                 k: Optional[int] = None) -> None:
        self._chunks = chunks
        self.device = engine.device
        S = chunks.shape[0]
        if k is None:  # explicit wave count (tests, user tuning)
            k = -(-S // (max(1, waves) * engine.n_dev))
        self.rpw = k * engine.n_dev
        self.waves = -(-S // self.rpw)  # all-pad waves are dropped
        self.S = S
        self.prefetch = (self.waves if prefetch is None
                         else max(1, prefetch))
        #: the rows of a wave this process uploads: its own partitions'
        #: (all of them without a process group)
        self._lo_row = engine.p_lo * k
        self._rows = engine.n_local * k
        self._shape = (self._rows,) + tuple(chunks.shape[1:])
        self._dtype = torch.from_numpy(chunks[:0]).dtype
        self._wave_nbytes = int(np.prod(self._shape, dtype=np.int64)
                                * chunks.dtype.itemsize)
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._futs: dict = {}
        self._ready: dict = {}
        #: per wave resolved by get() on CUDA, its copy's (start, done)
        #: timing events
        self._copies: dict = {}
        self._submitted = 0
        self._accounted: set = set()
        self.held_bytes = 0
        self.peak_held_bytes = 0
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._staging: list = [None] * self.STAGING_BUFFERS
            #: per buffer, the event of the last copy out of it
            self._copied: list = [None] * self.STAGING_BUFFERS

    def _put_wave(self, w: int):
        """Wave *w* on the device (on CUDA with its copy's event)."""
        lo = w * self.rpw + self._lo_row
        n = max(0, min(self._rows, self.S - lo))
        src = torch.from_numpy(self._chunks[lo:lo + n])
        if not self._cuda:
            if n == self._rows:
                return src  # a view of the caller's array
            block = torch.zeros(self._shape, dtype=self._dtype)
            block[:n] = src
            return block
        i = w % self.STAGING_BUFFERS
        if self._copied[i] is not None:
            self._copied[i].synchronize()  # its last copy has finished
        buf = self._staging[i]
        if buf is None:
            buf = self._staging[i] = torch.empty(
                self._shape, dtype=self._dtype, pin_memory=True)
        buf[:n].copy_(src)
        buf[n:].zero_()
        with torch.cuda.stream(self._stream):
            dev = torch.empty(self._shape, dtype=self._dtype,
                              device=self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
            dev.copy_(buf, non_blocking=True)
            done = torch.cuda.Event(enable_timing=True)
            done.record(self._stream)
        self._copied[i] = done
        return dev, start, done

    def _ensure_submitted(self, upto: int) -> None:
        upto = min(upto, self.waves - 1)
        if self._submitted > upto:
            return
        if self._pool is None:
            self._pool = cf.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mrtorch-feeder")
        for w in range(self._submitted, upto + 1):
            self._futs[w] = self._pool.submit(self._put_wave, w)
            if w not in self._accounted:
                self._accounted.add(w)
                self.held_bytes += self._wave_nbytes
                self.peak_held_bytes = max(self.peak_held_bytes,
                                           self.held_bytes)
        self._submitted = upto + 1

    def start(self) -> None:
        """Submit the first *prefetch* uploads without waiting."""
        self._ensure_submitted(self.prefetch - 1)

    def get(self, w: int) -> torch.Tensor:
        """Wave *w*, ``[k * P_local, ...]``, ready for the caller's
        stream."""
        self._ensure_submitted(w + self.prefetch - 1)
        if w not in self._ready:
            wave = self._futs.pop(w).result()
            if self._cuda:
                wave, start, done = wave
                self._copies[w] = (start, done)
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(done)
                wave.record_stream(compute)
            self._ready[w] = wave
        return self._ready[w]

    def copy_events(self, w: int) -> Optional[tuple]:
        """The ``(start, done)`` timing events around wave *w*'s copy
        (CUDA, once :meth:`get` resolved it), else None."""
        return self._copies.pop(w, None)

    def synchronize(self) -> None:
        """Return once every copy issued so far has landed."""
        if self._cuda:
            self._stream.synchronize()

    def release(self, w: int) -> None:
        self._ready.pop(w, None)
        self._copies.pop(w, None)
        if w in self._accounted:
            self._accounted.discard(w)
            self.held_bytes -= self._wave_nbytes

    def reset(self) -> None:
        self.close()
        self._submitted = 0

    def close(self) -> None:
        for f in self._futs.values():
            f.cancel()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._futs.clear()
        self._ready.clear()
        self._copies.clear()
        self._accounted.clear()
        self.held_bytes = 0


class DeviceEngine:
    """Run-many device MapReduce over ``P`` partitions on one device."""

    #: target host bytes per wave (the JAX engine's wave split, kept so
    #: both cut a corpus into the same waves)
    WAVE_BYTES = 48 << 20
    #: waves a streaming run uploads ahead of the one it computes
    STREAM_PREFETCH = 2

    def __init__(self, parts: Partitions, map_fn: Callable,
                 config: EngineConfig = EngineConfig(),
                 task: str = "-", autotune=None) -> None:
        _check_impls(config)
        self.device = parts.device
        self.parts = parts
        #: the global partition count, and this process's share of it:
        #: partitions [p_lo, p_lo + n_local) (all of them without a
        #: process group)
        self.n_dev = parts.n
        self.group = parts.group
        self.p_lo = parts.lo
        self.n_local = parts.n_local
        self.map_fn = map_fn
        self.config = config
        #: the observe->act loop (engine/autotune.AutoTuner): None (the
        #: default) records no decision and pre-sizes no capacity
        self.autotune = autotune
        #: the owning task's label ("-" outside the task machinery): the
        #: task of every control decision this engine's runs record
        self.task_label = task or "-"
        #: the bucket->partition table (partition_map configs only):
        #: host copy, and its device copy made at first use
        self._pmap_host: Optional[np.ndarray] = None
        self._pmap_dev: Optional[torch.Tensor] = None
        if config.partition_map:
            partition_buckets_for(config, self.n_dev)  # raises if P ∤ B
        #: the dtype of the map's value lanes: None until a wave's map
        #: emits them (a callable op's monoid library is typed by it)
        self.value_dtype: Optional[torch.dtype] = None
        if (self.device.type == "cuda" and callable(config.reduce_op)
                and not config.unit_values):
            # raises now for a monoid the kernel cannot take
            _monoid.check_lowers(config.reduce_op)
        self._tier_spec: Optional[TierSpecializer] = None
        #: (config key, row shape, dtype, k) of each wave program this
        #: engine acquired through the compile ledger
        self._acquired: set = set()

    @property
    def specializer(self) -> TierSpecializer:
        """The engine's one background tier-1 build thread (made at first
        use)."""
        if self._tier_spec is None:
            self._tier_spec = TierSpecializer()
        return self._tier_spec

    def autotune_key(self) -> str:
        """The capacity controller's learning key: everything that
        identifies the PROGRAM FAMILY minus the capacities themselves
        (two runs of one workload at different capacities, or a run and
        a session of it, must share a key, or nothing would ever be
        learned across a resize).  The JAX package's spelling."""
        cfg = self.config
        return "|".join([
            op_token(self.map_fn),
            op_token(cfg.reduce_op)
            if callable(cfg.reduce_op) else str(cfg.reduce_op),
            str(cfg.unit_values), str(cfg.combine_in_scan),
            str(cfg.sort_impl), str(cfg.tile), str(self.n_dev)])

    # -- the partition map ---------------------------------------------------

    @property
    def partition_buckets(self) -> int:
        return partition_buckets_for(self.config, self.n_dev)

    def partition_map(self) -> np.ndarray:
        """The current bucket->partition table (host copy); identity
        until :meth:`set_partition_map`."""
        if self._pmap_host is None:
            self._pmap_host = identity_pmap(self.partition_buckets,
                                            self.n_dev)
        return self._pmap_host

    def set_partition_map(self, pmap) -> None:
        """Install a table for future runs (needs ``config.
        partition_map``), checked loudly: the table is the partition
        function."""
        if not self.config.partition_map:
            raise ValueError("set_partition_map needs "
                             "EngineConfig.partition_map=True")
        self._pmap_host = validate_partition_map(
            pmap, self.partition_buckets, self.n_dev)
        self._pmap_dev = None

    def device_pmap(self) -> torch.Tensor:
        """The table on the engine's device."""
        if self._pmap_dev is None:
            self._pmap_dev = torch.from_numpy(
                self.partition_map().copy()).to(self.device)
        return self._pmap_dev

    # -- the wave ------------------------------------------------------------

    def _map_partition(self, cfg: EngineConfig, chunks: torch.Tensor,
                       first_index: int, n_real: int):
        """Steps 1-2 for one partition's ``k`` chunks: the map loop (with
        the in-scan combiner) and the local reduce.  Returns ``(local,
        local_oflow, map_oflow, comb_max, T)``, T the record slots
        ``map_fn`` emits a chunk."""
        local_op, local_unit, _ = _stage_ops(cfg)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        map_oflow, comb_oflow, comb_max = zero, zero, zero
        bk, bv, bp = [], [], []
        for j in range(chunks.shape[0]):
            idx = first_index + j
            keys, vals, pay, valid, m_oflow = self.map_fn(chunks[j], idx, cfg)
            if vals.dtype != self.value_dtype:
                self._learn_value_dtype(cfg, vals.dtype)
            T = keys.shape[0]
            # chunks past n_real are padding: their records are masked
            live = idx < n_real
            if live:
                map_oflow = map_oflow + m_oflow
            else:
                valid = torch.zeros_like(valid)
            if cfg.combine_in_scan:
                Tc = cfg.scan_combine_slots(keys.shape[0])
                cu = sorted_unique_reduce(
                    keys, vals, pay, valid, Tc, cfg.reduce_op,
                    unit_values=cfg.unit_values, sort_impl=cfg.sort_impl)
                keys, vals, pay, valid = (cu.keys, cu.values, cu.payload,
                                          cu.valid)
                comb_oflow = comb_oflow + (cu.n_unique - Tc).clamp(min=0)
                comb_max = torch.maximum(comb_max, cu.n_unique)
            # a valid record whose key is the sentinel pair becomes (0, 0);
            # invalid rows become the sentinel pair (they sort last)
            is_sent = (keys[:, 0] == SENTINEL) & (keys[:, 1] == SENTINEL)
            keys = torch.where(is_sent[:, None], 0, keys)
            bk.append(torch.where(valid[:, None], keys, SENTINEL))
            bv.append(vals)
            bp.append(pay)
        buf_k = torch.cat(bk)
        buf_valid = ~((buf_k[:, 0] == SENTINEL) & (buf_k[:, 1] == SENTINEL))
        local = sorted_unique_reduce(
            buf_k, torch.cat(bv), torch.cat(bp), buf_valid,
            cfg.local_capacity, local_op, unit_values=local_unit,
            sort_impl=cfg.sort_impl)
        local_oflow = (map_oflow + comb_oflow
                       + (local.n_unique - cfg.local_capacity).clamp(min=0))
        return local, local_oflow, map_oflow, comb_max, T

    def _learn_value_dtype(self, cfg: EngineConfig,
                           dtype: torch.dtype) -> None:
        """Note *dtype*, the map's value lanes', and on CUDA load the
        libraries of *cfg*'s path typed by it (a callable op's monoid
        library) before any reduce: each fresh load is a compile-ledger
        acquisition of its ``nvcc`` build.  The map's output names the
        library, as ``jax.eval_shape`` of the map does in the JAX
        engine, so it is loaded here and not with the wave program."""
        self.value_dtype = dtype
        if self.device.type == "cuda":
            kc.load(kc.sources_for(cfg, self.device, dtype), observe=True)

    def _acc_zeros(self, cfg: EngineConfig, values: torch.Tensor,
                   payload: torch.Tensor) -> tuple:
        """An all-invalid accumulator ``[P_local, C, ...]`` whose value
        and payload lanes are shaped like *values* / *payload* rows
        (``[n, ...]``), with the zeroed global ``[P, P]`` traffic lane
        under ``exchange_stats``."""
        P, C, dev = self.n_dev, cfg.out_capacity, self.device
        PL = self.n_local
        acc = (torch.zeros((PL, C, 2), dtype=torch.int32, device=dev),
               torch.zeros((PL, C) + tuple(values.shape[1:]),
                           dtype=values.dtype, device=dev),
               torch.zeros((PL, C) + tuple(payload.shape[1:]),
                           dtype=payload.dtype, device=dev),
               torch.zeros((PL, C), dtype=torch.bool, device=dev))
        if cfg.exchange_stats:
            acc += (torch.zeros((P, P), dtype=torch.int32, device=dev),)
        return acc

    def _wave(self, cfg: EngineConfig, chunks: torch.Tensor, first: int,
              k: int, n_real: int, acc, pmap=None) -> _Wave:
        """One wave over ``chunks [k*P_local, L]`` (this process's
        partitions' rows of the wave), folding into *acc* (None on the
        first wave).  *first* is the global chunk index of the wave's
        first row and *n_real* the mask bound (rows at or past it are
        padding); *pmap* is the ``[B]`` bucket->partition table on the
        device (``partition_map`` configs)."""
        lo = self.p_lo
        _, _, fin_op = _stage_ops(cfg)
        mapped = [self._map_partition(cfg, chunks[i * k:(i + 1) * k],
                                      first + (lo + i) * k, n_real)
                  for i in range(self.n_local)]
        locals_ = [m[0] for m in mapped]

        def stacked(field):
            return torch.stack([getattr(u, field) for u in locals_])

        if acc is None:  # all-invalid accumulator shaped like the fold
            acc = self._acc_zeros(cfg, locals_[0].values,
                                  locals_[0].payload)
        ex = partition_exchange(
            stacked("keys"), stacked("values"), stacked("payload"),
            stacked("valid"), cfg.exchange_capacity, carry=acc[:4],
            pmap=pmap,
            # the radix program plans the exchange on the radix kernels
            impl="radix" if cfg.sort_impl == "radix" else "lax",
            group=self.group)
        fins, oflows, needs = [], [], []
        for i in range(self.n_local):
            fin = sorted_unique_reduce(
                ex.keys[i], ex.values[i], ex.payload[i], ex.valid[i],
                cfg.out_capacity, fin_op, unit_values=False,
                sort_impl=cfg.sort_impl)
            local, local_oflow, map_oflow, comb_max, _ = mapped[i]
            fin_oflow = (fin.n_unique - cfg.out_capacity).clamp(min=0)
            fins.append(fin)
            oflows.append(local_oflow + ex.overflow[lo + i] + fin_oflow)
            # capacity needs: [local uniques, exchange per-dest max,
            # final uniques (cumulative), map drops, combiner max]
            needs.append(torch.stack([local.n_unique,
                                      ex.max_count[lo + i],
                                      fin.n_unique, map_oflow, comb_max]))
        new_acc = tuple(torch.stack([getattr(f, n) for f in fins])
                        for n in ("keys", "values", "payload", "valid"))
        if cfg.exchange_stats:
            new_acc += (acc[4] + ex.counts,)
        return _Wave(new_acc, torch.stack(oflows), torch.stack(needs),
                     int(mapped[0][4]))

    # -- a process group's host decisions ---------------------------------

    def _attempt_overflow(self, oflows, needs):
        """The attempt's total dropped rows (its one readback), and over
        a process group the capacity needs as ``[1, 1, 5]`` host values
        all-reduced over the ranks (maxima, and the sum of the map
        drops), so that every rank sizes the retry alike; None
        without a group (the needs are read only on a retry)."""
        if self.group is None:
            return int(torch.stack(oflows).sum()), None
        import torch.distributed as dist

        nd = torch.stack(needs).to(torch.int64)           # [W, PL, 5]
        sums = torch.stack([torch.stack(oflows).to(torch.int64).sum(),
                            nd[..., 3].sum()]).cpu()
        maxes = nd[..., [0, 1, 2, 4]].amax(dim=(0, 1)).cpu()
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=self.group)
        dist.all_reduce(maxes, op=dist.ReduceOp.MAX, group=self.group)
        m = maxes.tolist()
        return int(sums[0]), np.array([[[m[0], m[1], m[2],
                                         int(sums[1]), m[3]]]])

    def _gather_result(self, acc, cfg: EngineConfig, total_oflow: int):
        """``(DeviceResult over all P partitions, the [P, P] traffic
        matrix or None, live rows [P])`` on every rank of the group:
        each rank's live prefix, all-gathered (the JAX engine's
        ``_host``)."""
        from ..parallel.shuffle import all_gather_rows

        keys, vals, pay, valid = acc[:4]
        (n_live,) = all_gather_rows(
            [valid.sum(dim=1).to(torch.int32)[:, None]], self.group)
        n_live = n_live[:, 0]
        width = max(1, int(n_live.max()))
        parts = all_gather_rows([t[:, :width] for t in
                                 (keys, vals, pay, valid)], self.group)
        traffic = acc[4].cpu() if cfg.exchange_stats else None
        return DeviceResult(*parts, total_oflow), traffic, n_live

    # -- the cost model (obs/profile) ------------------------------------------

    def _program_costs(self, cfg: EngineConfig, shapes, records: int,
                       ) -> dict:
        """FLOPs and bytes of ONE wave, by the analytic model
        (``source="analytic"``: there is no compiler cost model to read)
        of the program that ran: the wave's input block and record width
        from its arrays (*shapes*: the block, then the accumulator
        lanes), *records* slots a chunk, the fold re-sorting all P
        partitions' accumulators, the port's radix pass count, and on
        CUDA the segmented-reduce kernel whatever ``segment_impl`` says
        (the device picks the route)."""
        block, _, vals, pay = shapes[:4]
        chunk_rows = int(block.shape[0])
        input_bytes = (chunk_rows * int(np.prod(block.shape[1:]))
                       * block.dtype.itemsize)
        Q = int(pay.shape[2]) if len(pay.shape) > 2 else 1
        val_bytes = (int(np.prod(vals.shape[2:])) or 1) * vals.dtype.itemsize
        costs = _profile.analytic_costs(
            input_bytes, chunk_rows * int(records), 8 + val_bytes + 4 * Q + 1,
            fold_records=self.n_local * cfg.out_capacity,
            argsort=cfg.sort_impl == "argsort",
            segment_impl=("pallas" if self.device.type == "cuda"
                          else cfg.segment_impl),
            sort_impl=cfg.sort_impl, radix_passes=RADIX_PASSES)
        costs["source"] = "analytic"
        return costs

    # -- host driver -----------------------------------------------------------

    def _rows_per_wave(self, row_bytes: int) -> int:
        return max(1, round(self.WAVE_BYTES / max(1, row_bytes)))

    def _auto_rows(self, chunks: np.ndarray) -> int:
        """Chunks per partition per wave: a fixed function of the row
        byte size, shrunk only for inputs smaller than one wave."""
        S = chunks.shape[0]
        row_bytes = max(1, chunks.nbytes // max(1, S))
        return min(self._rows_per_wave(row_bytes), -(-S // self.n_dev))

    @staticmethod
    def _fit(need: int) -> int:
        """Round a measured need up to a power of two with ~25% margin."""
        need = int(need * 1.25) + 16
        return 1 << max(need - 1, 1).bit_length()

    def _resize(self, cfg: EngineConfig, needs: np.ndarray) -> EngineConfig:
        """Right-size capacities from a failed attempt's needs ``[W, P,
        5]``; needs are lower bounds when an earlier stage truncated, so
        the loop may take another pass.  Never shrinks a capacity."""
        local_need = int(needs[:, :, 0].max())
        ex_need = int(needs[:, :, 1].max())
        fin_need = int(needs[:, :, 2].max())
        map_dropped = int(needs[:, :, 3].sum())
        comb_need = int(needs[:, :, 4].max())
        out = replace(
            cfg,
            local_capacity=max(cfg.local_capacity, self._fit(local_need)),
            exchange_capacity=max(cfg.exchange_capacity, self._fit(ex_need)),
            out_capacity=max(cfg.out_capacity, self._fit(fin_need)),
            tile_records=(min(cfg.tile_records * 2, cfg.tile)
                          if map_dropped else cfg.tile_records))
        if cfg.combine_in_scan and comb_need > 0:
            out = replace(out, combine_capacity=max(cfg.combine_capacity,
                                                    self._fit(comb_need)))
        return out

    def _libraries(self, cfg: EngineConfig):
        """The libraries a run of *cfg* launches: both tiers' under a
        tier policy."""
        cfgs = _tier_cfgs(cfg) if _is_tiered(cfg.sort_impl) else (cfg,)
        return tuple(dict.fromkeys(
            n for c in cfgs
            for n in kc.sources_for(c, self.device, self.value_dtype)))

    # -- the compile ledger ------------------------------------------------

    def _replay_info(self, cfg: EngineConfig, row_shape, row_dtype,
                     k: int) -> Optional[dict]:
        """The shape registry's replay spec (the JAX engine's
        ``_replay_info``): enough to rebuild this engine and precompile
        this program in a fresh process.  None when it cannot replay: a
        map_fn that is not importable by name, or a callable reduce op.
        A per-lane tuple op is recorded as a list."""
        path = _compile_obs.fn_path(self.map_fn)
        if path is None or callable(cfg.reduce_op):
            return None
        config = asdict(cfg)
        if isinstance(cfg.reduce_op, tuple):
            config["reduce_op"] = list(cfg.reduce_op)
        return {"kind": "device_engine", "map_fn": path, "config": config,
                "k": int(k), "row_shape": [int(d) for d in row_shape],
                "row_dtype": str(np.dtype(row_dtype)), "n_dev": self.n_dev}

    def _sizing(self, cfg: EngineConfig) -> Optional[dict]:
        """The capacities of a bucket that cannot replay (a callable
        reduce op): the map_fn's path and the config's capacities, from
        which the capacity controller pre-sizes the map_fn's next run
        (``engine/autotune``).  None for a map_fn that is not importable
        by name."""
        path = _compile_obs.fn_path(self.map_fn)
        return (None if path is None
                else {"map_fn": path, "config": _capacities(cfg)})

    def _mesh_doc(self) -> dict:
        kind = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        return {"n_devices": self.n_dev, "device_kind": kind,
                "platform": self.device.type}

    def _acquire(self, cfg: EngineConfig, row_shape, row_dtype,
                 k: int, registry: Optional[dict] = None,
                 pending: Optional[list] = None) -> None:
        """The wave program of concrete *cfg* for waves of ``k * P`` rows
        of *row_shape*: the libraries of its path loaded (on CUDA; a
        callable op's typed monoid library comes with the map's first
        output, :meth:`_learn_value_dtype`), once per engine, through
        the compile ledger (``cached`` when another
        engine of this process acquired the same program).  A run's wave
        loop passes the shape *registry* it read before the attempt and
        a *pending* list that takes ``(bucket, outcome)`` for the
        registry write after the attempt's readback, so that the loop
        does no file I/O; otherwise the registry is read and written
        here."""
        row_shape = tuple(int(d) for d in row_shape)
        dtype = np.dtype(row_dtype)
        mine = (cfg.cache_key(), row_shape, dtype.str, int(k))
        if mine in self._acquired:
            return
        libs = kc.sources_for(cfg, self.device)
        replay = self._replay_info(cfg, row_shape, dtype, k)
        build = ((lambda: kc.load(libs, observe=True))
                 if self.device.type == "cuda" else (lambda: None))
        _, outcome, bucket = _compile_obs.LEDGER.acquire(
            "wave", build,
            key=("wave", self.map_fn, cfg.cache_key(), self.n_dev,
                 str(self.device)) + mine[1:],
            avals=[_Aval((int(k) * self.n_dev,) + row_shape, dtype)],
            extra=("wave", op_token(self.map_fn), _cfg_token(cfg)),
            mesh=self._mesh_doc(),
            replay=replay, sizing=None if replay else self._sizing(cfg),
            tier=_TIERS.get(cfg.sort_impl), registry=registry,
            persist=pending is None)
        if pending is not None:
            pending.append((bucket, outcome))
        self._acquired.add(mine)

    def precompile(self, row_shape, row_dtype=np.uint8,
                   k: Optional[int] = None) -> float:
        """Acquire the wave program for rows of *row_shape* (``k`` chunks
        a partition a wave; default the auto split of a full wave)
        through the compile ledger: build and load the CUDA libraries of
        the config's path (both tiers' under a tier policy; one ``nvcc``
        per source, in parallel), returning the seconds spent; a
        callable op's monoid library only once a run has shown the map's
        value dtype, which types it.  The
        counterpart of the JAX engine's AOT compile: nothing of a corpus
        is launched.  On the CPU there is nothing to build, and only the
        ledger's record is made."""
        t0 = time.monotonic()
        if k is None:
            row_bytes = int(np.dtype(row_dtype).itemsize
                            * np.prod(row_shape))
            k = self._rows_per_wave(row_bytes)
        cfg = self.config
        if self.device.type == "cuda":  # every tier's libraries at once
            kc.load(self._libraries(cfg))
        for c in _tier_cfgs(cfg) if _is_tiered(cfg.sort_impl) else (cfg,):
            self._acquire(c, row_shape, row_dtype, k)
        return time.monotonic() - t0

    def stage_inputs(self, chunks: np.ndarray, waves: Optional[int] = None):
        """Upload every wave of *chunks* now, returning once the bytes
        are resident on the device (on CUDA a synchronize of the copy
        stream proves it), with a handle for ``run(staged=...)``: the
        list of wave tensors and the true chunk count.

        The handle holds the whole corpus in device memory, unlike a
        streaming run (~:attr:`STREAM_PREFETCH` waves); it is single-use:
        :meth:`run` empties its list and frees each wave after its
        fold."""
        if waves is None:
            feeder = _WaveFeeder(self, chunks, k=self._auto_rows(chunks))
        else:
            feeder = _WaveFeeder(self, chunks, max(1, waves))
        try:
            staged = [feeder.get(w) for w in range(feeder.waves)]
            feeder.synchronize()
        finally:
            feeder.close()
        return staged, feeder.S

    def run(self, chunks: Optional[np.ndarray], max_retries: int = 3,
            timings: Optional[dict] = None, waves: Optional[int] = None,
            staged=None, on_overflow: str = "raise") -> DeviceResult:
        """Execute over *chunks* (``[S, ...]`` host array), growing
        capacities until no stage overflowed.

        *waves* (default: auto from the input size) splits the chunks
        into waves of ``k`` chunks per partition; the accumulator carries
        each partition's uniques from wave to wave.  A streaming run
        uploads through :class:`_WaveFeeder`, at most
        :attr:`STREAM_PREFETCH` waves ahead, so copies overlap the
        previous wave's kernels.  With *staged* (from
        :meth:`stage_inputs`) the handle fixes the data and its wave
        split (passing *waves* too raises ``ValueError``); the handle is
        consumed (a consumed one raises ``RuntimeError``), each wave
        freed after its fold, and a capacity retry re-uploads from
        *chunks*, which must then be the handle's source array.

        Pass ``timings={}`` for, by the JAX package's names:
        ``upload_s`` (host time blocked waiting for a wave) and
        ``total_s``, streaming runs only; ``retry_upload_s`` when a
        staged run re-uploaded; ``compute_s`` (the attempts' wall time
        minus upload waits, ending in the overflow readback that waits
        for the device), ``readback_s``, ``waves``, ``retries``;
        ``first_dispatch_s`` (run entry to the first wave's first launch,
        including any library build the serving tier waited for);
        ``peak_input_wave_bytes`` and ``input_bytes`` when a feeder ran;
        under a tier policy ``tier_swaps``, ``tier_cold_start``,
        ``serving_tier`` (``"0"``, ``"1"`` or ``"radix"``) and
        ``tier_specialize_failed`` (the failure message or None); and,
        with ``exchange_stats``, ``exchange["matrix"]``: the final
        attempt's src x dst count of routed rows, summed over waves.

        If capacities still overflow after *max_retries* right-sized
        retries, raises ``RuntimeError``; ``on_overflow="return"`` returns
        the truncated result (``overflow`` > 0) instead."""
        if staged is not None and waves is not None:
            raise ValueError("run(staged=...) uses the handle's wave "
                             "split; pass waves to stage_inputs instead")
        if on_overflow not in ("raise", "return"):
            raise ValueError(f"on_overflow must be 'raise' or 'return', "
                             f"got {on_overflow!r}")
        cfg = self.config
        if self.autotune is not None:
            # the capacity controller pre-sizes this run from what
            # earlier runs of the program family learned (the decision
            # lands in the control ledger)
            cfg = self.autotune.recommend_config(
                cfg, self.autotune_key(), task=self.task_label)
        P = self.n_dev
        t_start = time.monotonic()
        feeder = None
        pairs = None  # the staged waves, consumed in place
        if staged is not None:
            staged_list, S = staged
            W = len(staged_list)
            if W == 0:
                raise RuntimeError(
                    "staged handle already consumed (handles are "
                    "single-use: each wave is freed as it is folded); "
                    "stage_inputs again for another run")
            pairs = dict(enumerate(staged_list))
            k = staged_list[0].shape[0] // self.n_local
            row_shape = tuple(staged_list[0].shape[1:])
            row_dtype = np.dtype(str(staged_list[0].dtype).replace(
                "torch.", ""))
            staged_list.clear()
        else:
            S = chunks.shape[0]
            k = (self._auto_rows(chunks) if waves is None
                 else -(-S // (max(1, waves) * P)))
            row_shape, row_dtype = chunks.shape[1:], chunks.dtype
            feeder = _WaveFeeder(self, chunks, k=k,
                                 prefetch=self.STREAM_PREFETCH)
            W = feeder.waves
        rpw = k * P
        tiered = _is_tiered(cfg.sort_impl)
        cuda = self.device.type == "cuda"
        task = self.task_label
        t_upload = t_compute = t_attempt_compute = 0.0
        t_first_dispatch = None
        reuploaded = False
        retries = 0
        uploads, busy = [], []
        try:
            for attempt in range(max_retries + 1):
                disp = TieredWaveDispatcher(self, cfg) if tiered else None
                # the shape registry is read before the attempt and
                # written after its readback, outside compute_s
                registry = _compile_obs.LEDGER.disk_buckets()
                acquired: list = []
                t0 = time.monotonic()
                t_blocked = 0.0
                acc = None
                oflows, needs = [], []
                # the first wave's arrays (the memory model's) and the
                # last wave's config (the cost model's), per attempt
                cost_shapes = cost_cfg = None
                records = 0
                pmap = self.device_pmap() if cfg.partition_map else None
                line = WaveTimeline(self.device, attempt, W, t0,
                                    histogram=_WAVE_SECONDS)
                try:
                    if feeder is not None:  # uploads overlap any build
                        feeder.start()
                    for w in range(W):
                        # the tier decision (and a cold tier's builds) at
                        # the wave boundary, then the libraries of the
                        # serving config: built at the first wave, found
                        # loaded later
                        wave_cfg = disp.next_cfg() if disp is not None else cfg
                        self._acquire(wave_cfg, row_shape, row_dtype, k,
                                      registry, acquired)
                        tb = time.monotonic()
                        if pairs is not None:
                            block = pairs.pop(w)
                            if cuda:  # the kernels' stream frees it
                                block.record_stream(
                                    torch.cuda.current_stream(self.device))
                            copy = None
                        else:
                            block = feeder.get(w)
                            copy = feeder.copy_events(w)
                        t_up = time.monotonic()
                        t_blocked += t_up - tb
                        line.wave(w, tb, t_up, copy)
                        if t_first_dispatch is None:
                            t_first_dispatch = time.monotonic()
                        line.compute_begin()
                        out = self._wave(wave_cfg, block, w * rpw, k, S, acc,
                                         pmap)
                        line.compute_end()
                        _DISPATCHES.inc(1, program="wave", task=task)
                        if cost_shapes is None:
                            cost_shapes = [_Aval.of(t) for t in
                                           (block, *out.acc)
                                           + ((pmap,) if pmap is not None
                                              else ())]
                        cost_cfg, records = wave_cfg, out.records
                        del block
                        if feeder is not None:
                            feeder.release(w)
                        acc = out.acc
                        oflows.append(out.overflow)
                        needs.append(out.needs)
                        # the allocator's counters on CUDA (host reads),
                        # else the input waves held plus the accumulator
                        held = feeder.held_bytes if feeder is not None else 0
                        _memory_obs.sample_device_memory(
                            [self.device], analytic_bytes_in_use=held + sum(
                                t.numel() * t.element_size() for t in acc))
                    # the one readback of the attempt: waits for the
                    # device; every wave span closes here
                    tr0 = time.monotonic()
                    total_oflow, group_needs = self._attempt_overflow(
                        oflows, needs)
                    tr1 = time.monotonic()
                except BaseException:
                    line.abort()
                    raise
                uploads, busy = line.finish(tr0, tr1)
                t_upload += t_blocked
                t_attempt_compute = time.monotonic() - t0 - t_blocked
                t_compute += t_attempt_compute
                for bucket, outcome in acquired:
                    _compile_obs.LEDGER.persist(bucket, outcome)
                if total_oflow == 0 or attempt == max_retries:
                    break
                retries = attempt + 1
                new_cfg = self._resize(
                    cfg, group_needs if group_needs is not None
                    else torch.stack(needs).cpu().numpy())
                # capacity-retry forensics: the attempt's program
                # footprint and the device's memory state, classified
                _memory_obs.capacity_retry_event(
                    task=task, attempt=attempt, overflow_rows=total_oflow,
                    program_memory_doc=_memory_obs.analytic_program_memory(
                        cost_shapes),
                    devices=[self.device],
                    old_capacities=_capacities(cfg),
                    new_capacities=_capacities(new_cfg))
                if self.autotune is not None:
                    # the controller learns the right-sized capacities,
                    # so the NEXT run (or session) starts there
                    self.autotune.note_retry(
                        self.autotune_key(), _capacities(cfg),
                        _capacities(new_cfg), task=task)
                cfg = new_cfg
                del acc
                # the inputs were freed wave by wave: the retry re-uploads
                if pairs is not None:
                    if chunks is None:
                        raise RuntimeError(
                            "capacity retry needs the input re-uploaded, "
                            "but the staged handle is consumed and no "
                            "chunks were passed; call run(chunks, "
                            "staged=handle) with the handle's source "
                            "array")
                    if chunks.shape[0] != S:
                        raise ValueError(
                            f"chunks has {chunks.shape[0]} rows, the "
                            f"staged handle {S}")
                    feeder = _WaveFeeder(self, chunks, k=k,
                                         prefetch=self.STREAM_PREFETCH)
                    pairs = None
                    reuploaded = True
                else:
                    feeder.reset()
        finally:
            if feeder is not None:
                feeder.close()
            if pairs:
                pairs.clear()
        if self.autotune is not None:
            # the next control window's measurement: zero retries after
            # a pre-sized start resolves the pending capacity decision
            self.autotune.note_run(self.autotune_key(), retries, task=task)
        if total_oflow and on_overflow == "raise":
            raise RuntimeError(
                f"device run still overflowed {total_oflow} rows after "
                f"{retries} right-sized retries; raise EngineConfig "
                "capacities (or max_retries), or pass on_overflow='return' "
                "to inspect the truncated result")
        # sliced readback: only the live prefix of each partition's
        # result.  The exchange traffic matrix rides the SAME n_live
        # fetch (one [P + 1, P] copy, not a second readback).
        t0 = time.monotonic()
        keys, vals, pay, valid = acc[:4]
        traffic_h = None
        with TRACER.span("readback", stage="result"):
            if self.group is not None:
                result, traffic_h, n_live = self._gather_result(
                    acc, cfg, total_oflow)
            else:
                if cfg.exchange_stats:
                    both = torch.cat([acc[4], valid.sum(dim=1).to(
                        acc[4].dtype).unsqueeze(0)]).cpu()
                    traffic_h, n_live = both[:P], both[P]
                else:
                    n_live = valid.sum(dim=1).cpu()
                width = max(1, int(n_live.max()))
                result = DeviceResult(keys[:, :width].cpu(),
                                      vals[:, :width].cpu(),
                                      pay[:, :width].cpu(),
                                      valid[:, :width].cpu(), total_oflow)
        t_readback = time.monotonic() - t0
        _WAVES.inc(W, task=task)
        _RETRIES.inc(retries, task=task)
        _STAGE_SECONDS.inc(t_upload, stage="upload", task=task)
        _STAGE_SECONDS.inc(t_compute, stage="compute", task=task)
        _STAGE_SECONDS.inc(t_readback, stage="readback", task=task)
        # per-partition skew inputs: live rows and their byte mass
        row_bytes = sum(t.element_size() * int(np.prod(t.shape[2:]))
                        for t in result[:3])
        for p, n in enumerate(n_live.tolist()):
            _PARTITION_RECORDS.set(n, task=task, partition=f"P{p:05d}")
            _PARTITION_BYTES.set(n * row_bytes, task=task,
                                 partition=f"P{p:05d}")
        # comms observability (obs/comms): the run's exchange traffic
        # matrix -> per-(src,dst) counters, imbalance gauges, the
        # link-class roll-up and the modeled exchange seconds against
        # the final attempt's compute (the matrix is already host data).
        # Over a process group every rank holds the identical matrix and
        # the collector sums counter families across processes, so only
        # rank 0 publishes (the timings carry it everywhere)
        comms_derived = {}
        if traffic_h is not None:
            comms_derived = _comms.record_exchange(
                traffic_h.tolist(), row_bytes=row_bytes, task=task,
                devices=partition_devices(P, self.device, self.parts.world),
                compute_s=t_attempt_compute,
                publish=self.parts.rank == 0)
        overlap = _comms.record_upload_overlap(
            _comms.overlap_fraction(uploads, busy), task=task)
        derived = {}
        if cost_shapes is not None:
            # the final attempt's program: its costs over the final
            # attempt's compute seconds (the MFU clock)
            derived = _profile.record_run(
                self._program_costs(cost_cfg, cost_shapes, records),
                waves=W, compute_s=t_attempt_compute, n_dev=1,
                device=_profile.describe_device(self.device), task=task)
            mem = _memory_obs.analytic_program_memory(cost_shapes)
            _memory_obs.record_program_memory("wave", mem)
            derived["program_memory_bytes"] = int(mem["total"])
            derived["memory_source"] = mem["source"]
        if timings is not None:
            timings.update(derived)
            timings.update(comms_derived)
            timings["upload_overlap_frac"] = round(overlap, 4)
            timings["waves"] = W
            timings["retries"] = retries
            timings["compute_s"] = t_compute
            timings["readback_s"] = t_readback
            timings["first_dispatch_s"] = t_first_dispatch - t_start
            if staged is None:
                timings["upload_s"] = t_upload
                timings["total_s"] = time.monotonic() - t_start
            elif reuploaded:
                timings["retry_upload_s"] = t_upload
            if feeder is not None:
                timings["peak_input_wave_bytes"] = feeder.peak_held_bytes
                timings["input_bytes"] = int(chunks.nbytes)
            if tiered:
                timings["tier_swaps"] = disp.swaps
                timings["tier_cold_start"] = disp.cold
                timings["serving_tier"] = disp.tier_label
                timings["tier_specialize_failed"] = disp.failed
        return result


# -- shape-registry replay (cli warmup --replay) -----------------------------


def replay_registry(registry_dir: Optional[str] = None,
                    device=None) -> list:
    """Precompile EVERY replayable bucket of the shape registry
    (:mod:`..obs.compile`) in *registry_dir* (default: the enabled
    cache's) on *device* (``None`` means ``"cuda"``): the full warm
    start, not just the word count's default (the JAX package's
    ``replay_registry``).  A bucket replays when it recorded a
    ``device_engine`` replay spec (an importable map_fn, a string or
    per-lane reduce op) and this port's torch version key, so the JAX
    package's buckets in a shared directory are skipped unimported; each
    replays on its own recorded partition
    count, which one card always offers (the JAX function skips a
    bucket recorded for another mesh size).  Anything else is reported
    as skipped with the reason, never dropped.  Returns one result dict
    per bucket: ``bucket``, ``program``, ``tier``, and ``seconds`` or
    ``skipped``."""
    results = []
    engines: dict = {}
    for bucket, rec in sorted(
            _compile_obs.LEDGER.disk_buckets(registry_dir).items()):
        row = {"bucket": bucket, "program": rec.get("program"),
               "tier": rec.get("tier")}
        spec = rec.get("replay")
        if not isinstance(spec, dict) or spec.get("kind") != "device_engine":
            row["skipped"] = "no replay spec recorded"
            results.append(row)
            continue
        # a shared cache dir ($MAPREDUCE_TPU_CACHE) may hold the JAX
        # package's buckets too: they carry no torch version, and their
        # map_fn must not be imported here
        owner = str(spec.get("map_fn", "")).partition(":")[0]
        if "torch" not in rec or owner.split(".")[0] == "mapreduce_tpu":
            row["skipped"] = (f"not this port's bucket (map_fn "
                              f"{spec.get('map_fn')!r}): the JAX "
                              "package's are not replayed here")
            results.append(row)
            continue
        try:
            map_fn = _compile_obs.resolve_fn(spec["map_fn"])
            fields = dict(spec["config"])
            if isinstance(fields.get("reduce_op"), list):
                fields["reduce_op"] = tuple(fields["reduce_op"])
            cfg = EngineConfig(**fields)
            n_dev = int(spec["n_dev"])
            ekey = (spec["map_fn"], _cfg_token(cfg), n_dev)
            eng = engines.get(ekey)
            if eng is None:
                eng = engines[ekey] = DeviceEngine(
                    Partitions(n_dev, device), map_fn, cfg)
            row["seconds"] = eng.precompile(
                tuple(spec["row_shape"]), np.dtype(spec["row_dtype"]),
                k=int(spec["k"]))
        except Exception as exc:  # a bad bucket must not stop the rest
            row["skipped"] = f"replay failed: {exc}"
        results.append(row)
    return results
