"""Device MapReduce with a monoid reduce (port of ``engine/device_engine.py``).

The user gives ``map_fn(chunk, chunk_index, cfg) -> (keys [T, 2] int32
bits, values, payload [T, Q] int32, valid [T] bool, overflow [] int32)``
— a fixed-capacity batch of hashed records from one input chunk — and a
``reduce_op``: "sum" / "min" / "max", a tuple of those (one per value
lane), or an associative + commutative callable (CPU only: the CUDA
segmented-reduce kernel takes op codes).

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

Left out of this port for now (ROADMAP): the compile ledger and the
shape registry, the autotune controllers (only ``plan_rebalance`` is
here), the metrics and memory gauges, custom callable monoids on CUDA,
multi-process runs.
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops import kernel_compat as kc
from ..ops.segscan import SENTINEL, ReduceOp, sorted_unique_reduce
from ..parallel.mesh import Partitions
from ..parallel.shuffle import partition_exchange
from .tiering import TierSpecializer, TieredWaveDispatcher


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


def op_token(op) -> str:
    """Stable spelling of a reduce op: strings pass through, functions
    become ``module:qualname`` (the JAX package's ``obs.compile.
    op_token``)."""
    if isinstance(op, str):
        return op
    mod = getattr(op, "__module__", None)
    qual = getattr(op, "__qualname__", None)
    if mod and qual:
        return f"{mod}:{qual}"
    return repr(op)


def _cfg_token(cfg: EngineConfig) -> str:
    """The config's cache key as one string, spelled as the JAX package
    spells it (callables by :func:`op_token`, everything else by
    ``repr``)."""
    return "|".join(op_token(v) if callable(v) else repr(v)
                    for v in cfg.cache_key())


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
    while the kernels still read it.  On the CPU nothing is pinned and
    no stream is used; the wave split and the byte accounting are the
    same.
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
        self._shape = (self.rpw,) + tuple(chunks.shape[1:])
        self._dtype = torch.from_numpy(chunks[:0]).dtype
        self._wave_nbytes = int(np.prod(self._shape, dtype=np.int64)
                                * chunks.dtype.itemsize)
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._futs: dict = {}
        self._ready: dict = {}
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
        lo = w * self.rpw
        n = min(self.rpw, self.S - lo)
        src = torch.from_numpy(self._chunks[lo:lo + n])
        if not self._cuda:
            if n == self.rpw:
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
            dev.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        self._copied[i] = done
        return dev, done

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
        """Wave *w*, ``[k * P, ...]``, ready for the caller's stream."""
        self._ensure_submitted(w + self.prefetch - 1)
        if w not in self._ready:
            wave = self._futs.pop(w).result()
            if self._cuda:
                wave, done = wave
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(done)
                wave.record_stream(compute)
            self._ready[w] = wave
        return self._ready[w]

    def synchronize(self) -> None:
        """Return once every copy issued so far has landed."""
        if self._cuda:
            self._stream.synchronize()

    def release(self, w: int) -> None:
        self._ready.pop(w, None)
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
                 config: EngineConfig = EngineConfig()) -> None:
        _check_impls(config)
        self.device = parts.device
        self.n_dev = parts.n
        self.map_fn = map_fn
        self.config = config
        #: the bucket->partition table (partition_map configs only):
        #: host copy, and its device copy made at first use
        self._pmap_host: Optional[np.ndarray] = None
        self._pmap_dev: Optional[torch.Tensor] = None
        if config.partition_map:
            partition_buckets_for(config, self.n_dev)  # raises if P ∤ B
        self._tier_spec: Optional[TierSpecializer] = None

    @property
    def specializer(self) -> TierSpecializer:
        """The engine's one background tier-1 build thread (made at first
        use)."""
        if self._tier_spec is None:
            self._tier_spec = TierSpecializer()
        return self._tier_spec

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
        local_oflow, map_oflow, comb_max)``."""
        local_op, local_unit, _ = _stage_ops(cfg)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        map_oflow, comb_oflow, comb_max = zero, zero, zero
        bk, bv, bp = [], [], []
        for j in range(chunks.shape[0]):
            idx = first_index + j
            keys, vals, pay, valid, m_oflow = self.map_fn(chunks[j], idx, cfg)
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
        return local, local_oflow, map_oflow, comb_max

    def _acc_zeros(self, cfg: EngineConfig, values: torch.Tensor,
                   payload: torch.Tensor) -> tuple:
        """An all-invalid accumulator ``[P, C, ...]`` whose value and
        payload lanes are shaped like *values* / *payload* rows (``[n,
        ...]``), with the zeroed ``[P, P]`` traffic lane under
        ``exchange_stats``."""
        P, C, dev = self.n_dev, cfg.out_capacity, self.device
        acc = (torch.zeros((P, C, 2), dtype=torch.int32, device=dev),
               torch.zeros((P, C) + tuple(values.shape[1:]),
                           dtype=values.dtype, device=dev),
               torch.zeros((P, C) + tuple(payload.shape[1:]),
                           dtype=payload.dtype, device=dev),
               torch.zeros((P, C), dtype=torch.bool, device=dev))
        if cfg.exchange_stats:
            acc += (torch.zeros((P, P), dtype=torch.int32, device=dev),)
        return acc

    def _wave(self, cfg: EngineConfig, chunks: torch.Tensor, first: int,
              k: int, n_real: int, acc, pmap=None) -> _Wave:
        """One wave over ``chunks [k*P, L]``, folding into *acc* (None on
        the first wave).  *first* is the global chunk index of the first
        row and *n_real* the mask bound (rows at or past it are
        padding); *pmap* is the ``[B]`` bucket->partition table on the
        device (``partition_map`` configs)."""
        P = self.n_dev
        _, _, fin_op = _stage_ops(cfg)
        mapped = [self._map_partition(cfg, chunks[p * k:(p + 1) * k],
                                      first + p * k, n_real)
                  for p in range(P)]
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
            impl="radix" if cfg.sort_impl == "radix" else "lax")
        fins, oflows, needs = [], [], []
        for p in range(P):
            fin = sorted_unique_reduce(
                ex.keys[p], ex.values[p], ex.payload[p], ex.valid[p],
                cfg.out_capacity, fin_op, unit_values=False,
                sort_impl=cfg.sort_impl)
            local, local_oflow, map_oflow, comb_max = mapped[p]
            fin_oflow = (fin.n_unique - cfg.out_capacity).clamp(min=0)
            fins.append(fin)
            oflows.append(local_oflow + ex.overflow[p] + fin_oflow)
            # capacity needs: [local uniques, exchange per-dest max,
            # final uniques (cumulative), map drops, combiner max]
            needs.append(torch.stack([local.n_unique, ex.max_count[p],
                                      fin.n_unique, map_oflow, comb_max]))
        new_acc = tuple(torch.stack([getattr(f, n) for f in fins])
                        for n in ("keys", "values", "payload", "valid"))
        if cfg.exchange_stats:
            new_acc += (acc[4] + ex.counts,)
        return _Wave(new_acc, torch.stack(oflows), torch.stack(needs))

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
        return tuple(dict.fromkeys(n for c in cfgs
                                   for n in kc.sources_for(c)))

    def precompile(self, row_shape, row_dtype=np.uint8,
                   k: Optional[int] = None) -> float:
        """Build and load the CUDA libraries of the config's path (both
        tiers' under a tier policy; one ``nvcc`` per source, in
        parallel), returning the seconds spent.  The counterpart of the
        JAX engine's AOT compile: CUDA has no program to compile per
        shape, so *row_shape*, *row_dtype* and *k* name the run it
        prepares but change nothing, and nothing of the corpus is
        launched.  On the CPU there is nothing to build."""
        t0 = time.monotonic()
        if self.device.type == "cuda":
            kc.load(self._libraries(self.config))
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
            k = staged_list[0].shape[0] // P
            staged_list.clear()
        else:
            S = chunks.shape[0]
            k = (self._auto_rows(chunks) if waves is None
                 else -(-S // (max(1, waves) * P)))
            feeder = _WaveFeeder(self, chunks, k=k,
                                 prefetch=self.STREAM_PREFETCH)
            W = feeder.waves
        rpw = k * P
        tiered = _is_tiered(cfg.sort_impl)
        cuda = self.device.type == "cuda"
        t_upload = t_compute = 0.0
        t_first_dispatch = None
        reuploaded = False
        retries = 0
        try:
            for attempt in range(max_retries + 1):
                disp = TieredWaveDispatcher(self, cfg) if tiered else None
                t0 = time.monotonic()
                t_blocked = 0.0
                acc = None
                oflows, needs = [], []
                pmap = self.device_pmap() if cfg.partition_map else None
                if feeder is not None:  # uploads overlap any build below
                    feeder.start()
                for w in range(W):
                    # the tier decision (and a cold tier's builds) at the
                    # wave boundary, then the libraries of the serving
                    # config: built at the first wave, found loaded later
                    wave_cfg = disp.next_cfg() if disp is not None else cfg
                    if cuda:
                        kc.load(kc.sources_for(wave_cfg))
                    tb = time.monotonic()
                    if pairs is not None:
                        block = pairs.pop(w)
                        if cuda:  # the kernels' stream frees it
                            block.record_stream(
                                torch.cuda.current_stream(self.device))
                    else:
                        block = feeder.get(w)
                    t_blocked += time.monotonic() - tb
                    if t_first_dispatch is None:
                        t_first_dispatch = time.monotonic()
                    out = self._wave(wave_cfg, block, w * rpw, k, S, acc,
                                     pmap)
                    del block
                    if feeder is not None:
                        feeder.release(w)
                    acc = out.acc
                    oflows.append(out.overflow)
                    needs.append(out.needs)
                # the one readback of the attempt: waits for the device
                total_oflow = int(torch.stack(oflows).sum())
                t_upload += t_blocked
                t_compute += time.monotonic() - t0 - t_blocked
                if total_oflow == 0 or attempt == max_retries:
                    break
                retries = attempt + 1
                cfg = self._resize(cfg, torch.stack(needs).cpu().numpy())
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
        if total_oflow and on_overflow == "raise":
            raise RuntimeError(
                f"device run still overflowed {total_oflow} rows after "
                f"{retries} right-sized retries; raise EngineConfig "
                "capacities (or max_retries), or pass on_overflow='return' "
                "to inspect the truncated result")
        # sliced readback: only the live prefix of each partition's result
        t0 = time.monotonic()
        keys, vals, pay, valid = acc[:4]
        width = max(1, int(valid.sum(dim=1).max()))
        result = DeviceResult(keys[:, :width].cpu(), vals[:, :width].cpu(),
                              pay[:, :width].cpu(), valid[:, :width].cpu(),
                              total_oflow)
        t_readback = time.monotonic() - t0
        if timings is not None:
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
            if cfg.exchange_stats:
                matrix = acc[4].cpu()
                timings["exchange"] = {
                    "matrix": matrix.tolist(),
                    "row_sums": matrix.sum(dim=1).tolist(),
                    "col_sums": matrix.sum(dim=0).tolist()}
        return result
