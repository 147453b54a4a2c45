"""Device word count (port of ``engine/wordcount.py``).

The flagship workload: tokenize + hash the bytes on the device
(``ops/tokenize``), compact each tile's word records (``ops/
compaction``), reduce them by 64-bit key through the engine (sort +
segmented count, exchange, fold), then build the answer on the host by
slicing the original bytes at one representative occurrence per unique
hash.  The host loops only over unique words, never over tokens.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.compaction import tile_compact
from ..ops.tokenize import (
    _WS, HASH_A1, HASH_A2, HASH_A3, shard_text, tokenize_hash,
    word_hashes_host)
from ..parallel.mesh import Partitions
from .device_engine import (
    DeviceEngine, DeviceResult, EngineConfig, partition_buckets_for,
    validate_partition_map)

#: host materialisation window: words longer than this take a per-row
#: Python scan (rare in natural language)
_WINDOW = 128
#: the collision-verify monoid, one op per value lane: [count, h3, h3]
#: reduced with (sum, min, max)
VERIFY_REDUCE_OP = ("sum", "min", "max")


def _global_start(start: torch.Tensor, chunk_index: int,
                  L: int) -> torch.Tensor:
    """``chunk_index * L + start`` as int32 with wraparound (the JAX
    package's int32 arithmetic)."""
    g = start.to(torch.int64) + chunk_index * L
    return (((g & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _wordcount_map_fn(chunk: torch.Tensor, chunk_index: int,
                      cfg: EngineConfig):
    """map_fn: one padded byte chunk -> (hash keys, count 1, payload =
    the word's global start byte offset, from which the host slices the
    word back out)."""
    L = chunk.shape[0]
    toks = tokenize_hash(chunk, impl=cfg.tokenize_impl)
    gstart = _global_start(toks.start, chunk_index, L)
    tc = tile_compact(toks.is_end, cfg.tile, cfg.tile_records,
                      toks.keys[:, 0], toks.keys[:, 1], gstart)
    k1, k2, gs = tc.arrays
    keys = torch.stack([k1, k2], dim=-1)
    values = tc.valid.to(torch.int32)
    return keys, values, gs[:, None], tc.valid, tc.overflow


def _wordcount_map_fn_verify(chunk: torch.Tensor, chunk_index: int,
                             cfg: EngineConfig):
    """Collision-verify variant: values = [count 1, h3, h3] where h3 is a
    third polynomial hash lane, reduced with :data:`VERIFY_REDUCE_OP`."""
    L = chunk.shape[0]
    toks = tokenize_hash(chunk, multipliers=(HASH_A1, HASH_A2, HASH_A3),
                         impl=cfg.tokenize_impl)
    gstart = _global_start(toks.start, chunk_index, L)
    tc = tile_compact(toks.is_end, cfg.tile, cfg.tile_records,
                      toks.keys[:, 0], toks.keys[:, 1], toks.keys[:, 2],
                      gstart)
    k1, k2, h3, gs = tc.arrays
    keys = torch.stack([k1, k2], dim=-1)
    values = torch.stack([tc.valid.to(torch.int32), h3, h3], dim=-1)
    return keys, values, gs[:, None], tc.valid, tc.overflow


def bench_engine_config() -> EngineConfig:
    """The flagship configuration (the JAX package's, field for field):
    tile_records 104 (~25% headroom over the ~83 words per 512-byte tile
    of natural text) and the in-scan combiner with 1<<17 slots per chunk.
    Its 'pallas' formulation names select the hot-path kernels there;
    here the CUDA kernels run on the card whatever they say."""
    return EngineConfig(local_capacity=1 << 18,
                        exchange_capacity=1 << 17,
                        out_capacity=1 << 18,
                        tile=512, tile_records=104,
                        combine_in_scan=True,
                        combine_capacity=1 << 17,
                        segment_impl="pallas",
                        tokenize_impl="pallas")


class DeviceWordCount:
    """Count the words of a text corpus on one device.

    *parts* gives the partition count and device; without it the count
    runs as one partition on *device* (``None`` means ``"cuda"``, which
    raises ``RuntimeError`` when CUDA is absent).  ``chunk_len`` is the
    per-chunk byte length; capacities grow automatically on overflow.
    ``verify_collisions=True`` carries a third hash lane reduced with
    (min, max) so a 64-bit key collision is detected, not merged.
    ``config.sort_impl='radix'`` runs every sort and the exchange plan on
    the radix kernels; ``'tiered'`` / ``'tiered-radix'`` serve a cold
    start on 'argsort' until the steady tier is built.  *partition_map*,
    a ``[B]`` bucket->partition table, turns ``config.partition_map`` on
    and routes the exchange through the table (checked here against the
    bucket count).

    :meth:`count_bytes` streams the chunks to the device; the flagship
    bench's path is :meth:`stage` (upload, resident on return), then
    :meth:`warm` (build the kernels), then :meth:`count_staged`."""

    def __init__(self, parts: Optional[Partitions] = None,
                 chunk_len: int = 1 << 22,
                 config: Optional[EngineConfig] = None,
                 verify_collisions: bool = False, device=None,
                 partition_map=None) -> None:
        if parts is not None and device is not None:
            raise ValueError("pass parts or device, not both")
        self.parts = parts if parts is not None else Partitions(1, device)
        self.chunk_len = chunk_len
        self.verify_collisions = verify_collisions
        cfg = config or EngineConfig(
            local_capacity=1 << 17, exchange_capacity=1 << 15,
            out_capacity=1 << 17, combine_in_scan=True)
        if verify_collisions:
            cfg = replace(cfg, unit_values=False,
                          reduce_op=VERIFY_REDUCE_OP,
                          tile=min(cfg.tile, chunk_len))
        else:
            cfg = replace(cfg, unit_values=True, reduce_op="sum",
                          tile=min(cfg.tile, chunk_len))
        if partition_map is not None:
            cfg = replace(cfg, partition_map=True)
        self.config = cfg
        self._map_fn = (_wordcount_map_fn_verify if verify_collisions
                        else _wordcount_map_fn)
        self._engines: Dict[int, DeviceEngine] = {}
        self._pmap = (None if partition_map is None
                      else validate_partition_map(
                          partition_map,
                          partition_buckets_for(cfg, self.parts.n),
                          self.parts.n))

    def _engine_for(self, padded_len: int) -> DeviceEngine:
        if padded_len not in self._engines:
            eng = DeviceEngine(self.parts, self._map_fn, self.config)
            if self._pmap is not None:
                eng.set_partition_map(self._pmap)
            self._engines[padded_len] = eng
        return self._engines[padded_len]

    @property
    def engine(self) -> DeviceEngine:
        """The most recently made engine (for inspection and
        benchmarks)."""
        if self._engines:
            return next(reversed(self._engines.values()))
        return self._engine_for(self._row_len())

    def warm(self) -> float:
        """Build and load the CUDA libraries every run of this count
        launches (:meth:`DeviceEngine.precompile` at the one padded row
        length every corpus maps to); returns the seconds spent."""
        return self._engine_for(self._row_len()).precompile(
            (self._row_len(),), np.uint8)

    def count_bytes(self, data: bytes, timings: Optional[dict] = None,
                    waves: Optional[int] = None) -> Dict[bytes, int]:
        """Count whitespace-separated words of *data* (the same answer as
        ``collections.Counter(data.split())``), streaming the chunks to
        the device wave by wave.  Counts are int32."""
        t0 = time.monotonic()
        chunks, L = self._to_chunks(data)
        t_split = time.monotonic() - t0
        result = self._engine_for(L).run(chunks, timings=timings,
                                         waves=waves)
        out = self._finish(chunks, result, timings)
        if timings is not None:
            timings["split_s"] = t_split
        return out

    def count_files(self, paths) -> Dict[bytes, int]:
        """Count the words of the files at *paths*, joined with
        ``b"\\n"``."""
        parts = []
        for p in paths:
            with open(p, "rb") as f:
                parts.append(f.read())
        return self.count_bytes(b"\n".join(parts))

    def stage(self, data: bytes, waves: Optional[int] = None):
        """Upload *data*'s chunks to the device now (returning once they
        are resident); count them later with :meth:`count_staged`.
        Returns the handle ``(chunks, L, staged)``."""
        chunks, L = self._to_chunks(data)
        staged = self._engine_for(L).stage_inputs(chunks, waves)
        return chunks, L, staged

    def count_staged(self, handle,
                     timings: Optional[dict] = None) -> Dict[bytes, int]:
        """Count a corpus uploaded by :meth:`stage`, consuming the
        handle."""
        chunks, L, staged = handle
        result = self._engine_for(L).run(chunks, timings=timings,
                                         staged=staged)
        return self._finish(chunks, result, timings)

    def _finish(self, chunks: np.ndarray, result: DeviceResult,
                timings: Optional[dict]) -> Dict[bytes, int]:
        """Host materialisation, timed as ``materialize_s``."""
        t0 = time.monotonic()
        out = materialize_counts(chunks, result)
        if timings is not None:
            timings["materialize_s"] = time.monotonic() - t0
        return out

    def host_exchange_matrix(self, data: bytes,
                             waves: Optional[int] = None) -> np.ndarray:
        """Host recompute of the exchange traffic matrix a
        ``count_bytes(data, waves=waves)`` run accumulates: per wave,
        entry ``[src][dst]`` counts the distinct word keys of *src*'s
        chunk block whose hash lands on *dst* (``k1 % P``, or through the
        engine's partition map when the config has one), summed over
        waves."""
        chunks, L = self._to_chunks(data)
        eng = self._engine_for(L)
        n_dev = eng.n_dev
        table = eng.partition_map() if self.config.partition_map else None
        S = chunks.shape[0]
        k = (eng._auto_rows(chunks) if waves is None
             else -(-S // (max(1, waves) * n_dev)))
        rpw = k * n_dev
        matrix = np.zeros((n_dev, n_dev), dtype=np.int64)
        for w in range(-(-S // rpw)):
            for d in range(n_dev):
                lo = w * rpw + d * k
                block = chunks[lo:min(lo + k, S)]
                if block.size == 0:
                    continue
                words: set = set()
                for row in block:  # per row: a chunk's last word must not
                    words.update(row.tobytes().split())  # join the next's
                keys = set(word_hashes_host(b" ".join(words)).values())
                for k1, _k2 in keys:
                    dst = (k1 % n_dev if table is None
                           else int(table[k1 % table.shape[0]]))
                    matrix[d, dst] += 1
        return matrix

    def _row_len(self) -> int:
        """The one padded chunk length every corpus maps to: chunk_len
        plus one tile of slack for the whitespace-boundary overhang."""
        return self.chunk_len + self.config.tile

    def _to_chunks(self, data: bytes):
        n_chunks = max(1, -(-len(data) // self.chunk_len))
        n_dev = self.parts.n
        n_chunks = -(-n_chunks // n_dev) * n_dev
        return shard_text(data, n_chunks, pad_multiple=self.config.tile,
                          pad_to=self._row_len())


def materialize_counts(chunks: np.ndarray,
                       result: DeviceResult) -> Dict[bytes, int]:
    """Host materialisation: gather each unique word's bytes at its
    start offset and build the dict over uniques only.  In verify mode,
    a unique whose min and max third-lane hash differ exposes two
    distinct words merged on the device (a 64-bit collision)."""
    valid = result.valid.numpy().reshape(-1)
    starts = result.payload.numpy().reshape(-1, result.payload.shape[-1])[:, 0]
    values = result.values.numpy()
    verify = values.ndim == 3
    if verify:
        vals3 = values.reshape(-1, 3)
        vals = vals3[:, 0]
    else:
        vals = values.reshape(-1)
    live_rows = np.nonzero(valid)[0]
    if live_rows.size == 0:
        return {}
    gstart = starts[live_rows].astype(np.int64)
    counts = vals[live_rows]
    if verify:
        bad = np.nonzero(vals3[live_rows, 1] != vals3[live_rows, 2])[0]
        if bad.size:
            raise RuntimeError(
                f"64-bit hash collision detected for {bad.size} key(s): "
                "distinct words were merged on device. Re-run with "
                "different HASH_A1/HASH_A2 multipliers (ops/tokenize.py).")
    out: Dict[bytes, int] = {}
    for word, c in zip(gather_words(chunks, gstart), counts):
        out[word] = out.get(word, 0) + int(c)
    return out


def gather_words(chunks: np.ndarray, gstarts: np.ndarray):
    """The word bytes at each padded-space start offset (``chunk*L +
    local``), aligned with *gstarts*: one numpy window-gather over all
    offsets, and a per-row Python scan only for words longer than the
    window."""
    S, L = chunks.shape
    flat = chunks.reshape(-1)
    gstarts = np.asarray(gstarts, dtype=np.int64)
    offs = gstarts[:, None] + np.arange(_WINDOW)[None, :]
    np.clip(offs, 0, flat.size - 1, out=offs)
    windows = flat[offs]
    is_ws = np.isin(windows, _WS)
    # words never span chunks and chunks are space-padded, so a word
    # shorter than the window ends inside it
    has_end = is_ws.any(axis=1)
    lengths = np.where(has_end, is_ws.argmax(axis=1), _WINDOW)
    out = []
    win_bytes = windows.tobytes()
    W = _WINDOW
    for i in range(gstarts.size):
        if has_end[i]:
            out.append(win_bytes[i * W:i * W + int(lengths[i])])
        else:  # overlong word: scan the original bytes
            row, col = divmod(int(gstarts[i]), L)
            end = col
            crow = chunks[row]
            while end < L and crow[end] not in _WS:
                end += 1
            out.append(crow[col:end].tobytes())
    return out
