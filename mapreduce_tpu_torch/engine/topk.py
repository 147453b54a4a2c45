"""Top-K heavy hitters over a streaming engine session (port of
``mapreduce_tpu/engine/topk.py``).

The session's accumulator holds every key's exact running count, so
top-K is a selection over the resident state read out at snapshot time
while the stream keeps flowing.  With ``out_capacity`` at least the
distinct-key count the counts are exact; a capacity loss is counted
(``DeviceResult.overflow``), never silent.

  * :class:`TopKWords` — streaming: ``feed(bytes)`` folds text into a
    resident :class:`~.session.EngineSession` through the word count's
    map, ``topk()`` reads the K heaviest words mid-stream.  The chunk
    bytes stay on the host for materialisation (the device holds only
    the aggregate); ``materialize=False`` keeps none (hash-only).
  * :func:`topk_bytes` — batch: one ``DeviceWordCount`` run (capacity
    retries included), then the same selection.

Ties break deterministically: the heaviest count first, then the word
in byte order.
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Tuple

import numpy as np

from ..ops.tokenize import shard_text
from ..parallel.mesh import Partitions
from .device_engine import EngineConfig
from .session import EngineSession
from .wordcount import DeviceWordCount, _wordcount_map_fn, gather_words


def _select_topk(result, k: int, resolve=None):
    """Rank a result's live rows by count (descending), resolve the
    candidates' words through *resolve* (global byte offsets -> word
    bytes) and break count ties by word.  Returns ``[(word, count)]``,
    or ``[(None, count)]`` without *resolve* (hash-only)."""
    valid = np.asarray(result.valid).reshape(-1)
    vals = np.asarray(result.values).reshape(-1)
    pay = np.asarray(result.payload)
    starts = pay.reshape(-1, pay.shape[-1])[:, 0]
    live = np.nonzero(valid)[0]
    if live.size == 0:
        return []
    counts = vals[live].astype(np.int64)
    # enough candidates to cover the count ties at the K boundary
    order = np.argsort(-counts, kind="stable")
    if live.size > k:
        kth = counts[order[k - 1]]
        n_cand = int(np.searchsorted(-counts[order], -kth, side="right"))
    else:
        n_cand = live.size
    cand = order[:n_cand]
    if resolve is None:
        pairs = sorted(((int(counts[i]), int(starts[live[i]]))
                        for i in cand), key=lambda p: (-p[0], p[1]))
        return [(None, c) for c, _ in pairs[:k]]
    words = resolve(starts[live[cand]].astype(np.int64))
    pairs = sorted(zip(words, (int(counts[i]) for i in cand)),
                   key=lambda wc: (-wc[1], wc[0]))
    return pairs[:k]


def _gather_candidate_rows(chunk_arrays, gstarts: np.ndarray,
                           row_len: int):
    """The rows the candidate offsets *gstarts* fall in, gathered from
    the per-feed chunk arrays, and the offsets remapped into them: a
    mid-stream poll costs O(K rows), not a concatenation of every feed.
    Sound because a word never crosses its row (``shard_text`` cuts at
    whitespace and pads every row with spaces)."""
    rows = np.asarray(gstarts, dtype=np.int64) // row_len
    uniq, inv = np.unique(rows, return_inverse=True)
    bounds = np.cumsum([0] + [c.shape[0] for c in chunk_arrays])
    sel = np.empty((uniq.size, row_len), dtype=chunk_arrays[0].dtype)
    for j, g in enumerate(uniq):
        li = int(np.searchsorted(bounds, g, side="right") - 1)
        sel[j] = chunk_arrays[li][int(g - bounds[li])]
    local = (inv.astype(np.int64) * row_len
             + np.asarray(gstarts, dtype=np.int64) % row_len)
    return sel, local


def default_topk_config(chunk_len: int) -> EngineConfig:
    """Capacities for natural-language heavy-hitter streams (the
    resident set is the distinct-key count, not the stream length)."""
    return EngineConfig(
        local_capacity=1 << 15, exchange_capacity=1 << 13,
        out_capacity=1 << 16, combine_in_scan=True,
        # explicit combiner slots: a stream cannot retry, so they must
        # cover a dense chunk's uniques up front
        combine_capacity=1 << 13,
        unit_values=True, reduce_op="sum")


class TopKWords:
    """Streaming top-K heavy-hitter words over an engine session on the
    partitions *parts*."""

    def __init__(self, parts: Partitions, k: int = 100,
                 chunk_len: int = 1 << 14,
                 config: Optional[EngineConfig] = None,
                 materialize: bool = True, task: str = "topk") -> None:
        cfg = config or default_topk_config(chunk_len)
        cfg = replace(cfg, unit_values=True, reduce_op="sum",
                      tile=min(cfg.tile, chunk_len))
        self.k = int(k)
        self.chunk_len = chunk_len
        self.config = cfg
        self.task = task
        self.materialize = materialize
        #: one padded chunk length for every feed (the word count's
        #: whitespace-overhang slack), so the row shape never changes
        self.row_len = chunk_len + cfg.tile
        self.session = EngineSession(parts, _wordcount_map_fn, cfg,
                                     task=task)
        self._chunks: List[np.ndarray] = []
        #: the row width shard_text actually made (rounded up to a tile
        #: multiple): payload offsets are chunk_index * this
        self._L: Optional[int] = None
        self._bytes_fed = 0

    def feed(self, data: bytes) -> None:
        """Fold *data*'s words into the resident aggregate (offsets stay
        stream-global, so a word first seen feeds ago still
        materialises)."""
        n_chunks = max(1, -(-len(data) // self.chunk_len))
        chunks, L = shard_text(data, n_chunks,
                               pad_multiple=self.config.tile,
                               pad_to=self.row_len)
        if self._L is None:
            self._L = int(L)
        # the payload offset is int32 (chunk_index * L + local): past
        # ~2 GiB a materialising stream would wrap it and pair counts
        # with garbled words, so refuse; hash-only never reads offsets
        if self.materialize:
            pos = self.session.stats(self.task).get("chunks", 0)
            end = (pos + chunks.shape[0]) * self._L
            if end > 2**31 - 1:
                raise OverflowError(
                    f"materialising top-K stream would reach byte "
                    f"offset {end} (> int32 payload range); restart the "
                    "stream, or use materialize=False for unbounded "
                    "hash-only streaming")
        self.session.feed(chunks, task=self.task)
        if self.materialize:
            self._chunks.append(chunks)
        self._bytes_fed += len(data)

    def _resolve_words(self, gstarts: np.ndarray) -> List[bytes]:
        sel, local = _gather_candidate_rows(self._chunks, gstarts,
                                            self._L)
        return gather_words(sel, local)

    def topk(self, k: Optional[int] = None) -> List[Tuple[bytes, int]]:
        """The K heaviest words so far: a snapshot plus a host selection
        over the candidates' rows; the stream goes on."""
        result = self.session.snapshot(self.task)
        resolve = (self._resolve_words
                   if self.materialize and self._chunks else None)
        return _select_topk(result, k or self.k, resolve=resolve)

    def stats(self) -> dict:
        st = dict(self.session.stats(self.task))
        st["bytes_fed"] = self._bytes_fed
        return st


def topk_bytes(parts: Partitions, data: bytes, k: int = 100,
               chunk_len: int = 1 << 14,
               config: Optional[EngineConfig] = None,
               ) -> List[Tuple[bytes, int]]:
    """Batch top-K: one ``DeviceWordCount`` engine run with its capacity
    retries (exact, or it raises), then the streaming form's
    selection."""
    wc = DeviceWordCount(parts, chunk_len=chunk_len, config=config)
    chunks, L = wc._to_chunks(data)
    result = wc._engine_for(L).run(chunks)
    return _select_topk(result, k,
                        resolve=lambda g: gather_words(chunks, g))


def host_topk(data: bytes, k: int) -> List[Tuple[bytes, int]]:
    """The host answer: split, count, sort, with the same tie-break."""
    counts: dict = {}
    for w in data.split():
        counts[w] = counts.get(w, 0) + 1
    return sorted(counts.items(), key=lambda wc: (-wc[1], wc[0]))[:k]
