"""The k-way merge powering the shuffle's reduce side (port of
``mapreduce_tpu/utils/iterators.py``).

Parity with mapreduce/utils.lua: ``merge_iterator`` (heap-based k-way
merge concatenating the value lists of equal keys across sorted
per-mapper files, utils.lua:206-271) is reimplemented over parsed records
with a total key order (serialization.sort_key).  The reference's line
reader (``gridfs_lines_iterator``, utils.lua:133-200) is
``Storage.open_lines``.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Iterator, List, Sequence, Tuple

from .serialization import sort_key

Record = Tuple[Any, Any]


def merge_iterator(
    sources: Sequence[Callable[[], Iterator[Record]]],
) -> Iterator[Record]:
    """K-way merge of sorted record streams.

    Each *source* is a zero-arg factory returning an iterator of
    ``(key, value_list)`` records sorted ascending by ``sort_key(key)``.
    Yields ``(key, concatenated_value_list)`` with equal keys across streams
    merged, exactly like the reference's merge (utils.lua:238-246): the
    reduce fn then sees *all* values for a key at once.
    """
    # entries: (sort_key, source_index, key, values, iterator).  The source
    # index is unique among live entries, so tuple comparison never reaches
    # the iterator element -- plain heapq is safe (and C-fast); it also makes
    # equal keys concatenate in source order, so the merge is deterministic
    # (the reference's pop order among equal keys is heap-arbitrary).
    heap: List[tuple] = []
    for idx, factory in enumerate(sources):
        it = iter(factory())
        first = next(it, None)
        if first is not None:
            key, values = first
            heap.append((sort_key(key), idx, key, list(values), it))
    heapq.heapify(heap)

    while heap:
        skey, idx, key, values, it = heapq.heappop(heap)
        # drain every stream whose head has the same key
        while heap and heap[0][0] == skey:
            _, idx2, _, more, other_it = heapq.heappop(heap)
            values.extend(more)
            nxt = next(other_it, None)
            if nxt is not None:
                k2, v2 = nxt
                heapq.heappush(heap, (sort_key(k2), idx2, k2, list(v2), other_it))
        nxt = next(it, None)
        if nxt is not None:
            k2, v2 = nxt
            # streams are sorted with unique keys per file (map output is
            # grouped by key, job.lua:196-215), so the next record's key is
            # strictly greater.
            heapq.heappush(heap, (sort_key(k2), idx, k2, list(v2), it))
        yield key, values
