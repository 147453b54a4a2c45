"""Binary min-heap with a caller-supplied comparator (port of
``mapreduce_tpu/core/heap.py``).

Parity with mapreduce/heap.lua (reference: push heap.lua:55-70, pop
heap.lua:33-53, top/size/empty/clear heap.lua:29-82).  This is the parity
component for callers that need an explicit comparator (the reference exposes
``heap(cmp)`` to user code); the framework's own k-way merge deliberately
does NOT use it -- utils/iterators.py uses stdlib ``heapq`` over tuples with
a unique (sort_key, source_index) prefix, which is C-fast and needs no
comparator.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional


class Heap:
    __slots__ = ("_data", "_less")

    def __init__(self, less: Optional[Callable[[Any, Any], bool]] = None):
        self._data: List[Any] = []
        self._less = less or (lambda a, b: a < b)

    def __len__(self) -> int:
        return len(self._data)

    def empty(self) -> bool:
        return not self._data

    def clear(self) -> None:
        self._data.clear()

    def top(self) -> Any:
        if not self._data:
            raise IndexError("top of empty heap")
        return self._data[0]

    def push(self, value: Any) -> None:
        d, less = self._data, self._less
        d.append(value)
        i = len(d) - 1
        while i > 0:
            parent = (i - 1) >> 1
            if less(d[i], d[parent]):
                d[i], d[parent] = d[parent], d[i]
                i = parent
            else:
                break

    def pop(self) -> Any:
        d, less = self._data, self._less
        if not d:
            raise IndexError("pop from empty heap")
        result = d[0]
        last = d.pop()
        n = len(d)
        if n:
            d[0] = last
            i = 0
            while True:
                l, r = 2 * i + 1, 2 * i + 2
                smallest = i
                if l < n and less(d[l], d[smallest]):
                    smallest = l
                if r < n and less(d[r], d[smallest]):
                    smallest = r
                if smallest == i:
                    break
                d[i], d[smallest] = d[smallest], d[i]
                i = smallest
        return result
