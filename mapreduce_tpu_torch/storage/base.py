"""Storage interface: named text and byte blobs with regex listing
(port of ``mapreduce_tpu/storage/base.py``, without its I/O metrics and
the line-record API of the job plane, which is not ported yet).

A :class:`FileBuilder` stages writes and publishes them atomically on
``build``; ``write_bytes`` / ``read_bytes`` carry binary blobs
(checkpoint shards are ``np.save`` bytes) under the same atomic-publish
contract.
"""

from __future__ import annotations

import re
from typing import List, Optional


class FileBuilder:
    """Write-staging handle; nothing is visible until :meth:`build`."""

    def __init__(self, storage: "Storage") -> None:
        self._storage = storage
        self._parts: List[str] = []

    def append(self, text: str) -> None:
        self._parts.append(text)

    def build(self, name: str) -> None:
        """Publish the staged content as *name*, atomically."""
        self._storage._publish(name, "".join(self._parts))
        self._parts = []


class Storage:
    """Abstract named-blob store."""

    #: DSL scheme name ("mem", "shared")
    scheme: str = "?"

    def builder(self) -> FileBuilder:
        return FileBuilder(self)

    def _publish(self, name: str, content: str) -> None:
        raise NotImplementedError

    def read(self, name: str) -> str:
        return self._read(name)

    def _read(self, name: str) -> str:
        raise NotImplementedError

    def write(self, name: str, content: str) -> None:
        """One-shot atomic publish of a text blob."""
        b = self.builder()
        b.append(content)
        b.build(name)

    def write_bytes(self, name: str, data: bytes) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} has no binary blob support")

    def read_bytes(self, name: str) -> bytes:
        raise NotImplementedError(
            f"{type(self).__name__} has no binary blob support")

    def list(self, pattern: Optional[str] = None) -> List[str]:
        """Names matching regex *pattern* (``re.search``), sorted."""
        names = self._all_names()
        if pattern is not None:
            rx = re.compile(pattern)
            names = [n for n in names if rx.search(n)]
        return sorted(names)

    def _all_names(self) -> List[str]:
        raise NotImplementedError

    def remove(self, name: str) -> None:
        raise NotImplementedError

    def remove_many(self, names: List[str]) -> None:
        for n in names:
            self.remove(n)
