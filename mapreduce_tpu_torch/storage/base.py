"""Storage interface: named text and byte blobs with regex listing
(port of ``mapreduce_tpu/storage/base.py``).

A :class:`FileBuilder` stages writes and publishes them atomically on
``build`` (GridFileBuilder / tmpfile + rename in the reference,
fs.lua:80-115); record lines go through ``write_record_line`` and come
back through :meth:`Storage.open_lines` (the reference's
``gridfs_lines_iterator``, utils.lua:133-200).  ``write_bytes`` /
``read_bytes`` carry binary blobs (checkpoint shards are ``np.save``
bytes) under the same atomic-publish contract.  Every backend reports
its bytes, records and operations to :func:`..obs.metrics.storage_io`
and :func:`..obs.metrics.storage_op`.
"""

from __future__ import annotations

import re
from typing import Iterator, List, Optional

from ..obs.metrics import storage_io, storage_op


def _text_bytes(text: str) -> int:
    """UTF-8 byte length of *text* — what the disk backend actually
    moves (the isascii fast path skips the encode)."""
    return len(text) if text.isascii() else len(text.encode("utf-8"))


class FileBuilder:
    """Write-staging handle; nothing is visible until :meth:`build`."""

    def __init__(self, storage: "Storage") -> None:
        self._storage = storage
        self._parts: List[str] = []
        self._records = 0

    def append(self, text: str) -> None:
        self._parts.append(text)

    def write_record_line(self, line: str) -> None:
        self.append(line)
        self.append("\n")
        self._records += 1

    def build(self, name: str) -> None:
        """Publish the staged content as *name*, atomically."""
        content = "".join(self._parts)
        self._storage._publish(name, content)
        storage_io(self._storage.scheme, "write", _text_bytes(content),
                   records=self._records)
        storage_op(self._storage.scheme, "publish")
        self._parts = []
        self._records = 0


class Storage:
    """Abstract named-blob store."""

    #: DSL scheme name ("mem", "shared")
    scheme: str = "?"

    def builder(self) -> FileBuilder:
        return FileBuilder(self)

    def _publish(self, name: str, content: str) -> None:
        raise NotImplementedError

    # the str read paths are counted HERE, so each backend implements
    # only the raw `_read` / `_open_lines`; writes are counted by
    # FileBuilder.build, the one publish point every backend shares.

    def open_lines(self, name: str) -> Iterator[str]:
        """Iterate the non-empty text lines of blob *name*
        (newline-stripped)."""
        records = nbytes = 0
        try:
            for line in self._open_lines(name):
                records += 1
                nbytes += _text_bytes(line) + 1  # + the newline
                yield line
        finally:
            storage_io(self.scheme, "read", nbytes, records=records)
            storage_op(self.scheme, "open_lines")

    def read(self, name: str) -> str:
        content = self._read(name)
        storage_io(self.scheme, "read", _text_bytes(content))
        storage_op(self.scheme, "read")
        return content

    def _open_lines(self, name: str) -> Iterator[str]:
        raise NotImplementedError

    def _read(self, name: str) -> str:
        raise NotImplementedError

    def write(self, name: str, content: str) -> None:
        """One-shot atomic publish of a text blob."""
        b = self.builder()
        b.append(content)
        b.build(name)

    # the binary plane bypasses the str wrappers above: backends count
    # their own storage_io there

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

    def exists(self, name: str) -> bool:
        raise NotImplementedError

    def remove(self, name: str) -> None:
        raise NotImplementedError

    def remove_many(self, names: List[str]) -> None:
        for n in names:
            self.remove(n)

    def clear(self) -> None:
        for n in self._all_names():
            self.remove(n)
