"""In-process named byte store (port of ``mapreduce_tpu/storage/
memory.py``), with a process-wide registry so objects of one process
that open the same ``mem:NAME`` share its blobs."""

from __future__ import annotations

import threading
from typing import Dict, List, Union

from .base import Storage


class MemoryStorage(Storage):
    """Blobs are str (text) or bytes (checkpoint shards); each API
    decodes or encodes at the boundary (utf-8), so either writer's blob
    reads through either reader."""

    scheme = "mem"

    _registry: Dict[str, "MemoryStorage"] = {}
    _registry_lock = threading.Lock()

    def __init__(self) -> None:
        self._blobs: Dict[str, Union[str, bytes]] = {}
        self._lock = threading.RLock()

    @classmethod
    def named(cls, name: str) -> "MemoryStorage":
        with cls._registry_lock:
            if name not in cls._registry:
                cls._registry[name] = cls()
            return cls._registry[name]

    def _publish(self, name: str, content: str) -> None:
        with self._lock:
            self._blobs[name] = content

    def _read(self, name: str) -> str:
        with self._lock:
            content = self._blobs[name]
        return content.decode("utf-8") if isinstance(content, bytes) \
            else content

    def write_bytes(self, name: str, data: bytes) -> None:
        with self._lock:
            self._blobs[name] = bytes(data)

    def read_bytes(self, name: str) -> bytes:
        with self._lock:
            if name not in self._blobs:  # as the directory backend
                raise FileNotFoundError(name)
            content = self._blobs[name]
        return content.encode("utf-8") if isinstance(content, str) \
            else content

    def _all_names(self) -> List[str]:
        with self._lock:
            return list(self._blobs.keys())

    def remove(self, name: str) -> None:
        with self._lock:
            self._blobs.pop(name, None)
