"""Directory-backed storage (port of ``mapreduce_tpu/storage/
localdir.py``): the ``shared:PATH`` scheme.

Blob name -> one file under the root, the name flattened with URL
quoting so listing is one ``listdir``; writes go to a staging
subdirectory and are renamed into place (atomic on one file system).
The layout is the JAX package's, so either package reads the other's
directory.
"""

from __future__ import annotations

import os
import urllib.parse
import uuid
from typing import List

from .base import Storage


class LocalDirStorage(Storage):
    scheme = "shared"

    #: staging subdirectory: keeps half-written files out of listings
    STAGING = ".staging"

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(os.path.join(root, self.STAGING), exist_ok=True)

    def _fname(self, name: str) -> str:
        return os.path.join(self.root, urllib.parse.quote(name, safe=""))

    def _tmp(self) -> str:
        return os.path.join(self.root, self.STAGING,
                            f"{os.getpid()}.{uuid.uuid4().hex[:8]}")

    def _publish(self, name: str, content: str) -> None:
        tmp = self._tmp()
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(content)
        os.rename(tmp, self._fname(name))  # same fs: atomic

    def _read(self, name: str) -> str:
        with open(self._fname(name), "r", encoding="utf-8") as f:
            return f.read()

    def read_bytes(self, name: str) -> bytes:
        with open(self._fname(name), "rb") as f:
            return f.read()

    def write_bytes(self, name: str, data: bytes) -> None:
        tmp = self._tmp()
        with open(tmp, "wb") as f:
            f.write(data)
        os.rename(tmp, self._fname(name))  # same fs: atomic

    def _all_names(self) -> List[str]:
        return [urllib.parse.unquote(e) for e in os.listdir(self.root)
                if e != self.STAGING]

    def remove(self, name: str) -> None:
        try:
            os.remove(self._fname(name))
        except FileNotFoundError:
            pass
