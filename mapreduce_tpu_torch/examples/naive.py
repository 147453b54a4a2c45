"""Naive single-process in-memory wordcount — the correctness oracle the
end-to-end tests diff against (reference misc/naive.lua + test.sh:11-15:
"distributed result ≡ naive in-memory result"); port of
``mapreduce_tpu/examples/naive.py``)."""

from __future__ import annotations

from typing import Dict, Iterable


def wordcount(files: Iterable[str]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for path in files:
        with open(path, "r") as f:
            for line in f:
                for word in line.split():
                    counts[word] = counts.get(word, 0) + 1
    return counts
