"""Core host data structures (port of ``mapreduce_tpu/core``)."""

from .heap import Heap  # noqa: F401
