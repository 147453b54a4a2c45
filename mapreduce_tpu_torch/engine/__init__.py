"""The device MapReduce engine, the device word count, the resident
sessions with their spill plane and streaming top-K, and the
controllers that tune them (:mod:`.autotune`).

The names below load their module (and PyTorch) at first use, so a
host-plane process that needs only :mod:`.autotune`'s reclaimer never
imports torch."""

import importlib

_EXPORTS = {
    "DeviceEngine": "device_engine", "DeviceResult": "device_engine",
    "EngineConfig": "device_engine", "replay_registry": "device_engine",
    "DeviceWordCount": "wordcount", "bench_engine_config": "wordcount",
    "materialize_counts": "wordcount",
    "EngineSession": "session", "SessionBusyError": "session",
    "SessionOverflowError": "session", "SessionStreamBroken": "session",
    "SessionRestoreError": "spill", "SessionSpillStore": "spill",
    "SpillPolicy": "spill",
    "TopKWords": "topk", "topk_bytes": "topk",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{module}", __name__), name)
