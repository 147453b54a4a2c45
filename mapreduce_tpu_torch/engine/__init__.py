"""The device MapReduce engine, the device word count, and the resident
sessions with their spill plane and streaming top-K."""

from .device_engine import DeviceEngine, DeviceResult, EngineConfig  # noqa: F401
from .wordcount import (  # noqa: F401
    DeviceWordCount, bench_engine_config, materialize_counts)
from .session import (  # noqa: F401
    EngineSession, SessionBusyError, SessionOverflowError,
    SessionStreamBroken)
from .spill import (  # noqa: F401
    SessionRestoreError, SessionSpillStore, SpillPolicy)
from .topk import TopKWords, topk_bytes  # noqa: F401
