"""The device MapReduce engine and the device word count."""

from .device_engine import DeviceEngine, DeviceResult, EngineConfig  # noqa: F401
from .wordcount import (  # noqa: F401
    DeviceWordCount, bench_engine_config, materialize_counts)
