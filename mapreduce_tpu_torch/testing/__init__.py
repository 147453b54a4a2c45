"""Test-support subpackage (port of ``mapreduce_tpu/testing``): network
fault injection for the two HTTP planes (:mod:`.faults`).  Ships inside
the package so a live topology can be chaos-tested with the same harness
the tests use."""

from .faults import FaultProxy, FaultRule, FaultSchedule

__all__ = ["FaultProxy", "FaultRule", "FaultSchedule"]
