"""Tiered serving as a policy (port of ``engine/tiering.py``).

``EngineConfig.sort_impl = 'tiered'`` or ``'tiered-radix'`` is a policy
over two concrete configs whose accumulator layouts are equal (only the
sort formulation differs), so the carry threads straight through a swap
at a wave boundary and the swap is invisible in results:

* **tier 0** — ``sort_impl='argsort'`` (two stable ``torch.sort``\\ s):
  serves a cold start at once;
* **tier 1** — ``'variadic'`` under ``'tiered'``, ``'radix'`` (the radix
  sort and plan kernels) under ``'tiered-radix'``: the steady state,
  made ready by one background :class:`TierSpecializer` thread per
  engine and swapped in at the next wave boundary.

What differs from the JAX package, where a tier is a compiled program:

* **Cold means unbuilt libraries, not an uncompiled shape.**  A tier is
  warm when every CUDA library it launches is built
  (:func:`..ops.kernel_compat.is_built`: loaded, or its ``.so`` for the
  current sources in the build cache).  On a cold card
  ``'tiered-radix'`` first submits the ``radix`` build to the
  specializer and then builds tier 0's ``tokenize`` and ``segreduce``
  in the foreground, in parallel with it: the first wave waits for the
  slower of the two, never for ``radix.cu``.
* **A retry only re-probes.**  Libraries do not depend on capacities,
  so a capacity retry never re-targets a build; its fresh dispatcher
  goes to tier 1 if the build has landed, else re-enters tier 0.
* **'tiered' steadies at once once its libraries are built.**  Its two
  tiers share every library: cold, it builds them in the foreground for
  tier 0, the specializer finds them built, and the run swaps at the
  next wave boundary.
* **CPU runs are warm unless forced cold.**  On the CPU nothing needs
  building (the plain versions run), so a tiered run serves tier 1 at
  once unless :class:`force_cold` is in effect.  The specializer's one
  step is the module-level :func:`specialize`, which tests replace to
  block on an event or to raise.

A failed tier-1 build is never silent: it is logged, counted in
``TIER_COUNTS["specialize_failed"]`` and shown in the run's
``timings["tier_specialize_failed"]``, and tier 0 keeps serving on its
kernels (tokenize and segreduce still launch: this is not the plain
versions).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional, Tuple

import torch

from ..ops import kernel_compat as kc

logger = logging.getLogger("mapreduce_tpu_torch.engine.tiering")

#: plain-int counters, like ``kernel_compat.LAUNCHES``: tiered runs that
#: started cold on tier 0, swaps to tier 1 at a wave boundary, and tier-1
#: builds that failed (each one a run held at tier-0 throughput)
TIER_COUNTS: Dict[str, int] = {"cold_starts": 0, "swaps": 0,
                               "specialize_failed": 0}

#: set by :class:`force_cold`: every warmness probe reports cold
_FORCE_COLD = False


class force_cold:
    """Context manager: treat every tiered warmness probe as cold for
    the duration (tests and ``chip_smoke.py``: the tiered path made
    deterministic on a card whose libraries are built)."""

    def __enter__(self):
        global _FORCE_COLD
        self._prev = _FORCE_COLD
        _FORCE_COLD = True
        return self

    def __exit__(self, *exc):
        global _FORCE_COLD
        _FORCE_COLD = self._prev
        return False


def specialize(names: Tuple[str, ...], device: torch.device,
               foreground: Tuple[str, ...] = ()) -> None:
    """The specializer's one step: build the libraries of *names* that
    the foreground does not build meanwhile (*foreground*: tier 0's),
    then load all of *names* (waiting for the foreground's builds where
    they are still running).  Nothing on the CPU, where the plain
    versions run."""
    if device.type == "cuda":
        kc.build_all(names=[n for n in names if n not in foreground])
        kc.load(names)


class TierSpecializer:
    """ONE background build thread per engine.

    ``submit(key, device, foreground)`` asks for the libraries *key* (a
    tuple of source names) built and loaded, leaving the builds of
    *foreground* to the caller's thread; the daemon thread runs
    :func:`specialize` for the latest target and records it as ready or
    failed.  ``seconds[key]`` is the step's wall time."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._target: Optional[tuple] = None
        self._ready: set = set()
        self._failed: Dict[Tuple[str, ...], str] = {}
        self._thread: Optional[threading.Thread] = None
        self.seconds: Dict[Tuple[str, ...], float] = {}

    def submit(self, key: Tuple[str, ...], device: torch.device,
               foreground: Tuple[str, ...] = ()) -> None:
        with self._cv:
            if key in self._ready or key in self._failed:
                return
            self._target = (key, device, foreground)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="mrtorch-tier1-specializer")
                self._thread.start()
            self._cv.notify_all()

    def _loop(self) -> None:
        while True:
            with self._cv:
                if self._target is None:
                    self._thread = None
                    self._cv.notify_all()
                    return
                key, device, foreground = self._target
            err = None
            t0 = time.monotonic()
            try:
                specialize(key, device, foreground)
            except Exception as exc:  # the serving tier keeps running
                err = f"{type(exc).__name__}: {exc}"
                logger.warning("tier-1 build of %s failed (%s); tier 0 "
                               "keeps serving", ", ".join(key), err)
                TIER_COUNTS["specialize_failed"] += 1
            with self._cv:
                self.seconds[key] = time.monotonic() - t0
                if err is None:
                    self._ready.add(key)
                else:
                    self._failed[key] = err
                if self._target is not None and self._target[0] == key:
                    self._target = None
                self._cv.notify_all()

    def ready(self, key) -> bool:
        with self._cv:
            return key in self._ready

    def failed(self, key) -> Optional[str]:
        """The failure message of *key*'s build, or None."""
        with self._cv:
            return self._failed.get(key)

    def target_key(self) -> Optional[Tuple[str, ...]]:
        """The key being (or about to be) built, or None."""
        with self._cv:
            return self._target[0] if self._target is not None else None

    def wait(self, key, timeout: float) -> bool:
        """Block until *key*'s build finished either way (True), or
        *timeout* seconds passed (False).  The serving path never
        calls it."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while key not in self._ready and key not in self._failed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return True


class TieredWaveDispatcher:
    """The serving config of each wave of one attempt under a tiered
    policy.  The first :meth:`next_cfg` probes: tier 1 when its
    libraries are built (or on the CPU), else tier 0 while the engine's
    specializer builds tier 1; every later call is a wave boundary where
    a landed build swaps tier 0 for tier 1.  One dispatcher per attempt,
    so a capacity retry re-probes."""

    def __init__(self, engine, cfg) -> None:
        from .device_engine import _tier_cfgs

        self._engine = engine
        self._cfg0, self._cfg1 = _tier_cfgs(cfg)
        self._key = kc.sources_for(self._cfg1)
        #: serving tier: None until the first wave, then 0 or 1
        self.tier: Optional[int] = None
        self.swaps = 0
        self.cold = False

    @property
    def tier_label(self) -> str:
        """``"0"``, ``"1"`` (variadic) or the steady impl's name
        (``"radix"``) for tier 1, as the JAX package labels tiers."""
        if self.tier != 1:
            return str(self.tier)
        impl = self._cfg1.sort_impl
        return "1" if impl == "variadic" else impl

    @property
    def failed(self) -> Optional[str]:
        """Why tier 1's build failed, or None."""
        return self._engine.specializer.failed(self._key)

    def _decide(self) -> None:
        device = self._engine.device
        warm = not _FORCE_COLD and (
            device.type == "cpu" or all(kc.is_built(n) for n in self._key))
        if warm:
            self.tier = 1
            return
        self.tier = 0
        self.cold = True
        TIER_COUNTS["cold_starts"] += 1
        # the background build first, then tier 0's own in the
        # foreground: the two run in parallel
        names0 = kc.sources_for(self._cfg0)
        self._engine.specializer.submit(self._key, device, names0)
        if device.type == "cuda":
            kc.load(names0)

    def next_cfg(self):
        """The concrete config that serves the next wave."""
        if self.tier is None:
            self._decide()
        elif self.tier == 0 and self._engine.specializer.ready(self._key):
            self.tier = 1
            self.swaps += 1
            TIER_COUNTS["swaps"] += 1
        return self._cfg1 if self.tier == 1 else self._cfg0
