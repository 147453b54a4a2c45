"""Build/environment identity: the ``mrtpu_build_info`` gauge (port of
``mapreduce_tpu/obs/buildinfo.py``).

A profile bundle or a smoke line without an environment stamp is
unattributable: "which torch, which CUDA, which card produced this
number?" should be a label read.  The Prometheus idiom: a gauge whose
value is always 1 and whose labels carry the identity (version, python,
torch, cuda, backend, device kind).

The torch fields are filled only from an already-imported torch
(``sys.modules``): the docserver and host-plane worker processes never
import it (seconds of startup they do not need), and an identity probe
must not change that.  They report ``torch="unloaded"``; a process that
loaded torch reports its version, ``torch.version.cuda``, the backend
(``cuda`` or ``cpu``) and ``torch.cuda.get_device_name()``, or
``"unavailable"`` for the device kind where no card is visible.  The
cache refreshes itself the first time it is read after torch appears.
"""

from __future__ import annotations

import logging
import platform
import sys
import threading
from typing import Dict, Optional

from .metrics import gauge

logger = logging.getLogger("mapreduce_tpu_torch.obs.buildinfo")

_BUILD_INFO = gauge(
    "mrtpu_build_info",
    "build/environment identity; value is always 1, the labels are the "
    "payload (version, python, torch, cuda, backend, device_kind)")

_lock = threading.Lock()
_cache: Optional[Dict[str, str]] = None


def _torch_fields() -> Dict[str, str]:
    torch = sys.modules.get("torch")
    if torch is None:
        return {"torch": "unloaded", "cuda": "unloaded",
                "backend": "unloaded", "device_kind": "unloaded"}
    out = {"torch": str(getattr(torch, "__version__", "?")),
           "cuda": str(getattr(torch.version, "cuda", None)
                       or "unavailable")}
    try:
        if torch.cuda.is_available():
            out["backend"] = "cuda"
            out["device_kind"] = str(torch.cuda.get_device_name())
        else:
            out["backend"] = "cpu"
            out["device_kind"] = "unavailable"
    except Exception as exc:
        # a half-initialised CUDA runtime is a reportable state, not a crash
        # in an identity probe
        logger.debug("torch device probe failed: %s", exc)
        out.setdefault("backend", "unavailable")
        out.setdefault("device_kind", "unavailable")
    return out


def build_info(refresh: bool = False) -> Dict[str, str]:
    """The identity dict (cached); also (re)publishes the gauge.  The
    cache refreshes once torch is imported after a torch-less read."""
    global _cache
    with _lock:
        stale = (_cache is None or refresh
                 or (_cache.get("torch") == "unloaded"
                     and "torch" in sys.modules))
        if stale:
            from .. import __version__

            info = {"version": __version__,
                    "python": platform.python_version()}
            info.update(_torch_fields())
            _cache = info
            # replace, not set: a refresh swaps the whole label set so a
            # pre-torch series cannot linger beside the post-torch one
            _BUILD_INFO.replace([(dict(info), 1.0)])
        return dict(_cache)
