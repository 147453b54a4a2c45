"""The user contract: task function modules and their loading (port of
``mapreduce_tpu/spec.py``).

Reference semantics (SURVEY.md §1 L6): a user program is a set of modules,
each exporting the function named after its role — split form, one module
per role (examples/WordCount/{taskfn,mapfn,partitionfn,reducefn,finalfn}.lua)
— or a single module exporting all of them (examples/WordCount/init.lua:47-63).
The server stores module *names* in the task document; workers ``require``
them by name (task.lua:102-107, job.lua:64-76).  The rebuild keeps exactly
that: roles are importable-module-path strings, resolved with
:func:`importlib.import_module`, cached per process.

Roles and their signatures (server.lua:427-443 validation):

  * ``taskfn(emit)``                     — emit(key, value) job splits
  * ``mapfn(key, value, emit)``          — emit(k2, v2) intermediate pairs
  * ``partitionfn(key) -> int``          — partition index for a key
  * ``reducefn(key, values) -> value``   — fold a key's value list
  * ``combinerfn(key, values) -> value`` — map-side pre-aggregation
  * ``finalfn(pairs_iter) -> True|False|None|"loop"``

Optional per-module: ``init(args)`` run once per process (server.lua:452-456
— and, unlike the reference's worker-side ``init(nil)`` bug at job.lua:369,
workers here receive the real init_args); reducer property flags
``associative_reducer`` / ``commutative_reducer`` / ``idempotent_reducer``
(examples/WordCount/reducefn.lua:10-14) that unlock the fast paths.
"""

from __future__ import annotations

import importlib
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

MANDATORY_ROLES = ("taskfn", "mapfn", "partitionfn", "reducefn", "finalfn")
ACI_FLAGS = ("associative_reducer", "commutative_reducer", "idempotent_reducer")

# process-wide module/fn cache (reference: job.lua:64-76 caches required
# modules; cached() memoizes partitioners job.lua:42-58).  The lock keeps
# the once-per-process init guarantee honest when N worker threads share
# the process (the reference has one job per OS process and no such risk).
_fn_cache: Dict[tuple, "RoleModule"] = {}
_inits_done: Dict[int, bool] = {}
_init_lock = threading.Lock()


@dataclass
class RoleModule:
    """One resolved role: the callable plus its module's properties."""

    name: str                       # module path it came from
    role: str
    fn: Callable
    init: Optional[Callable] = None
    flags: Dict[str, bool] = field(default_factory=dict)

    def ensure_init(self, init_args: Any) -> None:
        """Run module init exactly once per process, deduped by module
        identity like the server does (server.lua:452-456)."""
        # dedup by function identity, like the server's identity-dedup of
        # module inits (server.lua:452-456) — split-form modules re-export
        # one shared init and it must run once
        if self.init is None:
            return
        key = id(self.init)
        with _init_lock:
            if not _inits_done.get(key):
                self.init(init_args)
                _inits_done[key] = True


def load_role(module_name: str, role: str) -> RoleModule:
    """Import *module_name* and resolve *role* from it (cached).

    The module must expose an attribute named after the role — callable —
    mirroring the reference's ``loaded_module[fname]`` lookup
    (job.lua:77-79).  Mixed split/single module forms both work since each
    role names its own module.
    """
    key = (module_name, role)
    if key in _fn_cache:
        return _fn_cache[key]
    mod = importlib.import_module(module_name)
    fn = getattr(mod, role, None)
    if not callable(fn):
        raise TypeError(
            f"module {module_name!r} does not export a callable {role!r} "
            f"(reference contract server.lua:427-443)")
    rm = RoleModule(
        name=module_name,
        role=role,
        fn=fn,
        init=getattr(mod, "init", None),
        flags={f: bool(getattr(mod, f, False)) for f in ACI_FLAGS},
    )
    _fn_cache[key] = rm
    return rm


def clear_caches() -> None:
    """Test hook: forget module/init caches (fresh-process semantics)."""
    _fn_cache.clear()
    _inits_done.clear()


def is_aci(rm: RoleModule) -> bool:
    """True when the reduce module declares itself associative +
    commutative + idempotent — the flags gating the reference's fast path
    (job.lua:264-284: skip the reduce call when #values==1) and our
    device-side segmented-reduce path."""
    return all(rm.flags.get(f, False) for f in ACI_FLAGS)


#: hooks a module exports to unlock the unified device fast path: with
#: ``device=True`` in configure(), Server.loop dispatches the fused
#: map+shuffle+reduce phases to the port's DeviceEngine while taskfn and
#: finalfn stay host-side — ONE framework, two execution planes (the
#: reference runs every workload through one server machinery,
#: server.lua:464-609; this is its GPU form).
DEVICE_HOOKS = ("device_prepare", "device_map", "device_result")


@dataclass
class DeviceSpec:
    """The device analogue of the mapfn/reducefn module pair.

    * ``prepare(pairs, parts) -> np.ndarray chunks`` — host prep: turn
      the taskfn-emitted (key, value) splits into the engine's chunk
      batch (read files, shard bytes, pad) for the given
      :class:`~.parallel.mesh.Partitions`;
    * ``map_fn(chunk, chunk_index, cfg)`` — the engine's map_fn on
      tensors (DeviceEngine contract: fixed-capacity hashed record
      batches);
    * ``result(chunks, DeviceResult) -> iterable[(key, [values])]`` —
      host materialisation of the reduced uniques into finalfn pairs;
    * ``config() -> EngineConfig`` (optional) — capacities + reduce
      monoid; defaults to EngineConfig().
    """

    name: str
    prepare: Callable
    map_fn: Callable
    result: Callable
    config: Optional[Callable] = None


def load_device(module_name: str) -> Optional[DeviceSpec]:
    """Resolve a module's device hooks; None when it exports none."""
    mod = importlib.import_module(module_name)
    if not all(callable(getattr(mod, h, None)) for h in DEVICE_HOOKS):
        return None
    return DeviceSpec(
        name=module_name,
        prepare=mod.device_prepare,
        map_fn=mod.device_map,
        result=mod.device_result,
        config=getattr(mod, "device_config", None),
    )


def validate_spec(params: Dict[str, Any]) -> Dict[str, Any]:
    """Server-side validation of a configure() params table
    (server.lua:425-443): mandatory roles present and loadable."""
    for role in MANDATORY_ROLES:
        name = params.get(role)
        if not name:
            raise ValueError(f"configure: missing mandatory parameter {role!r}")
        load_role(name, role)
    if params.get("combinerfn"):
        load_role(params["combinerfn"], "combinerfn")
    if params.get("device"):
        if load_device(params["mapfn"]) is None:
            raise ValueError(
                f"device=True but module {params['mapfn']!r} does not "
                f"export the device hooks {DEVICE_HOOKS}")
        if not is_aci(load_role(params["reducefn"], "reducefn")):
            raise ValueError(
                "device=True requires an associative+commutative+"
                "idempotent reducefn: the device engine reorders and "
                "partially combines (the device form of "
                "reducefn.lua:10-14's flags)")
    return params
