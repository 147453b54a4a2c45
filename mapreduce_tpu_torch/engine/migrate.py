"""Live session migration: evict on host A, serve from host B (port of
``mapreduce_tpu/engine/migrate.py``).

The spill plane makes any single stream durable and value-exact across
partition counts; the fleet plane (coord/fleet.py) makes hosts
addressable.  This module composes the two into a MOVE: :func:`migrate`
spills the stream's resident accumulator on the source
(:meth:`~.session.EngineSession.migrate_out`, which also marks the
stream handed off so a racing feed gets retry-after semantics, never a
fork), flips the fleet route to the destination with a guarded write (a
migration racing a recovery sweep resolves to exactly one winner), and
leaves the restore LAZY: the destination pays the load only when the
stream's next feed or snapshot arrives, which is what makes recovery of
a dead host's whole tenancy one cheap sweep.

The callers:

  * the :class:`~.autotune.FleetRebalancer` (memory-pressure evidence,
    ``reason="rebalance"``),
  * ``cli drain <host>`` (``reason="drain"``),
  * tests and fixtures (``reason="explicit"``);
  * the scheduler's failed-host recovery sweep moves routes WITHOUT a
    live source session (the host is dead; its last spill is the
    handoff) via :func:`~..coord.fleet.rehome_routes`: same metrics,
    same ledger controller.

Every migration is counted (``mrtpu_session_migrations_total``) and
recorded in the control ledger (controller ``fleet``) with the JAX
package's evidence and action keys, so ``cli diagnose`` can answer "why
did this stream move".

A session over a process group moves too: every rank of the source
group calls :func:`migrate`, its ``migrate_out`` is collective, and rank
0 alone flips the route, counts the move and records the decision
(:func:`..parallel.mesh.on_rank0`), so ``routed`` and the decision are
the same on every rank and a move racing a recovery sweep still has one
winner.  The other ranks' registries do not count it.  In the fleet a
group is its rank 0's host id; the route documents keep the JAX schema.

Monotonic-only module: migration stages are durations; route stamps are
minted by coord/docstore.now inside the registry.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from ..coord.fleet import _MIGRATIONS
from ..obs import control as _control
from ..parallel.mesh import on_rank0


def migrate(task: str, src, dst=None, *,
            registry=None, src_host: Optional[str] = None,
            dst_host: Optional[str] = None,
            reason: str = "explicit",
            ledger: Optional[_control.ControlLedger] = None,
            evidence: Optional[Dict[str, Any]] = None,
            ) -> Dict[str, Any]:
    """Move *task* from session *src* to session *dst* (both over ONE
    spill store — the store is the wire).

    *src* may be None when the source host is dead or remote (its last
    spill is the handoff); *dst* may be None because the restore is
    lazy anyway — passing it only documents intent and lets the
    destination pre-adopt.  With *registry* (+ ``src_host``/
    ``dst_host``) the fleet route flips under a guard: False-y
    ``routed`` in the result means another mover won the race and THIS
    move's route stands wherever that mover put it.  A *src* over a
    process group is moved by every rank of its group alike (module
    docstring).  A *dst* over a process group that a one-process *src*
    moves into is adopted here on this rank only: its other ranks call
    ``dst.adopt(task)`` themselves, as :class:`.autotune.FleetRebalancer`
    does.

    Returns ``{"task", "reason", "spill_s", "step", "routed",
    "decision"}``.
    """
    task = str(task)
    ledger = ledger if ledger is not None else _control.LEDGER
    t0 = time.monotonic()
    step = None
    if src is not None:
        step = src.migrate_out(task, reason=reason)
    spill_s = time.monotonic() - t0
    if dst is not None:
        # a stream migrating BACK to a former source must lift that
        # session's handed-off refusal; a fresh destination is a no-op
        dst.adopt(task)

    def flip_and_record():
        routed = False
        if registry is not None and dst_host is not None:
            routed = registry.reroute(task, dst_host,
                                      expect_src=src_host)
            if not routed and registry.route(task) is None:
                # first placement: nothing to guard against
                registry.assign(task, dst_host, reason=reason)
                routed = True
        _MIGRATIONS.inc(task=task, reason=str(reason))
        ev: Dict[str, Any] = {
            "src": str(src_host) if src_host is not None else "-",
            "spilled_resident": step is not None,
            "spill_s": round(spill_s, 6),
        }
        if evidence:
            # the caller's richer evidence (e.g. the rebalancer's HBM
            # pressure + candidate scores) rides the same single decision
            ev.update(evidence)
        action: Dict[str, Any] = {
            "dst": str(dst_host) if dst_host is not None else "-",
            "reason": str(reason),
            "routed": bool(routed) if registry is not None else None,
        }
        decision = ledger.record(
            "fleet", task, ev, action, outcome="applied",
            note="migrated {} {} -> {} ({})".format(
                task,
                str(src_host) if src_host is not None else "this host",
                str(dst_host) if dst_host is not None else "spill store",
                reason))
        return routed, decision

    # over a group: rank 0's flip and decision, shared with every rank
    routed, decision = on_rank0(getattr(src, "group", None),
                                flip_and_record)
    return {"task": task, "reason": str(reason),
            "spill_s": round(spill_s, 6), "step": step,
            "routed": routed, "decision": decision}
