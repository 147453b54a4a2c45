"""The control ledger (port of ``mapreduce_tpu/obs/control.py``): every
automatic decision, with its evidence and its measured outcome.

The controllers of :mod:`..engine.autotune` act on the telemetry (the
exchange traffic matrix, capacity-retry forensics, kernel warmth,
completed-job latencies); this module is the record of what they did,
so an operator (or a test) can answer "what did the system change, on
what evidence, and did it help?" without reading logs.

Each decision is ONE structured record::

    {"id": 7, "controller": "repartition", "task": "wc",
     "evidence": {"imbalance_recv": 3.4, "hot_dst": 5, ...},
     "action":   {"moved_buckets": 12, ...},
     "outcome":  "pending" | "applied" | "refused" | "error"
               | "improved" | "neutral" | "regressed",
     "outcome_evidence": {...},     # filled when the next window lands
     "note": "rebalanced P00000 off device 5"}

Lifecycle: :meth:`ControlLedger.record` captures the decision when it
is applied (or refused: a refused rebalance is a decision too, counted
and loud); :meth:`ControlLedger.resolve` lands the NEXT control window's
measurement as ``improved`` / ``neutral`` / ``regressed``.  Every record
and resolve emits a zero-duration ``control_decision`` tracer event, so
decisions ride the telemetry pusher to the collector and the merged
timeline.

Surfaces: ``mrtpu_control_decisions_total{controller,outcome}`` and
``mrtpu_control_evicted_total`` (the JAX names), and
:func:`validate_control`, the strict check of a ``control_ledger.json``
document, so either package accepts the other's ledger snapshot.

Embedder contract: with no controller attached nothing in this module
runs: a run with controllers disabled records ZERO decisions.

Monotonic-only module: decision ages are durations; the one persisted
wall timestamp is minted through ``coord/docstore.now`` like every
other board stamp.

A docserver binds its durable history (:meth:`ControlLedger.
bind_history`): every resolution's evidence then carries the PERSISTED
increase of the controller's :data:`HISTORY_EVIDENCE_FAMILIES` over
[decision, resolution].  The ledger's ``/statusz`` section
(:func:`control_snapshot`), its ``status`` render and its profile-bundle
artifact are served.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from .metrics import counter
from .trace import TRACER

#: the controllers of engine/autotune.py (+ the fleet plane's movers:
#: engine/migrate, coord/fleet.rehome_routes), in the JAX package's order
CONTROLLERS = ("repartition", "capacity", "admission", "reclaim",
               "fleet")

#: terminal-at-record outcomes vs measured-next-window outcomes
RECORD_OUTCOMES = ("pending", "applied", "refused", "error")
RESOLVED_OUTCOMES = ("improved", "neutral", "regressed")

#: decisions kept in the in-process ring (oldest evicted, counted)
MAX_DECISIONS = 256

_DECISIONS = counter(
    "mrtpu_control_decisions_total",
    "automatic control-plane decisions (labels: controller="
    "repartition|capacity|admission|reclaim|fleet, outcome) — counted "
    "once at record time (pending/applied/refused/error) and once "
    "more "
    "when the next control window measures a pending decision "
    "(improved/neutral/regressed), so outcome sums tell the whole "
    "story: total decisions AND how they turned out")
_EVICTED = counter(
    "mrtpu_control_evicted_total",
    "control-ledger decisions evicted from the bounded in-process "
    "ring before /statusz or a bundle captured them")


#: counter families whose persisted window-increase is attached as
#: resolution evidence per controller (the "did it help?" families:
#: what each controller's action is supposed to move)
HISTORY_EVIDENCE_FAMILIES: Dict[str, tuple] = {
    "repartition": ("mrtpu_exchange_records_total",
                    "mrtpu_device_waves_total"),
    "capacity": ("mrtpu_device_retries_total",
                 "mrtpu_device_capacity_retry_events_total",
                 "mrtpu_session_overflow_rows_total"),
    "admission": ("mrtpu_sched_admission_total",
                  "mrtpu_sched_tasks_total"),
    "reclaim": ("mrtpu_worker_jobs_total",
                "mrtpu_worker_lease_lost_total"),
    "fleet": ("mrtpu_session_migrations_total",
              "mrtpu_worker_lease_lost_total"),
}


class ControlLedger:
    """Bounded, thread-safe ring of control decisions (one per process
    by default, :data:`LEDGER`; embedders and tests may make their
    own)."""

    def __init__(self, max_decisions: int = MAX_DECISIONS) -> None:
        self._lock = threading.Lock()
        self._decisions: "OrderedDict[int, Dict[str, Any]]" = \
            OrderedDict()
        self._seq = 0
        self.max_decisions = max_decisions
        #: durable history plane (obs/history.MetricHistory) — when
        #: bound, every resolution's outcome_evidence carries the
        #: PERSISTED counter increases over [decision, resolution]
        self._history: Optional[Any] = None

    def bind_history(self, history: Any) -> None:
        """Attach the durable history plane: outcome evidence is then
        read from persisted windows instead of racy in-memory counter
        snapshots (the docserver binds its MetricHistory here)."""
        with self._lock:
            self._history = history

    def unbind_history(self, history: Any) -> None:
        """Detach *history* if it is still the bound plane (a docserver
        shutting down must not unbind a successor's binding)."""
        with self._lock:
            if self._history is history:
                self._history = None

    # -- the write side ----------------------------------------------------

    def record(self, controller: str, task: str,
               evidence: Dict[str, Any], action: Dict[str, Any],
               outcome: str = "pending", note: str = "",
               tracer=TRACER) -> int:
        """Record one decision when it is applied (or refused); returns
        the id :meth:`resolve` later lands the measured outcome on."""
        if controller not in CONTROLLERS:
            raise ValueError(f"unknown controller {controller!r} "
                             f"(known: {CONTROLLERS})")
        if outcome not in RECORD_OUTCOMES:
            raise ValueError(f"record outcome must be one of "
                             f"{RECORD_OUTCOMES}, got {outcome!r}")
        from ..coord import docstore  # the one wall-clock mint point

        with self._lock:
            self._seq += 1
            did = self._seq
            dec = {
                "id": did,
                "controller": controller,
                "task": str(task or "-"),
                "evidence": dict(evidence or {}),
                "action": dict(action or {}),
                "outcome": outcome,
                "note": str(note or ""),
                "monotonic": time.monotonic(),
                "time": docstore.now(),
            }
            self._decisions[did] = dec
            while len(self._decisions) > self.max_decisions:
                self._decisions.popitem(last=False)
                _EVICTED.inc()
        _DECISIONS.inc(controller=controller, outcome=outcome)
        self._emit(dec, tracer)
        return did

    def resolve(self, decision_id: int, outcome: str,
                evidence: Optional[Dict[str, Any]] = None,
                note: Optional[str] = None, tracer=TRACER) -> bool:
        """Land the next control window's measurement on a pending
        decision.  Returns False when the decision aged out of the ring
        (counted as evicted at record time) or was already resolved."""
        if outcome not in RESOLVED_OUTCOMES:
            raise ValueError(f"resolved outcome must be one of "
                             f"{RESOLVED_OUTCOMES}, got {outcome!r}")
        with self._lock:
            dec0 = self._decisions.get(decision_id)
            if dec0 is None or dec0["outcome"] in RESOLVED_OUTCOMES:
                return False
            t0 = dec0.get("time")
            history = self._history
            hist_controller = dec0["controller"]
        # persisted before/after window, computed OUTSIDE the ledger
        # lock (it tails segments): the increase of the controller's
        # "did it help?" families over [decision, resolution]
        hist_ev: Optional[Dict[str, Any]] = None
        if history is not None and isinstance(t0, (int, float)):
            from ..coord import docstore

            t1 = docstore.now()
            increases: Dict[str, float] = {}
            for fam in HISTORY_EVIDENCE_FAMILIES.get(hist_controller,
                                                     ()):
                try:
                    increases[fam] = history.window_increase(
                        fam, float(t0), t1)
                except (OSError, RuntimeError):
                    # evidence is an upgrade, never a reason to drop
                    # the resolution itself
                    continue
            if increases:
                hist_ev = {"t0": round(float(t0), 3),
                           "t1": round(t1, 3),
                           "increase": increases}
        with self._lock:
            dec = self._decisions.get(decision_id)
            if dec is None or dec["outcome"] in RESOLVED_OUTCOMES:
                return False
            dec["outcome"] = outcome
            dec["outcome_evidence"] = dict(evidence or {})
            if hist_ev is not None:
                dec["outcome_evidence"]["history_window"] = hist_ev
            if note:
                # the record-time note says what was decided and why;
                # the resolution's says how it turned out: keep both
                dec["outcome_note"] = str(note)
            controller = dec["controller"]
            snap = dict(dec)
        _DECISIONS.inc(controller=controller, outcome=outcome)
        self._emit(snap, tracer)
        return True

    @staticmethod
    def _emit(dec: Dict[str, Any], tracer) -> None:
        """One zero-duration ``control_decision`` event per record /
        resolve: decisions travel with the span ring to the collector
        and the merged timeline."""
        now = time.monotonic()
        tracer.end(
            tracer.begin("control_decision", start=now,
                         controller=dec["controller"],
                         task=dec["task"]),
            now, decision_id=int(dec["id"]), outcome=dec["outcome"],
            evidence=dec.get("evidence"), action=dec.get("action"),
            outcome_evidence=dec.get("outcome_evidence"),
            note=dec.get("note"))

    # -- the read side -----------------------------------------------------

    def decisions(self, controller: Optional[str] = None,
                  task: Optional[str] = None) -> List[Dict[str, Any]]:
        """Decisions newest-last, optionally filtered."""
        with self._lock:
            out = [dict(d) for d in self._decisions.values()]
        if controller is not None:
            out = [d for d in out if d["controller"] == controller]
        if task is not None:
            out = [d for d in out if d["task"] == task]
        return out

    def pending(self, controller: str,
                task: Optional[str] = None) -> List[Dict[str, Any]]:
        return [d for d in self.decisions(controller, task)
                if d["outcome"] == "pending"]

    def snapshot(self) -> Dict[str, Any]:
        """The decision ring (ages instead of raw monotonic stamps) plus
        per-controller outcome counts; empty when no controller ever
        decided anything, so a controllers-disabled run provably
        emitted nothing."""
        now = time.monotonic()
        with self._lock:
            rows = [dict(d) for d in self._decisions.values()]
        if not rows:
            return {}
        counts: Dict[str, Dict[str, int]] = {}
        for d in rows:
            d["age_s"] = round(now - d.pop("monotonic"), 3)
            c = counts.setdefault(d["controller"], {})
            c[d["outcome"]] = c.get(d["outcome"], 0) + 1
        return {"decisions": rows, "counts": counts}

    def reset(self) -> None:
        """Tests only: forget every decision."""
        with self._lock:
            self._decisions.clear()


#: the process-global ledger every controller records into by default
LEDGER = ControlLedger()


def control_snapshot() -> Dict[str, Any]:
    return LEDGER.snapshot()


def validate_control(doc: Any) -> None:
    """Strict structural check of a ``control_ledger.json`` document
    (``{"kind": "mrtpu-control", "snapshot": ...}``): a document that
    passes is one the JAX package's analysis tools accept too."""
    if not isinstance(doc, dict) or doc.get("kind") != "mrtpu-control":
        raise ValueError("control: not a mrtpu-control document")
    snap = doc.get("snapshot")
    if not isinstance(snap, dict):
        raise ValueError("control: snapshot is not an object")
    decisions = snap.get("decisions")
    if not isinstance(decisions, list) or not decisions:
        raise ValueError("control: decisions is not a non-empty list "
                         "(an empty ledger is not written at all)")
    all_outcomes = set(RECORD_OUTCOMES) | set(RESOLVED_OUTCOMES)
    for i, d in enumerate(decisions):
        if not isinstance(d, dict):
            raise ValueError(f"control: decision {i} is not an object")
        if d.get("controller") not in CONTROLLERS:
            raise ValueError(
                f"control: decision {i} has unknown controller "
                f"{d.get('controller')!r}")
        if d.get("outcome") not in all_outcomes:
            raise ValueError(
                f"control: decision {i} has unknown outcome "
                f"{d.get('outcome')!r}")
        for field in ("evidence", "action"):
            if not isinstance(d.get(field), dict):
                raise ValueError(
                    f"control: decision {i} missing {field!r} object")
        if not isinstance(d.get("id"), int):
            raise ValueError(f"control: decision {i} has no integer id")
    counts = snap.get("counts")
    if not isinstance(counts, dict):
        raise ValueError("control: counts is not an object")
    for ctrl, by_outcome in counts.items():
        if ctrl not in CONTROLLERS or not isinstance(by_outcome, dict):
            raise ValueError(
                f"control: counts entry {ctrl!r} malformed")
