"""The observe->act loop (port of ``mapreduce_tpu/engine/autotune.py``):
controllers that consume the port's telemetry and act on it.

Every decision lands in the control ledger (:mod:`..obs.control`) with
its evidence and its NEXT window's measured outcome, so the loop is
auditable end to end.  Four controllers and one facade:

* :class:`RepartitionController`: skew-aware repartition.  Reads a
  session stream's exchange traffic matrix per feed window; when the
  window's recv imbalance crosses the threshold, it bins the stream's
  resident hash buckets onto partitions greedily
  (:func:`plan_rebalance`) and installs the table mid-stream through
  :meth:`~.session.EngineSession.rebalance`, bit-identical to a run
  under the new table from the start, and REFUSED loudly (counted,
  stream untouched) when a partition's re-binned rows would overflow
  ``out_capacity``.
* :class:`CapacityController`: capacity autotuning.  Learns right-sized
  ``local/exchange/out/combine`` capacities from the engine's
  capacity-retry forensics (every in-run resize notes its old->new
  capacities here) and pre-sizes the NEXT run's config, or a session's
  at its door (a session cannot retry).
* :class:`AdmissionAdvisor`: telemetry-informed admission.  Scores
  candidate placements by warmth (serving the tenant's program there
  needs no ``nvcc``) and device-memory headroom, so the scheduler routes
  a task where it can be served NOW.
* :class:`SpeculativeReclaimer`: straggler-driven speculative re-claim
  on the host plane.  The MAD straggler test, applied live to RUNNING
  job docs: a job held far beyond every OTHER worker's completed-job
  latency profile is re-claimed (the reap transition, claim-guarded)
  BEFORE its lease expires; exactly-once rides the existing claim
  fencing (the deposed worker's next heartbeat answers False and its
  run fences at the next emit).

Embedder contract: nothing here runs unless attached
(``DeviceEngine(autotune=)``, ``EngineSession(autotune=)``,
``Scheduler(advisor=)``, ``Server(reclaim=)``): a run with controllers
disabled records ZERO decisions and computes what it computed before.
The CLI surfaces attach them.

Differences from the JAX package: :func:`local_mesh_facts` also counts
a program warm when every kernel library it launches passes
``kernel_compat.is_built``, and reads memory from
``torch.cuda.mem_get_info``.  The capacity controller reads the compile
ledger's shape registry (:mod:`..obs.compile`) as the JAX one does.
The :class:`FleetRebalancer` moves the coldest stream off a host whose
heartbeat facts show memory pressure (:mod:`.migrate`).

Monotonic-only module: controllers time control windows; the persisted
job timestamps the reclaimer compares are minted by
``coord/docstore.now`` like every board stamp.  The module imports no
torch (a host-plane server builds a reclaimer without it).
"""

from __future__ import annotations

import logging
import threading
import weakref
from dataclasses import replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..obs import control as _control
from ..obs.analysis import STRAGGLER_MAD_K, _mad, _median
from ..obs.comms import matrix_stats
from ..utils.constants import STATUS

logger = logging.getLogger("mapreduce_tpu_torch.autotune")


# -- skew-aware repartition ---------------------------------------------------


#: a window's recv imbalance (max/mean of the traffic-matrix column
#: deltas) at or above this triggers a rebalance plan
REBALANCE_IMBALANCE = 1.5
#: windows smaller than this many routed records are noise, not skew
REBALANCE_MIN_RECORDS = 256
#: outcome classification: the next window's imbalance must come in at
#: or below this fraction OF the decision's evidence imbalance to count
#: as improved
IMPROVE_FRACTION = 0.9


def plan_rebalance(bucket_weights: np.ndarray, n_dev: int) -> np.ndarray:
    """Greedy longest-processing-time binning of hash buckets onto
    partitions: heaviest bucket first, each onto the currently lightest
    partition.  Deterministic (ties break on bucket index, then on
    partition index): the same weights always give the same table."""
    w = np.asarray(bucket_weights, dtype=np.int64)
    order = sorted(range(w.shape[0]), key=lambda b: (-int(w[b]), b))
    load = [0] * n_dev
    pmap = np.zeros(w.shape[0], dtype=np.int32)
    for b in order:
        p = min(range(n_dev), key=lambda d: (load[d], d))
        pmap[b] = p
        load[p] += int(w[b])
    return pmap


class RepartitionController:
    """Between-feed skew control for :class:`~.session.EngineSession`
    streams (``partition_map`` + ``exchange_stats`` configs).

    Called at each feed epilogue (outside the session lock): reads the
    stream's traffic-matrix WINDOW (cumulative matrix minus the last
    window's), resolves any pending decision against it, and, when the
    window's recv imbalance crosses the threshold, re-bins the stream's
    resident buckets and installs the new table mid-stream."""

    def __init__(self, ledger: _control.ControlLedger = None,
                 imbalance_threshold: float = REBALANCE_IMBALANCE,
                 min_records: int = REBALANCE_MIN_RECORDS) -> None:
        self.ledger = ledger if ledger is not None else _control.LEDGER
        self.imbalance_threshold = float(imbalance_threshold)
        self.min_records = int(min_records)
        self._lock = threading.Lock()
        #: per-session {task: window state}, WEAK keys: a dropped
        #: session's windows vanish with it (a tuner shared across
        #: short-lived sessions must neither leak state nor alias a new
        #: session to a dead one's cumulative matrix via id() reuse)
        self._state: "weakref.WeakKeyDictionary[Any, Dict[str, Dict]]" \
            = weakref.WeakKeyDictionary()

    def _task_state(self, session, task: str) -> Dict[str, Any]:
        by_task = self._state.get(session)
        if by_task is None:
            by_task = self._state.setdefault(session, {})
        return by_task.setdefault(str(task), {"last": None,
                                              "pending": None,
                                              "evidence": None})

    def _window(self, session, task: str,
                matrix: np.ndarray) -> Optional[Dict[str, Any]]:
        """This window's matrix stats (delta vs the last call)."""
        with self._lock:
            st = self._task_state(session, task)
            last = st["last"]
            st["last"] = matrix
        delta = matrix if last is None else matrix - last
        if int(delta.sum()) <= 0:
            return None
        return matrix_stats(delta.tolist())

    def after_feed(self, session, task: str) -> Optional[int]:
        """The feed-epilogue hook; returns the new decision id when a
        rebalance was applied or refused, else None."""
        cfg = session.config
        if not (cfg.partition_map and cfg.exchange_stats):
            return None
        matrix = session.traffic_matrix(task)
        if matrix is None:
            return None
        stats = self._window(session, task,
                             np.asarray(matrix, dtype=np.int64))
        if stats is None:
            return None
        self._resolve_pending(session, task, stats)
        if (stats["imbalance_recv"] < self.imbalance_threshold
                or stats["records"] < self.min_records):
            return None
        with self._lock:
            if self._task_state(session, task)["pending"] is not None:
                return None  # one decision in flight per stream window
        weights = session.bucket_histogram(task)
        if weights is None or int(weights.sum()) == 0:
            return None
        pmap = plan_rebalance(weights, session.engine.n_dev)
        with self._lock:
            refused = self._task_state(session, task).get("refused")
        if (refused is not None
                and np.array_equal(refused["pmap"], pmap)
                and stats["imbalance_recv"] <= refused["imbalance"]):
            # this exact plan was already refused on evidence at least
            # this strong: re-attempting would re-bin the whole resident
            # accumulator AND write one refused row PER FEED: wait for
            # materially new evidence or a different plan
            return None
        old = session.partition_map(task)
        evidence = {
            "imbalance_recv": stats["imbalance_recv"],
            "hot_dst": int(stats["hot_dst"]),
            "hot_dst_share": stats["hot_dst_share"],
            "window_records": int(stats["records"]),
            "source": "exchange_matrix",
        }
        if old is not None and np.array_equal(old, pmap):
            return None  # the balanced table IS the current one
        moved = (int(np.count_nonzero(old != pmap))
                 if old is not None else int(pmap.shape[0]))
        action = {
            "moved_buckets": moved,
            "buckets": int(pmap.shape[0]),
            "partitions": int(session.engine.n_dev),
        }
        note = ("rebalanced P{:05d} off device {}: recv share "
                "{:.0%} at {:.1f}x uniform".format(
                    int(stats["hot_dst"]), int(stats["hot_dst"]),
                    stats["hot_dst_share"], stats["imbalance_recv"]))
        from .spill import SessionRestoreError

        try:
            session.rebalance(task, pmap)
        except SessionRestoreError as exc:
            # the refusal contract: re-binning would overflow a
            # partition: counted, loud, stream untouched.  The plan is
            # memoized so the next feed does not re-pay the re-bin and
            # re-record the same refusal on no-better evidence.
            with self._lock:
                self._task_state(session, task)["refused"] = {
                    "pmap": pmap,
                    "imbalance": stats["imbalance_recv"]}
            return self.ledger.record(
                "repartition", task, evidence,
                {**action, "refused": str(exc)}, outcome="refused",
                note="rebalance refused: " + str(exc))
        except Exception as exc:
            # the stream was evicted, closed or poisoned between the
            # evidence read and the install: the feed whose epilogue ran
            # this hook already FOLDED its rows, so raising here would
            # invite a double-counting re-feed: recorded loudly (ledger
            # outcome=error + log), never raised into serving.  str(exc)
            # eagerly: a retained LogRecord must not pin the frames.
            logger.warning("rebalance of %r failed: %s", task, str(exc))
            return self.ledger.record(
                "repartition", task, evidence,
                {**action, "error": str(exc)}, outcome="error",
                note="rebalance errored: " + str(exc))
        did = self.ledger.record("repartition", task, evidence, action,
                                 outcome="pending", note=note)
        with self._lock:
            st = self._task_state(session, task)
            st["pending"] = did
            st["evidence"] = evidence
            st["refused"] = None  # a landed rebalance resets the memo
        return did

    def _resolve_pending(self, session, task: str,
                         stats: Dict[str, Any]) -> None:
        """Land the measured outcome of the previous window's decision:
        this window ran under the rebalanced table."""
        if stats["records"] < self.min_records:
            # the same noise floor new decisions obey: a trickle
            # window's imbalance is hash luck, not a measurement; the
            # decision stays pending until a real window lands
            return
        with self._lock:
            st = self._task_state(session, task)
            did = st.get("pending")
            before = (st.get("evidence") or {}).get("imbalance_recv")
            if did is None:
                return
            st["pending"] = None
        after = stats["imbalance_recv"]
        if before and after <= before * IMPROVE_FRACTION:
            outcome = "improved"
        elif before and after > before:
            outcome = "regressed"
        else:
            outcome = "neutral"
        self.ledger.resolve(
            did, outcome,
            {"imbalance_recv_before": before,
             "imbalance_recv_after": after,
             "window_records": int(stats["records"])},
            note="imbalance {:.1f}x -> {:.1f}x".format(
                before or 0.0, after))


# -- capacity autotuning ------------------------------------------------------


#: the EngineConfig fields the controller learns (the capacity-retry
#: forensics payload, minus tile_records which the engine's resize
#: bounds by tile)
_CAPACITY_FIELDS = ("local_capacity", "exchange_capacity",
                    "out_capacity", "combine_capacity")


class CapacityController:
    """Cross-run capacity learning: the engine's in-run retry loop
    already right-sizes a single run; this controller makes the NEXT
    run (or session, which cannot retry at all) start right-sized.

    Sources, in evidence order: capacity-retry forensics
    (:meth:`note_retry`, called by the engine at every resize) and the
    shape registry's replayable configs (the capacities that eventually
    ran on this machine, surviving process restarts)."""

    def __init__(self, ledger: _control.ControlLedger = None) -> None:
        self.ledger = ledger if ledger is not None else _control.LEDGER
        self._lock = threading.Lock()
        #: key -> {"caps": {field: learned}, "retries": n, "pending": id}
        self._state: Dict[str, Dict[str, Any]] = {}

    def _entry(self, key: str) -> Dict[str, Any]:
        return self._state.setdefault(
            str(key), {"caps": {}, "retries": 0, "pending": None,
                       "source": None, "applied": None})

    def note_retry(self, key: str, old_caps: Dict[str, int],
                   new_caps: Dict[str, int], task: str = "-") -> None:
        """A capacity retry's forensics, max-merged into the learned
        state (the engine calls this at every in-run resize)."""
        with self._lock:
            st = self._entry(key)
            st["retries"] += 1
            for field in _CAPACITY_FIELDS:
                v = int(new_caps.get(field) or 0)
                if v > int(st["caps"].get(field) or 0):
                    st["caps"][field] = v
            st["source"] = "retry_forensics"

    def _registry_caps(self, key: str, cfg) -> Dict[str, int]:
        """Learned capacities from the shape registry: the max of every
        device-engine bucket whose map_fn matches this key's program
        family, from its replay spec or, for a run that cannot replay (a
        callable reduce op), its ``sizing``."""
        from ..obs.compile import LEDGER as _COMPILE_LEDGER

        out: Dict[str, int] = {}
        try:
            buckets = _COMPILE_LEDGER.disk_buckets()
        except Exception as exc:
            logger.debug("shape registry unavailable: %s", str(exc))
            return out
        fn_token = str(key).split("|", 1)[0]
        for rec in buckets.values():
            spec = rec.get("replay")
            if (not isinstance(spec, dict)
                    or spec.get("kind") != "device_engine"):
                spec = rec.get("sizing")
            if not isinstance(spec, dict) or spec.get("map_fn") != fn_token:
                continue
            for field in _CAPACITY_FIELDS:
                v = int((spec.get("config") or {}).get(field) or 0)
                if v > out.get(field, 0):
                    out[field] = v
        return out

    def recommend_config(self, cfg, key: str, task: str = "-"):
        """The run-entry hook: returns *cfg* with any learned capacity
        raised to its learned value (never lowered: a user's generous
        explicit capacity always stands), recording ONE control decision
        when anything actually changed."""
        with self._lock:
            st = self._entry(key)
            learned = dict(st["caps"])
            retries = st["retries"]
            source = st["source"]
            pending = st["pending"]
        reg = self._registry_caps(key, cfg)
        for field, v in reg.items():
            if v > learned.get(field, 0):
                learned[field] = v
                source = (source + "+shape_registry" if source
                          else "shape_registry")
        changes = {}
        for field in _CAPACITY_FIELDS:
            have = int(getattr(cfg, field))
            want = int(learned.get(field) or 0)
            if want > have:
                changes[field] = {"old": have, "new": want}
        if not changes:
            return cfg
        new_cfg = replace(cfg, **{f: c["new"]
                                  for f, c in changes.items()})
        with self._lock:
            already = self._entry(key)["applied"] == changes
        if already:
            # steady state: the same learned capacities re-applied to
            # the same base config are ONE decision (already recorded
            # and measured), not one per run
            return new_cfg
        if pending is None:
            did = self.ledger.record(
                "capacity", task,
                {"capacity_retries_observed": retries,
                 "learned": learned, "source": source or "unknown"},
                {"changes": changes}, outcome="pending",
                note="pre-sized {} from {}".format(
                    "/".join(sorted(changes)), source or "learning"))
            with self._lock:
                st = self._entry(key)
                st["pending"] = did
                st["applied"] = changes
        return new_cfg

    def note_run(self, key: str, retries: int, task: str = "-") -> None:
        """The next window's measurement: a pre-sized run that did not
        retry proves the learned capacities converged."""
        with self._lock:
            st = self._entry(key)
            did = st["pending"]
            st["pending"] = None
        if did is None:
            return
        outcome = "improved" if retries == 0 else "neutral"
        self.ledger.resolve(
            did, outcome, {"retries_after": int(retries)},
            note=("converged: zero capacity retries" if retries == 0
                  else f"{retries} retr{'y' if retries == 1 else 'ies'}"
                       " after pre-sizing (needs were lower bounds)"))

    def note_session_feed(self, key: str, overflow_rows: int,
                          task: str = "-") -> None:
        """The session-plane measurement: sessions cannot retry, so a
        pre-sized stream's first feed either fits (overflow-free: the
        learned capacities converged) or proves the needs were lower
        bounds."""
        with self._lock:
            st = self._entry(key)
            did = st["pending"]
            st["pending"] = None
        if did is None:
            return
        outcome = "improved" if overflow_rows == 0 else "neutral"
        self.ledger.resolve(
            did, outcome, {"overflow_rows_after": int(overflow_rows)},
            note=("converged: pre-sized session feed ran overflow-free"
                  if overflow_rows == 0 else
                  "{} rows overflowed after pre-sizing (needs were "
                  "lower bounds)".format(int(overflow_rows))))


# -- telemetry-informed admission ---------------------------------------------


class AdmissionAdvisor:
    """Route a tenant's task to the placement that can serve it NOW.

    Hosts :meth:`register_mesh` their placement facts: which program
    tokens are warm there and the worst device's memory use fraction.
    The scheduler asks :meth:`choose` at admission; the pick and its
    per-candidate evidence land in the control ledger.  Score: warm
    beats cold (an avoided cold build dominates everything), headroom
    breaks ties (1 - hbm_frac)."""

    #: a mesh above this memory fraction is pressure-penalized even
    #: when warm
    PRESSURE_FRAC = 0.8

    def __init__(self, ledger: _control.ControlLedger = None) -> None:
        self.ledger = ledger if ledger is not None else _control.LEDGER
        self._lock = threading.Lock()
        self._meshes: Dict[str, Dict[str, Any]] = {}

    def register_mesh(self, mesh_id: str, warm_programs=(),
                      hbm_frac: Optional[float] = None) -> None:
        """(Re-)announce a placement: *warm_programs* are program tokens
        the host can serve without a build; *hbm_frac* the worst
        device's bytes in use over its total (None = unknown, scored as
        half-full)."""
        with self._lock:
            self._meshes[str(mesh_id)] = {
                "warm": set(map(str, warm_programs)),
                "hbm_frac": None if hbm_frac is None
                else float(hbm_frac),
            }

    def unregister_mesh(self, mesh_id: str) -> None:
        """Forget a placement (a host that left): an unregistered mesh
        is never chosen again.  Unknown ids are a no-op."""
        with self._lock:
            self._meshes.pop(str(mesh_id), None)

    def candidates(self) -> List[str]:
        with self._lock:
            return sorted(self._meshes)

    def _score(self, entry: Dict[str, Any], program: str,
               ) -> Tuple[float, Dict[str, Any]]:
        warm = str(program) in entry["warm"]
        frac = entry["hbm_frac"]
        headroom = 1.0 - (0.5 if frac is None else min(max(frac, 0.0),
                                                       1.0))
        score = (2.0 if warm else 0.0) + headroom
        if frac is not None and frac >= self.PRESSURE_FRAC:
            score -= 2.0  # pressure outweighs warmth: don't OOM a warm mesh
        return score, {"warm": warm, "hbm_frac": frac,
                       "score": round(score, 4)}

    def choose(self, program: str, tenant: str = "-",
               task: str = "-") -> Optional[str]:
        """Pick a registered mesh for *program*; None with nothing
        registered (the scheduler then routes as before: the advisor
        must never block admission)."""
        with self._lock:
            meshes = {m: dict(e, warm=set(e["warm"]))
                      for m, e in self._meshes.items()}
        if not meshes:
            return None
        scored = {m: self._score(e, program)
                  for m, e in sorted(meshes.items())}
        best = max(scored, key=lambda m: (scored[m][0], m))
        if len(meshes) > 1 or scored[best][1]["warm"]:
            # a one-candidate cold pick is not a decision worth a ledger
            # row; a real choice (or a warm hit) is
            frac = scored[best][1]["hbm_frac"]
            head = ("headroom unknown" if frac is None
                    else "headroom {:.0%}".format(1.0 - frac))
            self.ledger.record(
                "admission", task,
                {"tenant": str(tenant), "program": str(program),
                 "candidates": {m: s[1] for m, s in scored.items()}},
                {"mesh": best}, outcome="applied",
                note="routed {} to mesh {} ({}, {})".format(
                    tenant, best,
                    "warm" if scored[best][1]["warm"] else "cold",
                    head))
        return best


def local_mesh_facts() -> Tuple[List[str], Optional[float]]:
    """The LOCAL process's placement facts for
    :meth:`AdmissionAdvisor.register_mesh`: the program tokens the
    compile ledger holds buckets for (its in-process records and the
    enabled cache's shape registry, as in the JAX function), with
    ``"wave"`` (the device engine's wave at the default config) and
    ``"tf_step"`` (the transformer step) also warm when every kernel
    library they launch passes ``kernel_compat.is_built`` (serving them
    here needs no ``nvcc``), and the worst card's memory use fraction,
    ``torch.cuda.memory_allocated`` over the total of
    ``torch.cuda.mem_get_info`` (None on the CPU, as the JAX function
    returns None when no device reported).  The CLI runner registers
    these under its host id and refreshes them while it serves."""
    import torch

    from ..ops import kernel_compat as kc
    from .device_engine import EngineConfig

    from ..obs.compile import LEDGER as _compile_ledger

    programs = {"wave": kc.sources_for(EngineConfig()),
                "tf_step": ("flash_attention",)}
    warm = {tok for tok, libs in programs.items()
            if all(kc.is_built(n) for n in libs)}
    warm.update((_compile_ledger.snapshot().get("programs") or {}).keys())
    try:
        for rec in _compile_ledger.disk_buckets().values():
            if rec.get("program"):
                warm.add(str(rec["program"]))
    except Exception as exc:
        logger.debug("shape registry unavailable: %s", str(exc))
    warm = sorted(warm)
    worst = None
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            _free, total = torch.cuda.mem_get_info(i)
            if total:
                frac = float(torch.cuda.memory_allocated(i)) / float(total)
                worst = frac if worst is None else max(worst, frac)
    return warm, worst


# -- fleet rebalancing (live migration off a hot host) ------------------------


class FleetRebalancer:
    """Move streams off an engine host running hot.

    The fleet registry's heartbeat facts carry every host's worst
    device-memory fraction (published by the host's own
    :func:`local_mesh_facts`: on the card the CUDA allocator's bytes
    over the card's total).  One :meth:`step` per control window: for
    each LIVE host at or over the pressure threshold, pick its COLDEST
    resident stream (oldest last touch — evicting the coldest frees
    device memory at the least serving cost, and the hot stream that CAUSED the
    pressure keeps its warm placement) and migrate it to the
    best-scored live host with headroom (warmth beats cold, headroom
    breaks ties — the AdmissionAdvisor score over heartbeat facts).
    Every move is one control-ledger ``fleet`` decision carrying the
    pressure evidence; a window with nowhere to move records ONE
    refused decision per hot host until the situation changes (never
    one per window — alarm spam is not auditability).

    *sessions* maps host id -> :class:`~.session.EngineSession` for
    the hosts this process can reach (the in-process fleet shape the
    test fixtures run); hosts without a reachable session are
    skipped — their streams move through the scheduler's failed-host
    recovery sweep instead.

    A session over a process group is a host too, named by its rank 0's
    host id: every rank of the group calls :meth:`step` with it, the
    group's coldest stream comes from the ranks' gathered ages, rank 0
    decides every move from its own read of the board and shares the
    decision (:func:`..parallel.mesh.on_rank0`), and every rank then
    runs the same migrations (a one-process source among *sessions*
    moves on rank 0 alone, and a group destination adopts the stream
    on every rank), so the ranks never pick different victims."""

    #: a host at or above this worst-device memory fraction is "running
    #: hot" (the AdmissionAdvisor pressure threshold)
    PRESSURE_FRAC = AdmissionAdvisor.PRESSURE_FRAC

    def __init__(self, registry, ledger: _control.ControlLedger = None,
                 pressure_frac: Optional[float] = None) -> None:
        self.registry = registry
        self.ledger = ledger if ledger is not None else _control.LEDGER
        self.pressure_frac = float(
            self.PRESSURE_FRAC if pressure_frac is None
            else pressure_frac)
        #: hot hosts whose "no destination" refusal is already recorded
        self._refused_hosts: set = set()

    def step(self, sessions: Dict[str, Any],
             ) -> List[Tuple[str, str]]:
        """One control window; returns the ``(task, dst_host)`` moves
        made (the same list on every rank of a group)."""
        from ..parallel.mesh import on_rank0
        from .migrate import migrate as _migrate

        group = next((s.group for s in sessions.values()
                      if s.group is not None), None)
        # a group session's coldest stream is a collective read, so
        # every rank takes it before rank 0 decides
        victims = {h: s.coldest_task() for h, s in sorted(sessions.items())
                   if s.group is not None}
        plan = on_rank0(group, lambda: self._plan(sessions, victims))
        lead = True  # this process moves one-process sources
        if group is not None:
            import torch.distributed as dist

            lead = dist.get_rank(group) == 0
        for victim, host_id, dst, evidence in plan:
            sess, into = sessions.get(host_id), sessions.get(dst)
            if into is not None and into.group is not None:
                # a group destination lifts a handed-off mark on every
                # rank, also where rank 0 alone moves the source
                into.adopt(victim)
            if sess is None or (sess.group is None and not lead):
                continue
            _migrate(victim, sess, into,
                     registry=self.registry, src_host=host_id,
                     dst_host=dst, reason="rebalance",
                     ledger=self.ledger, evidence=evidence)
        return [(victim, dst) for victim, _, dst, _ in plan]

    def _plan(self, sessions: Dict[str, Any], victims: Dict[str, Any],
              ) -> List[Tuple[str, str, str, Dict[str, Any]]]:
        """The window's ``(victim, src_host, dst_host, evidence)`` moves
        from one read of the board; a hot host with nowhere to go gets
        its one refused decision here.  *victims* holds the group
        sessions' coldest streams."""
        from ..coord import docstore as _docstore
        from ..coord.fleet import _score_host, host_state

        now = _docstore.now()
        live = {str(d["_id"]): d for d in self.registry.hosts()
                if host_state(d, now) == "live"}
        plan = []
        for host_id, doc in sorted(live.items()):
            frac = (doc.get("facts") or {}).get("hbm_frac")
            if frac is None or float(frac) < self.pressure_frac:
                self._refused_hosts.discard(host_id)
                continue
            sess = sessions.get(host_id)
            if sess is None:
                continue
            cands = {
                h: d for h, d in live.items()
                if h != host_id
                and (((d.get("facts") or {}).get("hbm_frac"))
                     is None
                     or float(d["facts"]["hbm_frac"])
                     < self.pressure_frac)}
            victim = (victims[host_id] if host_id in victims
                      else sess.coldest_task())
            evidence = {
                "src": host_id, "hbm_frac": float(frac),
                "pressure_frac": self.pressure_frac,
                "source": "fleet_heartbeat_facts",
            }
            if victim is None:
                self._refused_hosts.discard(host_id)
                continue  # hot but nothing resident to move
            if not cands:
                if host_id not in self._refused_hosts:
                    self._refused_hosts.add(host_id)
                    self.ledger.record(
                        "fleet", victim, evidence,
                        {"reason": "rebalance", "deferred": True},
                        outcome="refused",
                        note=f"host {host_id} hot at "
                             f"{float(frac):.0%} HBM but no live "
                             "host has headroom — deferring")
                continue
            self._refused_hosts.discard(host_id)
            rt = self.registry.route(victim)
            program = rt.get("program") if rt else None
            scored = {h: _score_host(d, program)
                      for h, d in sorted(cands.items())}
            dst = max(scored, key=lambda h: (scored[h][0], h))
            evidence["candidates"] = {h: s[1]
                                      for h, s in scored.items()}
            plan.append((victim, host_id, dst, evidence))
        return plan


# -- straggler-driven speculative re-claim ------------------------------------


#: a running job is re-claimed only when its age exceeds the peer
#: baseline by the MAD test AND this ratio AND this absolute floor
RECLAIM_MIN_RATIO = 3.0
RECLAIM_MIN_AGE_S = 1.0
#: completed jobs (with real_time) other workers must have before any
#: baseline exists: no peers, no speculation
RECLAIM_MIN_PEER_JOBS = 2


class SpeculativeReclaimer:
    """Server-side speculative re-claim of straggler-held RUNNING jobs.

    Baseline: every OTHER worker's completed-job ``real_time`` durations
    (monotonic-measured, persisted at write).  A RUNNING job's age
    (board wall clock ``now - started_time``, the comparison every lease
    check makes) is flagged when it exceeds ``median + K·1.4826·MAD``
    AND ``ratio × median`` AND the absolute floor.  The re-claim is the
    reap transition (claim-guarded ``RUNNING -> BROKEN`` + repetitions)
    taken EARLY: the deposed worker's heartbeat guard fails, its run
    fences at the next emit, and another worker claims the re-issued
    copy.  FINISHED jobs (user fn done, output writing) are never
    touched: their work is done."""

    def __init__(self, ledger: _control.ControlLedger = None,
                 mad_k: float = STRAGGLER_MAD_K,
                 min_ratio: float = RECLAIM_MIN_RATIO,
                 min_age_s: float = RECLAIM_MIN_AGE_S) -> None:
        self.ledger = ledger if ledger is not None else _control.LEDGER
        self.mad_k = float(mad_k)
        self.min_ratio = float(min_ratio)
        self.min_age_s = float(min_age_s)
        #: reclaimed job -> pending decision id, resolved when the job
        #: reaches a terminal state on a later scan
        self._pending: Dict[Tuple[str, str], int] = {}

    def _latencies(self, docs) -> Dict[str, List[float]]:
        out: Dict[str, List[float]] = {}
        for d in docs:
            if d.get("status") != int(STATUS.WRITTEN):
                continue
            w = d.get("worker")
            rt = d.get("real_time")
            if w and isinstance(rt, (int, float)) and rt >= 0:
                out.setdefault(str(w), []).append(float(rt))
        return out

    def _resolve_written(self, did: int, jid: str, doc) -> None:
        self.ledger.resolve(
            did, "improved",
            {"completed_by": doc.get("worker"),
             "real_time_s": doc.get("real_time")},
            note=f"job {jid} completed by {doc.get('worker')} after "
                 "re-claim")

    def _resolve_vanished(self, did: int, jid: str) -> None:
        self.ledger.resolve(
            did, "neutral", {"status": "vanished"},
            note=f"job {jid} doc vanished before its outcome was "
                 "observed")

    def scan(self, store, coll: str) -> List[str]:
        """One control window over *coll*: resolve prior re-claims that
        completed, then re-claim any newly flagged straggler-held job.
        Returns the job ids re-claimed this scan."""
        from ..coord import docstore

        # filtered like the surrounding poll loop: the scan needs only
        # RUNNING (candidates), WRITTEN (baselines + resolution) and
        # FAILED (resolution) docs; an unfiltered find would dominate
        # board traffic on exactly the large runs where speculation
        # matters.  Pending re-claims are $or'd in BY ID so a job
        # transiting BROKEN/PENDING is never misread as vanished.
        query: Dict[str, Any] = {"status": {"$in": [
            int(STATUS.RUNNING), int(STATUS.WRITTEN),
            int(STATUS.FAILED)]}}
        pend_ids = [jid for (pcoll, jid) in self._pending
                    if pcoll == coll]
        if pend_ids:
            query = {"$or": [query, {"_id": {"$in": pend_ids}}]}
        docs = store.find(coll, query)
        by_id = {str(d.get("_id")): d for d in docs}
        # resolve prior windows first: a re-claimed job another worker
        # carried to WRITTEN proves the speculation paid off
        for (pcoll, jid), did in list(self._pending.items()):
            if pcoll != coll:
                continue
            doc = by_id.get(jid)
            if doc is None:
                # the job doc VANISHED (its task completed and the
                # collection was dropped): terminal for the ledger, or
                # the record/resolve counter sums disagree forever
                self._pending.pop((pcoll, jid))
                self._resolve_vanished(did, jid)
                continue
            status = doc.get("status")
            if status == int(STATUS.WRITTEN):
                self._pending.pop((pcoll, jid))
                self._resolve_written(did, jid, doc)
            elif status == int(STATUS.FAILED):
                self._pending.pop((pcoll, jid))
                self.ledger.resolve(did, "regressed",
                                    {"status": "FAILED"})
        lat = self._latencies(docs)
        now = docstore.now()
        reclaimed: List[str] = []
        for d in docs:
            if d.get("status") != int(STATUS.RUNNING):
                continue
            worker = str(d.get("worker") or "")
            age = now - float(d.get("started_time") or now)
            # leave-one-out baseline: every OTHER worker's completed
            # latencies (a straggler's own history must not raise the
            # bar it is judged against)
            peers = [v for w, vals in lat.items() if w != worker
                     for v in vals]
            if len(peers) < RECLAIM_MIN_PEER_JOBS:
                continue
            med = _median(peers)
            gate = max(med + self.mad_k * 1.4826 * _mad(peers, med),
                       med * self.min_ratio, self.min_age_s)
            if age <= gate:
                continue
            jid = str(d.get("_id"))
            if (coll, jid) in self._pending:
                continue  # already speculated; waiting on the outcome
            # the reap transition, taken early and CLAIM-GUARDED: only
            # the still-running original claim can be broken
            got = store.find_and_modify(
                coll,
                {"_id": d.get("_id"), "worker": d.get("worker"),
                 "tmpname": d.get("tmpname"),
                 "status": int(STATUS.RUNNING)},
                {"$set": {"status": int(STATUS.BROKEN)},
                 "$inc": {"repetitions": 1}})
            if got is None:
                continue
            did = self.ledger.record(
                "reclaim", coll.rsplit(".", 1)[0],
                {"worker": worker, "job_age_s": round(age, 3),
                 "peer_median_s": round(med, 3),
                 "peer_jobs": len(peers),
                 "gate_s": round(gate, 3)},
                {"job": jid, "reclaimed_from": worker},
                outcome="pending",
                note="re-claimed job {} off straggler {} "
                     "({:.1f}s held vs {:.2f}s peer median)".format(
                         jid, worker, age, med))
            self._pending[(coll, jid)] = did
            reclaimed.append(jid)
            logger.warning(
                "speculative re-claim: job %s off %s (%.1fs held, "
                "peer median %.2fs)", jid, worker, age, med)
        return reclaimed

    def finish(self, store, coll: str) -> None:
        """Phase-completion sweep: resolve every still-pending re-claim
        for *coll* from the final job docs (scan() stops running when
        the phase drains, and a pending row must not outlive it)."""
        pend = {jid: did for (pcoll, jid), did in self._pending.items()
                if pcoll == coll}
        if not pend:
            return
        docs = {str(d.get("_id")): d
                for d in store.find(coll,
                                    {"_id": {"$in": sorted(pend)}})}
        for jid, did in pend.items():
            self._pending.pop((coll, jid), None)
            doc = docs.get(jid)
            status = None if doc is None else doc.get("status")
            if status == int(STATUS.WRITTEN):
                self._resolve_written(did, jid, doc)
            elif status == int(STATUS.FAILED):
                self.ledger.resolve(did, "regressed",
                                    {"status": "FAILED"})
            elif doc is None:
                self._resolve_vanished(did, jid)
            else:
                self.ledger.resolve(
                    did, "neutral", {"status": "phase_ended"},
                    note=f"phase drained before job {jid}'s outcome "
                         "was observed")


# -- the facade ---------------------------------------------------------------


class AutoTuner:
    """One handle bundling the per-engine/session controllers (the
    advisor and reclaimer attach to the scheduler and server directly).
    Attach to a :class:`~.device_engine.DeviceEngine` or
    :class:`~.session.EngineSession`; each sub-controller can be
    disabled on its own."""

    def __init__(self, ledger: _control.ControlLedger = None,
                 repartition: bool = True, capacity: bool = True,
                 imbalance_threshold: float = REBALANCE_IMBALANCE,
                 min_records: int = REBALANCE_MIN_RECORDS) -> None:
        ledger = ledger if ledger is not None else _control.LEDGER
        self.ledger = ledger
        self.repartition = (RepartitionController(
            ledger, imbalance_threshold=imbalance_threshold,
            min_records=min_records) if repartition else None)
        self.capacity = CapacityController(ledger) if capacity else None

    # engine hooks (DeviceEngine.run) ------------------------------------

    def recommend_config(self, cfg, key: str, task: str = "-"):
        if self.capacity is None:
            return cfg
        return self.capacity.recommend_config(cfg, key, task=task)

    def note_retry(self, key: str, old_caps, new_caps,
                   task: str = "-") -> None:
        if self.capacity is not None:
            self.capacity.note_retry(key, old_caps, new_caps, task=task)

    def note_run(self, key: str, retries: int, task: str = "-") -> None:
        if self.capacity is not None:
            self.capacity.note_run(key, retries, task=task)

    def note_session_feed(self, key: str, overflow_rows: int,
                          task: str = "-") -> None:
        if self.capacity is not None:
            self.capacity.note_session_feed(key, overflow_rows,
                                            task=task)

    # session hook (EngineSession feed epilogue) -------------------------

    def after_feed(self, session, task: str) -> None:
        if self.repartition is not None:
            self.repartition.after_feed(session, task)
