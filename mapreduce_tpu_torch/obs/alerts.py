"""The alerting plane: durable alert rules evaluated on the board (port
of ``mapreduce_tpu/obs/alerts.py``).

The push half of the operator plane: the SLO burn rates and the
``/queryz`` history are pull-only, an alert pages.  Three rule kinds
share one grammar (``NAME:EXPR:OP:THRESHOLD[:FOR]``):

* **threshold** — ``increase|rate|delta(FAMILY{k=v,...}[WINDOW_S])``
  evaluated through :meth:`MetricHistory.query` verbatim, one alert
  instance per returned label set (``increase(mrtpu_kernel_launches_
  total{kernel=radix_onesweep}[300])`` fires on the card's launches);
* **burn** — ``burn(OBJECTIVE[,short|long])`` bound to the serving
  objectives of :mod:`.slo`, one instance per tenant;
* **anomaly** — ``anomaly(FAMILY{k=v,...}[WINDOW_S])``: the trailing
  window's increase scored against a median/MAD baseline learned from
  the preceding history windows; the rule value is the robust z-score.

Each (rule, label set) instance walks ``inactive -> pending(FOR) ->
firing -> resolved`` with flap damping on the way down.  EVERY
transition is an append to a generation-fenced :class:`MutationLog`
(``alert.log`` on the HA dir), so a promoted standby replays the log,
resumes ``pending`` timers from their persisted wall stamps, and never
re-enters ``firing`` for an instance the dead primary already fired.
The log's entries are the JAX package's, so either package replays the
other's log.

Notification sinks (webhook POST riding the shared
``RetryPolicy``/breaker, or an exec command fed JSON on stdin) drain
the log's firing/resolved transitions through per-sink cursor files on
the same shared dir — the cursor is re-read from disk at every pump,
which is what makes delivery resume-exactly-once across a SIGKILL
failover.  ``pending``/``inactive`` transitions never notify; silenced
transitions are logged but suppressed, and a silence expiring against a
still-firing instance appends a ``refire`` transition so the page
finally lands.

Surfaces: ``mrtpu_alert_transitions_total{rule,to}``,
``mrtpu_alert_notifications_total{sink,outcome}``,
``mrtpu_alerts_firing``; auth-gated ``/alertz`` (served from standbys
too); the ``alerts`` section of /statusz + ``status`` CLI; ``cli
alerts`` (list / silence / ack / --watch); ``alerts.json`` in profile
bundles behind the strict :func:`validate_alerts`.

With no rules configured nothing here runs — the plane snapshots empty
and the docserver never starts an evaluator.  Flap-damp clocks are
durations (``time.monotonic``); the persisted wall stamps on
transitions and silences are minted through ``coord.docstore.now``.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shlex
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .metrics import REGISTRY, counter, gauge

logger = logging.getLogger(__name__)

#: alert-instance lifecycle, in order
STATES = ("inactive", "pending", "firing", "resolved")

#: comparison operators the grammar accepts (symbols normalize to words)
OPS = {">": "gt", "<": "lt", ">=": "ge", "<=": "le",
       "gt": "gt", "lt": "lt", "ge": "ge", "le": "le"}

#: default trailing window for threshold/anomaly expressions, seconds
DEFAULT_WINDOW_S = 300.0

#: a firing instance resolves only after its condition has been false
#: continuously this long — one noisy window cannot flap a page
DEFAULT_FLAP_DAMP_S = 30.0

#: anomaly rules need this many fully-covered baseline windows before
#: they score anything (the leave-one-out test is meaningless on two
#: points)
ANOMALY_MIN_BASELINE = 4

#: how many baseline windows the anomaly scorer looks back over
ANOMALY_BASELINE_WINDOWS = 8

#: notifiable transitions retained in memory for sink pumps; a sink
#: further behind than this has its oldest deliveries dropped (loudly)
MAX_NOTIFIABLE = 256

#: exec sinks get this long to consume the notification on stdin
EXEC_SINK_TIMEOUT_S = 10.0

_TRANSITIONS = counter(
    "mrtpu_alert_transitions_total",
    "alert state-machine transitions by rule and destination state")
_NOTIFICATIONS = counter(
    "mrtpu_alert_notifications_total",
    "alert notifications attempted per sink, by outcome")
_FIRING = gauge(
    "mrtpu_alerts_firing",
    "alert instances currently in the firing state")

_EXPR_RX = re.compile(r"^(\w+)\((.*)\)$")
_SELECTOR_RX = re.compile(
    r"^([A-Za-z_:][\w:]*)\s*(?:\{([^}]*)\})?\s*(?:\[([0-9.]+)\])?$")
_CURSOR_SAFE_RX = re.compile(r"[^\w.-]")


# -- rule grammar ------------------------------------------------------------


@dataclass
class AlertRule:
    """One parsed rule.  ``kind`` selects how :meth:`AlertPlane._values`
    produces (label set, value) pairs; ``op``/``threshold``/``for_s``
    drive the shared state machine."""

    name: str
    kind: str                    # "threshold" | "burn" | "anomaly"
    expr: str                    # the EXPR segment, verbatim
    op: str                      # normalized: gt | lt | ge | le
    threshold: float
    for_s: float = 0.0
    # threshold/anomaly:
    family: str = ""
    matchers: Dict[str, str] = field(default_factory=dict)
    window_s: float = DEFAULT_WINDOW_S
    fn: str = "increase"
    # burn:
    objective: str = ""
    burn_window: str = "long"    # "short" | "long"

    def condition(self, value: float) -> bool:
        if self.op == "gt":
            return value > self.threshold
        if self.op == "lt":
            return value < self.threshold
        if self.op == "ge":
            return value >= self.threshold
        return value <= self.threshold

    def describe(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name, "kind": self.kind, "expr": self.expr,
            "op": self.op, "threshold": self.threshold,
            "for_s": self.for_s,
        }
        if self.kind in ("threshold", "anomaly"):
            out["family"] = self.family
            out["window_s"] = self.window_s
            if self.matchers:
                out["matchers"] = dict(self.matchers)
            if self.kind == "threshold":
                out["fn"] = self.fn
        else:
            out["objective"] = self.objective
            out["burn_window"] = self.burn_window
        return out


def _parse_matchers(raw: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        k, eq, v = part.partition("=")
        if not eq or not k.strip():
            raise ValueError(f"bad alert matcher {part!r} "
                             "(want key=value)")
        out[k.strip()] = v.strip().strip('"')
    return out


def _parse_selector(inner: str, what: str) -> Tuple[str, Dict[str, str],
                                                    float]:
    m = _SELECTOR_RX.match(inner.strip())
    if not m:
        raise ValueError(
            f"bad alert {what} selector {inner!r} "
            "(want FAMILY{k=v,...}[WINDOW_S])")
    family, matchers_raw, window_raw = m.group(1), m.group(2), m.group(3)
    matchers = _parse_matchers(matchers_raw) if matchers_raw else {}
    window_s = float(window_raw) if window_raw else DEFAULT_WINDOW_S
    if window_s <= 0:
        raise ValueError(f"alert window must be > 0, got {window_s}")
    return family, matchers, window_s


def parse_alert(spec: str,
                objectives: Optional[Sequence[str]] = None) -> AlertRule:
    """Parse one ``NAME:EXPR:OP:THRESHOLD[:FOR]`` rule spec.

    EXPR contains no colons by construction (matchers use ``=``), so a
    plain split is unambiguous.  *objectives* — when given — is the
    closed set of SLO objective names a ``burn()`` rule may bind; the
    docserver passes the configured plane's names so a typo fails at
    startup, not silently at evaluation time.
    """
    parts = [p.strip() for p in str(spec).split(":")]
    if len(parts) not in (4, 5):
        raise ValueError(
            f"bad alert spec {spec!r} "
            "(want NAME:EXPR:OP:THRESHOLD[:FOR])")
    name, expr, op_raw, thr_raw = parts[:4]
    if not re.match(r"^[\w.-]+$", name):
        raise ValueError(f"bad alert name {name!r}")
    op = OPS.get(op_raw)
    if op is None:
        raise ValueError(
            f"bad alert op {op_raw!r} (want one of "
            f"{sorted(set(OPS))})")
    try:
        threshold = float(thr_raw)
    except ValueError:
        raise ValueError(f"bad alert threshold {thr_raw!r}")
    for_s = 0.0
    if len(parts) == 5:
        try:
            for_s = float(parts[4])
        except ValueError:
            raise ValueError(f"bad alert for-duration {parts[4]!r}")
        if for_s < 0:
            raise ValueError(
                f"alert for-duration must be >= 0, got {for_s}")
    m = _EXPR_RX.match(expr)
    if not m:
        raise ValueError(
            f"bad alert expr {expr!r} (want "
            "rate|increase|delta|anomaly(SELECTOR) or burn(OBJECTIVE))")
    fn, inner = m.group(1), m.group(2)
    if fn in ("rate", "increase", "delta"):
        family, matchers, window_s = _parse_selector(inner, fn)
        return AlertRule(name=name, kind="threshold", expr=expr, op=op,
                         threshold=threshold, for_s=for_s, family=family,
                         matchers=matchers, window_s=window_s, fn=fn)
    if fn == "anomaly":
        family, matchers, window_s = _parse_selector(inner, fn)
        return AlertRule(name=name, kind="anomaly", expr=expr, op=op,
                         threshold=threshold, for_s=for_s, family=family,
                         matchers=matchers, window_s=window_s)
    if fn == "burn":
        obj, _, win = inner.partition(",")
        obj = obj.strip()
        burn_window = (win.strip() or "long")
        if burn_window not in ("short", "long"):
            raise ValueError(
                f"bad alert burn window {win.strip()!r} "
                "(want short or long)")
        if objectives is not None and obj not in objectives:
            raise ValueError(
                f"unknown alert objective {obj!r} "
                f"(configured: {sorted(objectives)})")
        if not obj:
            raise ValueError("alert burn() wants an objective name")
        return AlertRule(name=name, kind="burn", expr=expr, op=op,
                         threshold=threshold, for_s=for_s, objective=obj,
                         burn_window=burn_window)
    raise ValueError(
        f"bad alert expr function {fn!r} "
        "(want rate, increase, delta, anomaly or burn)")


def load_rules_file(path: str,
                    objectives: Optional[Sequence[str]] = None,
                    ) -> List[AlertRule]:
    """Load rules from a JSON file: either a bare array of spec strings
    or ``{"rules": [...]}``."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        doc = doc.get("rules")
    if not isinstance(doc, list):
        raise ValueError(
            f"alert rules file {path}: want a JSON array of "
            "NAME:EXPR:OP:THRESHOLD[:FOR] strings (or {\"rules\": [...]})")
    return [parse_alert(s, objectives=objectives) for s in doc]


# -- notification sinks ------------------------------------------------------


class WebhookSink:
    """POST each notification as JSON to ``http://host:port/path``,
    under a tight retry policy (pumps run on the evaluator thread; a
    dead receiver must not stall rule evaluation for long)."""

    def __init__(self, name: str, address: str, path: str = "/",
                 auth_token: Optional[str] = None,
                 retry: Optional[Any] = None) -> None:
        from ..utils.httpclient import KeepAliveClient, RetryPolicy
        self.name = name
        self.path = path
        self._client = KeepAliveClient.from_address(
            address, timeout=5.0, what="alert webhook sink",
            auth_token=auth_token,
            retry=retry if retry is not None else RetryPolicy(
                max_attempts=3, base_delay=0.05, max_delay=0.5,
                deadline=5.0, breaker_threshold=4,
                breaker_cooldown=5.0))

    def deliver(self, doc: Dict[str, Any]) -> None:
        body = json.dumps(doc, sort_keys=True).encode("utf-8")
        status, _data = self._client.request(
            "POST", self.path, body=body,
            headers={"Content-Type": "application/json"})
        if status >= 300:
            raise IOError(
                f"alert webhook {self.name}: status {status}")


class ExecSink:
    """Run a command per notification, the JSON doc on stdin — the
    'page me however you like' escape hatch (mailx, PagerDuty CLI, a
    test harness's append-to-file)."""

    def __init__(self, name: str, command: str,
                 timeout_s: float = EXEC_SINK_TIMEOUT_S) -> None:
        self.name = name
        self.argv = shlex.split(command)
        if not self.argv:
            raise ValueError("alert exec sink wants a command")
        self.timeout_s = timeout_s

    def deliver(self, doc: Dict[str, Any]) -> None:
        body = json.dumps(doc, sort_keys=True).encode("utf-8")
        proc = subprocess.run(
            self.argv, input=body, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, timeout=self.timeout_s)
        if proc.returncode != 0:
            raise IOError(
                "alert exec sink {}: rc={} stderr={!r}".format(
                    self.name, proc.returncode,
                    proc.stderr[-200:].decode("utf-8", "replace")))


def parse_webhook_spec(spec: str) -> WebhookSink:
    """``[NAME=]HOST:PORT`` → sink.  The name keys the durable delivery
    cursor, so give stable names when running several receivers."""
    name, eq, addr = spec.partition("=")
    if not eq:
        name, addr = "", spec
    addr = addr.strip()
    name = name.strip() or "webhook-" + addr.replace(":", "-")
    return WebhookSink(_CURSOR_SAFE_RX.sub("_", name), addr)


def parse_exec_spec(spec: str) -> ExecSink:
    """``[NAME=]COMMAND`` → sink (NAME must look like an identifier,
    else the whole spec is the command)."""
    name, eq, cmd = spec.partition("=")
    if not eq or not re.match(r"^[\w.-]+$", name.strip()):
        name, cmd = "", spec
    cmd = cmd.strip()
    name = name.strip() or "exec-" + (
        os.path.basename(shlex.split(cmd)[0]) if cmd.strip() else "cmd")
    return ExecSink(_CURSOR_SAFE_RX.sub("_", name), cmd)


# -- the plane ---------------------------------------------------------------


LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class AlertPlane:
    """Rules + state machine + durable log + sinks.  One per board
    process (the module-level :data:`PLANE`); the docserver's evaluator
    thread calls :meth:`evaluate` + :meth:`pump` on the primary and
    :meth:`refresh` on standbys so /alertz answers everywhere."""

    def __init__(self, flap_damp_s: float = DEFAULT_FLAP_DAMP_S) -> None:
        self._lock = threading.RLock()
        self.flap_damp_s = float(flap_damp_s)
        self.rules: List[AlertRule] = []
        self.sinks: List[Any] = []
        self.log: Optional[Any] = None
        self.log_dir: Optional[str] = None
        self._fsync = False
        self._gen_fn: Optional[Callable[[], int]] = None
        self._instances: Dict[Tuple[str, LabelKey], Dict[str, Any]] = {}
        self._silences: Dict[int, Dict[str, Any]] = {}
        self._notifiable: List[Dict[str, Any]] = []
        self._dropped_notifiable = 0
        self._seq = 0
        self._max_gen = 0
        self._offset = 0
        self._replayed = 0
        self._skipped_stale = 0
        self._rule_errors: Dict[str, str] = {}

    # -- configuration ------------------------------------------------------

    def configure(self, rules: Sequence[AlertRule],
                  log_dir: Optional[str] = None, fsync: bool = False,
                  gen_fn: Optional[Callable[[], int]] = None,
                  sinks: Sequence[Any] = (),
                  flap_damp_s: Optional[float] = None) -> None:
        """(Re)arm the plane.  *log_dir* holds ``alert.log`` plus the
        per-sink cursor files — point it at the shared HA dir and a
        promoted standby resumes exactly where the dead primary
        stopped."""
        from ..coord.persistent_table import MutationLog
        with self._lock:
            self._close_locked()
            self.rules = list(rules)
            self.sinks = list(sinks)
            self._gen_fn = gen_fn
            if flap_damp_s is not None:
                self.flap_damp_s = float(flap_damp_s)
            self._instances = {}
            self._silences = {}
            self._notifiable = []
            self._dropped_notifiable = 0
            self._seq = 0
            self._max_gen = 0
            self._offset = 0
            self._replayed = 0
            self._skipped_stale = 0
            self._rule_errors = {}
            self.log_dir = log_dir
            self._fsync = fsync
            if log_dir is not None:
                self.log = MutationLog(os.path.join(log_dir, "alert.log"),
                                       fsync=fsync)
                self._refresh_locked(replaying=True)

    def reset(self) -> None:
        """Back to unconfigured (tests, docserver shutdown)."""
        with self._lock:
            self._close_locked()
            self.rules, self.sinks = [], []
            self._instances, self._silences = {}, {}
            self._notifiable = []
            self._gen_fn, self.log_dir = None, None
            self._seq = self._max_gen = self._offset = 0
            self._replayed = self._skipped_stale = 0
            self._dropped_notifiable = 0
            self._rule_errors = {}
            _FIRING.set(0.0)

    close = reset

    def configured(self) -> bool:
        with self._lock:
            return bool(self.rules)

    # -- durable log --------------------------------------------------------

    def _refresh_locked(self, replaying: bool = False) -> None:
        """Tail new log entries (another generation's appends, or the
        whole log when *replaying* after configure/promotion)."""
        if self.log is None:
            return
        entries, self._offset = self.log.read_from(self._offset)
        for e in entries:
            self._apply_locked(e)
            if replaying:
                self._replayed += 1
        if entries:
            self._recount_locked()

    def refresh(self) -> None:
        """Standby path: absorb the primary's appends so /alertz and
        ``cli alerts`` against this process show the live lifecycle."""
        with self._lock:
            self._refresh_locked()

    def _append_locked(self, entry: Dict[str, Any]) -> Dict[str, Any]:
        self._seq += 1
        entry = dict(entry, g=self._gen(), n=self._seq)
        if self.log is not None:
            self.log.append(entry)
            self._offset = self.log.size()
        self._apply_locked(entry)
        return entry

    def _gen(self) -> int:
        if self._gen_fn is None:
            return self._max_gen
        try:
            return max(int(self._gen_fn() or 0), self._max_gen)
        except (TypeError, ValueError):
            return self._max_gen

    def _apply_locked(self, e: Dict[str, Any]) -> None:
        g = int(e.get("g") or 0)
        if g < self._max_gen:
            # a fenced-out generation's late write — the HA replay rule
            self._skipped_stale += 1
            return
        self._max_gen = g
        self._seq = max(self._seq, int(e.get("n") or 0))
        kind = e.get("kind")
        if kind == "transition":
            self._apply_transition_locked(e)
        elif kind == "silence":
            self._silences[int(e.get("n") or 0)] = {
                "rule": e.get("rule"), "until": float(e.get("until") or 0)}
            for (rname, _lk), inst in self._instances.items():
                if rname == e.get("rule") and inst["state"] == "firing":
                    inst["suppressed"] = True
        elif kind == "ack":
            for (rname, _lk), inst in self._instances.items():
                if rname == e.get("rule") and inst["state"] == "firing":
                    inst["acked"] = True
        # "noop": the promotion fence — nothing beyond the g bump

    def _apply_transition_locked(self, e: Dict[str, Any]) -> None:
        key = (str(e.get("rule")), _label_key(e.get("labels") or {}))
        to = e.get("to")
        inst = self._instances.setdefault(key, {
            "state": "inactive", "since": None, "pending_since": None,
            "firing_since": None, "value": None, "suppressed": False,
            "acked": False})
        t = e.get("t")
        inst["state"] = to
        inst["since"] = t
        inst["value"] = e.get("value")
        if to == "pending":
            inst["pending_since"] = t
            inst["firing_since"] = None
        elif to == "firing":
            if not e.get("refire"):
                inst["firing_since"] = t
            inst["pending_since"] = None
            inst["suppressed"] = bool(e.get("silenced"))
        else:
            inst["pending_since"] = inst["firing_since"] = None
            inst["suppressed"] = inst["acked"] = False
        _TRANSITIONS.inc(rule=key[0], to=str(to))
        if to in ("firing", "resolved") and not e.get("silenced"):
            self._notifiable.append(e)
            if len(self._notifiable) > MAX_NOTIFIABLE:
                drop = len(self._notifiable) - MAX_NOTIFIABLE
                del self._notifiable[:drop]
                self._dropped_notifiable += drop
                logger.warning(
                    "alert plane dropped %d undelivered notifiable "
                    "transitions (sink further behind than %d)",
                    drop, MAX_NOTIFIABLE)

    def _recount_locked(self) -> None:
        _FIRING.set(float(sum(
            1 for i in self._instances.values()
            if i["state"] == "firing")))

    def _close_locked(self) -> None:
        if self.log is not None:
            self.log.close()
            self.log = None

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, history: Optional[Any] = None,
                 collector: Optional[Any] = None,
                 registry: Any = REGISTRY,
                 now: Optional[float] = None) -> None:
        """One evaluation sweep (primary only — the docserver gates).
        *now* is wall seconds; tests and the bench gate pass explicit
        stamps so the sweep is deterministic."""
        from ..coord import docstore
        if now is None:
            now = docstore.now()
        mono = time.monotonic()
        with self._lock:
            if not self.rules:
                return
            self._refresh_locked()
            gen = self._gen()
            if gen > self._max_gen and self.log is not None:
                # promotion fence: everything below this generation is
                # a dead primary's late write from here on
                self._append_locked({"kind": "noop"})
                self._max_gen = gen
            self._prune_silences_locked(now)
            for rule in self.rules:
                try:
                    values = self._values_locked(
                        rule, history, collector, registry, now)
                    self._rule_errors.pop(rule.name, None)
                except (ValueError, KeyError, TypeError, OSError) as exc:
                    self._rule_errors[rule.name] = str(exc)
                    logger.warning("alert rule %s evaluation failed: %s",
                                   rule.name, exc)
                    continue
                self._step_rule_locked(rule, values, now, mono)
            self._recount_locked()

    def _values_locked(self, rule: AlertRule, history: Any,
                       collector: Any, registry: Any, now: float,
                       ) -> List[Tuple[Dict[str, str], float]]:
        if rule.kind == "burn":
            from . import slo as _slo
            snap = _slo.PLANE.evaluate(registry=registry,
                                       collector=collector, now=now)
            out = []
            for tenant, objs in sorted(
                    (snap.get("tenants") or {}).items()):
                e = objs.get(rule.objective)
                if not e:
                    continue
                v = e.get("burn_short" if rule.burn_window == "short"
                          else "burn_long")
                if v is None:
                    continue
                out.append(({"tenant": tenant,
                             "objective": rule.objective}, float(v)))
            return out
        if history is None:
            raise ValueError(
                f"alert rule {rule.name} needs the history plane "
                "(docserver --history-dir)")
        if rule.kind == "threshold":
            try:
                doc = history.query(rule.family,
                                    matchers=rule.matchers or None,
                                    start=-rule.window_s, fn=rule.fn,
                                    now=now)
            except ValueError as exc:
                if "empty history range" in str(exc):
                    return []
                raise
            out = []
            for s in doc.get("series") or []:
                pts = s.get("points") or []
                if pts:
                    out.append((dict(s.get("labels") or {}),
                                float(pts[-1][1])))
            return out
        # anomaly: leave-the-current-window-out median/MAD over the
        # trailing baseline windows (the straggler test, generalized)
        from .analysis import _mad, _median
        w = rule.window_s
        snap = history.snapshot() or {}
        oldest = snap.get("oldest_t")
        baseline = []
        for i in range(1, ANOMALY_BASELINE_WINDOWS + 1):
            lo, hi = now - (i + 1) * w, now - i * w
            if oldest is not None and lo < oldest:
                break
            baseline.append(history.window_increase(
                rule.family, lo, hi, matchers=rule.matchers or None))
        if len(baseline) < ANOMALY_MIN_BASELINE:
            return []
        current = history.window_increase(
            rule.family, now - w, now, matchers=rule.matchers or None)
        med = _median(baseline)
        scale = max(1.4826 * _mad(baseline, med), 0.05 * abs(med), 1e-9)
        return [(dict(rule.matchers), (current - med) / scale)]

    def _step_rule_locked(self, rule: AlertRule,
                          values: List[Tuple[Dict[str, str], float]],
                          now: float, mono: float) -> None:
        seen: Dict[LabelKey, Tuple[Dict[str, str], float]] = {}
        for labels, v in values:
            seen[_label_key(labels)] = (labels, v)
        silenced = self._silenced_locked(rule.name, now)
        # union: label sets with fresh values + instances whose series
        # vanished (cond False, value None — the resolve path)
        keys = set(seen)
        keys.update(lk for (rname, lk) in self._instances
                    if rname == rule.name)
        for lk in sorted(keys):
            labels, value = seen.get(lk, (dict(lk), None))
            cond = value is not None and rule.condition(value)
            self._step_instance_locked(rule, labels, lk, cond, value,
                                       now, mono, silenced)

    def _step_instance_locked(self, rule: AlertRule,
                              labels: Dict[str, str], lk: LabelKey,
                              cond: bool, value: Optional[float],
                              now: float, mono: float,
                              silenced: bool) -> None:
        key = (rule.name, lk)
        inst = self._instances.get(key)
        state = inst["state"] if inst else "inactive"

        def transition(to: str, refire: bool = False) -> None:
            e: Dict[str, Any] = {
                "kind": "transition", "rule": rule.name,
                "labels": dict(labels), "from": state, "to": to,
                "t": now, "value": value}
            if silenced and to in ("firing", "resolved") and not refire:
                e["silenced"] = True
            if refire:
                e["refire"] = True
            self._append_locked(e)

        if state in ("inactive", "resolved"):
            if cond:
                transition("pending" if rule.for_s > 0 else "firing")
            elif state == "inactive" and inst is not None:
                del self._instances[key]  # bound idle-instance memory
        elif state == "pending":
            if not cond:
                transition("inactive")
            elif now - float(inst["pending_since"] or now) >= rule.for_s:
                transition("firing")
        elif state == "firing":
            if cond:
                inst.pop("_clear_mono", None)
                if inst.get("suppressed") and not silenced:
                    # the silence expired against a still-firing
                    # instance: page now
                    transition("firing", refire=True)
            else:
                clear = inst.setdefault("_clear_mono", mono)
                if mono - clear >= self.flap_damp_s:
                    transition("resolved")

    # -- silences / acks ----------------------------------------------------

    def _silenced_locked(self, rule_name: str, now: float) -> bool:
        return any(s["rule"] in (rule_name, "*") and s["until"] > now
                   for s in self._silences.values())

    def _prune_silences_locked(self, now: float) -> None:
        for sid in [sid for sid, s in self._silences.items()
                    if s["until"] <= now]:
            del self._silences[sid]

    def silence(self, rule_name: str, duration_s: float,
                now: Optional[float] = None) -> Dict[str, Any]:
        """Suppress notifications for *rule_name* (``*`` = every rule)
        for *duration_s*.  Durable: the silence is a log append, so it
        survives failover like everything else."""
        from ..coord import docstore
        if duration_s <= 0:
            raise ValueError(
                f"silence duration must be > 0, got {duration_s}")
        if now is None:
            now = docstore.now()
        with self._lock:
            if rule_name != "*" and rule_name not in {
                    r.name for r in self.rules}:
                raise ValueError(f"unknown alert rule {rule_name!r}")
            e = self._append_locked({
                "kind": "silence", "rule": rule_name,
                "until": now + float(duration_s)})
            return {"rule": rule_name, "until": e["until"],
                    "id": e["n"]}

    def ack(self, rule_name: str) -> Dict[str, Any]:
        """Mark *rule_name*'s firing instances acknowledged (cosmetic:
        shows in /alertz and ``cli alerts``; cleared on resolve)."""
        with self._lock:
            if rule_name not in {r.name for r in self.rules}:
                raise ValueError(f"unknown alert rule {rule_name!r}")
            self._append_locked({"kind": "ack", "rule": rule_name})
            n = sum(1 for (rname, _lk), i in self._instances.items()
                    if rname == rule_name and i.get("acked"))
            return {"rule": rule_name, "acked_instances": n}

    # -- sinks --------------------------------------------------------------

    def _cursor_path(self, sink_name: str) -> Optional[str]:
        if self.log_dir is None:
            return None
        return os.path.join(self.log_dir, f"cursor-{sink_name}.json")

    def _read_cursor(self, sink_name: str) -> int:
        path = self._cursor_path(sink_name)
        if path is None:
            return int(getattr(self, "_mem_cursors", {}).get(sink_name, 0))
        try:
            with open(path, "r", encoding="utf-8") as f:
                return int(json.load(f)["n"])
        except FileNotFoundError:
            return 0
        except (OSError, ValueError, KeyError, TypeError) as exc:
            logger.warning("alert sink cursor %s unreadable (%s); "
                           "restarting from 0", path, exc)
            return 0

    def _write_cursor(self, sink_name: str, n: int) -> None:
        path = self._cursor_path(sink_name)
        if path is None:
            self.__dict__.setdefault("_mem_cursors", {})[sink_name] = n
            return
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"n": int(n)}, f)
            if self._fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)

    def pump(self) -> Dict[str, int]:
        """Drain undelivered firing/resolved transitions to every sink.
        The cursor is re-read from DISK each pump — that one property
        is the failover guarantee: a promoted standby's first pump
        continues exactly past the last transition any previous
        primary durably delivered."""
        with self._lock:
            sinks = list(self.sinks)
            notifiable = list(self._notifiable)
        delivered: Dict[str, int] = {}
        for sink in sinks:
            cur = self._read_cursor(sink.name)
            for e in notifiable:
                n = int(e.get("n") or 0)
                if n <= cur:
                    continue
                doc = {"kind": "mrtpu-alert-notification", "version": 1,
                       "rule": e.get("rule"), "labels": e.get("labels"),
                       "from": e.get("from"), "to": e.get("to"),
                       "t": e.get("t"), "value": e.get("value"),
                       "seq": n, "refire": bool(e.get("refire"))}
                try:
                    sink.deliver(doc)
                except (IOError, OSError, ValueError,
                        subprocess.SubprocessError) as exc:
                    _NOTIFICATIONS.inc(sink=sink.name, outcome="error")
                    logger.warning(
                        "alert sink %s delivery failed at seq %d: %s "
                        "(will retry next pump)", sink.name, n, exc)
                    break
                _NOTIFICATIONS.inc(sink=sink.name, outcome="delivered")
                self._write_cursor(sink.name, n)
                cur = n
                delivered[sink.name] = delivered.get(sink.name, 0) + 1
        return delivered

    # -- surfaces -----------------------------------------------------------

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The /statusz + profile-bundle section; ``{}`` when no rules
        are configured (the no-op embedder contract)."""
        from ..coord import docstore
        with self._lock:
            if not self.rules:
                return {}
            if now is None:
                now = docstore.now()
            self._refresh_locked()
            rules = []
            for r in self.rules:
                d = r.describe()
                n_inst = sum(1 for (rname, _lk) in self._instances
                             if rname == r.name)
                d["instances"] = n_inst
                err = self._rule_errors.get(r.name)
                if err:
                    d["last_error"] = err
                rules.append(d)
            instances = []
            for (rname, lk), i in sorted(self._instances.items()):
                row: Dict[str, Any] = {
                    "rule": rname, "labels": dict(lk),
                    "state": i["state"], "value": i["value"]}
                if i["since"] is not None:
                    row["age_s"] = round(max(0.0, now - i["since"]), 3)
                if i["state"] == "pending" and i["pending_since"]:
                    row["pending_for_s"] = round(
                        max(0.0, now - i["pending_since"]), 3)
                if i.get("suppressed"):
                    row["suppressed"] = True
                if i.get("acked"):
                    row["acked"] = True
                instances.append(row)
            counts: Dict[str, int] = {}
            for i in self._instances.values():
                counts[i["state"]] = counts.get(i["state"], 0) + 1
            silences = [{"id": sid, "rule": s["rule"],
                         "expires_in_s": round(s["until"] - now, 3)}
                        for sid, s in sorted(self._silences.items())
                        if s["until"] > now]
            out: Dict[str, Any] = {
                "rules": rules, "instances": instances,
                "counts": counts, "silences": silences,
                "sinks": [s.name for s in self.sinks],
                "log": {"seq": self._seq, "generation": self._max_gen,
                        "replayed": self._replayed,
                        "skipped_stale": self._skipped_stale,
                        "bytes": (self.log.size()
                                  if self.log is not None else 0)},
            }
            if self._dropped_notifiable:
                out["log"]["dropped_notifiable"] = self._dropped_notifiable
            return out


#: the process-global plane (the SLO/control pattern: embedders and
#: surfaces share one instance; unconfigured = inert)
PLANE = AlertPlane()


def alerts_snapshot() -> Dict[str, Any]:
    return PLANE.snapshot()


def alertz_doc() -> Dict[str, Any]:
    """The GET /alertz response body."""
    from ..coord import docstore
    return {"kind": "mrtpu-alerts", "version": 1,
            "time": docstore.now(), "snapshot": PLANE.snapshot()}


def validate_alerts(doc: Dict[str, Any]) -> None:
    """Strict check for ``alerts.json`` bundle docs (write AND reload,
    like the comms/slo/control artifacts)."""
    if not isinstance(doc, dict):
        raise ValueError("alerts: document is not an object")
    if doc.get("kind") != "mrtpu-alerts":
        raise ValueError(
            f"alerts: kind is {doc.get('kind')!r}, want 'mrtpu-alerts'")
    snap = doc.get("snapshot")
    if not isinstance(snap, dict):
        raise ValueError("alerts: snapshot is not an object")
    if not snap:
        return
    rules = snap.get("rules")
    if not isinstance(rules, list) or not rules:
        raise ValueError("alerts: rules is not a non-empty list")
    for i, r in enumerate(rules):
        if not isinstance(r, dict) or not r.get("name"):
            raise ValueError(f"alerts: rule[{i}] has no name")
        if r.get("op") not in ("gt", "lt", "ge", "le"):
            raise ValueError(
                f"alerts: rule[{i}] bad op {r.get('op')!r}")
        if not isinstance(r.get("threshold"), (int, float)):
            raise ValueError(
                f"alerts: rule[{i}] threshold is not a number")
        if r.get("kind") not in ("threshold", "burn", "anomaly"):
            raise ValueError(
                f"alerts: rule[{i}] bad kind {r.get('kind')!r}")
    insts = snap.get("instances")
    if not isinstance(insts, list):
        raise ValueError("alerts: instances is not a list")
    for i, inst in enumerate(insts):
        if not isinstance(inst, dict) or inst.get("state") not in STATES:
            raise ValueError(
                f"alerts: instance[{i}] bad state "
                f"{inst.get('state') if isinstance(inst, dict) else inst!r}")
        if not isinstance(inst.get("labels"), dict):
            raise ValueError(
                f"alerts: instance[{i}] labels is not an object")
    if not isinstance(snap.get("counts"), dict):
        raise ValueError("alerts: counts is not an object")
