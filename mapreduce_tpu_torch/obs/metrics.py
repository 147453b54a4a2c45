"""Metrics registry: counters, gauges and histograms (port of
``mapreduce_tpu/obs/metrics.py``).

The reference system's only observability was the per-phase stats doc the
server wrote into Mongo at the end of each iteration (server.lua:555-600).
This module is what the port builds that doc from: the server publishes
its phase stats as gauges and reads them back, every storage backend
counts its bytes, records and operations here, and the docserver renders
the whole registry as Prometheus text at ``/metrics``.

Design points (the JAX package's):

* one process-global :data:`REGISTRY` (module-level ``counter()`` /
  ``gauge()`` / ``histogram()`` helpers are get-or-create, so any module
  can name a metric without import-order coupling);
* thread-safe throughout — worker threads, heartbeat threads and the
  server write concurrently;
* labels are plain keyword arguments (``inc(task="wc")``); each
  label-set is an independent series, exactly the Prometheus data model;
* ``Registry.value()`` reads a series back — ``Server._compute_stats``
  builds the persisted stats doc FROM these reads, so the doc and the
  live exposition cannot drift apart;
* ``Registry.render()`` is the Prometheus text exposition (format
  0.0.4, the JAX package's byte for byte) and ``parse_prometheus()``
  its inverse — the telemetry collector parses every pushed snapshot
  with it.

Left out for now: the device and SLO bucket ladders and the percentile
estimators of the SLO plane (ROADMAP A.8).  Everything is stdlib.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: preset latency buckets (seconds) for RPC/phase timings; the classic
#: Prometheus ladder plus a 30s rung.
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, float("inf"))

_NAME_RX = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RX = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    for k in labels:
        if not _LABEL_RX.match(k):
            raise ValueError(f"bad label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(value: float) -> str:
    """Prometheus sample value: integral floats render as ints, +Inf as
    the literal Prometheus spells it."""
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _labels_str(key: LabelKey, extra: Optional[List[Tuple[str, str]]] = None,
                ) -> str:
    items = list(key) + list(extra or [])
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
    return "{" + inner + "}"


class Metric:
    """One named metric family; per-label-set series live inside it."""

    kind = "untyped"

    def __init__(self, name: str, help: str) -> None:
        if not _NAME_RX.match(name):
            raise ValueError(f"bad metric name {name!r}")
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, Any] = {}

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def sum(self, **labels: Any) -> float:
        """Sum every series whose labels are a superset of *labels*
        (counters/gauges: the value; histograms: the observation count)."""
        want = set(_label_key(labels))
        total = 0.0
        with self._lock:
            for key, v in self._series.items():
                if want.issubset(set(key)):
                    total += v["count"] if isinstance(v, dict) else v
        return float(total)

    def samples(self) -> List[str]:
        with self._lock:
            return [f"{self.name}{_labels_str(k)} {_fmt(v)}"
                    for k, v in sorted(self._series.items())]


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def replace(self, values: Iterable[Tuple[Dict[str, Any], float]],
                ) -> None:
        """Atomically swap the whole series set (snapshot-style gauges
        like board queue depth: a clear-then-set sequence would let a
        concurrent render see an empty family mid-rebuild)."""
        fresh = {_label_key(labels): float(v) for labels, v in values}
        with self._lock:
            self._series = fresh


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 buckets: Iterable[float] = LATENCY_BUCKETS) -> None:
        super().__init__(name, help)
        bounds = sorted(float(b) for b in buckets)
        if not bounds or bounds[-1] != math.inf:
            bounds.append(math.inf)
        self.buckets: Tuple[float, ...] = tuple(bounds)

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = {
                    "counts": [0] * len(self.buckets),
                    "sum": 0.0, "count": 0}
            for i, b in enumerate(self.buckets):
                if value <= b:
                    s["counts"][i] += 1
                    break
            s["sum"] += value
            s["count"] += 1

    def value(self, **labels: Any) -> float:
        """A histogram's scalar read-back is its observation count."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            return float(s["count"]) if s else 0.0

    def samples(self) -> List[str]:
        out = []
        with self._lock:
            for key, s in sorted(self._series.items()):
                cum = 0
                for bound, n in zip(self.buckets, s["counts"]):
                    cum += n
                    out.append(
                        f"{self.name}_bucket"
                        f"{_labels_str(key, [('le', _fmt(bound))])} {cum}")
                out.append(f"{self.name}_sum{_labels_str(key)} "
                           f"{_fmt(s['sum'])}")
                out.append(f"{self.name}_count{_labels_str(key)} "
                           f"{s['count']}")
        return out


class Registry:
    """Named metric families; get-or-create accessors, atomic render."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = LATENCY_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def value(self, name: str, **labels: Any) -> float:
        """Read one series back (0.0 for a series never touched) — the
        accessor Server._compute_stats builds the stats doc from."""
        with self._lock:
            m = self._metrics.get(name)
        return m.value(**labels) if m is not None else 0.0

    def sum(self, name: str, **labels: Any) -> float:
        """Sum a family's series over a label subset (CLI summaries)."""
        with self._lock:
            m = self._metrics.get(name)
        return m.sum(**labels) if m is not None else 0.0

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: List[str] = []
        for m in metrics:
            lines.append(f"# HELP {m.name} {_escape(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.samples())
        return "\n".join(lines) + "\n"


#: the process-global registry every instrument in the package writes to
#: and the docserver's /metrics endpoint renders.
REGISTRY = Registry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Iterable[float] = LATENCY_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets)


# -- shared storage-plane instruments (every backend reports here) ----------

_STORAGE_BYTES = counter(
    "mrtpu_storage_bytes_total",
    "bytes read/written per storage plane (labels: scheme, direction)")
_STORAGE_RECORDS = counter(
    "mrtpu_storage_records_total",
    "record lines read/written per storage plane")
_STORAGE_OPS = counter(
    "mrtpu_storage_ops_total",
    "blob-level operations per storage plane (labels: scheme, op)")


def storage_io(scheme: str, direction: str, nbytes: int,
               records: int = 0) -> None:
    """One reporting point for every Storage backend (base.py wrappers)."""
    _STORAGE_BYTES.inc(nbytes, scheme=scheme, direction=direction)
    if records:
        _STORAGE_RECORDS.inc(records, scheme=scheme, direction=direction)


def storage_op(scheme: str, op: str) -> None:
    _STORAGE_OPS.inc(scheme=scheme, op=op)


# -- exposition parser (the collector's ingest, tests) ----------------------

_SAMPLE_RX = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$")
_LABEL_PAIR_RX = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_ESCAPE_RX = re.compile(r"\\(.)")
_UNESCAPES = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape(value: str) -> str:
    """Single left-to-right pass, so a literal backslash followed by 'n'
    (rendered as ``\\\\n``) decodes back to backslash+n, not a newline —
    sequential str.replace calls get that case wrong."""
    return _ESCAPE_RX.sub(
        lambda m: _UNESCAPES.get(m.group(1), m.group(1)), value)


def parse_prometheus(text: str) -> Dict[Tuple[str, LabelKey], float]:
    """Parse exposition text back into ``{(name, labelkey): value}``.

    Strict on structure: any non-comment, non-blank line that fails to
    parse raises ValueError.
    """
    out: Dict[Tuple[str, LabelKey], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RX.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        labels: List[Tuple[str, str]] = []
        raw = m.group("labels")
        if raw:
            # sequential match from position 0: garbage BETWEEN pairs
            # must fail too, not just garbage after the last one
            pos = 0
            while pos < len(raw):
                pm = _LABEL_PAIR_RX.match(raw, pos)
                if pm is None:
                    raise ValueError(f"unparseable labels in: {line!r}")
                labels.append((pm.group(1), _unescape(pm.group(2))))
                pos = pm.end()
                if pos < len(raw):
                    if raw[pos] != ",":
                        raise ValueError(
                            f"unparseable labels in: {line!r}")
                    pos += 1  # separator (a trailing comma is legal)
        v = m.group("value")
        value = (math.inf if v == "+Inf" else
                 -math.inf if v == "-Inf" else
                 math.nan if v == "NaN" else float(v))
        out[(m.group("name"), tuple(labels))] = value
    return out
