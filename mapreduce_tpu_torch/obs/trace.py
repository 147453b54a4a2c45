"""Span tracer: monotonic-clock spans exported as Chrome trace events
(port of ``mapreduce_tpu/obs/trace.py``).

Covers the job lifecycle — claim -> map/reduce run -> write — with a
per-thread span stack so nesting falls out of lexical scope, and a
``TRACE_HEADER`` carrying ``trace_id:span_id`` across both HTTP planes
(the blob client and the docstore client inject it; the docserver
adopts it around each RPC), so one job's board RPCs and blob transfers
share its trace.  The server's device phase records the same claim ->
run -> write under its ``__device__`` job.

Clocks are ``time.monotonic()`` throughout.  Export is the Chrome
trace-event JSON object of the JAX package, key for key — complete
("ph": "X") events with microsecond ``ts``/``dur`` on real thread ids —
loadable in Perfetto / chrome://tracing.

The buffer is a bounded RING (:attr:`Tracer.max_events`): overflow
evicts the OLDEST spans and counts each eviction in
``mrtpu_trace_dropped_total``; :meth:`Tracer.events_since` is the
incremental read the telemetry pusher drains, which learns how many
events the ring evicted before it read them.

Two span surfaces:

* :meth:`Tracer.span` — the lexical context manager (per-thread parent
  stack), and :meth:`Tracer.record` for an interval already elapsed;
* :meth:`Tracer.begin` / :meth:`Tracer.end` — DETACHED spans with an
  explicit parent, for work whose lifetime crosses lexical scope.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
import uuid
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

from .metrics import counter

#: HTTP header propagating ``trace_id:span_id`` across both planes.
TRACE_HEADER = "X-Mrtpu-Trace"

_DROPPED = counter("mrtpu_trace_dropped_total",
                   "spans dropped because the trace buffer was full")
_SPANS = counter("mrtpu_trace_spans_total",
                 "spans recorded (labels: name)")


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """A live span; ``args`` may be mutated until the span closes (e.g.
    to stamp an ``outcome``)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "args")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], t0: float,
                 args: Dict[str, Any]) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.args = args


class Tracer:
    def __init__(self, max_events: int = 100_000) -> None:
        self.max_events = max_events
        self._lock = threading.Lock()
        # ring entries are (seq, event): seq is a process-lifetime
        # monotonic counter (never reset) so an incremental consumer —
        # the telemetry pusher — can ask for "everything after N" and
        # learn exactly how many events the ring evicted before it read
        # them (its lossy-but-counted contract)
        self._events: Deque[Tuple[int, Dict[str, Any]]] = collections.deque()
        self._seq = 0
        self._tls = threading.local()

    # -- span stack -------------------------------------------------------

    def _stack(self) -> List[Tuple[str, Optional[str]]]:
        """Per-thread stack of ``(trace_id, span_id)`` parents; a remote
        parent adopted from TRACE_HEADER is just another frame."""
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[Tuple[str, Optional[str]]]:
        st = self._stack()
        return st[-1] if st else None

    def trace_context(self) -> Optional[str]:
        """``trace_id:span_id`` for TRACE_HEADER, or None outside any
        span (clients then send no header)."""
        cur = self.current()
        if cur is None or cur[1] is None:
            return None
        return f"{cur[0]}:{cur[1]}"

    @contextlib.contextmanager
    def adopt(self, header_value: Optional[str]) -> Iterator[None]:
        """Server side: parent subsequent spans on this thread under the
        remote caller's context (no-op for a missing/bad header)."""
        parts = (header_value or "").split(":")
        if len(parts) != 2 or not all(parts):
            yield
            return
        st = self._stack()
        st.append((parts[0], parts[1]))
        try:
            yield
        finally:
            st.pop()

    # -- recording --------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, start: Optional[float] = None,
             **args: Any) -> Iterator[Span]:
        """Record a complete span around the ``with`` body.

        ``start`` (a ``time.monotonic()`` stamp) backdates the span — the
        worker uses it so the per-job root span covers the claim RPC that
        *preceded* knowing there was a job at all.
        """
        parent = self.current()
        trace_id = parent[0] if parent else _new_id()
        sp = Span(name, trace_id, _new_id(),
                  parent[1] if parent else None,
                  start if start is not None else time.monotonic(),
                  dict(args))
        st = self._stack()
        st.append((sp.trace_id, sp.span_id))
        try:
            yield sp
        finally:
            st.pop()
            self._record(sp, time.monotonic())

    def record(self, name: str, t0: float, t1: float, **args: Any) -> None:
        """Record an already-elapsed interval as a child of the current
        span (the worker's retroactive ``claim`` span)."""
        parent = self.current()
        sp = Span(name, parent[0] if parent else _new_id(), _new_id(),
                  parent[1] if parent else None, t0, dict(args))
        self._record(sp, t1)

    # -- detached spans (explicit parentage, cross-scope lifetime) ---------

    def begin(self, name: str, parent: Optional[Span] = None,
              start: Optional[float] = None, **args: Any) -> Span:
        """Open a DETACHED span — not pushed on the thread's stack —
        parented under *parent* (a live :class:`Span`) or, when None,
        under the thread's current span context.  For work whose
        lifetime crosses lexical scope (the engine's overlapping waves);
        close it with :meth:`end`.  All timestamps are
        ``time.monotonic()``."""
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            cur = self.current()
            trace_id = cur[0] if cur else _new_id()
            parent_id = cur[1] if cur else None
        return Span(name, trace_id, _new_id(), parent_id,
                    start if start is not None else time.monotonic(),
                    dict(args))

    def end(self, sp: Span, stop: Optional[float] = None,
            **args: Any) -> None:
        """Close a detached span from :meth:`begin` (idempotence is the
        caller's job — ending twice records the span twice)."""
        if args:
            sp.args.update(args)
        self._record(sp, stop if stop is not None else time.monotonic())

    def _record(self, sp: Span, t1: float) -> None:
        event = {
            "name": sp.name,
            "ph": "X",
            "ts": round(sp.t0 * 1e6, 1),
            "dur": max(round((t1 - sp.t0) * 1e6, 1), 0.0),
            "pid": os.getpid(),
            "tid": threading.get_ident() % (1 << 31),
            "cat": "mapreduce_tpu_torch",
            "args": {"trace_id": sp.trace_id, "span_id": sp.span_id,
                     "parent_id": sp.parent_id, **sp.args},
        }
        _SPANS.inc(name=sp.name)
        dropped = 0
        with self._lock:
            self._seq += 1
            self._events.append((self._seq, event))
            # ring semantics: evict the OLDEST events past the bound, so
            # an export always holds the newest activity
            while len(self._events) > self.max_events:
                self._events.popleft()
                dropped += 1
        if dropped:
            _DROPPED.inc(dropped)

    # -- export -----------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [e for _, e in self._events]

    def events_since(self, seq: int) -> Tuple[int, List[Dict[str, Any]],
                                              int]:
        """Events recorded after sequence number *seq* (0 = everything
        still in the ring), as ``(new_seq, events, missed)``: pass
        ``new_seq`` back next call, ``missed`` is how many events were
        recorded after *seq* but already EVICTED by the ring — the
        telemetry pusher counts them as lost rather than pretending the
        timeline is complete."""
        with self._lock:
            fresh = [e for s, e in self._events if s > seq]
            missed = max(0, (self._seq - seq) - len(fresh))
            return self._seq, fresh, missed

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object format (Perfetto-loadable)."""
        return {"traceEvents": self.events(),
                "displayTimeUnit": "ms",
                "otherData": {"clock": "monotonic"}}

    def export(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(), f)
        return path


#: the process-global tracer (the registry's sibling); instruments write
#: here, ``--trace-out`` exports it and the telemetry pusher drains it.
TRACER = Tracer()
