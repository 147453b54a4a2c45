"""Span tracer: monotonic-clock spans kept as Chrome trace events (port
of ``mapreduce_tpu/obs/trace.py``).

Covers the job lifecycle — claim -> map/reduce run -> write — with a
per-thread span stack so nesting falls out of lexical scope.  The
server's device phase records the same claim -> run -> write under its
``__device__`` job.

Clocks are ``time.monotonic()`` throughout.  Each span is a Chrome
trace event — a complete ("ph": "X") event with microsecond
``ts``/``dur`` on its real thread id — read back with
:meth:`Tracer.events`.

The buffer is a bounded RING (:attr:`Tracer.max_events`): overflow
evicts the OLDEST spans.

Spans come from :meth:`Tracer.span` (the lexical context manager) and
:meth:`Tracer.record` (an interval already elapsed).  Left out for now:
the JAX tracer's detached spans (the JAX engine's overlapping waves;
the port's engine records no spans), the cross-process trace header and
the incremental read of the telemetry pusher, which go with the
networked board, and the file export, which goes with the CLI's
``--trace-out`` (ROADMAP A.4b).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
import uuid
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple


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
        self._events: Deque[Dict[str, Any]] = collections.deque()
        self._tls = threading.local()

    # -- span stack -------------------------------------------------------

    def _stack(self) -> List[Tuple[str, Optional[str]]]:
        """Per-thread stack of ``(trace_id, span_id)`` parents."""
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[Tuple[str, Optional[str]]]:
        st = self._stack()
        return st[-1] if st else None

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
        with self._lock:
            self._events.append(event)
            # ring semantics: evict the OLDEST events past the bound, so
            # the buffer always holds the newest activity
            while len(self._events) > self.max_events:
                self._events.popleft()

    # -- read-back --------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)


#: the process-global tracer (the registry's sibling); instruments write
#: here and :meth:`Tracer.events` reads it back.
TRACER = Tracer()
