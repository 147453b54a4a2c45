"""Network fault injection for the two HTTP planes (port of
``mapreduce_tpu/testing/faults.py``).

The paper's whole claim is re-execution-based fault tolerance (Dean &
Ghemawat, OSDI'04 §3.3): workers die, the task finishes anyway.  The
board (coord/docserver.py) and blob (storage/httpstore.py) planes carry
that story over TCP — so proving it means breaking TCP on purpose, the
chaos-engineering move (Basiri et al., IEEE Software 2016).  This module
is the harness: a :class:`FaultProxy` sits between a client and a real
server and misbehaves per scripted :class:`FaultRule`, toggled at
runtime.

Topology::

    client ──► FaultProxy (127.0.0.1:N) ──► real DocServer / BlobServer

Point the client's connstr / storage DSL at ``proxy.address`` and script
faults on the proxy; the server stays healthy, which is exactly the
partition case (the endpoint is fine, the PATH to it is not).

Fault actions (per client->server request chunk unless noted):

* ``reset``     — SO_LINGER(0) close: the client sees ECONNRESET mid-RPC.
* ``blackhole`` — swallow the bytes and never answer; the client hangs
  until its socket timeout (a partition for one request).
* ``delay``     — sleep, then forward (latency injection).
* ``corrupt``   — flip bytes before forwarding (default: the response
  direction, garbling what the client parses).
* ``http_error``— answer ``503 Service Unavailable`` (or any status)
  without touching the upstream: a 5xx storm.

plus the connection-level :meth:`FaultProxy.partition` /
:meth:`FaultProxy.heal` pair, which drops EVERYTHING (existing pumps and
new connects) for a window — the "partition outlasts the job lease"
scenario.

A :class:`FaultSchedule` scripts scenarios: each rule has a byte-pattern
``match`` (e.g. ``b"find_and_modify"`` to target claim RPCs), an
``after`` skip count, a ``count`` budget and/or a ``for_secs`` window —
so "kill the docserver socket after the 3rd claim, for 2s" is::

    sched = FaultSchedule()
    sched.reset(match=b"find_and_modify", after=3, for_secs=2.0)
    proxy = FaultProxy.for_upstream(host, port, schedule=sched).start()

Everything is stdlib threads + sockets; no external chaos tooling.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from typing import List, Optional

logger = logging.getLogger("mapreduce_tpu_torch.testing.faults")

_CHUNK = 65536
_LINGER_RST = struct.pack("ii", 1, 0)  # SO_LINGER on, 0s: close sends RST


class FaultRule:
    """One scripted fault.  Thread-safe; counters mutate under a lock.

    ``action``   — reset | blackhole | delay | corrupt | http_error.
    ``match``    — bytes that must appear in the traffic chunk for the
                   rule to consider it (None = every chunk).
    ``direction``— "request" (client->server, default) or "response".
    ``after``    — let this many MATCHING chunks pass before triggering.
    ``count``    — apply to at most this many chunks.  Default: 1 for a
                   countable rule, unlimited when ``for_secs`` bounds the
                   rule instead (a windowed rule fires on everything it
                   matches while the window is open).
    ``for_secs`` — once first triggered, stay active this long, then
                   expire (None = no time window, ``count`` governs).
    ``delay``    — seconds for the delay action / hold for blackhole.
    ``status``   — HTTP status for http_error.
    """

    _UNSET = object()

    def __init__(self, action: str, *, match: Optional[bytes] = None,
                 direction: str = "request", after: int = 0,
                 count=_UNSET,
                 for_secs: Optional[float] = None,
                 delay: float = 0.0, status: int = 503) -> None:
        if action not in ("reset", "blackhole", "delay", "corrupt",
                          "http_error"):
            raise ValueError(f"unknown fault action {action!r}")
        if count is FaultRule._UNSET:
            count = None if for_secs is not None else 1
        self.action = action
        self.match = match
        self.direction = direction
        self.after = after
        self.count = count
        self.for_secs = for_secs
        self.delay = delay
        self.status = status
        self.hits = 0          # times the rule fired (observable by tests)
        self._skip = after
        self._t0: Optional[float] = None
        self._lock = threading.Lock()

    def consider(self, direction: str, data: bytes) -> bool:
        """Does this rule fire for *data*?  Advances counters if so."""
        if direction != self.direction:
            return False
        if self.match is not None and self.match not in data:
            return False
        with self._lock:
            if self._skip > 0:
                self._skip -= 1
                return False
            now = time.monotonic()
            if self.for_secs is not None:
                if self._t0 is None:
                    self._t0 = now
                elif now - self._t0 > self.for_secs:
                    return False  # window over
            if self.count is not None and self.hits >= self.count:
                return False
            self.hits += 1
            return True

    def __repr__(self) -> str:
        return (f"FaultRule({self.action!r}, match={self.match!r}, "
                f"after={self.after}, count={self.count}, "
                f"for_secs={self.for_secs}, hits={self.hits})")


class FaultSchedule:
    """An ordered, runtime-mutable set of :class:`FaultRule`; the sugar
    methods build + register a rule and return it so tests can assert on
    ``rule.hits`` afterwards."""

    def __init__(self, *rules: FaultRule) -> None:
        self._rules: List[FaultRule] = list(rules)
        self._lock = threading.Lock()

    def add(self, rule: FaultRule) -> FaultRule:
        with self._lock:
            self._rules.append(rule)
        return rule

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()

    def pick(self, direction: str, data: bytes) -> Optional[FaultRule]:
        """First rule that fires for this chunk, or None (forward as-is)."""
        with self._lock:
            rules = list(self._rules)
        for r in rules:
            if r.consider(direction, data):
                return r
        return None

    # -- scenario sugar ---------------------------------------------------

    def reset(self, **kw) -> FaultRule:
        return self.add(FaultRule("reset", **kw))

    def blackhole(self, **kw) -> FaultRule:
        return self.add(FaultRule("blackhole", **kw))

    def delay(self, seconds: float, **kw) -> FaultRule:
        return self.add(FaultRule("delay", delay=seconds, **kw))

    def corrupt(self, **kw) -> FaultRule:
        kw.setdefault("direction", "response")
        return self.add(FaultRule("corrupt", **kw))

    def http_error(self, **kw) -> FaultRule:
        return self.add(FaultRule("http_error", **kw))


class FaultProxy:
    """TCP proxy with scripted misbehavior (see module docstring).

    ``proxy.address`` is ``HOST:PORT`` — drop it into a connstr
    (``http://{proxy.address}``) or storage DSL (``http:{proxy.address}``)
    in place of the real endpoint.  ``start()`` returns self;
    ``stop()`` closes the listener and every live connection.
    """

    def __init__(self, upstream_host: str, upstream_port: int,
                 host: str = "127.0.0.1", port: int = 0,
                 schedule: Optional[FaultSchedule] = None) -> None:
        self.upstream = (upstream_host, upstream_port)
        self.schedule = schedule if schedule is not None else FaultSchedule()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()[:2]
        self._stop = threading.Event()
        self._partition_until: Optional[float] = None
        self._plock = threading.Lock()
        self._conns: List[socket.socket] = []
        self._clock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def for_upstream(cls, upstream_host: str, upstream_port: int,
                     **kw) -> "FaultProxy":
        return cls(upstream_host, upstream_port, **kw)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "FaultProxy":
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self._close_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- partition control ------------------------------------------------

    def partition(self, duration: Optional[float] = None) -> None:
        """Drop ALL traffic — live pumps stall, new connects are parked
        unanswered — until :meth:`heal` or *duration* elapses.  The
        endpoint stays healthy; the network to it is what died."""
        with self._plock:
            self._partition_until = (float("inf") if duration is None
                                     else time.monotonic() + duration)

    def heal(self) -> None:
        """End a partition.  Connections that lived through it are closed
        (their streams are mid-request garbage); clients reconnect."""
        with self._plock:
            was = self._partition_until
            self._partition_until = None
        if was is not None:
            self._close_all()

    def partitioned(self) -> bool:
        with self._plock:
            until = self._partition_until
            if until is None:
                return False
            if time.monotonic() >= until:
                self._partition_until = None
                return False
            return True

    # -- internals --------------------------------------------------------

    def _track(self, s: socket.socket) -> None:
        with self._clock:
            self._conns.append(s)

    def _untrack(self, *socks: socket.socket) -> None:
        """Drop finished sockets from the kill list — a reset-heavy soak
        reconnects thousands of times and must not accumulate dead
        socket objects (or make heal() close long-finished ones)."""
        with self._clock:
            for s in socks:
                try:
                    self._conns.remove(s)
                except ValueError:
                    pass  # already swept by _close_all

    def _close_all(self) -> None:
        with self._clock:
            conns, self._conns = self._conns, []
        for s in conns:
            _quiet_close(s)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._listener.accept()
            except OSError:
                return  # listener closed by stop()
            client.settimeout(0.25)
            self._track(client)
            threading.Thread(target=self._handle, args=(client,),
                             daemon=True).start()

    def _handle(self, client: socket.socket) -> None:
        if self.partitioned():
            self._park(client)
            self._untrack(client)
            return
        try:
            server = socket.create_connection(self.upstream, timeout=10)
        except OSError:
            _quiet_close(client)
            self._untrack(client)
            return
        server.settimeout(0.25)
        self._track(server)
        dead = threading.Event()
        t = threading.Thread(target=self._pump,
                             args=(server, client, "response", dead),
                             daemon=True)
        t.start()
        self._pump(client, server, "request", dead)
        t.join()
        _quiet_close(client)
        _quiet_close(server)
        self._untrack(client, server)

    def _park(self, client: socket.socket) -> None:
        """Hold a connection open during a partition, swallowing whatever
        arrives (packets into the void) and never answering; closed when
        the partition ends or the proxy stops."""
        while not self._stop.is_set() and self.partitioned():
            try:
                if client.recv(_CHUNK) == b"":
                    break
            except socket.timeout:
                continue
            except OSError:
                break
        _quiet_close(client)

    def _pump(self, src: socket.socket, dst: socket.socket,
              direction: str, dead: threading.Event) -> None:
        """One direction of the relay, applying rules per chunk.  For
        HTTP/1.1 request traffic a chunk almost always aligns with one
        request's bytes (headers, or headers+small body, sent with one
        send()), which is what makes byte-pattern matching per chunk a
        workable request matcher."""
        client_side = src if direction == "request" else dst
        while not self._stop.is_set() and not dead.is_set():
            try:
                data = src.recv(_CHUNK)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                break
            if self.partitioned():
                self._park(src)
                break
            rule = self.schedule.pick(direction, data)
            if rule is None:
                if not _send(dst, data):
                    break
                continue
            logger.info("fault %s fired (%s, %d bytes)", rule.action,
                        direction, len(data))
            if rule.action == "delay":
                if dead.wait(rule.delay):
                    break
                if not _send(dst, data):
                    break
            elif rule.action == "corrupt":
                if not _send(dst, _flip(data)):
                    break
            elif rule.action == "reset":
                try:
                    client_side.setsockopt(socket.SOL_SOCKET,
                                           socket.SO_LINGER, _LINGER_RST)
                except OSError:
                    pass
                dead.set()
                break
            elif rule.action == "blackhole":
                # swallow; hold the line unanswered for the rule's window
                hold = rule.delay or rule.for_secs or 86400.0
                dead.wait(hold)
                dead.set()
                break
            elif rule.action == "http_error":
                body = (f"HTTP/1.1 {rule.status} Injected Fault\r\n"
                        "Content-Length: 0\r\n"
                        "Connection: close\r\n\r\n").encode()
                _send(client_side, body)
                dead.set()
                break
        dead.set()


def _send(s: socket.socket, data: bytes) -> bool:
    try:
        s.sendall(data)
        return True
    except OSError:
        return False


def _flip(data: bytes) -> bytes:
    """Corrupt a chunk: XOR the first 32 bytes (start line / status line
    for HTTP), leave the rest — guaranteed unparseable, same length."""
    head = bytes(b ^ 0x5A for b in data[:32])
    return head + data[32:]


def _quiet_close(s: socket.socket) -> None:
    try:
        s.close()
    except OSError:
        pass
