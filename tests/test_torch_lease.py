"""The port's trainer lease, alone and against the JAX package's on one
``dir://`` board.

A lease that must hold while the test runs is 5 s (a loaded host can
stall a test for a good part of a second); a lease that must expire is
cut to 0.2 s by one heartbeat at that length, so the test sleeps 0.3 s
and drives every heartbeat itself: nothing sleeps out a production
lease.
"""

import time
import uuid

import pytest

from mapreduce_tpu.coord import Connection as JConnection
from mapreduce_tpu.coord.lease import TrainerLease as JLease

from mapreduce_tpu_torch.coord import (
    Connection, TrainerFencedError, TrainerLease)
from mapreduce_tpu_torch.coord.task import LeaseLostError
from mapreduce_tpu_torch.obs.metrics import REGISTRY


def _board():
    return f"mem://{uuid.uuid4().hex}"


def _lapse(lease):
    """Cut *lease*'s expiry to 0.2 s from now with one heartbeat, then
    wait it out."""
    lease.lease = 0.2
    assert lease.heartbeat()
    time.sleep(0.3)


def test_acquire_generation_heartbeat_release():
    board = _board()
    a = TrainerLease(Connection(board, "t"), holder="a", lease=5.0)
    b = TrainerLease(Connection(board, "t"), holder="b", lease=5.0)
    assert a.peek() is None
    before = REGISTRY.value("mrtpu_trainer_lease_acquires_total",
                            outcome="acquired")
    assert a.acquire(timeout=1) == 1
    assert REGISTRY.value("mrtpu_trainer_lease_acquires_total",
                          outcome="acquired") == before + 1
    assert REGISTRY.value("mrtpu_trainer_lease_generation") == 1
    assert not b.try_acquire()  # held and fresh
    assert a.heartbeat()
    a.ensure_owned()
    doc = a.peek()
    assert doc["holder"] == "a" and doc["generation"] == 1
    assert a.release() and a.generation is None
    assert not a.release()  # a no-op once released
    assert b.try_acquire() and b.generation == 2  # at once, no expiry wait
    assert b.peek()["holder"] == "b"


def test_acquire_times_out_while_held():
    board = _board()
    a = TrainerLease(Connection(board, "t"), holder="a", lease=5.0)
    a.acquire(timeout=1)
    b = TrainerLease(Connection(board, "t"), holder="b", lease=5.0)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="not acquired within 0.2s"):
        b.acquire(timeout=0.2, poll=0.05)
    assert time.monotonic() - t0 < 5
    assert b.generation is None


def test_expired_lease_is_taken_and_the_holder_fences():
    board = _board()
    a = TrainerLease(Connection(board, "t"), holder="a", lease=5.0)
    b = TrainerLease(Connection(board, "t"), holder="b", lease=5.0)
    a.acquire(timeout=1)
    assert not b.try_acquire()
    _lapse(a)  # a misses its next beat: the lease expires
    assert b.try_acquire() and b.generation == 2
    fences = REGISTRY.value("mrtpu_trainer_lease_fences_total")
    assert not a.heartbeat()
    with pytest.raises(TrainerFencedError, match="generation 1"):
        a.ensure_owned()
    assert REGISTRY.value("mrtpu_trainer_lease_fences_total") == fences + 1
    assert issubclass(TrainerFencedError, LeaseLostError)
    assert not a.release()  # guarded: never a theft
    assert b.peek()["holder"] == "b"


def test_ensure_owned_fences_after_transport_errors(monkeypatch):
    a = TrainerLease(Connection(_board(), "t"), holder="a", lease=0.1)
    a.acquire(timeout=1)

    def down():
        raise OSError("board unreachable")

    monkeypatch.setattr(a, "heartbeat", down)
    with pytest.raises(TrainerFencedError, match="unverifiable"):
        a.ensure_owned(max_wait=0.2, poll=0.05)


def test_seed_never_clobbers_a_held_lease():
    board = _board()
    a = TrainerLease(Connection(board, "t"), holder="a", lease=5.0)
    a.acquire(timeout=1)
    late = TrainerLease(Connection(board, "t"), holder="late", lease=5.0)
    late._seed()
    assert a.peek()["holder"] == "a" and a.heartbeat()


def test_jax_and_port_leases_exclude_each_other(tmp_path):
    """One ``dir://`` board: whichever package holds the lease, the other
    waits; the generation rises across the two."""
    board = f"dir://{tmp_path / 'board'}"
    j = JLease(JConnection(board, "train"), holder="jax", lease=5.0)
    t = TrainerLease(Connection(board, "train"), holder="torch", lease=5.0)
    assert j.acquire(timeout=1) == 1
    with pytest.raises(TimeoutError):
        t.acquire(timeout=0.2, poll=0.05)
    assert j.heartbeat()
    assert j.release()
    assert t.acquire(timeout=1) == 2
    with pytest.raises(TimeoutError):
        j.acquire(timeout=0.2, poll=0.05)
    assert j.peek()["holder"] == "torch"
    t.ensure_owned()
    # the port's holder lets the lease lapse: the JAX one takes it, and
    # the port's fences at its next boundary
    _lapse(t)
    assert j.try_acquire() and j.generation == 3
    with pytest.raises(TrainerFencedError):
        t.ensure_owned()
