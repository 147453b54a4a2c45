"""Control plane (port of ``mapreduce_tpu/coord``): the job board.

A document store of named collections (``<db>.task``,
``<db>.map_jobs``, ``<db>.red_jobs``, ``<db>.errors``) in process
memory (``mem://NAME``) or in a shared directory (``dir:///PATH``),
with atomic claims and leased RUNNING jobs; the task state machine;
the map and reduce job executors; the trainer and board-primary
leases; the networked board (``http://``: :mod:`.docserver`'s
``DocServer`` and ``HttpDocStore``); and its replication (:mod:`.ha`:
the mutation log of :mod:`.persistent_table`, the lease-elected
primary and its standbys).
"""

from .docstore import DirDocStore, MemoryDocStore, connect  # noqa: F401
from .connection import Connection  # noqa: F401
from .task import Task  # noqa: F401
from .job import Job  # noqa: F401
from .lease import (  # noqa: F401
    BoardLease, TrainerFencedError, TrainerLease)
from .ha import HaController, ReplicatedDocStore  # noqa: F401
from .persistent_table import PersistentTable  # noqa: F401
