"""Control plane (port of ``mapreduce_tpu/coord``): the job board.

A document store of named collections (``<db>.task``,
``<db>.map_jobs``, ``<db>.red_jobs``, ``<db>.errors``) in process
memory (``mem://NAME``) or in a shared directory (``dir:///PATH``),
with atomic claims and leased RUNNING jobs; the task state machine;
the map and reduce job executors; and the trainer lease.  The networked
board (``http://``) and the replicated board with its board lease are
not ported yet (ROADMAP A.4b).
"""

from .docstore import DirDocStore, MemoryDocStore, connect  # noqa: F401
from .connection import Connection  # noqa: F401
from .task import Task  # noqa: F401
from .job import Job  # noqa: F401
from .lease import TrainerFencedError, TrainerLease  # noqa: F401
