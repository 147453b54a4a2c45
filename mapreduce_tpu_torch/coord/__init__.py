"""Control plane (port of ``mapreduce_tpu/coord``): the job board.

A document store of named collections (``<db>.task``,
``<db>.map_jobs``, ``<db>.red_jobs``, ``<db>.errors``) in process
memory (``mem://NAME``) or in a shared directory (``dir:///PATH``),
with atomic claims and leased RUNNING jobs; the task state machine; and
the map and reduce job executors.  The networked board (``http://``),
leases for trainers and the replicated board are not ported yet
(ROADMAP A.4b).
"""

from .docstore import DirDocStore, MemoryDocStore, connect  # noqa: F401
from .connection import Connection  # noqa: F401
from .task import Task  # noqa: F401
from .job import Job  # noqa: F401
