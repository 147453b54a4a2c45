"""Named-blob storage (port of ``mapreduce_tpu/storage``): the durable
plane under checkpoints and session spills.

Two backends, chosen by a DSL string through :func:`router`:

  * ``mem[:name]`` — an in-process named byte store (tests, one
    process);
  * ``shared:PATH`` (alias ``local:PATH``) — a directory on local disk
    or NFS, atomic tempfile + rename writes.

The JAX package's ``http:HOST:PORT`` blob service and its storage
metrics are not ported yet (ROADMAP).  A blob either package writes
through ``shared:`` reads back through the other's: the file names and
bytes are the same.
"""

from .base import FileBuilder, Storage  # noqa: F401
from .localdir import LocalDirStorage  # noqa: F401
from .memory import MemoryStorage  # noqa: F401
from .router import get_storage_from, router  # noqa: F401
