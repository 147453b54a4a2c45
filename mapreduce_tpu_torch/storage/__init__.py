"""Named-blob storage (port of ``mapreduce_tpu/storage``): the durable
plane under the job plane's record files, checkpoints and session
spills.

Three backends, chosen by a DSL string through :func:`router`:

  * ``mem[:name]`` — an in-process named byte store (tests, one
    process);
  * ``shared:PATH`` (alias ``local:PATH``) — a directory on local disk
    or NFS, atomic tempfile + rename writes;
  * ``http:HOST:PORT`` — a central blob service (:mod:`.httpstore`),
    the cross-host role the reference's scp/"sshfs" backend played
    (fs.lua:141-181).  Start one with ``python -m
    mapreduce_tpu_torch.cli blobserver DIR --port N``.

A blob either package writes through ``shared:`` or ``http:`` reads
back through the other's: the file names, the bytes and the wire are
the same.
"""

from .base import FileBuilder, Storage  # noqa: F401
from .localdir import LocalDirStorage  # noqa: F401
from .memory import MemoryStorage  # noqa: F401
from .httpstore import BlobServer, HttpStorage  # noqa: F401
from .router import get_storage_from, router  # noqa: F401
