"""The partition axis and the exchange between partitions."""

from .mesh import Partitions  # noqa: F401
from .shuffle import Exchanged, partition_exchange  # noqa: F401
