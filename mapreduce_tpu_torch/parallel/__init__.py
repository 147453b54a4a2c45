"""The partition axis, its link classes, the exchange between
partitions and the ring attention over sequence partitions."""

from .mesh import (  # noqa: F401
    LINK_CLASSES, Partitions, device_link_matrix, link_class, link_peaks,
    partition_devices)
from .ring import full_attention_reference, ring_attention  # noqa: F401
from .shuffle import Exchanged, partition_exchange  # noqa: F401
