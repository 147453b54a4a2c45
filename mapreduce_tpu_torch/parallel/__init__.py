"""The partition axis, its link classes and the exchange between
partitions."""

from .mesh import (  # noqa: F401
    LINK_CLASSES, Partitions, device_link_matrix, link_class, link_peaks,
    partition_devices)
from .shuffle import Exchanged, partition_exchange  # noqa: F401
