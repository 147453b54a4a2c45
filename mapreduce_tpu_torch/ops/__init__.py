"""Device ops: the tokenizer, tile compaction and sorted-run reduction,
with the hand-written CUDA kernels behind ``tokenize_hash`` and the
segmented reduce (``kernel_compat`` holds the one kernel-vs-plain rule)."""

from .compaction import tile_compact  # noqa: F401
from .segscan import SENTINEL, sorted_unique_reduce  # noqa: F401
from .tokenize import TokenStream, tokenize_hash  # noqa: F401
