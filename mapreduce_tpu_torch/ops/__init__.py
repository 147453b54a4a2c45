"""Device ops: the tokenizer, tile compaction, sorted-run reduction and
flash attention (``ops.flash_attention``, a module: import from it),
with the hand-written CUDA kernels behind ``tokenize_hash``, the
segmented reduce, the radix sort and attention (``kernel_compat`` holds
the one kernel-vs-plain rule)."""

from .compaction import tile_compact  # noqa: F401
from .segscan import SENTINEL, sorted_unique_reduce  # noqa: F401
from .tokenize import TokenStream, tokenize_hash  # noqa: F401
