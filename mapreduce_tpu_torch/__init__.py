"""mapreduce_tpu_torch -- the PyTorch + CUDA port of mapreduce_tpu.

The device word count and the transformer training step of the JAX
package, rebuilt for one NVIDIA H100: plain tensor code is PyTorch, and
each Pallas TPU kernel on those paths is a CUDA C++ kernel written by
hand for Hopper (``csrc/``, built with ``nvcc`` for ``sm_90a`` at first
use).  The package imports nothing of
JAX or of ``mapreduce_tpu``; it keeps its own copies of what it needs.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel is replaced by its plain PyTorch
version — the form the tests hold against the JAX package.
"""

__version__ = "0.1.0"
