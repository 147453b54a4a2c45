"""Models: the transformer LM on the flash-attention kernels."""

from .transformer import (  # noqa: F401
    Transformer, TransformerConfig, TransformerTrainer, forward_local,
    init_transformer, jax_name, loss_local, module_name, param_shapes,
    train_flops)
