"""Models: the transformer LM on the flash-attention kernels (with its
MoE FFN and the ring over sequence partitions), the pipelined
classifier, and the digits MLP with its fused trainer."""

from .digits import make_digits  # noqa: F401
from .mlp import MLPConfig  # noqa: F401
from .pipeline import (  # noqa: F401
    PipelineConfig, PipelinedTrainer, init_pipeline_params,
    pipeline_forward_local, pipeline_reference)
from .trainer import DistributedTrainer, TrainConfig  # noqa: F401
from .transformer import (  # noqa: F401
    Transformer, TransformerConfig, TransformerTrainer, forward_local,
    init_transformer, jax_name, loss_local, module_name, param_shapes,
    train_flops)
