"""paddle_tpu_torch.incubate.nn.layer (↔ paddle_tpu/incubate/nn/layer)."""

from .fused_attention_layers import (FusedBiasDropoutResidualLayerNorm,
                                     FusedFeedForward,
                                     FusedMultiHeadAttention,
                                     FusedTransformerEncoderLayer)
from .fused_transformer import FusedMultiTransformer

__all__ = ["FusedBiasDropoutResidualLayerNorm", "FusedFeedForward",
           "FusedMultiHeadAttention", "FusedMultiTransformer",
           "FusedTransformerEncoderLayer"]
