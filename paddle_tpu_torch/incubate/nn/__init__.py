"""paddle_tpu_torch.incubate.nn (↔ paddle_tpu/incubate/nn): the fused
functionals and the fused layers."""

from . import functional
from .layer import (FusedBiasDropoutResidualLayerNorm, FusedFeedForward,
                    FusedMultiHeadAttention, FusedMultiTransformer,
                    FusedTransformerEncoderLayer)

__all__ = ["FusedBiasDropoutResidualLayerNorm", "FusedFeedForward",
           "FusedMultiHeadAttention", "FusedMultiTransformer",
           "FusedTransformerEncoderLayer", "functional"]
