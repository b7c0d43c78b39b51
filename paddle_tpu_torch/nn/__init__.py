"""paddle_tpu_torch.nn — the layers of the ported path, as torch.nn.Modules
with Paddle's names and layouts."""

from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import Embedding, LayerList, LayerNorm, Linear, RMSNorm

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Embedding", "LayerList", "LayerNorm", "Linear", "RMSNorm",
           "clip_grad_norm_", "clip_grad_value_", "functional"]
