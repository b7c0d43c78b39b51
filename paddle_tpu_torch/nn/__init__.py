"""paddle_tpu_torch.nn — the layers of the ported path, as torch.nn.Modules
with Paddle's names and layouts."""

from . import functional
from .layer import Embedding, LayerList, LayerNorm, Linear, RMSNorm

__all__ = ["Embedding", "LayerList", "LayerNorm", "Linear", "RMSNorm",
           "functional"]
