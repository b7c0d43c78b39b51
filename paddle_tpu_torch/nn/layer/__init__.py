from .common import Embedding, Linear
from .norm import LayerNorm, RMSNorm

__all__ = ["Embedding", "LayerNorm", "Linear", "RMSNorm"]
