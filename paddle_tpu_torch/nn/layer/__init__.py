from .common import Embedding, Linear
from .container import LayerList
from .norm import LayerNorm, RMSNorm

__all__ = ["Embedding", "LayerList", "LayerNorm", "Linear", "RMSNorm"]
