"""paddle_tpu_torch.nn.functional — the functionals the ported path uses."""

from .activation import gelu
from .flash_attention import scaled_dot_product_attention
from .norm import layer_norm, rms_norm

__all__ = ["gelu", "layer_norm", "rms_norm", "scaled_dot_product_attention"]
