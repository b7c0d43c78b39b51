"""paddle_tpu_torch.nn.functional — the functionals the ported paths use."""

from .activation import gelu
from .common import embedding, linear
from .extras import flash_attn_varlen_qkvpacked
from .flash_attention import (flash_attention, flash_attn_unpadded,
                              flashmask_attention, ring_flash_attention,
                              scaled_dot_product_attention)
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["cross_entropy", "embedding", "flash_attention",
           "flash_attn_unpadded", "flash_attn_varlen_qkvpacked",
           "flashmask_attention", "gelu", "layer_norm", "linear", "rms_norm",
           "ring_flash_attention", "scaled_dot_product_attention"]
