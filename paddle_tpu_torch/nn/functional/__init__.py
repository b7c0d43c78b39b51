"""paddle_tpu_torch.nn.functional — the functionals the ported paths use."""

from .activation import gelu, relu, silu, tanh
from .common import dropout, embedding, linear
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d,
                   conv3d_transpose)
from .extras import flash_attn_varlen_qkvpacked
from .flash_attention import (flash_attention, flash_attn_unpadded,
                              flashmask_attention, ring_flash_attention,
                              scaled_dot_product_attention)
from .loss import cross_entropy
from .norm import (batch_norm, batch_stats_group, batch_stats_over,
                   layer_norm, rms_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)

__all__ = ["adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
           "avg_pool1d", "avg_pool2d", "avg_pool3d", "batch_norm",
           "batch_stats_group", "batch_stats_over", "conv1d",
           "conv1d_transpose", "conv2d", "conv2d_transpose", "conv3d",
           "conv3d_transpose", "cross_entropy", "dropout", "embedding",
           "flash_attention", "flash_attn_unpadded",
           "flash_attn_varlen_qkvpacked", "flashmask_attention", "gelu",
           "layer_norm", "linear", "max_pool1d", "max_pool2d", "max_pool3d",
           "relu", "ring_flash_attention", "rms_norm",
           "scaled_dot_product_attention", "silu", "tanh"]
