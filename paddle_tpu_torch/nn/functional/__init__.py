"""paddle_tpu_torch.nn.functional — the functionals the ported paths use."""

from .activation import (gelu, gumbel_softmax, log_softmax, relu, rrelu,
                         silu, softmax, tanh)
from .common import (alpha_dropout, dropout, dropout2d, dropout3d, embedding,
                     linear)
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d,
                   conv3d_transpose)
from .extras import flash_attn_varlen_qkvpacked
from .flash_attention import (flash_attention, flash_attn_unpadded,
                              flashmask_attention, ring_flash_attention,
                              scaled_dot_product_attention)
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   class_center_sample, cosine_embedding_loss, cross_entropy,
                   ctc_loss, hinge_embedding_loss, hsigmoid_loss, kl_div,
                   l1_loss, log_loss, margin_cross_entropy,
                   margin_ranking_loss, mse_loss, nll_loss,
                   sigmoid_focal_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost,
                   triplet_margin_loss)
from .norm import (batch_norm, batch_stats_group, batch_stats_over,
                   group_norm, instance_norm, layer_norm, rms_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)

__all__ = ["alpha_dropout", "dropout2d", "dropout3d", "gumbel_softmax",
           "rrelu", "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
           "avg_pool1d", "avg_pool2d", "avg_pool3d", "batch_norm",
           "batch_stats_group", "batch_stats_over", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "class_center_sample", "conv1d", "conv1d_transpose",
           "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
           "cosine_embedding_loss", "cross_entropy", "ctc_loss", "dropout",
           "embedding", "flash_attention", "flash_attn_unpadded",
           "flash_attn_varlen_qkvpacked", "flashmask_attention", "gelu",
           "group_norm", "hinge_embedding_loss", "hsigmoid_loss",
           "instance_norm", "kl_div", "l1_loss", "layer_norm", "linear",
           "log_loss", "log_softmax", "margin_cross_entropy",
           "margin_ranking_loss", "max_pool1d", "max_pool2d", "max_pool3d",
           "mse_loss", "nll_loss", "relu", "ring_flash_attention", "rms_norm",
           "scaled_dot_product_attention", "sigmoid_focal_loss", "silu",
           "smooth_l1_loss", "softmax", "softmax_with_cross_entropy",
           "square_error_cost", "tanh", "triplet_margin_loss"]
