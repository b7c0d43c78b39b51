"""paddle_tpu_torch.nn.functional — the reference's functional names (↔
paddle_tpu/nn/functional/__init__.py). The names ROADMAP keeps for item 8
(the unpool, lp and fractional pools, the transposed convs, `ctc_loss`)
raise naming it; `local_response_norm` is not ported yet."""

from . import activation, common, conv, extras, loss, norm, pooling
from . import flash_attention as _flash_attention_mod
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d,
                   conv3d_transpose)
from .extras import *  # noqa: F401,F403
from .flash_attention import *  # noqa: F401,F403
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   class_center_sample, cosine_embedding_loss, cross_entropy,
                   ctc_loss, hinge_embedding_loss, hsigmoid_loss, kl_div,
                   l1_loss, log_loss, margin_cross_entropy,
                   margin_ranking_loss, mse_loss, nll_loss,
                   sigmoid_focal_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost,
                   triplet_margin_loss)
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403

__all__ = sorted({
    *activation.__all__, *common.__all__, *extras.__all__, *norm.__all__,
    *pooling.__all__, *_flash_attention_mod.__all__,
    "conv1d", "conv1d_transpose", "conv2d", "conv2d_transpose", "conv3d",
    "conv3d_transpose", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "class_center_sample",
    "cosine_embedding_loss", "cross_entropy", "ctc_loss",
    "hinge_embedding_loss", "hsigmoid_loss", "kl_div", "l1_loss", "log_loss",
    "margin_cross_entropy", "margin_ranking_loss", "mse_loss", "nll_loss",
    "sigmoid_focal_loss", "smooth_l1_loss", "softmax_with_cross_entropy",
    "square_error_cost", "triplet_margin_loss"})
