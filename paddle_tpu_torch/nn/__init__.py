"""paddle_tpu_torch.nn — the layers of the ported paths, as torch.nn.Modules
with Paddle's names and layouts."""

from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "clip_grad_value_", "functional", *_layers]
