"""paddle_tpu_torch.nn — the layers, functionals, initializers and
utilities of Paddle's `nn` (↔ paddle_tpu/nn/), as torch.nn.Modules with
Paddle's names, signatures and layouts."""

from . import functional, initializer, quant, utils
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import *  # noqa: F401,F403
from .layer import (activation, common, container, conv, layers, loss, norm,  # noqa: F401
                    pooling, transformer)
from .layer import __all__ as _layers

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "clip_grad_value_", "functional", "initializer",
           "quant", "utils", *_layers]
