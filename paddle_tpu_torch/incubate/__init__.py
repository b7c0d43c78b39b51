"""paddle_tpu_torch.incubate (↔ paddle_tpu/incubate): the fused
functionals and layers of `nn`, the softmax-mask fusions of `operators`,
the MoE layer of `distributed.models.moe` and the optimizers of
`optimizer`. `autotune` (no tile autotuner here) is ROADMAP item 7 and
`jit.inference` (it needs `jit.to_static`) item 8."""

from . import nn, operators
from .operators import softmax_mask_fuse, softmax_mask_fuse_upper_triangle

__all__ = ["nn", "operators", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle"]
