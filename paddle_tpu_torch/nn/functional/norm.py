"""Normalization functionals (↔ paddle_tpu/nn/functional/norm.py).

`layer_norm` over one axis and `rms_norm` go through
`paddle_tpu_torch.ops.fused_norm.FusedNorm`: the forward and dx kernels on a
CUDA tensor, their plain versions on a CPU tensor, so a LayerNorm carries a
`grad_fn` like any other op. A LayerNorm over several trailing axes is the
plain composite, as in the JAX package. Both cast their inputs for AMP as
the ops "layer_norm" and "rms_norm" (black list: float32).
"""

from __future__ import annotations

import torch

from ... import amp
from ...ops.fused_norm import layer_norm_fwd, rms_norm_fwd

__all__ = ["layer_norm", "rms_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    n_axes = len(normalized_shape)
    x, weight, bias = amp.cast_inputs("layer_norm", x, weight, bias)
    if n_axes == 1:
        return layer_norm_fwd(x, weight, bias, epsilon)
    axes = tuple(range(x.dim() - n_axes, x.dim()))
    x32 = x.float()
    mean = x32.mean(axes, keepdim=True)
    var = (x32 - mean).square().mean(axes, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last axis with f32 statistics."""
    x, weight = amp.cast_inputs("rms_norm", x, weight)
    return rms_norm_fwd(x, weight, epsilon)
