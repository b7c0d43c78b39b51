"""The softmax-mask fusions (↔ paddle_tpu/incubate/operators.py), torch
ops as the JAX package's are jnp."""

from __future__ import annotations

import torch

from .. import amp

__all__ = ["softmax_mask_fuse", "softmax_mask_fuse_upper_triangle"]


def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) over the last axis (↔ :19): x [B, H, S, S]
    scores, an additive mask broadcastable to it, cast to x's dtype."""
    x, mask = amp.cast_inputs("fused_softmax_mask", x, mask)
    return torch.softmax(x + mask.to(x.dtype), dim=-1)


def softmax_mask_fuse_upper_triangle(x, name=None):
    """The causal softmax over x [..., S, S] (↔ :31): the scores above the
    diagonal take the dtype's lowest finite value first."""
    (x,) = amp.cast_inputs("fused_softmax_mask_upper_triangle", x)
    s = x.shape[-1]
    keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    low = torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype,
                     device=x.device)
    return torch.softmax(torch.where(keep, x, low), dim=-1)
