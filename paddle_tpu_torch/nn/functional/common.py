"""Common functionals (↔ paddle_tpu/nn/functional/common.py): `linear` and
`embedding`, each casting its inputs for AMP at the op boundary under the
JAX package's op name."""

from __future__ import annotations

import torch

from ... import amp

__all__ = ["embedding", "linear"]


def linear(x, weight, bias=None, name=None):
    """y = x @ W (+ b), W stored [in, out] (Paddle's layout). Mixed input
    dtypes promote, as `jnp.matmul` does; a bf16 product accumulates in
    f32 and rounds once, then the bias is added in the output dtype."""
    x, weight, bias = amp.cast_inputs("linear", x, weight, bias)
    dt = torch.promote_types(x.dtype, weight.dtype)
    out = torch.matmul(x.to(dt), weight.to(dt))
    return out if bias is None else out + bias


def embedding(x, weight, name=None):
    """Row lookup `weight[x]` for integer ids x (padding_idx and sparse
    gradients come with the rest of the nn surface, ROADMAP A3)."""
    (weight,) = amp.cast_inputs("embedding", weight)
    return weight[x.long()]
