"""Common functionals (↔ paddle_tpu/nn/functional/common.py): `linear`,
`embedding` and `dropout`, each casting its inputs for AMP at the op
boundary under the JAX package's op name."""

from __future__ import annotations

import torch

from ... import amp

__all__ = ["dropout", "embedding", "linear"]


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


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Dropout (↔ :63): the identity at p = 0 or outside training, where
    mode "downscale_in_infer" scales by 1 - p. Dropping at p > 0 in
    training raises: the mask needs an explicit generator (ROADMAP queue A
    item 4)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            (x,) = amp.cast_inputs("dropout_scale", x)
            return x * (1.0 - p)
        return x
    raise NotImplementedError(
        f"dropout at p = {p} in training needs an explicit generator "
        "(ROADMAP queue A item 4); set the dropout probabilities to 0")
