"""Common functionals (↔ paddle_tpu/nn/functional/common.py): `linear`,
`embedding` and the dropout family (`dropout`, `dropout2d`, `dropout3d`,
`alpha_dropout`), each casting its inputs for AMP at the op boundary
under the JAX package's op name. The dropout masks are drawn from the
port's generators (`framework.random`), so the same generator state gives
the same mask; they are not the JAX package's masks (another RNG)."""

from __future__ import annotations

import torch

from ... import amp
from ...framework.core import reported
from ...framework import random

__all__ = ["alpha_dropout", "dropout", "dropout2d", "dropout3d", "embedding",
           "linear"]


@reported("linear")
def linear(x, weight, bias=None, name=None):
    """y = x @ W (+ b), W stored [in, out] (Paddle's layout). Mixed input
    dtypes promote, as `jnp.matmul` does; a bf16 product accumulates in
    f32 and rounds once, then the bias is added in the output dtype."""
    x, weight, bias = amp.cast_inputs("linear", x, weight, bias)
    dt = torch.promote_types(x.dtype, weight.dtype)
    out = torch.matmul(x.to(dt), weight.to(dt))
    return out if bias is None else out + bias


@reported("embedding")
def embedding(x, weight, name=None):
    """Row lookup `weight[x]` for integer ids x (padding_idx and sparse
    gradients come with the rest of the nn surface, ROADMAP queue A item 8)."""
    (weight,) = amp.cast_inputs("embedding", weight)
    return weight[x.long()]


def _keep(x, p, shape):
    """A bool mask of `shape` on x's device, each element kept with
    probability 1 - p, from the port's generator (`framework.random`)."""
    g = random.generator(x.device)
    return torch.rand(shape, generator=g, device=x.device) >= p


@reported("dropout")
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Dropout (↔ :63): the identity at p = 0 or outside training, where
    mode "downscale_in_infer" scales by 1 - p. In training each element
    (or, with `axis`, each slice along the axes given, the mask broadcast
    over the others) is kept with probability 1 - p: as x / (1 - p) in
    mode "upscale_in_train", as x in "downscale_in_infer"; p = 1 gives
    zeros. The output keeps the input's dtype (after the AMP cast of the
    op "dropout")."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unknown dropout mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            (x,) = amp.cast_inputs("dropout_scale", x)
            return x * (1.0 - p)
        return x
    if p == 1.0:
        (x,) = amp.cast_inputs("dropout_all", x)
        return x.masked_fill(torch.ones((), dtype=torch.bool,
                                        device=x.device), 0)
    (x,) = amp.cast_inputs("dropout", x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = _keep(x, p, shape)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0)
    return torch.where(keep, x, 0.0)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels dropped: the mask is [N, C, 1, 1] (↔ :87)."""
    axes = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axes, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Whole channels dropped: the mask is [N, C, 1, 1, 1] (↔ :92)."""
    axes = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axes, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout (↔ :97): a dropped element takes -alpha * scale, and
    the result is scaled and shifted so that a zero-mean unit-variance
    input keeps its mean and variance."""
    if not training or p == 0.0:
        return x
    (x,) = amp.cast_inputs("alpha_dropout", x)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    q = 1.0 - p
    a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
    b_coef = -a_coef * alpha_p * p
    keep = _keep(x, p, x.shape)
    return a_coef * torch.where(keep, x, alpha_p) + b_coef
