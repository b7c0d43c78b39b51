"""Activations (↔ paddle_tpu/nn/functional/activation.py). Each casts its
input for AMP under the JAX package's op name. `rrelu` in training and
`gumbel_softmax` draw from the port's generators (`framework.random`)."""

from __future__ import annotations

import torch

from ... import amp
from ...framework.core import reported
from ...framework import random

__all__ = ["gelu", "gumbel_softmax", "log_softmax", "relu", "rrelu", "silu",
           "softmax", "tanh"]


@reported("gelu")
def gelu(x, approximate=False, name=None):
    """GELU; exact erf form unless `approximate` (tanh form), as Paddle's.
    Casts for AMP as the op "gelu"."""
    (x,) = amp.cast_inputs("gelu", x)
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")


@reported("softmax")
def softmax(x, axis=-1, dtype=None, name=None):
    """The softmax over `axis` (of x cast to `dtype` first, where given).
    Casts for AMP as the op "softmax" (black list: float32)."""
    (x,) = amp.cast_inputs("softmax", x)
    return torch.softmax(x if dtype is None else x.to(dtype), dim=axis)


@reported("log_softmax")
def log_softmax(x, axis=-1, dtype=None, name=None):
    """log(softmax(x)) over `axis`, as `softmax`; the op "log_softmax"."""
    (x,) = amp.cast_inputs("log_softmax", x)
    return torch.log_softmax(x if dtype is None else x.to(dtype), dim=axis)


@reported("relu")
def relu(x, name=None):
    (x,) = amp.cast_inputs("relu", x)
    return torch.relu(x)


@reported("tanh")
def tanh(x, name=None):
    (x,) = amp.cast_inputs("tanh", x)
    return torch.tanh(x)


@reported("silu")
def silu(x, name=None):
    (x,) = amp.cast_inputs("silu", x)
    return torch.nn.functional.silu(x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    """Randomized leaky ReLU (↔ :245): in training each negative element
    is scaled by its own slope ~ U(lower, upper), drawn in x's dtype; in
    eval by (lower + upper) / 2."""
    if not 0 <= lower <= upper <= 1:
        raise ValueError(
            f"rrelu expects 0 <= lower <= upper <= 1, got {lower}, {upper}")
    if not training:
        (x,) = amp.cast_inputs("rrelu_eval", x)
        return torch.where(x >= 0, x, x * ((lower + upper) / 2.0))
    (x,) = amp.cast_inputs("rrelu_train", x)
    s = torch.empty_like(x, memory_format=torch.contiguous_format).uniform_(
        lower, upper, generator=random.generator(x.device))
    return torch.where(x >= 0, x, x * s)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) over `axis` with Gumbel noise g drawn
    in x's dtype (↔ :212); `hard` gives the one-hot of the largest
    (every tie kept) in the forward and the soft gradient."""
    (x,) = amp.cast_inputs("gumbel_softmax", x)
    u = torch.empty_like(x, memory_format=torch.contiguous_format).uniform_(
        generator=random.generator(x.device))
    tiny = torch.finfo(x.dtype).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        oh = (y == y.amax(dim=axis, keepdim=True)).to(y.dtype)
        return oh + y - y.detach()
    return y
