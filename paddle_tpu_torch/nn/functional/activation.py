"""Activations (↔ paddle_tpu/nn/functional/activation.py). Each casts its
input for AMP under the JAX package's op name and computes the reference's
formula with torch ops (the reference's are jax.nn / jnp, with no Pallas
kernel), with its defaults: `leaky_relu` 0.01, `hardsigmoid` clip(x /
6 + 1 / 2, 0, 1) at Paddle's slope 0.1666667, `hardswish` x * relu6(x +
3) / 6, `softplus` x where beta * x exceeds the threshold. `relu_`
rectifies its tensor in place and returns it. `rrelu` in training and
`gumbel_softmax` draw from the port's generators (`framework.random`)."""

from __future__ import annotations

import torch

from ... import amp
from ...framework.core import reported
from ...framework import random

__all__ = ["celu", "elu", "gelu", "glu", "gumbel_softmax", "hardshrink",
           "hardsigmoid", "hardswish", "hardtanh", "leaky_relu",
           "log_sigmoid", "log_softmax", "maxout", "mish", "prelu", "relu",
           "relu6", "relu_", "rrelu", "selu", "sigmoid", "silu", "softmax",
           "softplus", "softshrink", "softsign", "swish", "tanh",
           "tanhshrink", "thresholded_relu"]


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


def _unary(op_name, fn):
    """The activation `op_name`: fn(x) on x cast for AMP as that op."""
    @reported(op_name)
    def op(x, name=None):
        (x,) = amp.cast_inputs(op_name, x)
        return fn(x)

    op.__name__ = op.__qualname__ = op_name
    return op


relu6 = _unary("relu6", lambda a: torch.clamp(a, 0.0, 6.0))
sigmoid = _unary("sigmoid", torch.sigmoid)
log_sigmoid = _unary("log_sigmoid", torch.nn.functional.logsigmoid)
softsign = _unary("softsign", lambda a: a / (1 + a.abs()))
tanhshrink = _unary("tanhshrink", lambda a: a - torch.tanh(a))
mish = _unary("mish", lambda a: a * torch.tanh(
    torch.nn.functional.softplus(a)))
hardswish = _unary("hardswish", lambda a: a * torch.clamp(a + 3.0, 0.0, 6.0)
                   / 6.0)


def relu_(x, name=None):
    """relu in place on x; returns x."""
    return torch.relu_(x)


def swish(x, name=None):
    return silu(x)


@reported("leaky_relu")
def leaky_relu(x, negative_slope=0.01, name=None):
    (x,) = amp.cast_inputs("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


@reported("elu")
def elu(x, alpha=1.0, name=None):
    (x,) = amp.cast_inputs("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


@reported("selu")
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    (x,) = amp.cast_inputs("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@reported("celu")
def celu(x, alpha=1.0, name=None):
    (x,) = amp.cast_inputs("celu", x)
    return torch.celu(x, alpha)


@reported("hardsigmoid")
def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    (x,) = amp.cast_inputs("hardsigmoid", x)
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@reported("hardtanh")
def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    (x,) = amp.cast_inputs("hardtanh", x)
    return torch.clamp(x, min, max)


@reported("hardshrink")
def hardshrink(x, threshold=0.5, name=None):
    (x,) = amp.cast_inputs("hardshrink", x)
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


@reported("softshrink")
def softshrink(x, threshold=0.5, name=None):
    (x,) = amp.cast_inputs("softshrink", x)
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


@reported("softplus")
def softplus(x, beta=1.0, threshold=20.0, name=None):
    (x,) = amp.cast_inputs("softplus", x)
    return torch.where(beta * x > threshold, x,
                       torch.nn.functional.softplus(beta * x) / beta)


@reported("prelu")
def prelu(x, weight, data_format="NCHW", name=None):
    """max(0, x) + slope * min(0, x): one slope, or one a channel (axis 1,
    or the last axis when `data_format` is not "NC...")."""
    x, weight = amp.cast_inputs("prelu", x, weight)
    if weight.numel() == 1:
        slope = weight.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format.startswith("NC") else x.dim() - 1] = weight.numel()
        slope = weight.reshape(shape)
    return torch.where(x > 0, x, slope * x)


@reported("glu")
def glu(x, axis=-1, name=None):
    """a * sigmoid(b), a and b the two halves of x along `axis`."""
    (x,) = amp.cast_inputs("glu", x)
    a, b = x.chunk(2, dim=axis)
    return a * torch.sigmoid(b)


@reported("maxout")
def maxout(x, groups, axis=1, name=None):
    """The channels of `axis` in runs of `groups`, each run's largest."""
    (x,) = amp.cast_inputs("maxout", x)
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax + 1)


@reported("thresholded_relu")
def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    (x,) = amp.cast_inputs("thresholded_relu", x)
    return torch.where(x > threshold, x, torch.full_like(x, value))
