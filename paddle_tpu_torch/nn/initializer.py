"""Parameter initializers (↔ paddle_tpu/nn/initializer.py).

Each initializer is a callable that fills a parameter IN PLACE, on the
parameter's own device, and returns it: the port's `Parameter` is a
`torch.nn.Parameter` that optimizers and steps hold by identity, so a fresh
tensor would leave them holding the old one. A random initializer draws
from the `generator` it is given, else from the port's generator of the
parameter's device (`framework.random.generator`), so `paddle.seed` and
`rng_guard` govern it; the numbers are not the JAX package's (another
RNG), their distribution is. Normal and uniform draws are made in the
parameter's dtype, as the port's layers always drew them; the truncated
normal and the orthogonal matrix are drawn in f32 and cast.

`calculate_gain` and `_fans` are the reference's exactly: a 2-d weight is
[in, out] (Paddle's Linear layout), a conv weight [out, in, *k].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..framework.core import Tensor

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Orthogonal", "Dirac", "calculate_gain"]


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0,
        "linear": 1.0,
        "conv1d": 1.0,
        "conv2d": 1.0,
        "conv3d": 1.0,
        "tanh": 5.0 / 3.0,
        "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    return gains[nonlinearity]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _held(param):
    """The torch tensor to fill: the parameter itself, or a `Tensor`'s."""
    return param._value if isinstance(param, Tensor) else param


class Initializer:
    """`init(param, generator=None)` fills `param` in place and returns
    it (module docstring)."""

    def __call__(self, param, block=None, generator=None):
        t = _held(param)
        with torch.no_grad():
            self._fill(t, generator if generator is not None
                       else _default_generator(t.device))
        return param

    def _fill(self, t, g):
        raise NotImplementedError


def _default_generator(device):
    from ..framework import random

    return random.generator(device)


def _copy_f32(t, value):
    t.copy_(value.to(t.dtype))


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _fill(self, t, g):
        t.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def _fill(self, t, g):
        t.normal_(self.mean, self.std, generator=g)


class TruncatedNormal(Initializer):
    """mean + std * v, v standard normal cut to [a, b] (in units of std,
    the reference's `jax.random.truncated_normal(a, b)`)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _fill(self, t, g):
        v = torch.empty(t.shape, dtype=torch.float32, device=t.device)
        torch.nn.init.trunc_normal_(v, 0.0, 1.0, self.a, self.b, generator=g)
        _copy_f32(t, self.mean + self.std * v)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def _fill(self, t, g):
        t.uniform_(self.low, self.high, generator=g)


class _Fanned(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fan_sum(self, t):
        fi, fo = _fans(t.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return fi + fo


class XavierNormal(_Fanned):
    def _fill(self, t, g):
        t.normal_(0.0, self.gain * math.sqrt(2.0 / self._fan_sum(t)),
                  generator=g)


class XavierUniform(_Fanned):
    def _fill(self, t, g):
        limit = self.gain * math.sqrt(6.0 / self._fan_sum(t))
        t.uniform_(-limit, limit, generator=g)


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain_fan(self, t):
        fi = self.fan_in if self.fan_in is not None else _fans(t.shape)[0]
        return calculate_gain(self.nonlinearity, self.negative_slope), fi


class KaimingNormal(_Kaiming):
    def _fill(self, t, g):
        gain, fi = self._gain_fan(t)
        t.normal_(0.0, gain / math.sqrt(fi), generator=g)


class KaimingUniform(_Kaiming):
    def _fill(self, t, g):
        gain, fi = self._gain_fan(t)
        limit = gain * math.sqrt(3.0 / fi)
        t.uniform_(-limit, limit, generator=g)


class Assign(Initializer):
    """The parameter takes `value` (a numpy array, a list, a `Tensor` or a
    torch tensor of its shape), cast to its dtype."""

    def __init__(self, value, name=None):
        self.value = value

    def _fill(self, t, g):
        v = _held(self.value)
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        t.copy_(v.to(device=t.device, dtype=t.dtype).reshape(t.shape))


class Orthogonal(Initializer):
    """The Q of a QR of a standard normal [max(r, c), min(r, c)] matrix,
    its columns' signs set by R's diagonal, transposed when r < c, r the
    first dim and c the product of the others; times `gain`."""

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def _fill(self, t, g):
        rows = t.shape[0]
        cols = int(np.prod(t.shape[1:])) if t.dim() > 1 else 1
        flat = torch.randn(max(rows, cols), min(rows, cols), generator=g,
                           dtype=torch.float32, device=t.device)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        _copy_f32(t, self.gain * q[:rows, :cols].reshape(t.shape))


class Dirac(Initializer):
    """Ones at the centre tap of each (group's out channel i, in channel
    i) pair, zeros elsewhere: a conv that passes its input through."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def _fill(self, t, g):
        t.zero_()
        out_per_group = t.shape[0] // self.groups
        minc = min(out_per_group, t.shape[1])
        centers = tuple(s // 2 for s in t.shape[2:])
        for grp in range(self.groups):
            for i in range(minc):
                t[(grp * out_per_group + i, i) + centers] = 1.0


# the reference's lower-case aliases
constant = Constant
normal = Normal
uniform = Uniform
