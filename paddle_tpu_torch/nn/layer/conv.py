"""Conv layers (↔ paddle_tpu/nn/layer/conv.py).

The weight is [out, in / groups, *k], drawn Kaiming-uniform with
a = sqrt(5) over fan_in = in / groups * prod(k), the reference's default
(:40-43: bound 1 / sqrt(fan_in)); the bias starts at zero. Both go through
`Layer.create_parameter`, so a `weight_attr` / `bias_attr` applies (a
given weight_attr replaces the Kaiming default by its own initializer,
else Xavier-uniform, as in the reference). Only the "zeros" padding mode
exists, as in the reference. The transposed conv layers take the
reference's parameters and raise, naming ROADMAP queue A item 8.
"""

from __future__ import annotations

import math

import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose"]


class _ConvNd(Layer):
    _n = None
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode {padding_mode!r} is ported with ROADMAP queue A "
                "item 8")
        n = self._n
        k = (kernel_size,) * n if isinstance(kernel_size, int) else tuple(kernel_size)
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = k
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        kw = dict(dtype=dtype, generator=generator, device=device)
        fan_in = in_channels // groups * math.prod(k)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *k], weight_attr,
            default_initializer=None if weight_attr is not None else
            I.KaimingUniform(fan_in=fan_in, negative_slope=math.sqrt(5.0),
                             nonlinearity="leaky_relu"), **kw)
        self.bias = self.create_parameter([out_channels], bias_attr,
                                          is_bias=True, **kw)

    def forward(self, x):
        return self._fn(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, kernel_size="
                f"{self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")


class Conv1D(_ConvNd):
    _n = 1
    _fn = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, **kw)


class Conv2D(_ConvNd):
    _n = 2
    _fn = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, **kw)


class Conv3D(_ConvNd):
    _n = 3
    _fn = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, **kw)


def _transpose_unported(layer):
    raise NotImplementedError(
        f"{type(layer).__name__} is ported with ROADMAP queue A item 8")


class Conv1DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__()
        _transpose_unported(self)


class Conv2DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        _transpose_unported(self)


class Conv3DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__()
        _transpose_unported(self)
