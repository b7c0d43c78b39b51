"""Conv layers (↔ paddle_tpu/nn/layer/conv.py).

The weight is [out, in / groups, *k], drawn Kaiming-uniform with
a = sqrt(5) over fan_in = in / groups * prod(k), the reference's default
(:40-43: bound 1 / sqrt(fan_in)); the bias starts at zero. Only the
"zeros" padding mode exists, as in the reference. The transposed conv
layers raise, naming ROADMAP queue A item 8.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from .layers import Layer
from ...framework.core import Parameter

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
        if weight_attr is not None:
            raise NotImplementedError(
                "a weight_attr (ParamAttr initializers) is ported with ROADMAP "
                "queue A item 6")
        dev = resolve_device(device)
        n = self._n
        k = (kernel_size,) * n if isinstance(kernel_size, int) else tuple(kernel_size)
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = k
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        w = torch.empty(out_channels, in_channels // groups, *k, device=dev,
                        dtype=dtype)
        with torch.no_grad():
            nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=generator)
        self.weight = Parameter(w)
        self.bias = (None if bias_attr is False else Parameter(
            torch.zeros(out_channels, device=dev, dtype=dtype)))

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


class _ConvTransposeUnported(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()
        raise NotImplementedError(
            f"{type(self).__name__} is ported with ROADMAP queue A item 8")


class Conv1DTranspose(_ConvTransposeUnported):
    pass


class Conv2DTranspose(_ConvTransposeUnported):
    pass


class Conv3DTranspose(_ConvTransposeUnported):
    pass
