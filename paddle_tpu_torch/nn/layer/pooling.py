"""Pooling layers (↔ paddle_tpu/nn/layer/pooling.py): each calls its
functional with the arguments it was built with, as the reference's."""

from __future__ import annotations


from .. import functional as F
from .layers import Layer

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D"]


class _Pool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, **kw):
        super().__init__()
        self._args = (kernel_size, stride, padding)
        self._kw = kw

    def forward(self, x):
        return getattr(F, self._fn)(x, *self._args, **self._kw)

    def extra_repr(self):
        return f"kernel_size={self._args[0]}, stride={self._args[1]}, padding={self._args[2]}"


class AvgPool1D(_Pool):
    _fn = "avg_pool1d"


class AvgPool2D(_Pool):
    _fn = "avg_pool2d"


class AvgPool3D(_Pool):
    _fn = "avg_pool3d"


class MaxPool1D(_Pool):
    _fn = "max_pool1d"


class MaxPool2D(_Pool):
    _fn = "max_pool2d"


class MaxPool3D(_Pool):
    _fn = "max_pool3d"


class _AdaptivePool(Layer):
    _fn = None

    def __init__(self, output_size, **kw):
        super().__init__()
        self._output_size = output_size
        self._kw = kw

    def forward(self, x):
        return getattr(F, self._fn)(x, self._output_size, **self._kw)

    def extra_repr(self):
        return f"output_size={self._output_size}"


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = "adaptive_avg_pool1d"


class AdaptiveAvgPool2D(_AdaptivePool):
    _fn = "adaptive_avg_pool2d"


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = "adaptive_avg_pool3d"


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = "adaptive_max_pool1d"


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = "adaptive_max_pool2d"


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = "adaptive_max_pool3d"
