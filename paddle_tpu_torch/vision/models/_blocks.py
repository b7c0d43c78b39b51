"""Shared conv building blocks of the vision zoo (↔
paddle_tpu/vision/models/_blocks.py)."""

from __future__ import annotations

import torch

from ... import nn as pnn
from ...nn.layer.layers import Layer

__all__ = ["ConvBNReLU"]


class ConvBNReLU(Layer):
    """Conv2D (no bias) + BatchNorm2D + ReLU."""

    def __init__(self, in_ch, out_ch, k, stride=1, padding=0, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.conv = pnn.Conv2D(in_ch, out_ch, k, stride=stride,
                               padding=padding, bias_attr=False,
                               generator=generator, device=device, dtype=dtype)
        self.bn = pnn.BatchNorm2D(out_ch, device=device, dtype=dtype)
        self.relu = pnn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))
