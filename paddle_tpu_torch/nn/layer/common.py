"""Linear, Embedding, Identity, Flatten and Dropout (↔
paddle_tpu/nn/layer/common.py).

Paddle's layout: `Linear.weight` is [in_features, out_features] and the
layer computes x @ W + b (`nn.functional.linear`, which casts for AMP).
Parameters are created on an explicit device and
dtype and initialised from an explicit `torch.Generator`:
`weight_std=None` keeps Paddle's default initializer (Xavier-uniform for a
Linear weight, N(0, 1) for an Embedding), a float draws N(0, weight_std)
(the GPT models' `_init_attr`). Biases start at zero.
"""

from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from .layers import Layer
from ...framework.core import Parameter

__all__ = ["AlphaDropout", "Dropout", "Dropout2D", "Dropout3D", "Embedding",
           "Flatten", "Identity", "Linear", "init_weight"]


def init_weight(w, std, default, generator):
    """Fill `w` in place: N(0, std) when `std` is given, else `default`
    ("xavier_uniform" | "xavier_normal" | "normal"), drawing from
    `generator` (None = torch's default generator)."""
    with torch.no_grad():
        if std is not None:
            w.normal_(0.0, std, generator=generator)
        elif default == "xavier_uniform":
            nn.init.xavier_uniform_(w, generator=generator)
        elif default == "xavier_normal":
            nn.init.xavier_normal_(w, generator=generator)
        elif default == "normal":
            w.normal_(0.0, 1.0, generator=generator)
        else:
            raise ValueError(f"unknown initializer {default!r}")
    return w


class Linear(Layer):
    """y = xW + b, weight stored [in_features, out_features]."""

    def __init__(self, in_features, out_features, bias_attr=None, *,
                 weight_std=None, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self._in_features = in_features
        self._out_features = out_features
        self.weight = Parameter(init_weight(
            torch.empty(in_features, out_features, device=dev, dtype=dtype),
            weight_std, "xavier_uniform", generator))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = Parameter(
                torch.zeros(out_features, device=dev, dtype=dtype))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self._in_features}, out_features={self._out_features}"


class Embedding(Layer):
    """Token lookup table [num_embeddings, embedding_dim]."""

    def __init__(self, num_embeddings, embedding_dim, *, weight_std=None,
                 generator=None, device=None, dtype=torch.float32,
                 default_init="normal"):
        super().__init__()
        dev = resolve_device(device)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.weight = Parameter(init_weight(
            torch.empty(num_embeddings, embedding_dim, device=dev, dtype=dtype),
            weight_std, default_init, generator))

    def forward(self, x):
        return F.embedding(x, self.weight)

    def extra_repr(self):
        return f"num_embeddings={self._num_embeddings}, embedding_dim={self._embedding_dim}"


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Flatten(Layer):
    """Dims start_axis..stop_axis flattened into one (Paddle's defaults
    1 and -1)."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        if x.dim() == 0:
            return x.reshape(1)
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Dropout(Layer):
    """`nn.functional.dropout` in the layer's mode: the identity at p = 0
    or in eval mode, a mask from the port's generators in training."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"


class Dropout2D(Layer):
    """`nn.functional.dropout2d`: whole channels of an NCHW (or NHWC)
    input dropped in training."""

    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    """`nn.functional.dropout3d`: whole channels of an NCDHW (or NDHWC)
    input dropped in training."""

    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    """`nn.functional.alpha_dropout` in training, the identity in eval."""

    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)
