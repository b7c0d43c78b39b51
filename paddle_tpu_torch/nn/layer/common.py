"""Linear, Embedding, Identity, Flatten, the dropout family, and the thin
layers over `nn.functional` (↔ paddle_tpu/nn/layer/common.py): Upsample,
UpsamplingBilinear2D / UpsamplingNearest2D, Pad1D/2D/3D, ZeroPad2D,
CosineSimilarity, Bilinear, Unfold, Fold, PixelShuffle, PixelUnshuffle and
ChannelShuffle.

Paddle's layout: `Linear.weight` is [in_features, out_features] and the
layer computes x @ W + b (`nn.functional.linear`, which casts for AMP).
The positional parameters are the reference's, up to `name`; the port's
own (`weight_std`, `generator`, `device`, `dtype`) are keyword-only.
Parameters go through `Layer.create_parameter`, so a `weight_attr` /
`bias_attr` (`ParamAttr`) sets their initializer, learning rate,
regularizer, trainability and clipping, and False drops them. Without an
initializer a Linear weight is Xavier-uniform, an Embedding N(0, 1) (the
reference's defaults, :122) and a bias zero; `weight_std` makes the
default N(0, weight_std) (the GPT models' `_init_attr`). Random draws come
from the `generator` given, else from the port's generator of the device.

`Embedding(padding_idx=)` zeroes that row at build and masks it in the
lookup, so no gradient reaches it (a negative index counts from the end,
as the reference's); `sparse=True` is accepted and gives the dense
gradient, the only kind a torch optimizer step here reads.
"""

from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["AlphaDropout", "Bilinear", "ChannelShuffle", "CosineSimilarity",
           "Dropout", "Dropout2D", "Dropout3D", "Embedding", "Flatten",
           "Fold", "Identity", "Linear", "Pad1D", "Pad2D", "Pad3D",
           "PixelShuffle", "PixelUnshuffle", "Unfold", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "ZeroPad2D"]


def std_default(weight_std, default):
    """The default initializer of a weight: N(0, weight_std) when the
    port's `weight_std` is given, else `default`."""
    return I.Normal(0.0, weight_std) if weight_std is not None else default


class Linear(Layer):
    """y = xW + b, weight stored [in_features, out_features]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, weight_std=None,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.weight = self.create_parameter(
            [in_features, out_features], weight_attr,
            default_initializer=std_default(weight_std, None), **kw)
        self.bias = self.create_parameter([out_features], bias_attr,
                                          is_bias=True, **kw)

    # set by nn.quant.quantize_for_inference: the weight-only algorithm
    _weight_only = None

    def forward(self, x):
        if self._weight_only is not None:
            from ..quant import weight_only_linear

            return weight_only_linear(
                x, self.weight_quant, self.bias, self.weight_scale,
                "int4" if self._weight_only == "weight_only_int4" else "int8")
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self._in_features}, out_features={self._out_features}"


class Embedding(Layer):
    """Token lookup table [num_embeddings, embedding_dim] (module
    docstring)."""

    # the weight's initializer when no weight_attr is given
    _default_init = I.Normal(0.0, 1.0)

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *,
                 weight_std=None, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (None if padding_idx is None else padding_idx
                             if padding_idx >= 0
                             else num_embeddings + padding_idx)
        self._sparse = sparse
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], weight_attr,
            default_initializer=std_default(
                weight_std, self._default_init if weight_attr is None
                else None),
            dtype=dtype, generator=generator, device=device)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)

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


class Upsample(Layer):
    """`nn.functional.interpolate` with the layer's settings."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True,
                         data_format=data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False,
                         data_format=data_format)


class _PadN(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadN):
    pass


class Pad3D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(_PadN):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Bilinear(Layer):
    """out[b, o] = x1[b] W[o] x2[b] + bias[o]: weight [out, in1, in2]
    (Xavier-uniform by default), bias [1, out]."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], weight_attr, **kw)
        self.bias = self.create_parameter([1, out_features], bias_attr,
                                          is_bias=True, **kw)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor, self.data_format = downscale_factor, data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)
