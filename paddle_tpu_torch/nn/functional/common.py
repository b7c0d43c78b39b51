"""Common functionals (↔ paddle_tpu/nn/functional/common.py): `linear`,
`embedding`, the dropout family (`dropout`, `dropout2d`, `dropout3d`,
`alpha_dropout`), `one_hot`, `label_smooth`, `pad`, `interpolate` /
`upsample`, `unfold`, `fold`, `cosine_similarity`, `pixel_shuffle`,
`pixel_unshuffle`, `channel_shuffle` and `bilinear`, each casting its
inputs for AMP at the op boundary under the JAX package's op name; all
are torch ops (the reference's are jnp, with no Pallas kernel). The
dropout masks are drawn from the port's generators (`framework.random`),
so the same generator state gives the same mask; they are not the JAX
package's masks (another RNG).

`interpolate` follows Paddle's coordinate rules, which the reference's
`jax.image.resize` does not (ROADMAP queue C): "nearest" takes source
index floor(i * in / out), or floor(i * (in - 1) / (out - 1) + 1/2)
under `align_corners`; the linear modes ("linear", "bilinear", "trilinear")
take source coordinate i * (in - 1) / (out - 1) under `align_corners`,
else (i + 1/2) * in / out - 1/2 clamped at 0 (`align_mode` 0) or
i * in / out (`align_mode` 1), each axis in turn; "bicubic" is torch's
(a = -0.75, Paddle's), "area" the adaptive average pool. The output size
is `size`, else int(in * scale_factor). Channels-last `data_format`s move
the channels to axis 1 and back."""

from __future__ import annotations

import torch

from ... import amp
from ...framework.core import reported
from ...framework import random

__all__ = ["alpha_dropout", "bilinear", "channel_shuffle",
           "cosine_similarity", "dropout", "dropout2d", "dropout3d",
           "embedding", "fold", "interpolate", "label_smooth", "linear",
           "one_hot", "pad", "pixel_shuffle", "pixel_unshuffle", "unfold",
           "upsample"]


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
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Row lookup `weight[x]` for integer ids x. Rows of ids equal to
    `padding_idx` come out zero, so no gradient reaches that row of the
    weight (the reference's masked lookup). `sparse` is accepted; the
    gradient is dense either way."""
    (weight,) = amp.cast_inputs("embedding", weight)
    ids = x.long()
    out = weight[ids]
    if padding_idx is not None:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return out


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


@reported("one_hot")
def one_hot(x, num_classes, name=None):
    """f32 [..., num_classes] rows, 1 at each id (none for an id outside
    [0, num_classes), as the reference's `jax.nn.one_hot`)."""
    classes = torch.arange(int(num_classes), device=x.device)
    return (x.long()[..., None] == classes).to(torch.float32)


@reported("label_smooth")
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1 - epsilon) * label + epsilon * prior_dist (uniform 1 / K when
    None)."""
    label, prior_dist = amp.cast_inputs("label_smooth", label, prior_dist)
    if prior_dist is None:
        return (1 - epsilon) * label + epsilon / label.shape[-1]
    return (1 - epsilon) * label + epsilon * prior_dist


@reported("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):  # noqa: A002
    """`paddle.pad` (widths for every dim, or pairs for the spatial dims of
    `data_format`)."""
    from ...tensor.manipulation import pad_values

    (x,) = amp.cast_inputs("pad", x)
    return pad_values(x, pad, mode, value, data_format)


def _src_coords(n_in, n_out, mode, align_corners, align_mode, device):
    """The source coordinate of each of `n_out` output positions along an
    axis of `n_in` (module docstring), f32."""
    i = torch.arange(n_out, device=device, dtype=torch.float32)
    if align_corners:
        return i * ((n_in - 1) / (n_out - 1) if n_out > 1 else 0.0)
    ratio = n_in / n_out
    if mode == "nearest" or align_mode == 1:
        return i * ratio
    return ((i + 0.5) * ratio - 0.5).clamp(min=0.0)


def _linear_axis(x, axis, n_out, align_corners, align_mode):
    n_in = x.shape[axis]
    src = _src_coords(n_in, n_out, "linear", align_corners, align_mode,
                      x.device)
    lo = src.floor().long().clamp(max=n_in - 1)
    hi = (lo + 1).clamp(max=n_in - 1)
    shape = [1] * x.dim()
    shape[axis] = n_out
    w = (src - lo).to(x.dtype).reshape(shape)
    return (x.index_select(axis, lo) * (1 - w)
            + x.index_select(axis, hi) * w)


@reported("interpolate")
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes of x (module docstring)."""
    (x,) = amp.cast_inputs("interpolate", x)
    channels_last = not data_format.startswith("NC")
    if channels_last:
        x = x.movedim(-1, 1)
    n_sp = x.dim() - 2
    if size is not None:
        sizes = [int(s) for s in (size if isinstance(size, (list, tuple))
                                  else [size] * n_sp)]
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * n_sp)
        sizes = [int(x.shape[2 + k] * f) for k, f in enumerate(sf)]
    if mode == "nearest":
        out = x
        for k, n_out in enumerate(sizes):
            n_in = x.shape[2 + k]
            src = _src_coords(n_in, n_out, mode, align_corners, align_mode,
                              x.device)
            idx = (src + 0.5 if align_corners else src).floor().long()
            out = out.index_select(2 + k, idx.clamp(max=n_in - 1))
    elif mode in ("linear", "bilinear", "trilinear"):
        out = x
        for k, n_out in enumerate(sizes):
            out = _linear_axis(out, 2 + k, n_out, align_corners, align_mode)
    elif mode == "bicubic":
        out = torch.nn.functional.interpolate(
            x, size=sizes, mode="bicubic", align_corners=align_corners)
    elif mode == "area":
        out = torch.nn.functional.adaptive_avg_pool2d(x, sizes) \
            if n_sp == 2 else getattr(
                torch.nn.functional, f"adaptive_avg_pool{n_sp}d")(x, sizes)
    else:
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    return out.movedim(1, -1) if channels_last else out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@reported("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [N, C, H, W] -> [N, C * kh * kw, L], channel-major.
    `paddings` is one int, (h, w), or (top, left, bottom, right)."""
    (x,) = amp.cast_inputs("unfold", x)
    if isinstance(paddings, int):
        pt = pb = pl = pr = paddings
    elif len(paddings) == 2:
        pt = pb = paddings[0]
        pl = pr = paddings[1]
    else:
        pt, pl, pb, pr = paddings
    x = torch.nn.functional.pad(x, (pl, pr, pt, pb))
    return torch.nn.functional.unfold(x, _pair(kernel_sizes),
                                      dilation=_pair(dilations),
                                      stride=_pair(strides))


@reported("fold")
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the overlapping patches summed: [N, C * kh * kw, L] -> [N,
    C, H, W]; one padding (the first of a list) on every side, as the
    reference."""
    (x,) = amp.cast_inputs("fold", x)
    p = paddings if isinstance(paddings, int) else paddings[0]
    return torch.nn.functional.fold(x, _pair(output_sizes),
                                    _pair(kernel_sizes),
                                    dilation=_pair(dilations), padding=p,
                                    stride=_pair(strides))


@reported("cosine_similarity")
def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    """sum(x1 * x2) / max(|x1| |x2|, eps) along `axis`."""
    a, b = amp.cast_inputs("cosine_similarity", x1, x2)
    num = (a * b).sum(dim=axis)
    den = torch.linalg.vector_norm(a, dim=axis) * torch.linalg.vector_norm(
        b, dim=axis)
    return num / den.clamp(min=eps)


def _nchw(x, data_format, fn):
    if data_format == "NCHW":
        return fn(x)
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@reported("pixel_shuffle")
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    (x,) = amp.cast_inputs("pixel_shuffle", x)
    return _nchw(x, data_format, lambda a: torch.nn.functional.pixel_shuffle(
        a, int(upscale_factor)))


@reported("pixel_unshuffle")
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    (x,) = amp.cast_inputs("pixel_unshuffle", x)
    return _nchw(x, data_format, lambda a: torch.nn.functional.pixel_unshuffle(
        a, int(downscale_factor)))


@reported("channel_shuffle")
def channel_shuffle(x, groups, data_format="NCHW", name=None):
    (x,) = amp.cast_inputs("channel_shuffle", x)
    g = int(groups)

    def fn(a):
        n, c, h, w = a.shape
        return a.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(
            n, c, h, w)

    return _nchw(x, data_format, fn)


@reported("bilinear")
def bilinear(x1, x2, weight, bias=None, name=None):
    """out[b, o] = x1[b] W[o] x2[b] (+ bias), W [out, in1, in2]."""
    a, b, w, bias = amp.cast_inputs("bilinear", x1, x2, weight, bias)
    out = torch.einsum("bi,oij,bj->bo", a, w, b)
    return out if bias is None else out + bias
