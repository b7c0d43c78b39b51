"""Convolution functionals (↔ paddle_tpu/nn/functional/conv.py).

The reference lowers every conv to `lax.conv_general_dilated` outside any
Pallas body, so no TPU kernel stands behind it: here a conv is
`torch.nn.functional.conv{1,2,3}d` (cuDNN on the card), as a plain matmul
is `torch.matmul`.

Paddle's forms are kept: the weight is [out, in / groups, *k] in both
packages; `data_format` "NC*" (channels first) or "N*C" (channels last,
moved to channels first around the call); `padding` as an int, one int a
dim, a flat [lo, hi] pair a dim, the nested form that names the batch and
channel dims too (pairs a dim in the layout's order), "SAME" or "VALID".
"SAME" pads as XLA does, the odd row at the high end; torch's
padding="same" takes no stride above 1, so every asymmetric padding is an
explicit zero pad here. A float16 conv runs in float32 and rounds once,
as the reference's (:74-75); the bias is added after the conv, in its
output dtype (:84-88). Inputs are cast for AMP as the ops "conv1d",
"conv2d" and "conv3d" (white list).

The transposed convs are not ported: they raise, naming ROADMAP queue A
item 8.
"""

from __future__ import annotations

import numbers

import torch

from ... import amp

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose", "conv_pads", "pad_input",
           "padding_spec"]

_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}


def _tuple(v, n):
    if isinstance(v, numbers.Integral):
        return (int(v),) * n
    return tuple(int(x) for x in v)


def _is_int(v):
    return isinstance(v, numbers.Integral)


def padding_spec(padding, n, channels_last=False):
    """Paddle's padding forms -> "SAME", "VALID" or [(lo, hi)] * n."""
    if isinstance(padding, str):
        spec = padding.upper()
        if spec not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        return spec
    if _is_int(padding):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if all(_is_int(p) for p in padding):
        if len(padding) == n:
            return [(int(p), int(p)) for p in padding]
        if len(padding) == 2 * n:
            return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                    for i in range(n)]
    elif len(padding) == n + 2 and all(len(p) == 2 for p in padding):
        # the batch and channel dims name no padding; the spatial dims are
        # the layout's
        spatial = padding[1:-1] if channels_last else padding[2:]
        return [(int(p[0]), int(p[1])) for p in spatial]
    raise ValueError(f"unsupported padding spec {padding!r}")


def conv_pads(spec, sizes, kernel, stride, dilation):
    """[(lo, hi)] a spatial dim of a padding spec: "SAME" as XLA pads
    (out = ceil(in / stride), the odd row at the high end), "VALID" none."""
    if spec == "VALID":
        return [(0, 0)] * len(sizes)
    if spec != "SAME":
        return list(spec)
    pads = []
    for size, k, s, d in zip(sizes, kernel, stride, dilation):
        out = -(-size // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_input(x, pads, value=0.0):
    """x [N, C, *spatial] with `pads` [(lo, hi)] a spatial dim applied as an
    explicit pad of `value` (torch.nn.functional.pad orders the last dim
    first)."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return torch.nn.functional.pad(x, flat, value=value)


def _conv(x, weight, bias, stride, padding, dilation, groups, n, data_format):
    channels_last = not data_format.startswith("NC")
    x, weight, bias = amp.cast_inputs(f"conv{n}d", x, weight, bias)
    out_dtype = torch.promote_types(x.dtype, weight.dtype)
    cdt = torch.float32 if out_dtype == torch.float16 else out_dtype
    a = x.movedim(-1, 1) if channels_last else x
    strides, dil = _tuple(stride, n), _tuple(dilation, n)
    spec = padding_spec(padding, n, channels_last)
    pads = conv_pads(spec, a.shape[2:], weight.shape[2:], strides, dil)
    if all(lo == hi for lo, hi in pads):
        torch_pad = tuple(lo for lo, _ in pads)
    else:
        a, torch_pad = pad_input(a, pads), 0
    out = _CONV[n](a.to(cdt), weight.to(cdt), None, strides, torch_pad, dil,
                   int(groups)).to(out_dtype)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out.movedim(1, -1) if channels_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def _transpose_unported(*args, **kwargs):
    raise NotImplementedError(
        "the transposed convolutions are ported with ROADMAP queue A item 8")


conv1d_transpose = conv2d_transpose = conv3d_transpose = _transpose_unported
