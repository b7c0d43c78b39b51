"""Fused LayerNorm / RMSNorm forward (↔ paddle_tpu/ops/pallas/fused_norm.py).

`layer_norm_fwd` and `rms_norm_fwd` normalize over the last axis with f32
statistics and an optional weight/bias [N]. On a CUDA tensor they launch
the kernel of `csrc/fused_norm.cu` (one block per row, the row read from HBM
once); on a CPU tensor they run `norm_fwd_plain`, the same arithmetic in
plain PyTorch. `LAUNCHES` counts kernel launches.

The backward kernel (`fused_norm.py:196`) comes with the training slice.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["LAUNCHES", "layer_norm_fwd", "rms_norm_fwd", "norm_fwd",
           "norm_fwd_plain"]

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

_KINDS = ("ln", "rms")


def norm_fwd_plain(x2, weight, bias, kind, eps):
    """Plain PyTorch version of the kernel on x2 [R, N]: returns
    (out [R, N] in x2's dtype, rstd [R] f32, mean [R] f32 or None). LayerNorm
    uses the two-pass centred variance, as the Pallas kernel does."""
    x = x2.float()
    inv_n = 1.0 / x.shape[-1]
    if kind == "ln":
        mean = x.sum(-1, keepdim=True) * inv_n
        c = x - mean
    else:
        mean, c = None, x
    rstd = torch.rsqrt((c * c).sum(-1, keepdim=True) * inv_n + eps)
    out = c * rstd
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return (out.to(x2.dtype), rstd[:, 0],
            None if mean is None else mean[:, 0])


def _check(x2, weight, bias):
    if x2.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"fused norm: unsupported dtype {x2.dtype}")
    n = x2.shape[-1]
    for name, v in (("weight", weight), ("bias", bias)):
        if v is None:
            continue
        if v.shape != (n,):
            raise ValueError(f"fused norm: {name} shape {tuple(v.shape)} != ({n},)")
        if v.device != x2.device:
            raise ValueError(f"fused norm: {name} on {v.device}, x on {x2.device}")
        if v.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise TypeError(f"fused norm: unsupported {name} dtype {v.dtype}")
    if weight is not None and bias is not None and weight.dtype != bias.dtype:
        raise TypeError("fused norm: weight and bias dtypes differ "
                        f"({weight.dtype} vs {bias.dtype})")


def norm_fwd(x2, weight, bias, kind, eps):
    """x2 [R, N] -> (out, rstd [R], mean [R] or None). CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    global LAUNCHES
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}")
    if x2.dim() != 2:
        raise ValueError(f"fused norm wants a 2-D [rows, N] view, got {x2.dim()}-D")
    _check(x2, weight, bias)
    if x2.device.type == "cpu":
        return norm_fwd_plain(x2, weight, bias, kind, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"fused norm: unsupported device {x2.device}")
    for v in (x2, weight, bias):
        if v is not None and not v.is_contiguous():
            raise ValueError("fused norm: inputs must be contiguous")
    r, n = x2.shape
    out = torch.empty_like(x2)
    rstd = torch.empty(r, device=x2.device, dtype=torch.float32)
    mean = (torch.empty(r, device=x2.device, dtype=torch.float32)
            if kind == "ln" else None)
    if r == 0:
        return out, rstd, mean
    lib = _build.load_library()
    wb = weight if weight is not None else bias
    w_code = _build.DTYPE_CODES[str(wb.dtype)] if wb is not None else 0
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = lib.ptt_norm_fwd(
        x2.data_ptr(),
        None if weight is None else weight.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(), rstd.data_ptr(),
        None if mean is None else mean.data_ptr(),
        r, n, float(eps), _build.DTYPE_CODES[str(x2.dtype)], w_code,
        1 if kind == "ln" else 0, stream)
    _build.check(err, "ptt_norm_fwd")
    LAUNCHES += 1
    return out, rstd, mean


def layer_norm_fwd(x, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the last axis of x [..., N] (two-pass centred variance,
    f32 stats), optional weight/bias [N]; returns x's shape and dtype."""
    out, _, _ = norm_fwd(x.reshape(-1, x.shape[-1]), weight, bias, "ln",
                         float(epsilon))
    return out.reshape(x.shape)


def rms_norm_fwd(x, weight=None, epsilon=1e-6, bias=None):
    """RMSNorm over the last axis of x [..., N] (f32 stats), optional
    weight/bias [N]; returns x's shape and dtype."""
    out, _, _ = norm_fwd(x.reshape(-1, x.shape[-1]), weight, bias, "rms",
                         float(epsilon))
    return out.reshape(x.shape)
