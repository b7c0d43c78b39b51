"""Fused LayerNorm / RMSNorm (↔ paddle_tpu/ops/pallas/fused_norm.py).

`layer_norm_fwd` and `rms_norm_fwd` normalize over the last axis with f32
statistics and an optional weight/bias [N], differentiably: they go through
`FusedNorm`, a `torch.autograd.Function` (the JAX package's custom VJP).
Its forward is `norm_fwd`, its backward `norm_bwd_dx` for dx plus torch
reductions in f32 for dweight and dbias (jnp reductions in the JAX package,
`fused_norm.py:288-295`). On a CUDA tensor `norm_fwd` and `norm_bwd_dx`
launch the kernels of `csrc/fused_norm.cu`; on a CPU tensor they run
`norm_fwd_plain` and `norm_bwd_dx_plain`, the same arithmetic in plain
PyTorch. Both kernels hold a row in registers in a group of threads, 16
elements a thread, the row read from HBM once by 16-byte loads; rows wider
than 8192 elements take one block a row. dx runs the launch `dx_plan`
gives: the route (`rows`, `scalar` where a pointer is off the 16-byte line
or N is not a multiple of 16 // itemsize, `wide` past 8192), the group's
threads and the rows a CTA; a row's two sums are reduced in one exchange
and the next row's loads are issued before it. `LAUNCHES` counts forward
kernel launches and `DX_LAUNCHES` dx kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from ..framework.core import report_op

__all__ = ["DX_LAUNCHES", "DxPlan", "FusedNorm", "LAUNCHES", "dx_plan",
           "layer_norm_fwd", "norm_bwd_dx", "norm_bwd_dx_plain", "norm_fwd",
           "norm_fwd_plain", "rms_norm_fwd"]

# kernel launches since import (or since a caller reset them)
LAUNCHES = 0     # forward
DX_LAUNCHES = 0  # dx

_KINDS = ("ln", "rms")

# The dx plan's sizes (csrc/fused_norm.cu), for an H100 (132 SMs).
ROW_ELEMS = 16         # elements of a row a thread holds (kDxElems)
ROW_MAX_THREADS = 512  # threads of a row group at most: N <= 8192
ROW_CTA = 256          # threads of a CTA that holds several row groups
SMS = 132              # fewer rows than SMs: one row a CTA
_ROUTES = {"rows": 0, "scalar": 1, "wide": 2}


class DxPlan(NamedTuple):
    """The dx kernel's launch: `route` "rows" (16-byte loads and stores),
    "scalar" (element by element, the same kernel) or "wide" (one block a
    row); `gsize` threads a row (the block's threads when wide); `elems`
    elements of a row a thread holds (wide: visits); `rows_per_cta`."""
    route: str
    gsize: int
    elems: int
    rows_per_cta: int


def dx_plan(rows, n, itemsize, aligned=True):
    """The launch of the dx kernel on [rows, n] rows of `itemsize` bytes;
    `aligned` says that x, dy and dx lie on the 16-byte line. A group of
    `gsize` threads (ceil(n / 16) rounded up to a warp) holds a row, thread
    t the columns [(t + j gsize) V, (t + j gsize) V + V) for j < 16 / V, V =
    16 // itemsize; a CTA of 256 threads holds several groups unless a group
    fills it or the rows are no more than the SMs. Rows wider than 512
    threads can hold (n > 8192) take one block of ceil(n / 4) threads (a warp
    at least, 1024 at most) a row."""
    gsize = (-(-n // ROW_ELEMS) + 31) // 32 * 32
    if gsize > ROW_MAX_THREADS:
        threads = min(1024, max(32, (-(-n // 4) + 31) // 32 * 32))
        return DxPlan("wide", threads, -(-n // threads), 1)
    route = "rows" if aligned and n % (16 // itemsize) == 0 else "scalar"
    per_cta = 1 if gsize >= ROW_CTA or rows <= SMS else ROW_CTA // gsize
    return DxPlan(route, gsize, ROW_ELEMS, per_cta)


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


def norm_bwd_dx_plain(x2, weight, dy2, rstd, mean, kind):
    """Plain PyTorch version of the dx kernel on x2, dy2 [R, N] with the
    forward's rstd (and mean) [R]: g = dy * w, x_hat = (x - mean) * rstd,
    dx = rstd * (g - mean(g) - x_hat * mean(g * x_hat)) for LayerNorm and
    rstd * (g - x_hat * mean(g * x_hat)) for RMSNorm, in f32; dx in x2's
    dtype."""
    x = x2.float()
    g = dy2.float()
    if weight is not None:
        g = g * weight.float()
    inv_n = 1.0 / x.shape[-1]
    r = rstd[:, None]
    if kind == "ln":
        xhat = (x - mean[:, None]) * r
        c1 = g.sum(-1, keepdim=True) * inv_n
    else:
        xhat = x * r
        c1 = 0.0
    c2 = (g * xhat).sum(-1, keepdim=True) * inv_n
    return (r * (g - c1 - xhat * c2)).to(x2.dtype)


def norm_bwd_dx(x2, weight, dy2, rstd, mean, kind):
    """dx [R, N] of the norm from x2, dy2 [R, N] and the forward's f32
    rstd (and mean). CPU tensors run the plain version; CUDA tensors
    launch the kernel."""
    global DX_LAUNCHES
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}")
    if dy2.shape != x2.shape or x2.dim() != 2:
        raise ValueError(f"fused norm dx: x {tuple(x2.shape)} and dy "
                         f"{tuple(dy2.shape)} must be one [rows, N] shape")
    _check(x2, weight, None)
    dy2 = dy2.to(x2.dtype)
    if x2.device.type == "cpu":
        return norm_bwd_dx_plain(x2, weight, dy2, rstd, mean, kind)
    if x2.device.type != "cuda":
        raise ValueError(f"fused norm dx: unsupported device {x2.device}")
    dy2 = dy2.contiguous()
    for v in (x2, weight, rstd, mean):
        if v is not None and not v.is_contiguous():
            raise ValueError("fused norm dx: inputs must be contiguous")
    r, n = x2.shape
    dx = torch.empty_like(x2)
    if r == 0 or n == 0:
        return dx
    plan = dx_plan(r, n, x2.element_size(),
                   all(t.data_ptr() % 16 == 0 for t in (x2, dy2, dx)))
    lib = _build.load_library()
    w_code = _build.DTYPE_CODES[str(weight.dtype)] if weight is not None else 0
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = lib.ptt_norm_bwd_dx(
        x2.data_ptr(), None if weight is None else weight.data_ptr(),
        dy2.data_ptr(), rstd.data_ptr(),
        None if mean is None else mean.data_ptr(), dx.data_ptr(), r, n,
        _build.DTYPE_CODES[str(x2.dtype)], w_code, 1 if kind == "ln" else 0,
        _ROUTES[plan.route], plan.gsize, plan.elems, plan.rows_per_cta,
        stream)
    _build.check(err, "ptt_norm_bwd_dx")
    DX_LAUNCHES += 1
    return dx


# the reference's op names of the two norms (amp.debugging reads them)
_OP_NAMES = {"ln": "layer_norm", "rms": "rms_norm"}


class FusedNorm(torch.autograd.Function):
    """The norm over the last axis with its gradient (↔ `_fused_norm`'s
    custom VJP). Saves x, weight, rstd and mean; the backward runs the dx
    kernel (its plain version on the CPU) and the dweight/dbias row
    reductions in f32."""

    @staticmethod
    def forward(ctx, x, weight, bias, kind, eps):
        x2 = x.reshape(-1, x.shape[-1])
        out, rstd, mean = norm_fwd(x2, weight, bias, kind, eps)
        ctx.save_for_backward(x2, weight, rstd, mean)
        ctx.kind = kind
        ctx.shape = x.shape
        ctx.bias_dtype = None if bias is None else bias.dtype
        return report_op(_OP_NAMES[kind], out.reshape(x.shape))

    @staticmethod
    def backward(ctx, dout):
        x2, weight, rstd, mean = ctx.saved_tensors
        dy2 = dout.reshape(x2.shape)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        if need_x:
            dx = norm_bwd_dx(x2, weight, dy2, rstd, mean,
                             ctx.kind).reshape(ctx.shape)
        if need_w:
            x32 = x2.float()
            if ctx.kind == "ln":
                x32 = x32 - mean[:, None]
            dw = (dy2.float() * (x32 * rstd[:, None])).sum(0).to(weight.dtype)
        if need_b:
            db = dy2.float().sum(0).to(ctx.bias_dtype)
        report_op(_OP_NAMES[ctx.kind] + "_grad", (dx, dw, db))
        return dx, dw, db, None, None


def layer_norm_fwd(x, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the last axis of x [..., N] (two-pass centred variance,
    f32 stats), optional weight/bias [N]; returns x's shape and dtype.
    Differentiable through `FusedNorm`."""
    return FusedNorm.apply(x, weight, bias, "ln", float(epsilon))


def rms_norm_fwd(x, weight=None, epsilon=1e-6, bias=None):
    """RMSNorm over the last axis of x [..., N] (f32 stats), optional
    weight/bias [N]; returns x's shape and dtype. Differentiable through
    `FusedNorm`."""
    return FusedNorm.apply(x, weight, bias, "rms", float(epsilon))
