"""Weight-only and LLM.int8 quantized inference (↔
paddle_tpu/nn/quant/__init__.py).

`weight_quantize` turns an [in, out] weight into the reference's
transposed layout: int8 [out, in] (int4: [out, in / 2], two nibbles a
byte, the even input index in the low nibble) with an f32 scale per
output channel [out], or per group of 64 or 128 inputs [out, in /
group]; the values are round-half-to-even of w / max(scale, 1e-8),
clipped to [-128, 127] (int4: [-8, 7]), scale = max |w| times the f32
reciprocal of 127 (int4: 7), so the bits equal the reference's. `weight_dequantize` inverts it into
[in, out]. `weight_only_linear` computes x @ dequant(W)^T + bias, and
`llm_int8_linear` the LLM.int8() product: input columns whose largest
|x| exceeds `threshold` go through in float, the rest as int8 rows
quantized by their own abs-max. These are plain torch ops, as the
reference's inline dequantization is jnp: a hand-written GEMV for them is
queue B work.

`quantize_for_inference(model, algo, group_size, min_features)` converts
in place every `nn.Linear` under `model` (the single-device
`ColumnParallelLinear` / `RowParallelLinear` of the decoder stacks
included; a layer cut over mp keeps its float weight, as the reference
skips `is_mp` layers) whose dims are both at least `min_features` (and
that `algo` and `group_size` can take): it loses its float `weight`
parameter (the attribute reads None) and gains the buffers
`weight_quant` and `weight_scale`, and its forward becomes
`weight_only_linear`. The state_dict names are the reference's, so
`convert.load_paddle_tpu_state` carries a converted model across bit for
bit. A model that `quantization.ptq_convert_for_serving` (the engines'
`serve_w8`) has converted is refused, and that converter refuses a model
converted here: the two formats hold different layouts under the same
buffer names.
"""

from __future__ import annotations

import torch

from ... import amp
from ...framework.core import Tensor, report_op

__all__ = ["quantize_for_inference", "weight_quantize", "weight_dequantize",
           "weight_only_linear", "llm_int8_linear"]

_ALGOS = ("weight_only_int8", "weight_only_int4", "llm.int8")


def _t(x):
    return x._value if isinstance(x, Tensor) else x


@torch.no_grad()
def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """(int8 quantized [out, in] or packed int4 [out, in / 2], f32 scale
    [out] or [out, in / group_size]) of the [in, out] weight x (module
    docstring)."""
    if algo not in _ALGOS:
        raise ValueError(f"unknown algo {algo!r}")
    if group_size not in (-1, 64, 128):
        raise ValueError("group_size must be -1, 64 or 128")
    int4 = algo == "weight_only_int4"
    x = _t(x)
    in_features = int(x.shape[0])
    if int4 and in_features % 2:
        raise ValueError(
            f"weight_only_int4 packs two values per byte; in_features "
            f"must be even, got {in_features}")
    if group_size > 0 and in_features % group_size:
        raise ValueError(f"in_features {in_features} not divisible by "
                         f"group_size {group_size}")
    bound = 7.0 if int4 else 127.0
    wt = x.detach().float().T
    O, I = wt.shape
    g = wt.reshape(O, 1 if group_size == -1 else I // group_size, -1)
    # max |w| times the f32 reciprocal of the bound, as the reference's
    # compiled division by a constant computes it (bit for bit), and the
    # same on every device
    scale = g.abs().amax(dim=2, keepdim=True) * (1.0 / bound)
    q = torch.clamp(torch.round(g / scale.clamp(min=1e-8)), -bound - 1,
                    bound).reshape(O, I).to(torch.int8)
    scale = scale[:, 0, 0] if group_size == -1 else scale[:, :, 0]
    if int4:
        q32 = q.to(torch.int32) & 0xF
        q = (q32[:, 0::2] | (q32[:, 1::2] << 4)).to(torch.uint8).view(
            torch.int8)
    return report_op("weight_quantize", (q.contiguous(), scale.contiguous()))


def _unpack_int4(q):
    """[out, in / 2] packed nibbles -> int32 [out, in], sign-extended."""
    q32 = q.to(torch.int32)
    lo = ((q32 & 0xF) ^ 8) - 8
    hi = q32 >> 4
    return torch.stack([lo, hi], dim=-1).reshape(q.shape[0], -1)


def _dequant(qw, scale, algo, out_dtype):
    """f32 dequantized [out, in] of (qw, scale), cast to out_dtype."""
    w = _unpack_int4(qw) if algo == "weight_only_int4" else qw
    wf = w.float()
    scale = scale.float()
    if scale.dim() == 1:
        wf = wf * scale[:, None]
    else:
        O, I = wf.shape
        wf = (wf.reshape(O, scale.shape[1], -1) * scale[:, :, None]).reshape(
            O, I)
    return wf.to(out_dtype)


def weight_dequantize(x, scale, algo="weight_only_int8", out_dtype="float16"):
    """The [in, out] weight of `weight_quantize`'s (x, scale)."""
    from ...framework.dtype import convert_dtype

    return _dequant(_t(x), _t(scale), algo, convert_dtype(out_dtype)).T


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """x @ dequant(weight)^T (+ bias), int8 or packed int4 weights, the
    scale's shape telling per-channel from grouped; in x's dtype."""
    x, bias = amp.cast_inputs("weight_only_linear", x, bias)
    algo = "weight_only_int4" if weight_dtype == "int4" else "weight_only_int8"
    out = x @ _dequant(weight, weight_scale, algo, x.dtype).T
    if bias is not None:
        out = out + bias
    return report_op("weight_only_linear", out)


def llm_int8_linear(x, weight, bias=None, weight_scale=None, threshold=6.0):
    """LLM.int8() (arXiv:2208.07339, module docstring), in f32, returned in
    x's dtype."""
    x, bias = amp.cast_inputs("llm_int8_linear", x, bias)
    xf = x.float()
    outlier = xf.abs().amax(dim=tuple(range(xf.dim() - 1))) > threshold
    wf = weight.float() * weight_scale.float()[:, None]
    zero = torch.zeros((), device=xf.device)
    xm = torch.where(outlier, zero, xf)
    xs = xm.abs().amax(dim=-1, keepdim=True) / 127.0
    xq = torch.clamp(torch.round(xm / xs.clamp(min=1e-8)), -128, 127)
    main = (xq @ torch.where(outlier[None, :], zero, wf).T) * xs
    outl = torch.where(outlier, xf, zero) @ torch.where(
        outlier[None, :], wf, zero).T
    out = (main + outl).to(x.dtype)
    if bias is not None:
        out = out + bias
    return report_op("llm_int8_linear", out)


def quantize_for_inference(layer, algo="weight_only_int8", group_size=-1,
                           min_features=64):
    """Convert `layer`'s eligible Linears in place (module docstring);
    returns how many were converted."""
    from ...quantization import QuantizedLinear
    from ..layer.common import Linear

    if algo not in _ALGOS:
        raise ValueError(f"unknown algo {algo!r}")
    subs = list(layer.modules())
    if any(isinstance(m, QuantizedLinear) for m in subs):
        raise ValueError(
            "quantize_for_inference: the model was converted for serve_w8 "
            "(quantization.QuantizedLinear) already; convert a float model")
    n = 0
    for sub in subs:
        if (not isinstance(sub, Linear) or sub.weight is None
                or getattr(sub, "mp_group", None) is not None):
            continue
        in_f, out_f = (int(s) for s in sub.weight.shape)
        if (in_f < min_features or out_f < min_features
                or (algo == "weight_only_int4" and in_f % 2)
                or (group_size > 0 and in_f % group_size)):
            continue
        q, s = weight_quantize(sub.weight, algo=algo, group_size=group_size)
        del sub._parameters["weight"]
        sub.weight = None
        sub.register_buffer("weight_quant", q)
        sub.register_buffer("weight_scale", s)
        sub._weight_only = algo
        n += 1
    return n
