"""Weight-only int8 quantization for serving (↔ paddle_tpu/quantization).

`quantize_weight` is the per-channel symmetric abs-max quantizer,
`QuantizedLinear` a Linear holding int8 weights and f32 per-output-channel
scales, and `ptq_convert_for_serving` the convert pass the serving engines
run under `serve_w8=True`. Buffer names (`weight_quant`, `weight_scale`) and
shapes equal the JAX package's, so `convert.load_paddle_tpu_state` moves a
converted JAX model over as it is. PTQ calibration, QAT and `fake_quant`
are not ported yet (ROADMAP queue A item 5).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import amp
from ..nn import Linear

__all__ = ["QuantizedLinear", "ptq_convert_for_serving", "quantize_weight"]


def quantize_weight(w, bits=8, axis=0):
    """Per-channel symmetric abs-max quantization along `axis` (↔ JAX
    :36): the scale is abs-max / qmax in the weight's own dtype (1 where a
    channel is all zeros), the values round half to even and clip to
    [-qmax - 1, qmax]. Returns (int8 values, f32 scale with the reduced
    axes kept as size 1)."""
    qmax = 2 ** (bits - 1) - 1
    reduce = tuple(i for i in range(w.dim()) if i != axis)
    scale = w.abs().amax(dim=reduce, keepdim=True) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale.float()


class QuantizedLinear(nn.Module):
    """An int8-weight Linear (↔ JAX :99): the [in, out] weight as int8
    `weight_quant` with one f32 `weight_scale` per output column, and the
    Linear's bias. forward computes x @ (w_q * scale) + bias in x's dtype,
    as the JAX package does: a plain product (no Pallas kernel there
    either), so it is `torch.matmul`."""

    def __init__(self, linear: Linear, bits=8):
        super().__init__()
        with torch.no_grad():
            qw, scale = quantize_weight(linear.weight.detach(), bits=bits,
                                        axis=1)
        self.register_buffer("weight_quant", qw)
        self.register_buffer("weight_scale", scale)
        self.bias = linear.bias
        self.bits = bits

    def forward(self, x):
        x, sc, b = amp.cast_inputs("quantized_linear", x, self.weight_scale,
                                   self.bias)
        out = torch.matmul(x, self.weight_quant.to(x.dtype) * sc.to(x.dtype))
        if b is not None:
            out = out + b
        return out


def _swap_sublayer(root, name, new_layer):
    parent = root
    parts = name.split(".")
    for part in parts[:-1]:
        parent = getattr(parent, part)
    setattr(parent, parts[-1], new_layer)


def ptq_convert_for_serving(model, bits=8):
    """Weight-only int8 serving convert (↔ JAX :189): swap every Linear
    under `model` (the single-device `ColumnParallelLinear` and
    `RowParallelLinear` of the decoder stacks included) for a
    `QuantizedLinear`. Embeddings stay full precision, and so does the LM
    head: the tied head rides the embedding, and an untied `lm_head` is
    skipped by name. In place and idempotent (converted layers are
    skipped). Returns the number of layers converted."""
    n = 0
    for name, sub in list(model.named_modules()):
        # the single-device Column/RowParallelLinear subclass Linear
        if not name or not isinstance(sub, Linear):
            continue
        if name.split(".")[-1] == "lm_head":
            continue
        _swap_sublayer(model, name, QuantizedLinear(sub, bits=bits))
        n += 1
    return n
