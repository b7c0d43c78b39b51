"""Quantization (↔ paddle_tpu/quantization).

`quantize_weight` is the per-channel symmetric abs-max quantizer,
`QuantizedLinear` a Linear holding int8 weights and f32 per-output-channel
scales, and `ptq_convert_for_serving` the convert pass the serving engines
run under `serve_w8=True`. Buffer names (`weight_quant`, `weight_scale`) and
shapes equal the JAX package's, so `convert.load_paddle_tpu_state` moves a
converted JAX model over as it is.

`PTQ` hooks an `AbsMaxObserver` on the forward of each layer of the
`QuantConfig`'s types, calibration forwards feed it, and `convert` swaps
each observed layer for a `QuantizedLinear` that carries the calibrated
`activation_scale`. `QAT` fake-quantizes each such layer's weight for
every forward (`fake_quant`: the straight-through estimator), leaving the
stored weight as it is. The types default to `nn.Linear`, whose subclasses
here include the single-device `ColumnParallelLinear` and
`RowParallelLinear` of the decoder stacks; the JAX package's parallel
layers are no `nn.Linear`, so its PTQ and QAT leave a GPT's projections
alone (ROADMAP queue C).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import amp
from ..nn import Linear
from ..nn.layer.layers import Layer

__all__ = ["AbsMaxObserver", "PTQ", "QAT", "QuantConfig", "QuantizedLinear",
           "fake_quant", "ptq_convert_for_serving", "quantize_weight"]


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


class QuantizedLinear(Layer):
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
    skipped). A model that `nn.quant.quantize_for_inference` converted is
    refused (another layout under the same buffer names). Returns the
    number of layers converted."""
    if any(getattr(m, "_weight_only", None) for m in model.modules()):
        raise ValueError(
            "ptq_convert_for_serving: the model holds layers converted by "
            "nn.quant.quantize_for_inference; convert a float model")
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


def fake_quant(x, scale=None, bits=8):
    """Quantize and dequantize x (↔ :48) at `scale` (abs-max / qmax of x
    when None; 1 where it is 0), rounding half to even and clipping to
    [-qmax - 1, qmax]: the forward sees the rounded value, the gradient
    is the identity (x + (q - x).detach())."""
    (x,) = amp.cast_inputs("fake_quant", x)
    qmax = 2 ** (bits - 1) - 1
    s = x.detach().abs().max() / qmax if scale is None else \
        torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(x.detach() / s), -qmax - 1, qmax) * s
    return x + (q - x).detach()


class AbsMaxObserver:
    """The largest |x| seen over the calibration forwards (↔ :64); its
    scale is that / qmax, or 1 before anything nonzero was seen."""

    def __init__(self, quant_bits=8):
        self.quant_bits = quant_bits
        self._absmax = 0.0

    def observe(self, x):
        self._absmax = max(self._absmax, float(x.detach().abs().max()))

    def scale(self):
        qmax = 2 ** (self.quant_bits - 1) - 1
        return (self._absmax / qmax) if self._absmax else 1.0


class QuantConfig:
    """Which layer types quantize, and with which observers (↔ :80)."""

    def __init__(self, activation=None, weight=None):
        self.activation = activation
        self.weight = weight or AbsMaxObserver
        self._types = [Linear]

    def add_type_config(self, layer_types, activation=None, weight=None):
        types = (layer_types if isinstance(layer_types, (list, tuple))
                 else [layer_types])
        self._types.extend(t for t in types if t not in self._types)
        if weight is not None:
            self.weight = weight
        if activation is not None:
            self.activation = activation
        return self


def _targets(model, types):
    """(name, layer) of each sublayer of `model` (not `model` itself) that
    is an instance of one of `types`."""
    return [(name, sub) for name, sub in model.named_modules()
            if name and isinstance(sub, tuple(types))]


class PTQ:
    """Post-training quantization (↔ :138): `quantize` hooks an activation
    observer on each target layer's forward, calibration forwards feed
    them, `convert` swaps in the QuantizedLinears."""

    def __init__(self, q_config: QuantConfig | None = None):
        self.config = q_config or QuantConfig()
        self._observed = []

    def quantize(self, model, inplace=False):
        self._observed = []
        for name, sub in _targets(model, self.config._types):
            if getattr(sub, "_ptq_observed", False):
                continue
            obs = (self.config.activation or AbsMaxObserver)()
            orig = sub.forward

            def fwd(x, _orig=orig, _obs=obs):
                _obs.observe(x)
                return _orig(x)

            sub.forward = fwd
            sub._ptq_observed = True
            sub._ptq_orig_forward = orig
            self._observed.append((model, name, sub, obs))
        return model

    def activation_scales(self):
        return {name: obs.scale() for _, name, _, obs in self._observed}

    def convert(self, model, inplace=False, bits=8):
        """Swap each observed layer for its QuantizedLinear, which carries
        the calibrated `activation_scale`. `model` must be the one that
        `quantize` instrumented."""
        if self._observed and self._observed[0][0] is not model:
            raise ValueError("convert() must receive the same model instance "
                             "that quantize() instrumented")
        for owner, name, sub, obs in self._observed:
            sub.forward = sub._ptq_orig_forward
            del sub._ptq_observed, sub._ptq_orig_forward
            ql = QuantizedLinear(sub, bits=bits)
            ql.activation_scale = obs.scale()
            _swap_sublayer(owner, name, ql)
        return model


class QAT:
    """Quantization-aware training (↔ :227): each target layer's forward
    runs on `fake_quant` of its weight; the stored weight is untouched and
    takes the gradient straight through."""

    def __init__(self, q_config: QuantConfig | None = None):
        self.config = q_config or QuantConfig()

    def quantize(self, model, inplace=False):
        for _, sub in _targets(model, self.config._types):
            if getattr(sub, "_qat_wrapped", False):
                continue
            orig = sub.forward

            def fwd(x, _orig=orig, _sub=sub):
                # the forward reads the fake-quantized weight in place of the
                # parameter, which comes back afterwards
                w = _sub._parameters["weight"]
                _sub._parameters["weight"] = fake_quant(w)
                try:
                    return _orig(x)
                finally:
                    _sub._parameters["weight"] = w

            sub.forward = fwd
            sub._qat_wrapped = True
        return model
