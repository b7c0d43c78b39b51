"""The fused transformer blocks (↔ paddle_tpu/incubate/nn/functional/
fused_attention_ops.py): `fused_multi_head_attention` (alias
`fused_attention`), `fused_feedforward` and
`fused_bias_dropout_residual_layer_norm`.

Each is the JAX package's composition in torch ops: LayerNorm `_ln` with
f32 statistics, cuBLAS products, dropout and residual epilogues. The
attention core of `fused_multi_head_attention` without a mask and without
an active attention dropout is `ops.flash_attention.flash_attention_fwd`,
non-causal (the flash kernels on CUDA tensors, forward and, through
autograd, dQ and dK/dV); otherwise the f32-softmax composite, with the
dropout on the probabilities when it is active.

Dropout follows `_dropout` (:50-60): nothing is drawn at a rate of 0 or
outside training; "downscale_in_infer" scales by 1 - p outside training;
in training an element is kept with probability 1 - p, from the port's
generators (`framework.random`), as x / (1 - p) ("upscale_in_train") or x.
"""

from __future__ import annotations

import torch

from .... import amp
from ....nn.functional._attn_math import (mask_logits, masked_attention,
                                          split_mask)
from ....nn.functional.common import _keep
from ....ops.flash_attention import flash_attention_fwd

__all__ = ["fused_attention", "fused_bias_dropout_residual_layer_norm",
           "fused_feedforward", "fused_multi_head_attention"]


def _ln(v, scale, bias, eps):
    """LayerNorm over the last axis, statistics and affine in f32, the
    result in v's dtype (↔ :36)."""
    v32 = v.float()
    mu = v32.mean(-1, keepdim=True)
    var = (v32 - mu).square().mean(-1, keepdim=True)
    out = (v32 - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(v.dtype)


def _dropout(v, rate, training, mode):
    """The module docstring's dropout rule (↔ :50)."""
    if rate == 0.0 or not training:
        if mode == "downscale_in_infer" and not training:
            return v * (1.0 - rate)
        return v
    keep = _keep(v, rate, v.shape)
    if mode == "upscale_in_train":
        return torch.where(keep, v / (1.0 - rate), 0.0)
    return torch.where(keep, v, 0.0)


def fused_multi_head_attention(
        x, qkv_weight, linear_weight, pre_layer_norm=False, pre_ln_scale=None,
        pre_ln_bias=None, ln_scale=None, ln_bias=None, pre_ln_epsilon=1e-05,
        qkv_bias=None, linear_bias=None, cache_kv=None, attn_mask=None,
        dropout_rate=0.5, attn_dropout_rate=0.5, ln_epsilon=1e-05,
        training=True, mode="upscale_in_train", ring_id=-1,
        add_residual=True, num_heads=-1, transpose_qkv_wb=False, name=None):
    """Self-attention block (↔ :74): (pre-LN), the qkv projection (weight
    [3, H, D, E], or [E, 3E] under `transpose_qkv_wb` with `num_heads`),
    attention with `attn_mask` (bool or int: keep; float: additive) and
    attention dropout, the output projection, dropout, the residual and
    (post-LN). `cache_kv` [2, B, H, S_c, D] goes before this call's k and
    v; then returns (out, the new cache [2, B, H, S_c + S, D])."""
    if transpose_qkv_wb and num_heads <= 0:
        raise ValueError("transpose_qkv_wb=True requires num_heads > 0 (the "
                         "[E, 3E] weight layout does not carry the head count)")
    (x, qkv_w, lin_w, pre_s, pre_b, ln_s, ln_b, qkv_b, lin_b, cache,
     mask) = amp.cast_inputs(
        "fused_multi_head_attention", x, qkv_weight, linear_weight,
        pre_ln_scale, pre_ln_bias, ln_scale, ln_bias, qkv_bias, linear_bias,
        cache_kv, attn_mask)
    B, S, E = x.shape
    residual = x
    h = _ln(x, pre_s, pre_b, pre_ln_epsilon) if pre_layer_norm else x
    if transpose_qkv_wb:
        qkv = h @ qkv_w
        if qkv_b is not None:
            qkv = qkv + qkv_b
        qkv = qkv.reshape(B, S, 3, num_heads, E // num_heads)
    else:
        qkv = torch.einsum("bse,jhde->bsjhd", h, qkv_w)
        if qkv_b is not None:
            qkv = qkv + qkv_b
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    D = q.shape[-1]
    new_cache = None
    if cache is not None:
        k = torch.cat([cache[0].transpose(1, 2).to(k.dtype), k], dim=1)
        v = torch.cat([cache[1].transpose(1, 2).to(v.dtype), v], dim=1)
        new_cache = torch.stack([k.transpose(1, 2), v.transpose(1, 2)])
    keep, add = split_mask(mask)
    drop = training and attn_dropout_rate > 0.0
    if not drop and keep is None and add is None:
        ctx = flash_attention_fwd(q, k, v, causal=False)
    elif not drop:
        ctx = masked_attention(q, k, v, keep=keep, add_mask=add)
    else:
        s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * D ** -0.5
        p = _dropout(torch.softmax(mask_logits(s, keep, add), dim=-1),
                     attn_dropout_rate, training, mode)
        ctx = torch.einsum("bhst,bthd->bshd", p, v.float()).to(x.dtype)
    out = ctx.reshape(B, S, -1) @ lin_w
    if lin_b is not None:
        out = out + lin_b
    out = _dropout(out, dropout_rate, training, mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = _ln(out, ln_s, ln_b, ln_epsilon)
    out = out.to(x.dtype)
    return (out, new_cache) if new_cache is not None else out


fused_attention = fused_multi_head_attention

_FFN_ACTS = {"relu": torch.relu, "gelu": torch.nn.functional.gelu,
             "silu": torch.nn.functional.silu,
             "swish": torch.nn.functional.silu, "tanh": torch.tanh}


def fused_feedforward(
        x, linear1_weight, linear2_weight, linear1_bias=None,
        linear2_bias=None, ln1_scale=None, ln1_bias=None, ln2_scale=None,
        ln2_bias=None, dropout1_rate=0.5, dropout2_rate=0.5,
        activation="relu", ln1_epsilon=1e-5, ln2_epsilon=1e-5,
        pre_layer_norm=False, training=True, mode="upscale_in_train",
        ring_id=-1, add_residual=True, name=None):
    """FFN block (↔ :198): (pre-LN), linear1, the activation (relu, exact
    gelu, silu/swish, tanh), dropout1, linear2, dropout2, the residual,
    (post-LN)."""
    act = _FFN_ACTS[activation]
    (x, w1, w2, b1, b2, s1, lb1, s2, lb2) = amp.cast_inputs(
        "fused_feedforward", x, linear1_weight, linear2_weight, linear1_bias,
        linear2_bias, ln1_scale, ln1_bias, ln2_scale, ln2_bias)
    h = _ln(x, s1, lb1, ln1_epsilon) if pre_layer_norm else x
    h = h @ w1
    if b1 is not None:
        h = h + b1
    h = _dropout(act(h), dropout1_rate, training, mode) @ w2
    if b2 is not None:
        h = h + b2
    h = _dropout(h, dropout2_rate, training, mode)
    if add_residual:
        h = x + h
    if not pre_layer_norm:
        h = _ln(h, s2, lb2, ln2_epsilon)
    return h.to(x.dtype)


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None, dropout_rate=0.5,
        ln_epsilon=1e-5, training=True, mode="upscale_in_train", name=None):
    """layer_norm(residual + dropout(x + bias)) (↔ :261)."""
    x, res, b, s, lb = amp.cast_inputs(
        "fused_bias_dropout_residual_layer_norm", x, residual, bias, ln_scale,
        ln_bias)
    h = x + b if b is not None else x
    h = res + _dropout(h, dropout_rate, training, mode)
    return _ln(h, s, lb, ln_epsilon).to(x.dtype)
