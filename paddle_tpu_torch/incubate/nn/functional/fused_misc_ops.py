"""`fused_dot_product_attention`, `fused_gate_attention` and
`fused_matmul_bias` (↔ paddle_tpu/incubate/nn/functional/fused_misc_ops.py).

`fused_dot_product_attention` is `nn.functional.scaled_dot_product_attention`
with a custom scale folded into q, so without a mask and without dropout
it runs the flash kernels. The Evoformer gate attention and the bias
epilogue are torch ops (cuBLAS products), as the JAX package's are jnp.
"""

from __future__ import annotations

import torch

from .... import amp
from ....nn.functional._attn_math import mask_logits, split_mask
from ....nn.functional.flash_attention import scaled_dot_product_attention

__all__ = ["fused_dot_product_attention", "fused_gate_attention",
           "fused_matmul_bias"]


def fused_dot_product_attention(query, key, value, attn_mask=None,
                                dropout_p=0.0, is_causal=False,
                                scaling_factor=None, training=True, name=None):
    """Attention over q/k/v [B, S, H, D] (↔ :31) through
    `scaled_dot_product_attention`; `scaling_factor` is folded into q as
    q * scaling_factor * sqrt(D) (SDPA scales by 1 / sqrt(D))."""
    if scaling_factor is not None:
        query = query * (scaling_factor * query.shape[-1] ** 0.5)
    return scaled_dot_product_attention(
        query, key, value, attn_mask=attn_mask, dropout_p=dropout_p,
        is_causal=is_causal, training=training)


def fused_gate_attention(query, key=None, query_weight=None, key_weight=None,
                         value_weight=None, qkv_weight=None,
                         gate_linear_weight=None, gate_linear_bias=None,
                         out_linear_weight=None, out_linear_bias=None,
                         nonbatched_bias=None, attn_mask=None,
                         has_gating=True, merge_qkv=True,
                         use_flash_attn=False):
    """The AlphaFold Evoformer attention block (↔ :52) over activations
    [n, b, q, a]: per-head projections (qkv_weight [3, H, D, A] merged, or
    query/key/value_weight [A, H, D]), logits of q / sqrt(D) against k in
    f32, a keep or additive `attn_mask`, `nonbatched_bias` [n, H, q, k]
    broadcast over b, the softmax, sigmoid gating and the output
    projection [H, D, O]."""
    if out_linear_weight is None:
        raise ValueError("out_linear_weight is required")
    if has_gating and (gate_linear_weight is None or gate_linear_bias is None):
        raise ValueError("has_gating=True requires gate_linear_weight and "
                         "gate_linear_bias")
    if merge_qkv and qkv_weight is None:
        raise ValueError("merge_qkv=True requires qkv_weight")
    if not merge_qkv and (query_weight is None or key_weight is None
                          or value_weight is None):
        raise ValueError("merge_qkv=False requires query/key/value weights")
    m_data = query if key is None else key
    (q_data, m_data, qkv_w, qw, kw, vw, gw, gb, nb, mask, ow,
     ob) = amp.cast_inputs(
        "fused_gate_attention", query, m_data,
        qkv_weight if merge_qkv else None,
        None if merge_qkv else query_weight,
        None if merge_qkv else key_weight,
        None if merge_qkv else value_weight, gate_linear_weight,
        gate_linear_bias, nonbatched_bias, attn_mask, out_linear_weight,
        out_linear_bias)
    if merge_qkv:
        q = torch.einsum("nbqa,hda->nbqhd", q_data, qkv_w[0])
        k = torch.einsum("nbka,hda->nbkhd", m_data, qkv_w[1])
        v = torch.einsum("nbka,hda->nbkhd", m_data, qkv_w[2])
    else:
        q = torch.einsum("nbqa,ahd->nbqhd", q_data, qw)
        k = torch.einsum("nbka,ahd->nbkhd", m_data, kw)
        v = torch.einsum("nbka,ahd->nbkhd", m_data, vw)
    d = q.shape[-1]
    logits = torch.einsum("nbqhd,nbkhd->nbhqk", q * d ** -0.5, k).float()
    logits = mask_logits(logits, *split_mask(mask))
    if nb is not None:
        logits = logits + nb.float()[:, None]
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    ctx = torch.einsum("nbhqk,nbkhd->nbqhd", w, v)
    if has_gating:
        gate = torch.einsum("nbqa,ahd->nbqhd", q_data, gw) + gb
        ctx = ctx * torch.sigmoid(gate)
    out = torch.einsum("nbqhd,hdo->nbqo", ctx, ow)
    return out if ob is None else out + ob


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """x @ y (+ bias), either operand transposed first (↔ :136)."""
    x, y, bias = amp.cast_inputs("fused_matmul_bias", x, y, bias)
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = x @ y
    return out if bias is None else out + bias
