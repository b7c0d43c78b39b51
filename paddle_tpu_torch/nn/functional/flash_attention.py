"""Attention functionals (↔ paddle_tpu/nn/functional/flash_attention.py).

Paddle layout: q/k/v are [batch, seq, num_heads, head_dim].

Only `scaled_dot_product_attention` is ported so far, as the exact composite
`_ref_attention` of the JAX package: f32 logits, a bottom-right aligned
causal mask `tril(k=Skv-Sq)`, a bool mask that fills -1e30, GQA by head
repetition. It is plain PyTorch in both packages, never a kernel: the
serving prefill passes a full bool mask, which the JAX package also sends to
this composite. The flash-attention kernels (and the key-padding fused
path) come with the training slice.
"""

from __future__ import annotations

import torch

__all__ = ["scaled_dot_product_attention"]


def _ref_attention(q, k, v, mask=None, causal=False, scale=None):
    """q/k/v [B, S, H, D] -> [B, S, H, D]; f32 softmax."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = scale if scale is not None else 1.0 / (D ** 0.5)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * s
    if causal:
        cm = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device).tril(
            diagonal=Skv - Sq)
        logits = logits.masked_fill(~cm, -1e30)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, -1e30)
        else:
            logits = logits + mask.float()
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", p.to(v.dtype), v)
    return out.to(q.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, training=True,
                                 name=None):
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout needs the training slice (ROADMAP A6)")
    return _ref_attention(query, key, value, mask=attn_mask, causal=is_causal)
