"""The qkv-packed varlen wrapper (↔ paddle_tpu/nn/functional/extras.py:334,
:354)."""

from __future__ import annotations

from .flash_attention import flash_attn_unpadded

__all__ = ["flash_attn_varlen_qkvpacked"]


def _unpack_qkv(t, axis):
    """(q, k, v): the three slices of `t` along `axis`, as views (the
    kernels read them through their strides)."""
    return t.select(axis, 0), t.select(axis, 1), t.select(axis, 2)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                                max_seqlen_k, scale, dropout=0.0,
                                causal=False, varlen_padded=True,
                                return_softmax=False, **kwargs):
    """qkv [T, 3, H, D] of densely packed tokens -> flash_attn_unpadded's
    (out, None). The reference's default varlen_padded=True layout
    ([B * maxlen, ...] with padding rows) is another memory convention,
    and reading it as packed would misalign every sequence, so it raises:
    pass varlen_padded=False."""
    if varlen_padded:
        raise NotImplementedError(
            "flash_attn_varlen_qkvpacked: the padded [B*maxlen, 3, H, D] "
            "layout is not supported; pass varlen_padded=False with densely "
            "packed tokens")
    q, k, v = _unpack_qkv(qkv, axis=1)
    return flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                               max_seqlen_q, max_seqlen_k, scale,
                               dropout=dropout, causal=causal,
                               return_softmax=return_softmax)
