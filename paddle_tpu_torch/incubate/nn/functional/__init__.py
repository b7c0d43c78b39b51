"""Incubate fused functionals (↔ paddle_tpu/incubate/nn/functional).

Ported so far: `masked_multihead_attention` (MMHA), the single-step decode
attention over a dense [2, B, H, S_max, D] cache. The rest of the module
(`block_multihead_attention`, the fused norm, RoPE, SwiGLU and MoE
functionals) is ROADMAP A7 and A8b work.
"""

from __future__ import annotations

import torch

from .... import amp
from ....ops.decode_attention import NEG_INF, dense_decode_attention

__all__ = ["masked_multihead_attention"]


def _masked_attention(q, k, v, keep, add_mask):
    """The JAX package's `_attn_math.masked_attention`: q [B, 1, H, D],
    k/v [B, S, H, D], keep bool broadcastable to [B, H, 1, S], add_mask
    additive or None; f32 softmax, output in q's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    if add_mask is not None:
        logits = logits + add_mask.float()
    p = torch.softmax(logits, -1)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(q.dtype)


def masked_multihead_attention(
        x, cache_kv=None, bias=None, src_mask=None, cum_offsets=None,
        sequence_lengths=None, rotary_tensor=None, beam_cache_offset=None,
        qkv_out_scale=None, out_shift=None, out_smooth=None, seq_len=1,
        rotary_emb_dims=0, use_neox_rotary_style=False,
        compute_dtype="default", out_scale=-1, quant_round_type=1,
        quant_max_bound=127.0, quant_min_bound=-127.0, name=None):
    """Single-step decode attention with a KV cache (↔ JAX :535).

    x: [B, 3*H*D], one step's fused qkv (+ `bias` [3*H*D]). cache_kv:
    [2, B, H, S_max, D]. sequence_lengths: [B] tokens already cached per
    row (the write offset; zeros when None). Row b's new K/V land at
    position sequence_lengths[b] (clamped to S_max - 1), IN PLACE in
    `cache_kv` (the JAX package returns a fresh cache). Without `src_mask`
    the attention over the first sequence_lengths[b] + 1 positions is
    `dense_decode_attention` (the dense-cache kernel on the card); with an
    additive `src_mask` [B, ..., S] it is the exact composite. Returns
    (out [B, H*D] in x's dtype, cache_kv). The quant, beam and rotary
    arguments raise NotImplementedError, as in the JAX package."""
    if any(a is not None for a in (rotary_tensor, beam_cache_offset,
                                   qkv_out_scale, out_shift, out_smooth)) \
            or out_scale != -1:
        raise NotImplementedError(
            "masked_multihead_attention: the quant, beam and rotary-tensor "
            "paths are not ported (the JAX package has none either)")
    if cache_kv is None:
        raise ValueError("masked_multihead_attention: cache_kv is required")
    x, cache_kv, bias, src_mask = amp.cast_inputs(
        "masked_multihead_attention", x, cache_kv, bias, src_mask)
    B = x.shape[0]
    _, _, H, S_max, D = cache_kv.shape
    qkv = x.reshape(B, 3, H, D)
    if bias is not None:
        qkv = qkv + bias.reshape(1, 3, H, D)
    q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]   # [B, H, D]
    if sequence_lengths is None:
        lens = torch.zeros(B, dtype=torch.int32, device=x.device)
    else:
        lens = sequence_lengths.reshape(B).to(device=x.device,
                                              dtype=torch.int32)
    rows = torch.arange(B, device=x.device)
    at = lens.long().clamp(0, S_max - 1)
    k_cache, v_cache = cache_kv[0], cache_kv[1]
    k_cache[rows, :, at] = k_new.to(cache_kv.dtype)
    v_cache[rows, :, at] = v_new.to(cache_kv.dtype)
    if src_mask is None:
        out = dense_decode_attention(q.contiguous(), k_cache, v_cache,
                                     lens + 1)
    else:
        keep = (torch.arange(S_max, device=x.device)[None, :]
                <= lens.long()[:, None])[:, None, None, :]
        add = src_mask.reshape(B, 1, 1, -1)[..., :S_max]
        out = _masked_attention(q[:, None], k_cache.transpose(1, 2),
                                v_cache.transpose(1, 2), keep, add)
    return out.reshape(B, H * D).to(x.dtype), cache_kv
