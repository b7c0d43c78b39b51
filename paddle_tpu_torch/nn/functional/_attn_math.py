"""The shared dense-attention math (↔ paddle_tpu/nn/functional/_attn_math.py).

One f32-softmax masked attention for the composite routes that do not run
a flash kernel: MMHA with a `src_mask`, the block-attention prefill and
its int8 and prefix cases, `variable_length_memory_efficient_attention`
and `FusedMultiTransformer`. The mask constant and the dtype rule live
here only, so they cannot drift between those callers.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "bottom_right_causal_keep", "mask_logits",
           "masked_attention", "repeat_kv", "split_mask"]

NEG_INF = -1e30


def repeat_kv(k, v, num_q_heads, head_axis=2):
    """GQA/MQA (↔ :14): each kv head repeated up to `num_q_heads` along
    `head_axis` (kv head j serves query heads j*g .. j*g + g - 1)."""
    hkv = k.shape[head_axis]
    if hkv != num_q_heads:
        rep = num_q_heads // hkv
        k = k.repeat_interleave(rep, dim=head_axis)
        v = v.repeat_interleave(rep, dim=head_axis)
    return k, v


def split_mask(mask):
    """(keep, add_mask) of a mask as the fused ops read it: a bool or an
    integer mask keeps its true / nonzero entries, a float mask adds."""
    if mask is None:
        return None, None
    if mask.dtype == torch.bool:
        return mask, None
    if not mask.is_floating_point():
        return mask != 0, None
    return None, mask


def mask_logits(logits, keep=None, add_mask=None):
    """f32 logits with the entries that `keep` drops at -1e30, then
    `add_mask` added."""
    if keep is not None:
        logits = torch.where(keep, logits,
                             torch.full((), NEG_INF, device=logits.device))
    if add_mask is not None:
        logits = logits + add_mask.float()
    return logits


def masked_attention(q, k, v, keep=None, add_mask=None, scale=None):
    """q [B, Sq, H, D], k/v [B, Sk, H or Hkv, D] -> [B, Sq, H, D] (↔ :24).

    keep: bool broadcastable to [B, H, Sq, Sk] (True attends), the other
    logits set to -1e30; add_mask: additive, broadcastable to the same,
    added in f32 after. Logits at `scale` (1 / sqrt(D) when None), softmax
    and P V in f32, the output cast to q's dtype."""
    k, v = repeat_kv(k, v, q.shape[2])
    s = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * s
    p = torch.softmax(mask_logits(logits, keep, add_mask), dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(q.dtype)


def bottom_right_causal_keep(sq, sk, q_lens=None, kv_lens=None, device=None):
    """The bottom-right aligned causal keep mask (↔ :45): the last query
    row aligns with the last valid key. bool [B, 1, Sq, Sk] with lengths
    [B] (keys past kv_lens dropped too), else [1, 1, Sq, Sk]."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    if q_lens is None and kv_lens is None:
        return (kpos <= qpos + (sk - sq))[None, None]
    q_lens = q_lens.reshape(-1, 1, 1).to(device=device, dtype=torch.int64)
    kv_lens = kv_lens.reshape(-1, 1, 1).to(device=device, dtype=torch.int64)
    causal = kpos[None] <= qpos[None] + (kv_lens - q_lens)
    valid = kpos[None] < kv_lens
    return (causal & valid)[:, None]
