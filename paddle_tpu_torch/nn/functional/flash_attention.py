"""Attention functionals (↔ paddle_tpu/nn/functional/flash_attention.py).

Paddle layout: q/k/v are [batch, seq, num_heads, head_dim].

`scaled_dot_product_attention` dispatches as the JAX package does
(:99-140), but for eval mode at a dropout above 0, which the JAX package
sends to its composite and the port to the kernels: a call without
dropout in training (dropout 0, or eval) and
with either no mask or a key-padding mask (broadcastable to [B, 1, 1,
Skv], needing no gradient) goes to the flash attention of
`paddle_tpu_torch.ops.flash_attention` (the hand-written kernels on CUDA
tensors, their plain versions on CPU tensors), with the mask folded into
an additive per-key bias. Everything else, the serving prefill's full
bool mask and every call with dropout in training included, goes to the
exact composite `_ref_attention`: f32 logits, a bottom-right aligned
causal mask `tril(k=Skv-Sq)`, a bool mask that fills -1e30, GQA by head
repetition, and with dropout a Bernoulli mask on the probabilities drawn
from the port's generator (:72-74; no kernel has a dropout path, in
either package). The two routes disagree only on a row that sees no key:
the composite returns the mean of V there, the kernel zeros (as the JAX
default kernel does).

Inputs are cast for AMP as the op "flash_attention" on the kernel route and
"sdpa" on the composite one (both on the white list).

`flashmask_attention` (:223) takes the kernel route of the JAX package:
`paddle_tpu_torch.ops.masked_flash` (the flashmask kernels on CUDA
tensors, their plain versions on CPU tensors), with top-left causal
masking and zeros for a row that keeps no key. The JAX package's composite
route, taken there when Pallas is off, aligns causal bottom-right and gives
the mean of V for such a row; the two agree when Sq == Skv and every row
keeps a key.

`flash_attn_unpadded` (:165) is attention over packed documents, q
[Tq, H, D] and k/v [Tk, Hkv, D] with cu_seqlens prefix sums, through
`paddle_tpu_torch.ops.masked_flash`'s varlen kernels (their plain versions
on CPU tensors): the JAX package's kernel route, with causal masking
top-left within each document and zeros for a row whose document has no
keys (its composite route gives the mean of V there).

With dropout in training both leave their kernels for the composite
`_ref_attention` under the kernel route's masking (its keep mask, top-left
causal, and `zero_empty`: zeros on an empty row), which adds only the
dropout on the probabilities. The JAX package's flashmask and varlen calls with dropout
take their composite routes, which apply no dropout at all and mask as
said above (ROADMAP queue C).

`ring_flash_attention` (:340) is context-parallel exact attention: with a global
mesh, q/k/v are this rank's chunk of a sequence cut over the mesh's `sep`
group and go around its ring (`parallel.ring.ring_attention`) at any sep
degree, one included; with no mesh they are the whole sequence and take
the dense `_ref_attention`, as in the reference (:353-359). It takes no
dropout, as the reference's.
"""

from __future__ import annotations

import torch

from ... import amp
from ...framework.core import report_op
from ...ops.flash_attention import NEG_INF, flash_attention_fwd
from ...ops.masked_flash import (flashmask_attention_fwd, flashmask_keep,
                                 varlen_flash_attention_fwd, varlen_keep,
                                 varlen_layout)
from ._attn_math import repeat_kv
from .common import _keep

__all__ = ["flash_attention", "flash_attn_unpadded", "flashmask_attention",
           "ring_flash_attention", "scaled_dot_product_attention",
           "sdp_kernel"]


def _drop(p, rate):
    """Dropout on the probabilities p [B, H, Sq, Skv] (↔ :72-74): each kept
    with probability 1 - rate, as p / (1 - rate), from the port's
    generator."""
    keep = _keep(p, rate, p.shape)
    return torch.where(keep, p / (1.0 - rate), 0.0)


def _ref_attention(q, k, v, mask=None, causal=False, scale=None,
                   dropout=0.0, zero_empty=False):
    """q/k/v [B, S, H, D] -> [B, S, H, D]; f32 softmax, then dropout on
    the probabilities at `dropout` > 0. With `zero_empty` (a bool mask,
    broadcastable to [B, H, Sq, Skv]) a row that keeps no key gives
    zeros, as the kernels', where it otherwise gives the mean of V."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    k, v = repeat_kv(k, v, H)
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
    if zero_empty:
        p = p * mask
    if dropout > 0.0:
        p = _drop(p, dropout)
    out = torch.einsum("bhst,bthd->bshd", p.to(v.dtype), v)
    return out.to(q.dtype)


def _is_key_padding(mask, q, k):
    """A [B|1, 1, 1, Skv] mask that needs no gradient: a per-key padding
    mask, which rides the kernel as an additive key bias."""
    shape = tuple(mask.shape)
    return (len(shape) == 4 and shape[1] == 1 and shape[2] == 1
            and shape[3] == k.shape[1] and shape[0] in (1, q.shape[0])
            and not mask.requires_grad)


def _key_bias(mask, batch):
    """[B|1, 1, 1, Skv] bool or additive mask -> f32 key bias [B, Skv]."""
    m = mask.reshape(mask.shape[0], -1)
    if m.dtype == torch.bool:
        kb = torch.where(m, 0.0, NEG_INF).to(torch.float32)
    else:
        kb = m.float()
    if kb.shape[0] == 1 and batch > 1:
        kb = kb.expand(batch, kb.shape[1])
    return kb


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, training=True,
                                 name=None):
    has_mask = attn_mask is not None
    if (dropout_p == 0.0 or not training) and (not has_mask
                             or _is_key_padding(attn_mask, query, key)):
        q, k, v, m = amp.cast_inputs("flash_attention", query, key, value,
                                     attn_mask)
        kb = _key_bias(m, q.shape[0]) if has_mask else None
        return flash_attention_fwd(q, k, v, causal=is_causal, key_bias=kb)
    q, k, v, m = amp.cast_inputs("sdpa", query, key, value, attn_mask)
    return report_op("sdpa", _ref_attention(
        q, k, v, mask=m, causal=is_causal,
        dropout=dropout_p if training else 0.0))


def ring_flash_attention(query, key, value, causal=True, axis="sep",
                         name=None):
    """Context-parallel exact attention (↔ :340, module docstring); its
    inputs are cast for AMP as the op "ring_flash_attention"."""
    from ...distributed import env as _env
    from ...parallel.ring import ring_attention_spmd

    q, k, v = amp.cast_inputs("ring_flash_attention", query, key, value)
    mesh = _env.get_global_mesh()
    if mesh is None:
        return _ref_attention(q, k, v, causal=causal)
    return ring_attention_spmd(q, k, v, mesh, axis=axis, causal=causal)


class sdp_kernel:
    """The reference's attention-backend switch (:321), kept to the kernel
    route: `enable_flash=True` changes nothing, since every attention on
    the card already runs the port's flash kernels; `enable_flash=False`
    raises, because nothing on the card switches away from a kernel
    (ROADMAP, "Not mirrored on purpose"). `enable_math` and
    `enable_mem_efficient` are accepted and not read."""

    def __init__(self, enable_flash=True, enable_math=True,
                 enable_mem_efficient=True):
        if not enable_flash:
            raise NotImplementedError(
                "sdp_kernel(enable_flash=False): the port has no switch away "
                "from its attention kernels; on the card every attention "
                "runs them (a CPU tensor runs their plain versions)")
        self.enable_flash = enable_flash

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """paddle.nn.functional.flash_attention: returns (out, None), the second
    slot standing for the softmax the reference API may return."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """paddle.nn.functional.flashmask_attention: attention under the
    per-key masked row ranges of `startend_row_indices` [B, Hm, Skv, n]
    (n = 1 or 2 when causal, 2 or 4 otherwise; see ops/masked_flash.py).
    Without indices nothing is masked beyond `causal`. Casts q, k and v
    for AMP as the op "flashmask_attention". `dropout` > 0 in training
    takes the composite `_ref_attention` under the kernels' masking
    (module docstring); `window_size` and `return_softmax_lse` raise. With
    `return_seed_offset` returns (out, None)."""
    if window_size is not None or return_softmax_lse:
        raise NotImplementedError(
            "flashmask_attention: window_size and return_softmax_lse are not "
            "taken by the flashmask kernels")
    q, k, v = amp.cast_inputs("flashmask_attention", query, key, value)
    idx = startend_row_indices
    if idx is None:
        # nothing masked: rows >= Skv (causal), or rows >= Skv or < 0
        B, Skv = k.shape[0], k.shape[1]
        idx = torch.full((B, 1, Skv, 1 if causal else 2), Skv,
                         dtype=torch.int32, device=q.device)
        if not causal:
            idx[..., 1] = 0
    if dropout > 0.0 and training:
        keep = flashmask_keep(idx.transpose(2, 3), q.shape[1], k.shape[1],
                              causal)
        keep = keep.repeat_interleave(q.shape[2] // keep.shape[1], dim=1)
        out = _ref_attention(q, k, v, mask=keep, dropout=dropout,
                             zero_empty=True)
    else:
        out = flashmask_attention_fwd(q, k, v, idx, causal=causal)
    return (out, None) if return_seed_offset else out


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """paddle.nn.functional.flash_attn_unpadded: varlen attention over
    packed documents, query [Tq, H, D], key/value [Tk, Hkv, D],
    cu_seqlens_q / cu_seqlens_k [B + 1] prefix sums of the documents'
    lengths. Returns (out [Tq, H, D], None), the second slot standing for
    the softmax the reference API may return. max_seqlen_q/k are accepted
    and not needed. Casts q, k and v for AMP as the op
    "flash_attn_unpadded". `dropout` > 0 in training takes the composite
    `_ref_attention` under the kernels' masking (module docstring)."""
    q, k, v = amp.cast_inputs("flash_attn_unpadded", query, key, value)
    if dropout > 0.0 and training:
        layout = varlen_layout(cu_seqlens_q.to(q.device),
                               cu_seqlens_k.to(q.device), q.shape[0],
                               k.shape[0], bool(causal))
        keep = varlen_keep(layout, q.shape[0], bool(causal))
        out = _ref_attention(q[None], k[None], v[None], mask=keep,
                             scale=scale, dropout=dropout,
                             zero_empty=True)[0]
        return out, None
    out = varlen_flash_attention_fwd(q, k, v, cu_seqlens_q, cu_seqlens_k,
                                     scale, causal=causal)
    return out, None
