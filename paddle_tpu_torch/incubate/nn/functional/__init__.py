"""Incubate fused functionals (↔ paddle_tpu/incubate/nn/functional).

Ported so far:

- `swiglu` (:70): silu(x) * y, or the single-input form on the two halves
  of x;
- `fused_rotary_position_embedding` (:116): RoPE on 1-3 tensors through
  `ops.fused_rope` (the fused-RoPE kernel on CUDA tensors, one launch for
  all of them), with given sin/cos tables, `position_ids` or neither;
- `fused_rms_norm` (:193) and `fused_layer_norm` (:266): the optional
  bias and residual pre-adds, then the norm through `ops.fused_norm` (the
  fused-norm kernels on CUDA tensors) over the last axis, the plain
  composite over several;
- `masked_multihead_attention` (MMHA), the single-step decode attention
  over a dense [2, B, H, S_max, D] cache.

Each casts its inputs for AMP under the JAX package's op name ("swiglu",
"fused_rope", "fused_rms_norm", "fused_layer_norm",
"masked_multihead_attention"). The rest of the module
(`block_multihead_attention`, `fused_bias_act` and the other fused
functionals, `fused_moe`) is ROADMAP queue A item 5.
"""

from __future__ import annotations

import torch

from .... import amp
from ....ops.decode_attention import NEG_INF, dense_decode_attention
from ....ops.fused_norm import layer_norm_fwd, rms_norm_fwd
from ....ops.fused_rope import apply_fused_rope

__all__ = ["fused_layer_norm", "fused_rms_norm",
           "fused_rotary_position_embedding", "masked_multihead_attention",
           "swiglu"]


def swiglu(x, y=None, name=None):
    """silu(x) * y, the SiLU in f32 and rounded to x's dtype; with `y`
    None, x's last axis splits in two halves (x, y)."""
    if y is None:
        (x,) = amp.cast_inputs("swiglu", x)
        x, y = x.chunk(2, dim=-1)
    else:
        x, y = amp.cast_inputs("swiglu", x, y)
    return torch.nn.functional.silu(x.float()).to(x.dtype) * y


def _rope_tables(seq_len, head_dim, theta, position_ids=None, device=None):
    """Half-width f32 tables (cos, sin) [1 or B, S, D/2] at positions
    0..S-1, or at `position_ids` [B, S]: position (in f32) times
    1 / theta ** (arange(0, D, 2) / D), all in f32 as the JAX package
    computes them (no float64, no cached table)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    if position_ids is None:
        pos = torch.arange(seq_len, dtype=torch.float32, device=device)[None]
    else:
        pos = position_ids.to(device=device, dtype=torch.float32)
    freqs = pos[..., None] * inv[None, None, :]
    return torch.cos(freqs), torch.sin(freqs)


def fused_rotary_position_embedding(
        q, k=None, v=None, sin=None, cos=None, position_ids=None,
        use_neox_rotary_style=True, time_major=False,
        rotary_emb_base=10000.0, name=None):
    """Rotary embedding on q (and k, v) [B, S, H, D] ([S, B, H, D] with
    `time_major`) in one pass. Tables: `sin`/`cos` as given ([S, D] or
    [1, S, 1, D], full or half width; the last S rows are used; gathered at
    `position_ids` [B, S] if given), else computed at `position_ids` or at
    0..S-1 with base `rotary_emb_base`. Pairs are (x_j, x_{j+D/2}) with
    `use_neox_rotary_style`, else (x_{2j}, x_{2j+1}). Returns a 3-tuple,
    None where no tensor was given."""
    tensors = [q] + [t for t in (k, v) if t is not None]
    has_tables = sin is not None and cos is not None
    cast = amp.cast_inputs("fused_rope", *tensors,
                           *((cos, sin) if has_tables else ()))
    tensors = list(cast[:len(tensors)])
    if time_major:
        tensors = [t.transpose(0, 1) for t in tensors]
    S, D = tensors[0].shape[1], tensors[0].shape[3]
    if has_tables:
        c, s = cast[len(tensors):]
        c = c.reshape(-1, c.shape[-1])[-S:]
        s = s.reshape(-1, s.shape[-1])[-S:]
        if c.shape[-1] == D:  # full-width tables hold each value twice
            c = c[:, :D // 2] if use_neox_rotary_style else c[:, 0::2]
            s = s[:, :D // 2] if use_neox_rotary_style else s[:, 0::2]
        if position_ids is not None:
            pid = position_ids.to(c.device).long()
            c, s = c[pid], s[pid]
        else:
            c, s = c[None], s[None]
    else:
        c, s = _rope_tables(S, D, rotary_emb_base, position_ids,
                            tensors[0].device)
    outs = apply_fused_rope(tensors, c, s,
                            interleaved=not use_neox_rotary_style)
    if time_major:
        outs = [t.transpose(0, 1) for t in outs]
    return tuple(outs) + (None,) * (3 - len(outs))


def _norm_preadd(a, b, r, alpha=1.0):
    """The pre-norm adds of fused_rms_norm / fused_layer_norm:
    h = a (+ b) (+ r * alpha) in f32, and the residual output in a's dtype.
    With neither b nor r, `a` itself, untouched, for both."""
    if b is None and r is None:
        return a, a
    h = a.float()
    if b is not None:
        h = h + b.float()
    if r is not None:
        h = h + r.float() * alpha
    return h, h.to(a.dtype)


def _fused_norm(op, kind, x, norm_weight, norm_bias, epsilon, begin_norm_axis,
                bias, residual, alpha, quant_scale):
    if quant_scale != -1:
        raise NotImplementedError(
            f"{op}: the quantized output is not ported (ROADMAP queue A item 5)")
    a, w, nb, b, r = amp.cast_inputs(op, x, norm_weight, norm_bias, bias,
                                     residual)
    ax = begin_norm_axis % a.dim()
    h, res_out = _norm_preadd(a, b, r, alpha)
    if ax == a.dim() - 1 and a.dim() >= 2 and w.dim() == 1 and (
            nb is None or nb.dim() == 1):
        fwd = rms_norm_fwd(h, w, epsilon, bias=nb) if kind == "rms" else \
            layer_norm_fwd(h, w, nb, epsilon)
        return fwd.to(a.dtype), res_out
    h = h.float()
    axes = tuple(range(ax, a.dim()))
    if kind == "rms":
        out = h * torch.rsqrt(h.square().mean(axes, keepdim=True) + epsilon)
    else:
        mean = h.mean(axes, keepdim=True)
        var = (h - mean).square().mean(axes, keepdim=True)
        out = (h - mean) * torch.rsqrt(var + epsilon)
    out = out * w.float()
    if nb is not None:
        out = out + nb.float()
    return out.to(a.dtype), res_out


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, quant_round_type=0, quant_max_bound=0,
                   quant_min_bound=0, name=None):
    """RMSNorm of x (+ bias) (+ residual) over the axes from
    `begin_norm_axis` on, f32 statistics, weight and optional `norm_bias`.
    Returns (out in x's dtype, residual_out: the pre-added input in x's
    dtype, or x itself without pre-adds)."""
    return _fused_norm("fused_rms_norm", "rms", x, norm_weight, norm_bias,
                       epsilon, begin_norm_axis, bias, residual, 1.0,
                       quant_scale)


def fused_layer_norm(x, norm_weight, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None,
                     residual_alpha=1.0, quant_scale=-1, quant_round_type=0,
                     quant_max_bound=0, quant_min_bound=0, name=None):
    """LayerNorm of x (+ bias) (+ residual * residual_alpha), as
    `fused_rms_norm` with the centred two-pass variance."""
    return _fused_norm("fused_layer_norm", "ln", x, norm_weight, norm_bias,
                       epsilon, begin_norm_axis, bias, residual,
                       residual_alpha, quant_scale)


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
