"""Incubate fused functionals (↔ paddle_tpu/incubate/nn/functional).

- `swiglu` (:70): silu(x) * y, or the single-input form on the two halves
  of x;
- `fused_rotary_position_embedding` (:116): RoPE on 1-3 tensors through
  `ops.fused_rope` (the fused-RoPE kernel on CUDA tensors, one launch for
  all of them), with given sin/cos tables, `position_ids` or neither;
- `fused_rms_norm` (:193) and `fused_layer_norm` (:266): the optional
  bias and residual pre-adds, then the norm through `ops.fused_norm` (the
  fused-norm kernels on CUDA tensors) over the last axis, the plain
  composite over several;
- the epilogues `fused_bias_act` (:332), `fused_dropout_add` (:370),
  `fused_linear` (:390) and `fused_linear_activation` (:409): torch ops
  (cuBLAS products), as the JAX package's are jnp;
- `fused_moe` (:436): dense GShard dispatch, expert einsums and combine;
- `masked_multihead_attention` (MMHA, :535), the single-step decode over a
  dense [2, B, H, S_max, D] cache;
- `block_multihead_attention` (:629) over paged caches, with
  `blha_get_max_len` (:620): a decode step (S = 1) without int8 pages or a
  prefix runs the paged decode kernel of `ops.decode_attention`, every
  other case the composite of `nn.functional._attn_math`;
- `variable_length_memory_efficient_attention` (:803), the composite;
- from `fused_attention_ops` and `fused_misc_ops`: the fused attention,
  FFN and bias-dropout-residual-LN blocks, `fused_dot_product_attention`,
  `fused_gate_attention` and `fused_matmul_bias`.

Each casts its inputs for AMP under the JAX package's op name. The KV
caches of MMHA and block attention are written in place, where the JAX
package returns fresh arrays; each also returns them.
"""

from __future__ import annotations

import math

import torch

from .... import amp
from ....nn.functional._attn_math import (bottom_right_causal_keep,
                                          masked_attention)
from ....ops.decode_attention import dense_decode_attention, paged_decode_attention
from ....ops.fused_norm import layer_norm_fwd, rms_norm_fwd
from ....ops.fused_rope import apply_fused_rope

__all__ = ["blha_get_max_len", "block_multihead_attention", "fused_bias_act",
           "fused_dropout_add", "fused_layer_norm", "fused_linear",
           "fused_linear_activation", "fused_moe", "fused_rms_norm",
           "fused_rotary_position_embedding", "masked_multihead_attention",
           "swiglu", "variable_length_memory_efficient_attention"]


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


def _apply_rope_one(x, cos, sin, neox):
    """The rotary math of the JAX package's `_apply_rope_one` (:98), which
    block attention and FusedMultiTransformer use: x [B, S, H, D], half
    tables cos/sin [B or 1, S, D/2]. neox pairs (x_j, x_{j+D/2}), else
    (x_{2j}, x_{2j+1}); in f32, the result in x's dtype."""
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    xf = x.float()
    if neox:
        x1, x2 = xf.chunk(2, dim=-1)
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    else:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                          dim=-1).reshape(x.shape)
    return out.to(x.dtype)


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
        # the JAX package accepts quant_scale and never reads it (:193-265)
        raise NotImplementedError(
            f"{op}: quant_scale (an int8 output) is not computed; the JAX "
            "package ignores it")
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
        out = masked_attention(q[:, None], k_cache.transpose(1, 2),
                               v_cache.transpose(1, 2), keep=keep,
                               add_mask=add)
    return out.reshape(B, H * D).to(x.dtype), cache_kv


# gelu is torch's default exact erf form, Paddle's
_ACTS = {"gelu": torch.nn.functional.gelu, "relu": torch.relu,
         "silu": torch.nn.functional.silu, "identity": lambda x: x}
_GATED = {"geglu": torch.nn.functional.gelu,
          "swiglu": torch.nn.functional.silu}


def _act(method, h):
    """The activation `method` on h in f32: a gated one (geglu, swiglu)
    splits the last axis in halves (u, v) and gives act(u) * v."""
    if method in _GATED:
        u, v = h.chunk(2, dim=-1)
        return _GATED[method](u) * v
    if method not in _ACTS:
        raise ValueError(f"unsupported activation {method!r}")
    return _ACTS[method](h)


def fused_bias_act(x, bias=None, dequant_scales=None, shift=None, smooth=None,
                   act_method="gelu", compute_dtype="default", quant_scale=-1,
                   quant_round_type=0, quant_max_bound=0, quant_min_bound=0,
                   name=None):
    """act(x + bias) in f32, the result in x's dtype (↔ :332); gelu is the
    exact form; geglu and swiglu halve the last axis and apply the act to
    the first half. The JAX package takes `dequant_scales`, `shift`,
    `smooth`, `quant_scale` and `compute_dtype` and never reads them: here
    a value other than the default raises."""
    if (any(t is not None for t in (dequant_scales, shift, smooth))
            or quant_scale != -1 or compute_dtype != "default"):
        raise NotImplementedError(
            "fused_bias_act: dequant_scales, shift, smooth, quant_scale and "
            "compute_dtype are not read (the JAX package ignores them)")
    x, bias = amp.cast_inputs("fused_bias_act", x, bias)
    h = x.float()
    if bias is not None:
        h = h + bias.float()
    return _act(act_method.lower(), h).to(x.dtype)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      seed=None, name=None):
    """dropout(x) + y (↔ :370). Outside training or at p = 0 it is x + y
    in both modes, as in the JAX package. In training each element of x is
    kept with probability 1 - p, from the port's generators
    (`framework.random`): as x / (1 - p) in "upscale_in_train", as x in
    "downscale_in_infer"."""
    from ....nn.functional.common import _keep

    x, y = amp.cast_inputs("fused_dropout_add", x, y)
    if not training or p == 0.0:
        return x + y
    keep = _keep(x, p, x.shape)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, 0.0) + y


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """x @ weight (+ bias) (↔ :390); `transpose_weight` reads weight as
    [out, in]."""
    x, weight, bias = amp.cast_inputs("fused_linear", x, weight, bias)
    out = torch.matmul(x, weight.t() if transpose_weight else weight)
    return out if bias is None else out + bias


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu", name=None):
    """act(x @ y + bias) (↔ :409): the product in the inputs' dtype, the
    activation ("none", gelu, relu, silu, identity, geglu, swiglu) in f32
    and rounded back."""
    method = activation.lower()
    if method != "none" and method not in _ACTS and method not in _GATED:
        raise ValueError(f"unsupported activation {activation!r}")
    x, y, bias = amp.cast_inputs("fused_linear_activation", x, y, bias)
    if trans_x:
        x = x.transpose(-1, -2)
    if trans_y:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y) + bias
    if method == "none":
        return out
    return _act(method, out.float()).to(out.dtype)


def fused_moe(x, gate_weight, ffn1_weight, ffn2_weight, ffn1_bias=None,
              ffn1_scale=None, ffn2_bias=None, ffn2_scale=None,
              quant_method="None", moe_topk=2, norm_topk_prob=True,
              group_moe=False, name=None):
    """The fused MoE FFN (↔ :436), dense as in the JAX package: softmax
    gate logits (x @ gate_weight in f32), GShard top-k dispatch through
    the MoE gate's `_topk_dispatch` with a capacity of
    4 ceil(topk T / E) slots an expert (clipped to [1, T]; later routes
    past it dropped), the expert products as einsums, the combine.
    `group_moe` cuts the E experts into moe_topk groups, softmaxes within
    each and routes to each group's top expert. ffn1_weight is [E, M, 2H]
    (SwiGLU: silu of the first half times the second) or [E, M, H] (the
    tanh-form GELU, as `jax.nn.gelu`'s default); ffn2_weight [E, H, M].
    quant_method "weight_only_int8" dequantizes int8 expert weights by
    ffn1_scale / ffn2_scale [E, out] (one scale a channel)."""
    from ...distributed.models.moe.gate import _topk_dispatch

    weight_only = quant_method == "weight_only_int8"
    if quant_method not in ("None", None, "none", "weight_only_int8"):
        raise NotImplementedError(
            f"fused_moe quant_method {quant_method!r} (weight_only_int8 is "
            "supported)")
    if weight_only and (ffn1_scale is None or ffn2_scale is None):
        raise ValueError("weight_only_int8 requires ffn1_scale and ffn2_scale")
    x, gw, w1, w2, s1, s2, b1, b2 = amp.cast_inputs(
        "fused_moe", x, gate_weight, ffn1_weight, ffn2_weight,
        ffn1_scale if weight_only else None,
        ffn2_scale if weight_only else None, ffn1_bias, ffn2_bias)
    if weight_only:
        w1 = w1.to(x.dtype) * s1.reshape(w1.shape[0], 1, -1).to(x.dtype)
        w2 = w2.to(x.dtype) * s2.reshape(w2.shape[0], 1, -1).to(x.dtype)
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    T = xt.shape[0]
    E = gw.shape[-1]
    glu = w1.shape[-1] == 2 * w2.shape[1]
    cap = max(1, min(T, 4 * math.ceil(moe_topk * T / E)))
    logits = (xt @ gw).float()
    if group_moe:
        if E % moe_topk:
            raise ValueError(f"group_moe needs num_experts ({E}) divisible "
                             f"by moe_topk ({moe_topk})")
        eg = E // moe_topk
        gp = torch.softmax(logits.reshape(T, moe_topk, eg), dim=-1)
        sel = gp.argmax(-1)
        probs = (gp * torch.nn.functional.one_hot(sel, eg).to(gp.dtype)
                 ).reshape(T, E)
    else:
        probs = torch.softmax(logits, dim=-1)
    combine, dispatch, _ = _topk_dispatch(probs, moe_topk, lambda n: cap,
                                          norm_topk_prob)
    xe = torch.einsum("tec,tm->ecm", dispatch.to(xt.dtype), xt)
    h = torch.einsum("ecm,emh->ech", xe, w1)
    if b1 is not None:
        h = h + b1.reshape(E, 1, -1)
    if glu:
        u, g = h.chunk(2, dim=-1)
        h = torch.nn.functional.silu(u) * g
    else:
        h = torch.nn.functional.gelu(h, approximate="tanh")
    ye = torch.einsum("ech,ehm->ecm", h, w2)
    if b2 is not None:
        ye = ye + b2.reshape(E, 1, -1)
    out = torch.einsum("tec,ecm->tm", combine.to(xt.dtype), ye)
    return out.reshape(shape)


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size=None,
                     name=None):
    """(max encoder length, max decoder length), each a [1] tensor
    (↔ :620)."""
    return (seq_lens_encoder.max().reshape(1),
            seq_lens_decoder.max().reshape(1))


def block_multihead_attention(
        qkv, key_cache, value_cache, seq_lens_encoder, seq_lens_decoder,
        seq_lens_this_time, padding_offsets=None, cum_offsets=None,
        cu_seqlens_q=None, cu_seqlens_k=None, block_tables=None,
        pre_key_cache=None, pre_value_cache=None, cache_k_quant_scales=None,
        cache_v_quant_scales=None, cache_k_dequant_scales=None,
        cache_v_dequant_scales=None, qkv_out_scale=None, qkv_bias=None,
        out_shift=None, out_smooth=None, max_enc_len_this_time=None,
        max_dec_len_this_time=None, rope_emb=None, mask=None, tgt_mask=None,
        max_seq_len=-1, block_size=64, use_neox_style=False, name=None,
        **quant_kw):
    """Attention over paged KV caches (↔ :629), the JAX package's dense
    padded form.

    qkv [B, S, (H + 2 Hkv) D] (+ `qkv_bias`); key/value_cache
    [n_blocks, Hkv, block_size, D]; block_tables [B, P] page ids (-1
    unused); seq_lens_encoder [B] (> 0: the row's prompt length, a prefill
    at offset 0), seq_lens_decoder [B] (a decode row's tokens already
    cached, its write offset). With `rope_emb` ([2, B or 1, max_seq, 1,
    D/2] cos and sin) q and the new k rotate at their absolute positions
    before the write. The new K/V go into their pages IN PLACE (the JAX
    package returns fresh caches); a write past the row's valid tokens, or
    onto a -1 page, is dropped. With the four cache scales the pages are
    int8: per kv head, K * quant_scale rounded half to even and clipped to
    [-128, 127] on the write, payload * dequant_scale on the read.
    `pre_key_cache` / `pre_value_cache` [B, Hkv, P, D] are a prefix that
    every query of a live row attends before the pages.

    A decode step (S = 1) without int8 pages or a prefix runs
    `paged_decode_attention` (the paged decode kernel on CUDA tensors);
    every other case the composite `masked_attention` over the gathered
    pages, causal at the absolute positions. Returns (out [B, S, H D],
    qkv, key_cache, value_cache). `mask` and `tgt_mask` are never read by
    the JAX package: here they raise, as do the activation-quant
    arguments."""
    if any(v is not None for v in (qkv_out_scale, out_shift, out_smooth)):
        raise NotImplementedError("block_multihead_attention: the "
                                  "activation-quant paths are not supported")
    if mask is not None or tgt_mask is not None:
        raise NotImplementedError(
            "block_multihead_attention: mask and tgt_mask are not read (the "
            "JAX package ignores them; causality comes from the lengths)")
    if block_tables is None:
        raise ValueError("block_multihead_attention: block_tables is required")
    if (pre_key_cache is None) != (pre_value_cache is None):
        raise ValueError("pre_key_cache and pre_value_cache must be given "
                         "together")
    scales = (cache_k_quant_scales, cache_v_quant_scales,
              cache_k_dequant_scales, cache_v_dequant_scales)
    quant = any(t is not None for t in scales)
    if quant and any(t is None for t in scales):
        raise ValueError("int8 cache quant needs all four "
                         "cache_{k,v}_{quant,dequant}_scales")
    (qkv_c, kc, vc, b, rope, pre_k, pre_v, kqs, vqs, kdqs,
     vdqs) = amp.cast_inputs("block_multihead_attention", qkv, key_cache,
                             value_cache, qkv_bias, rope_emb, pre_key_cache,
                             pre_value_cache, *scales)
    dev = qkv_c.device
    B, S = qkv_c.shape[0], qkv_c.shape[1]
    n_blocks, Hkv, bs, D = kc.shape
    H = qkv_c.shape[-1] // D - 2 * Hkv
    q3 = qkv_c.reshape(B, S, -1, D)
    if b is not None:
        q3 = q3 + b.reshape(1, 1, -1, D)
    q, k_new, v_new = q3[:, :, :H], q3[:, :, H:H + Hkv], q3[:, :, H + Hkv:]
    enc = seq_lens_encoder.reshape(B).to(device=dev, dtype=torch.int64)
    dec = seq_lens_decoder.reshape(B).to(device=dev, dtype=torch.int64)
    tables = block_tables.to(dev)
    offs = torch.where(enc > 0, 0, dec)
    pos = offs[:, None] + torch.arange(S, device=dev)[None, :]      # [B, S]
    total = offs + torch.where(enc > 0, enc, 1)
    if rope is not None:
        ce, se = rope[0], rope[1]               # [B or 1, max_seq, 1, D/2]
        at = pos.clamp(max=ce.shape[1] - 1)
        rows = torch.arange(B, device=dev)[:, None] if ce.shape[0] > 1 else 0
        ce, se = ce[rows, at, 0].float(), se[rows, at, 0].float()  # [B, S, D/2]
        q = _apply_rope_one(q, ce, se, use_neox_style)
        k_new = _apply_rope_one(k_new, ce, se, use_neox_style)
    # the scatter into the pages, in place; invalid writes are dropped
    col = (pos // bs).clamp(max=tables.shape[1] - 1)
    page = tables.long().gather(1, col)
    ok = (pos < total[:, None]) & (page >= 0)
    kn, vn = k_new[ok], v_new[ok]                                 # [n, Hkv, D]
    if quant:
        kn = torch.clamp(torch.round(kn * kqs.reshape(1, Hkv, 1)), -128, 127)
        vn = torch.clamp(torch.round(vn * vqs.reshape(1, Hkv, 1)), -128, 127)
    pg, sl = page[ok], (pos % bs)[ok]
    kc[pg, :, sl] = kn.to(kc.dtype)
    vc[pg, :, sl] = vn.to(vc.dtype)
    if S == 1 and not quant and pre_k is None:
        out = paged_decode_attention(q[:, 0].contiguous(), kc, vc,
                                     tables.to(torch.int32).contiguous(),
                                     total.to(torch.int32))
        return out.reshape(B, S, H * D).to(qkv_c.dtype), qkv_c, kc, vc
    S_max = tables.shape[1] * bs
    safe = torch.where(tables >= 0, tables, 0).long()
    gk = kc[safe].transpose(2, 3).reshape(B, S_max, Hkv, D)
    gv = vc[safe].transpose(2, 3).reshape(B, S_max, Hkv, D)
    if quant:
        gk = gk.to(q.dtype) * kdqs.reshape(1, 1, Hkv, 1).to(q.dtype)
        gv = gv.to(q.dtype) * vdqs.reshape(1, 1, Hkv, 1).to(q.dtype)
    kpos = torch.arange(S_max, device=dev)[None, None, :]
    keep = (kpos <= pos[..., None]) & (kpos < total[:, None, None])
    if pre_k is not None:
        P = pre_k.shape[2]
        gk = torch.cat([pre_k.transpose(1, 2).to(gk.dtype), gk], dim=1)
        gv = torch.cat([pre_v.transpose(1, 2).to(gv.dtype), gv], dim=1)
        live = ((enc > 0) | (dec > 0))[:, None, None].expand(B, S, P)
        keep = torch.cat([live, keep], dim=-1)
    out = masked_attention(q, gk, gv, keep=keep[:, None])
    return out.reshape(B, S, H * D).to(qkv_c.dtype), qkv_c, kc, vc


def variable_length_memory_efficient_attention(
        query, key, value, seq_lens, kv_seq_lens, mask=None, scale=None,
        causal=False, pre_cache_length=0, name=None):
    """Attention on padded batches (↔ :803): q/k/v [B, H, S, D]; row b
    sees its first kv_seq_lens[b] keys, causal bottom-right aligned from
    its seq_lens[b] queries when `causal`; an additive `mask` and `scale`
    (1 / sqrt(D) when None). The composite `masked_attention`."""
    q, k, v, m = amp.cast_inputs("variable_length_memory_efficient_attention",
                                 query, key, value, mask)
    B, _, Sq, _ = q.shape
    Sk = k.shape[2]
    ql = seq_lens.reshape(B).to(q.device)
    kl = kv_seq_lens.reshape(B).to(q.device)
    if causal:
        keep = bottom_right_causal_keep(Sq, Sk, ql, kl, device=q.device)
    else:
        keep = (torch.arange(Sk, device=q.device)[None, :]
                < kl.long()[:, None])[:, None, None, :]
    out = masked_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), keep=keep, add_mask=m,
                           scale=scale)
    return out.transpose(1, 2)


from .fused_attention_ops import (  # noqa: E402
    fused_attention, fused_bias_dropout_residual_layer_norm,
    fused_feedforward, fused_multi_head_attention)
from .fused_misc_ops import (  # noqa: E402
    fused_dot_product_attention, fused_gate_attention, fused_matmul_bias)

__all__ += ["fused_attention", "fused_bias_dropout_residual_layer_norm",
            "fused_dot_product_attention", "fused_feedforward",
            "fused_gate_attention", "fused_matmul_bias",
            "fused_multi_head_attention"]
