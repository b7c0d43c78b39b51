"""FusedMultiTransformer, the fused pre-norm decoder stack for inference
(↔ paddle_tpu/incubate/nn/layer/fused_transformer.py).

Each layer's weights are stacked into [L, ...] parameters under the JAX
package's names. A `*_attrs` is one `ParamAttr` for its stacked
parameter, or a list of one a layer whose entries must agree (one tensor
takes one attribute; the JAX package reads the lists only for their
length, which gives `num_layers` when that is not given). The JAX package runs the stack as one `lax.scan` over
the layers; here it is a loop, each layer: the norm (LayerNorm or RMSNorm,
f32 statistics, scale and bias), the qkv product against a [qkv_out, M]
weight, the rotation at the absolute positions (θ = 10000, the tables of
`incubate.nn.functional._rope_tables`) when `rotary_emb_dims` > 0, the
cache write, the composite `masked_attention` (GQA, causal at the absolute
positions, an optional additive mask), the output product, the residual
(times `residual_alpha`), the FFN norm, ffn1, the activation (the
tanh-form GELU of `jax.nn.gelu`'s default, or ReLU), ffn2 and the
residual again.

The caches from `init_caches` are [L, 2, B, S_max, Hkv, D]. A call with
`time_step` None is a prefill at offset 0, with `time_step` t a step at
offset t; each layer's K/V are written IN PLACE into its slice of the
caches (the JAX package threads fresh caches through its scan), at the
offset clamped so that they fit, and the caches are returned beside the
output. Inputs and parameters are cast for AMP as the op
"fused_multi_transformer"; the caches keep their dtype.

The JAX package reads only whether `rotary_embs` is given (it builds its
own tables) and ignores `seq_lens`, `dropout_rate`, `trans_qkvw`, `nranks`
and `ring_id`: here `rotary_emb_dims` > 0 is the switch to the rotation,
and a `rotary_embs` tensor, `seq_lens`, or any other value of those
options raises. `pre_caches` and `beam_offset` raise, as in the JAX
package.
"""

from __future__ import annotations

import torch
from torch import nn

from .... import amp
from ....nn.functional._attn_math import masked_attention
from ..functional import _apply_rope_one, _rope_tables
from .fused_attention_layers import _Params
from ....nn.layer.layers import Layer, ParamAttr

__all__ = ["FusedMultiTransformer"]


def _attr_key(attr):
    if attr is None or attr is False:
        return attr
    a = ParamAttr._to_attr(attr)
    return (a.name, id(a.initializer), a.learning_rate, id(a.regularizer),
            a.trainable, a.need_clip)


def _stacked_attr(what, attrs, num_layers):
    """The one attribute of a parameter stacked over the layers: `attrs`
    itself, or the entry of a list of one a layer, which must all be the
    same (one [L, ...] tensor holds one initializer, rate and
    regularizer; the JAX package reads these lists only for their
    length)."""
    if not isinstance(attrs, (list, tuple)):
        return attrs
    if len(attrs) != num_layers:
        raise ValueError(f"{what}_attrs holds {len(attrs)} attributes for "
                         f"{num_layers} layers")
    if len({_attr_key(a) for a in attrs}) > 1:
        raise ValueError(
            f"{what}_attrs differ between layers; the layers' {what} is one "
            "stacked parameter, which takes one attribute")
    return attrs[0]


class FusedMultiTransformer(Layer):
    """The stack of `num_layers` decoder layers (↔ :28): pre-norm only,
    "layernorm" or "rmsnorm", "gelu" or "relu", grouped-query attention
    with `gqa_group_size` query heads a kv head."""

    def __init__(self, embed_dim, num_heads, dim_feedforward, dropout_rate=0.0,
                 activation="gelu", normalize_before=True, ln_scale_attrs=None,
                 ln_bias_attrs=None, qkv_weight_attrs=None, qkv_bias_attrs=None,
                 linear_weight_attrs=None, linear_bias_attrs=None,
                 ffn_ln_scale_attrs=None, ffn_ln_bias_attrs=None,
                 ffn1_weight_attrs=None, ffn1_bias_attrs=None,
                 ffn2_weight_attrs=None, ffn2_bias_attrs=None, epsilon=1e-5,
                 residual_alpha=1.0, num_layers=-1, nranks=1, trans_qkvw=True,
                 ring_id=-1, norm_type="layernorm", use_neox_rotary_style=False,
                 gqa_group_size=-1, name=None, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if not normalize_before:
            raise NotImplementedError("only pre-norm is supported (as in the "
                                      "JAX package)")
        if norm_type not in ("layernorm", "rmsnorm"):
            raise ValueError(f"unknown norm_type {norm_type!r}")
        if activation not in ("gelu", "relu"):
            raise ValueError(f"unsupported activation {activation!r}")
        attrs = dict(
            ln_scale=ln_scale_attrs, ln_bias=ln_bias_attrs,
            qkv_weight=qkv_weight_attrs, qkv_bias=qkv_bias_attrs,
            linear_weight=linear_weight_attrs,
            linear_bias=linear_bias_attrs, ffn_ln_scale=ffn_ln_scale_attrs,
            ffn_ln_bias=ffn_ln_bias_attrs, ffn1_weight=ffn1_weight_attrs,
            ffn1_bias=ffn1_bias_attrs, ffn2_weight=ffn2_weight_attrs,
            ffn2_bias=ffn2_bias_attrs)
        if num_layers <= 0 and isinstance(qkv_weight_attrs, (list, tuple)):
            num_layers = len(qkv_weight_attrs)
        if num_layers <= 0:
            raise ValueError("num_layers must be given (or a list of "
                             "qkv_weight_attrs, one a layer)")
        attrs = {k: _stacked_attr(k, a, num_layers) for k, a in attrs.items()}
        if (dropout_rate != 0.0 or not trans_qkvw or nranks != 1
                or ring_id != -1):
            raise NotImplementedError(
                "FusedMultiTransformer: dropout_rate, trans_qkvw, nranks and "
                "ring_id are not read (the JAX package ignores them); keep "
                "their defaults")
        self.num_layers = num_layers
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.kv_heads = (num_heads if gqa_group_size <= 0
                         else num_heads // gqa_group_size)
        self.head_dim = embed_dim // num_heads
        self.dim_feedforward = dim_feedforward
        self.activation = activation
        self.norm_type = norm_type
        self.epsilon = epsilon
        self.residual_alpha = residual_alpha
        self.use_neox_rotary_style = use_neox_rotary_style
        L, M, F = num_layers, embed_dim, dim_feedforward
        H, Hkv, D = self.num_heads, self.kv_heads, self.head_dim
        qkv_out = (H + 2 * Hkv) * D
        mk = _Params(generator, device, dtype)
        a = attrs
        self.ln_scale = mk([L, M], a["ln_scale"], kind="one")
        self.ln_bias = mk([L, M], a["ln_bias"], kind="bias")
        self.qkv_weight = mk([L, qkv_out, M], a["qkv_weight"])
        self.qkv_bias = mk([L, qkv_out], a["qkv_bias"], kind="bias")
        self.linear_weight = mk([L, H * D, M], a["linear_weight"])
        self.linear_bias = mk([L, M], a["linear_bias"], kind="bias")
        self.ffn_ln_scale = mk([L, M], a["ffn_ln_scale"], kind="one")
        self.ffn_ln_bias = mk([L, M], a["ffn_ln_bias"], kind="bias")
        self.ffn1_weight = mk([L, M, F], a["ffn1_weight"])
        self.ffn1_bias = mk([L, F], a["ffn1_bias"], kind="bias")
        self.ffn2_weight = mk([L, F, M], a["ffn2_weight"])
        self.ffn2_bias = mk([L, M], a["ffn2_bias"], kind="bias")

    def init_caches(self, batch_size, max_seq_len, dtype="float32"):
        """Zero KV caches [L, 2, B, S_max, Hkv, D] on the layer's device."""
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        return torch.zeros(self.num_layers, 2, batch_size, max_seq_len,
                           self.kv_heads, self.head_dim, dtype=dt,
                           device=self.ln_scale.device)

    def _norm(self, x, scale, bias):
        xf = x.float()
        if self.norm_type == "rmsnorm":
            y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True)
                                 + self.epsilon)
        else:
            mu = xf.mean(-1, keepdim=True)
            y = (xf - mu) * torch.rsqrt((xf - mu).square().mean(
                -1, keepdim=True) + self.epsilon)
        return (y * scale + bias).to(x.dtype)

    def forward(self, src, attn_mask=None, caches=None, pre_caches=None,
                rotary_embs=None, rotary_emb_dims=0, beam_offset=None,
                seq_lens=None, time_step=None):
        """src [B, S, M] -> [B, S, M]; with `caches`, (out, caches)."""
        if pre_caches is not None or beam_offset is not None:
            raise NotImplementedError("pre_caches and beam_offset are not "
                                      "supported (nor in the JAX package)")
        if rotary_embs is not None or seq_lens is not None:
            raise NotImplementedError(
                "FusedMultiTransformer builds its own rotary tables (theta "
                "10000, switched on by rotary_emb_dims > 0) and reads no "
                "seq_lens, as the JAX package, which ignores both tensors")
        (src, attn_mask, lns, lnb, wqkv, bqkv, wo, bo, flns, flnb, w1, b1, w2,
         b2) = amp.cast_inputs(
            "fused_multi_transformer", src, attn_mask, self.ln_scale,
            self.ln_bias, self.qkv_weight, self.qkv_bias, self.linear_weight,
            self.linear_bias, self.ffn_ln_scale, self.ffn_ln_bias,
            self.ffn1_weight, self.ffn1_bias, self.ffn2_weight,
            self.ffn2_bias)
        B, S, M = src.shape
        H, Hkv, D = self.num_heads, self.kv_heads, self.head_dim
        off = 0 if time_step is None else int(time_step)
        pos = off + torch.arange(S, device=src.device)
        if rotary_emb_dims > 0:
            cos, sin = _rope_tables(S, D, 10000.0, pos[None], src.device)
        act = (torch.relu if self.activation == "relu" else
               lambda t: torch.nn.functional.gelu(t, approximate="tanh"))
        alpha = self.residual_alpha
        h = src
        for i in range(self.num_layers):
            y = self._norm(h, lns[i], lnb[i])
            qkv = torch.einsum("bsm,om->bso", y, wqkv[i]) \
                + bqkv[i]
            q = qkv[..., :H * D].reshape(B, S, H, D)
            k = qkv[..., H * D:(H + Hkv) * D].reshape(B, S, Hkv, D)
            v = qkv[..., (H + Hkv) * D:].reshape(B, S, Hkv, D)
            if rotary_emb_dims > 0:
                q = _apply_rope_one(q, cos, sin, self.use_neox_rotary_style)
                k = _apply_rope_one(k, cos, sin, self.use_neox_rotary_style)
            if caches is not None:
                at = min(max(off, 0), caches.shape[3] - S)
                caches[i, 0, :, at:at + S] = k.to(caches.dtype)
                caches[i, 1, :, at:at + S] = v.to(caches.dtype)
                k, v = caches[i, 0], caches[i, 1]
            keep = (torch.arange(k.shape[1], device=src.device)[None, :]
                    <= pos[:, None])[None, None]
            attn = masked_attention(q, k, v, keep=keep, add_mask=attn_mask)
            o = torch.einsum("bso,om->bsm", attn.reshape(B, S, H * D).to(
                src.dtype), wo[i]) + bo[i]
            h = h * alpha + o
            y2 = self._norm(h, flns[i], flnb[i])
            f = act(torch.einsum("bsm,mf->bsf", y2, w1[i])
                    + b1[i])
            f = torch.einsum("bsf,fm->bsm", f, w2[i]) \
                + b2[i]
            h = h * alpha + f
        return (h, caches) if caches is not None else h
