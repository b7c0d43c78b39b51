"""FusedMultiHeadAttention, FusedFeedForward, FusedTransformerEncoderLayer
and FusedBiasDropoutResidualLayerNorm (↔ paddle_tpu/incubate/nn/layer/
fused_attention_layers.py): parameter holders over the fused functionals
of `incubate.nn.functional.fused_attention_ops`.

Parameter names and shapes are the JAX package's, so
`convert.load_paddle_tpu_state` carries its weights over. Weights start
Xavier-uniform by the reference's fan rule (`nn.initializer._fans`), drawn
from the `generator` given, on `device`; biases at zero, LayerNorm scales
at one. Each goes through `nn.layer.layers.make_parameter`, so its
`*_attr` (a `ParamAttr`) applies and False drops it. The JAX package
marks the projections' tensor-parallel layout (dist_attr), inert on one
rank; cutting these layers over mp is ROADMAP item 1f, so `nranks` other
than 1 raises.
"""

from __future__ import annotations

import torch

from ..functional.fused_attention_ops import (
    fused_bias_dropout_residual_layer_norm, fused_feedforward,
    fused_multi_head_attention)
from ....nn import initializer as I
from ....nn.layer.layers import Layer, make_parameter

__all__ = ["FusedBiasDropoutResidualLayerNorm", "FusedFeedForward",
           "FusedMultiHeadAttention", "FusedTransformerEncoderLayer"]


class _Params:
    """Creates a layer's parameters: Xavier-uniform weights, zero biases,
    constant-one scales, each with its `*_attr` applied."""

    def __init__(self, generator, device, dtype):
        self.kw = dict(generator=generator, device=device)
        self.dtype = dtype

    def __call__(self, shape, attr=None, kind="weight"):
        return make_parameter(
            shape, attr, self.dtype, is_bias=kind == "bias",
            default_initializer=I.Constant(1.0) if kind == "one" else None,
            **self.kw)


def _one_rank(nranks):
    if nranks != 1:
        raise NotImplementedError(
            "fused layers cut over model parallelism (nranks > 1) are "
            "ROADMAP item 1f")


class FusedMultiHeadAttention(Layer):
    """↔ :35: qkv_weight [3, H, D, E] (or [E, 3E] under
    `transpose_qkv_wb`), qkv_bias, linear_weight [E, E], linear_bias, and
    the pre-LN (`normalize_before`) or post-LN scale and bias."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, transpose_qkv_wb=False, name=None, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} does not divide into "
                             f"{num_heads} heads")
        if need_weights:
            raise NotImplementedError("need_weights=True is not supported "
                                      "(nor in the JAX package)")
        _one_rank(nranks)
        mk = _Params(generator, device, dtype)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.normalize_before = normalize_before
        self.transpose_qkv_wb = transpose_qkv_wb
        self._epsilon = epsilon
        if transpose_qkv_wb:
            w_shape, b_shape = [embed_dim, 3 * embed_dim], [3 * embed_dim]
        else:
            w_shape = [3, num_heads, self.head_dim, embed_dim]
            b_shape = [3, num_heads, self.head_dim]
        self.qkv_weight = mk(w_shape, qkv_weight_attr)
        self.qkv_bias = mk(b_shape, qkv_bias_attr, "bias")
        self.linear_weight = mk([num_heads * self.head_dim, embed_dim],
                                linear_weight_attr)
        self.linear_bias = mk([embed_dim], linear_bias_attr, "bias")
        pre = normalize_before
        self.pre_ln_scale = mk([embed_dim], pre_ln_scale_attr, "one") if pre else None
        self.pre_ln_bias = mk([embed_dim], pre_ln_bias_attr, "bias") if pre else None
        self.ln_scale = None if pre else mk([embed_dim], ln_scale_attr, "one")
        self.ln_bias = None if pre else mk([embed_dim], ln_bias_attr, "bias")

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        return fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self._epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, cache_kv=cache,
            attn_mask=attn_mask, dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            ln_epsilon=self._epsilon, training=self.training,
            num_heads=self.num_heads,
            transpose_qkv_wb=self.transpose_qkv_wb)

    def extra_repr(self):
        return (f"embed_dim={self.embed_dim}, num_heads={self.num_heads}, "
                f"dropout_rate={self.dropout_rate}, "
                f"attn_dropout_rate={self.attn_dropout_rate}, "
                f"epsilon={self._epsilon}")


class FusedFeedForward(Layer):
    """↔ :128: _linear1_weight [d, F], _linear2_weight [F, d], their
    biases, and the pre-LN (ln1) or post-LN (ln2) scale and bias."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-05, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None, *, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        _one_rank(nranks)
        mk = _Params(generator, device, dtype)
        self._d_model = d_model
        self._dim_feedforward = dim_feedforward
        self._dropout_rate = dropout_rate
        self._act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                  else act_dropout_rate)
        self._act_method = activation
        self._normalize_before = normalize_before
        self._epsilon = epsilon
        self._linear1_weight = mk([d_model, dim_feedforward],
                                  linear1_weight_attr)
        self._linear1_bias = mk([dim_feedforward], linear1_bias_attr, "bias")
        self._linear2_weight = mk([dim_feedforward, d_model],
                                  linear2_weight_attr)
        self._linear2_bias = mk([d_model], linear2_bias_attr, "bias")
        pre = normalize_before
        self._ln1_scale = mk([d_model], ln1_scale_attr, "one") if pre else None
        self._ln1_bias = mk([d_model], ln1_bias_attr, "bias") if pre else None
        self._ln2_scale = None if pre else mk([d_model], ln2_scale_attr, "one")
        self._ln2_bias = None if pre else mk([d_model], ln2_bias_attr, "bias")

    def forward(self, src, cache=None):
        return fused_feedforward(
            src, self._linear1_weight, self._linear2_weight,
            linear1_bias=self._linear1_bias, linear2_bias=self._linear2_bias,
            ln1_scale=self._ln1_scale, ln1_bias=self._ln1_bias,
            ln2_scale=self._ln2_scale, ln2_bias=self._ln2_bias,
            dropout1_rate=self._act_dropout_rate,
            dropout2_rate=self._dropout_rate, activation=self._act_method,
            ln1_epsilon=self._epsilon, ln2_epsilon=self._epsilon,
            pre_layer_norm=self._normalize_before, training=self.training)

    def extra_repr(self):
        return (f"d_model={self._d_model}, "
                f"dim_feedforward={self._dim_feedforward}, "
                f"dropout_rate={self._dropout_rate}, "
                f"epsilon={self._epsilon}, activation={self._act_method}, "
                f"normalize_before={self._normalize_before}")


class FusedTransformerEncoderLayer(Layer):
    """↔ :204: `fused_attn` (FusedMultiHeadAttention) then `ffn`
    (FusedFeedForward); the attention and activation dropouts default to
    `dropout_rate`."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, name=None, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        attn_dropout_rate = (dropout_rate if attn_dropout_rate is None
                             else attn_dropout_rate)
        act_dropout_rate = (dropout_rate if act_dropout_rate is None
                            else act_dropout_rate)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.normalize_before = normalize_before
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before, qkv_weight_attr=weight_attr,
            qkv_bias_attr=bias_attr, linear_weight_attr=weight_attr,
            linear_bias_attr=bias_attr, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before,
            linear1_weight_attr=weight_attr, linear1_bias_attr=bias_attr,
            linear2_weight_attr=weight_attr, linear2_bias_attr=bias_attr,
            **kw)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            out, new_cache = self.fused_attn(src, attn_mask=src_mask,
                                             cache=cache)
            return self.ffn(out), new_cache
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedBiasDropoutResidualLayerNorm(Layer):
    """↔ :239: linear_bias, ln_scale and ln_bias [embed_dim]."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-05, name=None, *, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        mk = _Params(generator, device, dtype)
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self._epsilon = epsilon
        self.linear_bias = mk([embed_dim], bias_attr, "bias")
        self.ln_scale = mk([embed_dim], weight_attr, "one")
        self.ln_bias = mk([embed_dim], None, "bias")

    def forward(self, x, residual):
        return fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, dropout_rate=self.dropout_rate,
            ln_epsilon=self._epsilon, training=self.training)

    def extra_repr(self):
        return (f"embed_dim={self.embed_dim}, "
                f"dropout_rate={self.dropout_rate}, epsilon={self._epsilon}")
