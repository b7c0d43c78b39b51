"""Transformer layers (↔ paddle_tpu/nn/layer/transformer.py):
`MultiHeadAttention`, `TransformerEncoderLayer` / `TransformerEncoder`,
`TransformerDecoderLayer` / `TransformerDecoder` and `Transformer`.

Attention goes through `nn.functional.scaled_dot_product_attention` with
the mask as given (:69-97): an additive or bool [B|1, 1, 1, Skv] mask that
needs no gradient (BERT's key-padding mask) rides the flash kernels as a
per-key bias; any other mask takes the exact composite. q, k and v are
split [B, S, E] -> [B, S, H, E / H] and the output joined back before
`out_proj`. `cache` is the reference's: a `MultiHeadAttention.Cache`
(k, v [B, S, H, D]) gets this call's k and v appended along S and is
returned beside the output; a `StaticCache` (the decoder's projected
memory) is read as it is. `gen_cache` makes either. In training the
attention's dropout (on the probabilities) takes the composite route and
the layers' dropouts draw from the port's generators (`framework.random`);
in eval mode no dropout applies and the attention takes the kernel route
whatever its dropout, where the JAX package's takes its composite at a
dropout above 0 (the two agree but on a row that sees no key).

Every Linear draws its weight from the `generator` given (Paddle's
Xavier-uniform), on `device`. `weight_attr` / `bias_attr` (a `ParamAttr`)
go to every Linear of the layer, as in the reference; `bias_attr=False`
drops the biases.
Encoder and decoder layers are copied `num_layers` times, as the
reference's (copy.deepcopy of the first), so every layer starts from the
first one's weights.
"""

from __future__ import annotations

import collections
import copy

import torch
from torch import nn

from ... import amp
from ...device import resolve_device
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm
from .layers import Layer

__all__ = ["MultiHeadAttention", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]


def _linear_kw(weight_attr, bias_attr, generator, device, dtype):
    return dict(weight_attr=weight_attr, bias_attr=bias_attr,
                generator=generator, device=device, dtype=dtype)


def _add(a, b):
    return torch.add(*amp.cast_inputs("add", a, b))


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None,
                 need_weights=False, weight_attr=None, bias_attr=None, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} does not divide into "
                             f"{num_heads} heads")
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.dropout = dropout
        self.need_weights = need_weights
        kw = _linear_kw(weight_attr, bias_attr, generator, device, dtype)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x):
        B, S, _ = x.shape
        return x.reshape(B, S, self.num_heads, self.head_dim)

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """A StaticCache of the projected key/value (`type=StaticCache`),
        else an empty Cache [B, 0, H, D] in f32 that each call extends."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        empty = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim,
                            device=key.device)
        return self.Cache(empty, empty.clone())

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
            out_cache = cache
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat(amp.cast_inputs("concat", cache.k, k), dim=1)
                v = torch.cat(amp.cast_inputs("concat", cache.v, v), dim=1)
                out_cache = self.Cache(k, v)
            else:
                out_cache = None
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            is_causal=False, training=self.training)
        B, S = out.shape[0], out.shape[1]
        out = self.out_proj(out.reshape(B, S, self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(None)
        if cache is not None:
            outs.append(out_cache)
        return out if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = _linear_kw(weight_attr, bias_attr, generator, device, dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = activation

    def _act(self, x):
        return getattr(F, self.activation)(x)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, incremental_cache = self.self_attn(src, src, src, src_mask,
                                                    cache)
        src = _add(residual, self.dropout1(src))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self._act(self.linear1(src))))
        src = _add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, incremental_cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = _linear_kw(weight_attr, bias_attr, generator, device, dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        norm_kw = dict(device=device, dtype=dtype)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **norm_kw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **norm_kw)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, **norm_kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = activation

    def _act(self, x):
        return getattr(F, self.activation)(x)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = _add(residual, self.dropout1(tgt))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, cache[1])
        tgt = _add(residual, self.dropout2(tgt))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self._act(self.linear1(tgt))))
        tgt = _add(residual, self.dropout3(tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache, static_cache))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask, memory_mask,
                                        cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        kw = dict(generator=generator, device=device, dtype=dtype)
        norm_kw = dict(device=device, dtype=dtype)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            enc_norm = LayerNorm(d_model, **norm_kw) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            dec_norm = LayerNorm(d_model, **norm_kw) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """[length, length] additive causal mask: -inf above the diagonal."""
        m = torch.full((length, length), float("-inf"),
                       device=resolve_device(device))
        return torch.triu(m, diagonal=1)
