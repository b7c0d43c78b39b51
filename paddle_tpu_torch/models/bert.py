"""BERT (↔ paddle_tpu/models/bert.py): `BertConfig`, `bert_base`,
`bert_tiny`, `BertEmbeddings`, `BertPooler`, `BertModel`,
`BertForPretraining`, `BertPretrainingCriterion` and
`BertForSequenceClassification`.

The encoder is `nn.TransformerEncoder` of post-LN `TransformerEncoderLayer`s
with GELU. `attention_mask` [B, S] (1 keep, 0 pad) becomes the additive f32
mask (1 - m) * -1e4 [B, 1, 1, S] (:104-110), a key-padding mask that needs
no gradient, so every attention takes the flash kernels' key-bias route on
the card. The masked-LM head gathers the `masked_positions` rows before the
tied [H, V] decode (:128-141), so the [B, S, V] logits are never made; the
decode is the word embedding's table, so the head has no weight of its
own. The criterion is the masked-LM cross entropy over the slots whose
label is not negative (-100 pads them) plus the NSP cross entropy
(:148-170), the log-softmax in the logits' dtype after the AMP cast, as
the reference's.

Each op casts its inputs for AMP under the JAX package's op name
("bert_cls_token", "bert_attn_mask", "mlm_gather", "mlm_decode",
"bert_pretraining_loss", "add"). Weights come from an explicit
`torch.Generator` seeded by `seed` with Paddle's default initializers;
cross-package tests copy the JAX weights with `convert.load_paddle_tpu_state`.
The hidden and attention dropouts (0.1 in `bert_base()`) draw from the
port's generators in training (`framework.random`); with attention
dropout the attention takes the composite route, in eval the flash
kernels' key-bias route.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import amp
from ..device import resolve_device
from ..nn import (Dropout, Embedding, LayerNorm, Linear, TransformerEncoder,
                  TransformerEncoderLayer)
from ..nn import functional as F
from ..nn.functional.loss import note_reduction
from ..nn.layer.layers import Layer

__all__ = ["BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "BertPretrainingCriterion",
           "bert_base", "bert_tiny"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 hidden_dropout_prob=0.1, attention_dropout_prob=0.1,
                 layer_norm_eps=1e-12):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_dropout_prob = attention_dropout_prob
        self.layer_norm_eps = layer_norm_eps


def bert_base(**kw):
    return BertConfig(**kw)


def bert_tiny(**kw):
    return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                      num_heads=4, intermediate_size=256,
                      max_position_embeddings=128, **kw)


def _add(a, b):
    return torch.add(*amp.cast_inputs("add", a, b))


class BertEmbeddings(Layer):
    def __init__(self, cfg: BertConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    device=device, dtype=dtype)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        B, S = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(S, device=input_ids.device).expand(B, S)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = _add(_add(self.word_embeddings(input_ids),
                      self.position_embeddings(position_ids)),
                 self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(h))


class BertPooler(Layer):
    def __init__(self, cfg: BertConfig, *, generator, device, dtype):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size,
                            generator=generator, device=device, dtype=dtype)

    def forward(self, hidden):
        (hidden,) = amp.cast_inputs("bert_cls_token", hidden)
        return F.tanh(self.dense(hidden[:, 0]))


class BertModel(Layer):
    """Encoder trunk; returns (sequence_output, pooled_output). `seed`
    seeds the generator the weights are drawn from (a model built inside a
    head shares the head's generator)."""

    def __init__(self, cfg: BertConfig, *, device=None, dtype=torch.float32,
                 seed=0, generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(int(seed))
        kw = dict(generator=gen, device=dev, dtype=dtype)
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg, **kw)
        layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation="gelu",
            attn_dropout=cfg.attention_dropout_prob,
            layer_norm_eps=cfg.layer_norm_eps, **kw)
        self.encoder = TransformerEncoder(layer, cfg.num_layers)
        self.pooler = BertPooler(cfg, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        mask = None
        if attention_mask is not None:
            (am,) = amp.cast_inputs("bert_attn_mask", attention_mask)
            # [B, S] keep-mask -> additive [B, 1, 1, S]
            mask = (1.0 - am.float())[:, None, None, :] * -1e4
        seq = self.encoder(h, mask)
        return seq, self.pooler(seq)


def _device_kw(device, dtype, seed):
    dev = resolve_device(device)
    return dict(device=dev, dtype=dtype,
                generator=torch.Generator(device=dev).manual_seed(int(seed)))


class BertForPretraining(Layer):
    """Masked-LM and NSP heads; forward returns (mlm_logits [B, M, V] at
    the masked positions, or [B, S, V] without them, nsp_logits [B, 2])."""

    def __init__(self, cfg: BertConfig, *, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        kw = _device_kw(device, dtype, seed)
        self.bert = BertModel(cfg, **kw)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.transform_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                        device=kw["device"], dtype=dtype)
        self.nsp_head = Linear(cfg.hidden_size, 2, **kw)
        self.config = cfg

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_positions=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_norm(F.gelu(self.transform(seq)))
        word_w = self.bert.embeddings.word_embeddings.weight  # tied decoder
        if masked_positions is not None:
            # gather the masked slots BEFORE the vocab matmul: [B, M, H] @ [H, V]
            (h,) = amp.cast_inputs("mlm_gather", h)
            idx = masked_positions.long()[..., None].expand(-1, -1, h.shape[-1])
            h = h.gather(1, idx)
        h, w = amp.cast_inputs("mlm_decode", h, word_w)
        dt = torch.promote_types(h.dtype, w.dtype)
        mlm_logits = torch.matmul(h.to(dt), w.to(dt).t())
        return mlm_logits, self.nsp_head(pooled)


class BertPretrainingCriterion(Layer):
    """Masked-LM cross entropy over the slots whose label is >= 0 (a mean
    over them; -100 pads a slot) plus the NSP cross entropy (a mean over
    the batch). It notes both reductions with their terms
    (`nn.functional.loss.note_reduction`): the masked-LM mean over
    sum(keep) slots and the NSP mean over B rows, so a step over a cut
    batch weighs each by its own global count and the loss is the global
    batch's, as the reference computes it over its global arrays
    (:154-165), whatever each rank's count of kept slots."""

    def __init__(self, cfg: BertConfig = None):
        super().__init__()

    def forward(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels):
        lg, ng = amp.cast_inputs("bert_pretraining_loss", mlm_logits,
                                 nsp_logits)
        ml, nl = mlm_labels.long(), nsp_labels.long()
        logp = torch.log_softmax(lg, dim=-1).gather(
            -1, ml.clamp(min=0)[..., None])[..., 0]
        keep = (ml >= 0).float()
        count = keep.sum()
        mlm = -(logp * keep).sum() / count.clamp(min=1.0)
        note_reduction("mean", count, count.clamp(min=1.0), mlm)
        nlogp = torch.log_softmax(ng, dim=-1).gather(-1, nl[..., None])[..., 0]
        nsp = -nlogp.mean()
        note_reduction("mean", float(nlogp.numel()),
                       float(max(nlogp.numel(), 1)), nsp)
        return mlm + nsp


class BertForSequenceClassification(Layer):
    def __init__(self, cfg: BertConfig, num_classes=2, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        kw = _device_kw(device, dtype, seed)
        self.bert = BertModel(cfg, **kw)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.classifier = Linear(cfg.hidden_size, num_classes, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))
