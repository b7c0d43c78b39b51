"""GPT-style decoder LM (↔ paddle_tpu/models/gpt.py), for serving and
training. One config drives both forms, as in the JAX package:

- GPT-3: pre-LN blocks of LayerNorm -> QKV (with biases) -> causal
  attention -> out-projection -> LayerNorm -> exact-erf GELU MLP, learned
  positions, a tied LM head (logits = h @ W_emb.T);
- LLaMA (`models.llama`): RMSNorm (`norm_type="rmsnorm"`), no biases,
  RoPE on q and k right after the projections (`use_rope`, through incubate
  `fused_rotary_position_embedding`, hence the fused-RoPE kernel on the
  card), grouped-query attention (`num_kv_heads`), a SwiGLU MLP
  (`gate_proj`, `up_proj`, `down_proj`), no position table, and an untied
  `lm_head` [hidden, vocab].

Parameter names and layouts equal the JAX package's, so
`paddle_tpu_torch.convert.load_paddle_tpu_state` moves its weights over as
they are.

Attention has three branches:

- no cache (the training forward and full-sequence inference): causal
  `scaled_dot_product_attention`, which goes to the flash-attention kernels
  on the card, or with `attn_variant="flashmask"` `flashmask_attention`
  (the flashmask kernels) under `attn_startend_row_indices`, or when none
  are given the trivial index full((B, 1, S, 1), S) that masks nothing
  beyond causal; with `use_recompute` and the model in training mode each
  decoder layer runs under `fleet.recompute` (JAX `gpt.py:458-471`);
- dense cache [B, S_max, Hkv, D] with an offset: the step's K/V are written
  at the offset and a bool mask feeds `scaled_dot_product_attention`. A
  scalar offset (the prefill, `generate`) writes every row at one offset;
  a vector offset [B] (the continuous-batching decode, one token per row)
  writes each row at its own length, and its [B, 1, 1, S_max] mask is a
  key-padding mask, so that decode runs the flash forward kernel;
- paged cache [n_pages, Hkv, page_size, D] with block tables and per-row
  lengths (decode, one token per row): `paged_kv_write` appends the step's
  K/V, then `paged_decode_attention` (the CUDA kernel on the card) attends
  over lengths + 1 tokens. A 4-tuple cache (k, v, k_scale, v_scale) is the
  int8 layout: `paged_kv_write_q8` appends under a running abs-max and the
  int8 kernel dequantizes per page.

The cached branches write the caches IN PLACE (the JAX package returns
fresh arrays): a serving process's KV pages are its largest allocation, and
a copy per layer per step would double them. They serve inference only.

Every op casts its inputs for AMP under the JAX package's op names
(`paddle_tpu_torch.amp`), the tied head as "lm_head_tied".

Weights are drawn from an explicit `torch.Generator` seeded by `seed`, as
N(0, initializer_range) like the JAX package's `_init_attr`; the two
frameworks' generators give different numbers, so cross-package tests copy
weights with `load_paddle_tpu_state`.

`GPTForCausalLM.generate` is `models.generation.generate`.

With RoPE every branch rotates q and k at the positions it is given:
`position_ids` (the engines pass each row's cache length at decode, and
0..Sp-1 at a bucket-padded prefill, so a prompt rotates at its true
positions), else 0..S-1, or the scalar cache offset onwards. K is cached
after the rotation, as in the JAX package, so cached pages (prefix-shared
or restored after a preemption) are never rotated again.

Not ported yet (each raises NotImplementedError naming its ROADMAP queue A
item): ring / context parallelism (1d), sequence parallelism (1b) and
dropout (4).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from .. import amp
from ..device import resolve_device
from ..distributed.fleet.layers.mpu.mp_layers import (
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ..distributed.fleet.recompute import recompute
from ..incubate.nn.functional import fused_rotary_position_embedding, swiglu
from ..nn import Embedding, LayerNorm, RMSNorm
from ..nn import functional as F
from ..ops.decode_attention import (
    paged_decode_attention,
    paged_kv_write,
    paged_kv_write_q8,
)

__all__ = [
    "GPTConfig",
    "GPTModel",
    "GPTForCausalLM",
    "GPTPretrainingCriterion",
    "gpt3_tiny",
    "gpt3_125m",
    "gpt3_350m",
    "gpt3_1p3b",
    "gpt3_6p7b",
    "gpt3_13b",
]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int | None = None  # GQA; None = MHA
    intermediate_size: int | None = None  # None -> 4h (gelu) or 8h/3 rounded (swiglu)
    max_position_embeddings: int = 2048
    norm_type: str = "layernorm"  # "layernorm" | "rmsnorm"
    activation: str = "gelu"  # "gelu" | "swiglu"
    use_rope: bool = False  # False -> learned position embeddings
    rope_theta: float = 10000.0
    use_neox_rotary_style: bool = True
    tie_word_embeddings: bool = True
    hidden_dropout_prob: float = 0.0
    attention_dropout_prob: float = 0.0
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    sequence_parallel: bool = False
    use_recompute: bool = False
    attn_variant: str = "flash"
    context_parallel: bool = False

    @property
    def kv_heads(self):
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self):
        if self.intermediate_size is not None:
            return self.intermediate_size
        if self.activation == "swiglu":
            # LLaMA sizing: 2/3 * 4h rounded up to a multiple of 256
            return int(math.ceil(8 * self.hidden_size / 3 / 256) * 256)
        return 4 * self.hidden_size

    def num_params(self, include_embeddings=True):
        """Parameters of the model as the JAX package counts them (its
        `GPTConfig.num_params`, which the MFU reads): attention, MLP and two
        norm weights per layer, the final norm weight, and with the
        embeddings the token table, the position table (without RoPE) and
        the untied head."""
        h, L, V = self.hidden_size, self.num_layers, self.vocab_size
        d = self.head_dim
        attn = h * (self.num_heads * d) + 2 * h * (self.kv_heads * d) + (self.num_heads * d) * h
        if self.activation == "swiglu":
            mlp = 3 * h * self.ffn_size
        else:
            mlp = 2 * h * self.ffn_size
        per_layer = attn + mlp + 2 * h
        total = L * per_layer + h
        if include_embeddings:
            total += V * h
            if not self.use_rope:
                total += self.max_position_embeddings * h
            if not self.tie_word_embeddings:
                total += V * h
        return total


def _check_supported(cfg: GPTConfig):
    """Raise on the branches of the JAX model the port does not have yet,
    and on unknown options."""
    if cfg.norm_type not in ("layernorm", "rmsnorm"):
        raise ValueError(f"unknown norm_type {cfg.norm_type!r}")
    if cfg.activation not in ("gelu", "swiglu"):
        raise ValueError(f"unknown activation {cfg.activation!r}")
    if cfg.attn_variant not in ("flash", "flashmask"):
        raise ValueError(f"unknown attn_variant {cfg.attn_variant!r}")
    if cfg.context_parallel:
        raise NotImplementedError(
            "context parallelism (ring attention) is ported with ROADMAP "
            "queue A item 1d")
    if cfg.sequence_parallel:
        raise NotImplementedError(
            "sequence parallelism is ported with ROADMAP queue A item 1b")
    if cfg.hidden_dropout_prob or cfg.attention_dropout_prob:
        raise NotImplementedError(
            "dropout (explicit generators, Philox in the attention kernels) "
            "is ported with ROADMAP queue A item 4")


def _dyn_update(buf, new, off):
    """Write `new` [B, S, H, D] into the dense cache `buf` at sequence
    offset `off`, in place. A scalar offset writes every row there, clamped
    so the update fits (as lax.dynamic_update_slice); a vector offset [B]
    writes row b's single token (S == 1) at off[b], the continuous-batching
    decode where each slot appends at its own length."""
    if torch.is_tensor(off) and off.dim() > 0:
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, off.long()] = new[:, 0].to(buf.dtype)
        return buf
    S = new.shape[1]
    o = min(max(int(off), 0), buf.shape[1] - S)
    buf[:, o:o + S] = new.to(buf.dtype)
    return buf


def _decode_mask(s_max, off, s_new, device):
    """Bool mask: position i (absolute off + i) attends to j <= off + i.
    A scalar offset gives [1, 1, s_new, s_max]; a vector offset [B] gives
    [B, 1, s_new, s_max] (per-slot lengths)."""
    cols = torch.arange(s_max, device=device)
    steps = torch.arange(s_new, device=device)
    if torch.is_tensor(off) and off.dim() > 0:
        rows = off.to(device).long()[:, None, None] + steps[None, :, None]
        return (cols[None, None, :] <= rows)[:, None]
    rows = int(off) + steps[:, None]
    return (cols[None, :] <= rows)[None, None]


def _paged_update(buf, new, tables, lengths):
    """Write this step's `new` [B, 1, H, D] K/V rows into the paged cache
    `buf` [n_pages, Hkv, ps, D] at each row's next slot (decode is S == 1)."""
    return paged_kv_write(buf, new[:, 0], tables, lengths)


def _paged_attend(q, kc, vc, tables, lengths, kv_scales=None):
    """q [B, 1, H, D] against the paged cache; `lengths` counts tokens
    present BEFORE this step and the step's K/V were just written, so the
    kernel sees lengths + 1 valid tokens. `kv_scales` (k_scale, v_scale)
    marks int8 pages."""
    B, S, H, D = q.shape
    o = paged_decode_attention(q.reshape(B, H, D), kc, vc, tables,
                               (lengths + 1).to(torch.int32),
                               kv_scales=kv_scales)
    return o.reshape(B, S, H, D)


def _paged_update_q8(buf, scales, new, tables, lengths):
    """The int8 append: write this step's `new` [B, 1, H, D] K/V rows into
    the int8 paged cache, growing each target page's running abs-max scale
    where needed. Returns (cache, scales), both updated in place."""
    return paged_kv_write_q8(buf, scales, new[:, 0], tables, lengths)


def _make_norm(config: GPTConfig, device, dtype):
    if config.norm_type == "rmsnorm":
        return RMSNorm(config.hidden_size, epsilon=config.layer_norm_epsilon,
                       device=device, dtype=dtype)
    return LayerNorm(config.hidden_size, epsilon=config.layer_norm_epsilon,
                     device=device, dtype=dtype)


def _linear_kw(config: GPTConfig, generator, device, dtype):
    """Keyword arguments of the projections: N(0, initializer_range)
    weights, and biases only in the GPT-3 form (LLaMA has none)."""
    return dict(weight_std=config.initializer_range, generator=generator,
                device=device, dtype=dtype,
                has_bias=config.norm_type == "layernorm")


class GPTAttention(nn.Module):
    """Multi-head / grouped-query causal self-attention."""

    def __init__(self, config: GPTConfig, *, generator, device, dtype):
        super().__init__()
        self.config = config
        h, d = config.hidden_size, config.head_dim
        kw = _linear_kw(config, generator, device, dtype)
        self.q_proj = ColumnParallelLinear(h, config.num_heads * d, gather_output=False, **kw)
        self.k_proj = ColumnParallelLinear(h, config.kv_heads * d, gather_output=False, **kw)
        self.v_proj = ColumnParallelLinear(h, config.kv_heads * d, gather_output=False, **kw)
        self.out_proj = RowParallelLinear(config.num_heads * d, h, input_is_parallel=True, **kw)

    def forward(self, x, position_ids=None, cache=None, cache_offset=None,
                startend_row_indices=None, block_tables=None):
        cfg = self.config
        B, S = x.shape[0], x.shape[1]
        q = self.q_proj(x).reshape(B, S, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(x).reshape(B, S, cfg.kv_heads, cfg.head_dim)
        v = self.v_proj(x).reshape(B, S, cfg.kv_heads, cfg.head_dim)
        if cfg.use_rope:
            q, k, _ = fused_rotary_position_embedding(
                q, k, position_ids=position_ids,
                use_neox_rotary_style=cfg.use_neox_rotary_style,
                rotary_emb_base=cfg.rope_theta)
        new_cache = None
        if cache is not None and block_tables is not None and len(cache) == 4:
            k_all, k_sc = _paged_update_q8(cache[0], cache[2], k,
                                           block_tables, cache_offset)
            v_all, v_sc = _paged_update_q8(cache[1], cache[3], v,
                                           block_tables, cache_offset)
            new_cache = (k_all, v_all, k_sc, v_sc)
            out = _paged_attend(q, k_all, v_all, block_tables, cache_offset,
                                kv_scales=(k_sc, v_sc))
        elif cache is not None and block_tables is not None:
            k_all = _paged_update(cache[0], k, block_tables, cache_offset)
            v_all = _paged_update(cache[1], v, block_tables, cache_offset)
            new_cache = (k_all, v_all)
            out = _paged_attend(q, k_all, v_all, block_tables, cache_offset)
        elif cache is not None:
            k_all = _dyn_update(cache[0], k, cache_offset)
            v_all = _dyn_update(cache[1], v, cache_offset)
            new_cache = (k_all, v_all)
            mask = _decode_mask(k_all.shape[1], cache_offset, S, x.device)
            out = F.scaled_dot_product_attention(
                q, k_all, v_all, attn_mask=mask, is_causal=False,
                training=self.training)
        elif cfg.attn_variant == "flashmask":
            idx = startend_row_indices
            if idx is None:
                # the trivial index (plain causal), so the flashmask kernels
                # run even without document boundaries
                idx = torch.full((B, 1, S, 1), S, dtype=torch.int32,
                                 device=x.device)
            out = F.flashmask_attention(q, k, v, startend_row_indices=idx,
                                        causal=True)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, training=self.training)
        out = self.out_proj(out.reshape(B, S, cfg.num_heads * cfg.head_dim))
        if cache is not None:
            return out, new_cache
        return out


class GPTMLP(nn.Module):
    """FFN: fc1 -> exact-erf GELU -> fc2, or with `activation="swiglu"`
    down_proj(swiglu(gate_proj(x), up_proj(x)))."""

    def __init__(self, config: GPTConfig, *, generator, device, dtype):
        super().__init__()
        h, f = config.hidden_size, config.ffn_size
        kw = _linear_kw(config, generator, device, dtype)
        self.activation = config.activation
        if config.activation == "swiglu":
            self.gate_proj = ColumnParallelLinear(h, f, gather_output=False, **kw)
            self.up_proj = ColumnParallelLinear(h, f, gather_output=False, **kw)
            self.down_proj = RowParallelLinear(f, h, input_is_parallel=True, **kw)
        else:
            self.fc1 = ColumnParallelLinear(h, f, gather_output=False, **kw)
            self.fc2 = RowParallelLinear(f, h, input_is_parallel=True, **kw)

    def forward(self, x):
        if self.activation == "swiglu":
            return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))
        return self.fc2(F.gelu(self.fc1(x)))


class GPTDecoderLayer(nn.Module):
    """Pre-norm decoder block."""

    def __init__(self, config: GPTConfig, *, generator, device, dtype):
        super().__init__()
        self.config = config
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.input_layernorm = _make_norm(config, device, dtype)
        self.self_attn = GPTAttention(config, **kw)
        self.post_attention_layernorm = _make_norm(config, device, dtype)
        self.mlp = GPTMLP(config, **kw)

    def forward(self, x, position_ids=None, cache=None, cache_offset=None,
                startend_row_indices=None, block_tables=None):
        h = self.input_layernorm(x)
        if cache is not None:
            h, new_cache = self.self_attn(h, position_ids, cache, cache_offset,
                                          block_tables=block_tables)
        else:
            h = self.self_attn(h, position_ids,
                               startend_row_indices=startend_row_indices)
            new_cache = None
        x = torch.add(*amp.cast_inputs("add", x, h))
        h = self.mlp(self.post_attention_layernorm(x))
        x = torch.add(*amp.cast_inputs("add", x, h))
        if cache is not None:
            return x, new_cache
        return x


class GPTModel(nn.Module):
    """Embeddings + decoder stack + final norm."""

    def __init__(self, config: GPTConfig, *, generator, device, dtype):
        super().__init__()
        self.config = config
        kw = dict(generator=generator, device=device, dtype=dtype)
        std = config.initializer_range
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, weight_std=std, **kw)
        if not config.use_rope:
            self.embed_positions = Embedding(
                config.max_position_embeddings, config.hidden_size,
                weight_std=std, **kw)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(config, **kw) for _ in range(config.num_layers)])
        self.final_norm = _make_norm(config, device, dtype)

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_offset=None, attn_startend_row_indices=None,
                block_tables=None):
        if caches is not None and attn_startend_row_indices is not None:
            raise ValueError(
                "attn_startend_row_indices is not supported together with KV "
                "caches: the cached decode path would silently attend across "
                "document boundaries")
        B, S = input_ids.shape[0], input_ids.shape[1]
        dev = input_ids.device
        if position_ids is None:
            start = 0
            if caches is not None and cache_offset is not None:
                # decode default: absolute positions start at the (scalar)
                # offset, as in the JAX package
                start = int(cache_offset)
            position_ids = (start + torch.arange(S, device=dev))[None].expand(B, S)
        h = self.embed_tokens(input_ids)
        if not self.config.use_rope:
            h = torch.add(*amp.cast_inputs("add", h,
                                           self.embed_positions(position_ids)))
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            if caches is not None:
                h, nc = layer(h, position_ids, caches[i], cache_offset,
                              block_tables=block_tables)
                new_caches.append(nc)
            elif self.config.use_recompute and self.training:
                h = recompute(layer, h, position_ids,
                              startend_row_indices=attn_startend_row_indices)
            else:
                h = layer(h, position_ids,
                          startend_row_indices=attn_startend_row_indices)
        h = self.final_norm(h)
        if caches is not None:
            return h, new_caches
        return h


class GPTForCausalLM(nn.Module):
    """LM head on top of GPTModel: tied to the token embedding, or with
    `tie_word_embeddings=False` (LLaMA) its own `lm_head` linear
    [hidden, vocab] without bias.

    `device` defaults to `cuda` (raises without a GPU); pass `device="cpu"`
    for the plain PyTorch path. `dtype` is the parameter (and compute) type.
    `seed` seeds the explicit generator the weights are drawn from."""

    def __init__(self, config: GPTConfig, *, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        _check_supported(config)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.config = config
        self.gpt = GPTModel(config, generator=gen, device=dev, dtype=dtype)
        if not config.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                gather_output=False, weight_std=config.initializer_range,
                generator=gen, device=dev, dtype=dtype)

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_offset=None, attn_startend_row_indices=None,
                block_tables=None):
        out = self.gpt(input_ids, position_ids, caches, cache_offset,
                       attn_startend_row_indices=attn_startend_row_indices,
                       block_tables=block_tables)
        h, new_caches = out if caches is not None else (out, None)
        if self.config.tie_word_embeddings:
            h, w = amp.cast_inputs("lm_head_tied", h,
                                   self.gpt.embed_tokens.weight)
            logits = torch.matmul(h, w.t())
        else:
            logits = self.lm_head(h)
        if caches is not None:
            return logits, new_caches
        return logits

    def generate(self, input_ids, **kwargs):
        """Greedy or sampled decoding (`models.generation.generate`)."""
        from .generation import generate

        return generate(self, input_ids, **kwargs)

    def init_kv_caches(self, batch_size, max_seq_len, dtype=None):
        """Static-capacity dense decode caches, one (k, v) pair per layer,
        zeroed, on the model's device (dtype defaults to the model's)."""
        cfg = self.config
        w = self.gpt.embed_tokens.weight
        shape = (batch_size, max_seq_len, cfg.kv_heads, cfg.head_dim)
        dt = w.dtype if dtype is None else dtype
        return [(torch.zeros(shape, device=w.device, dtype=dt),
                 torch.zeros(shape, device=w.device, dtype=dt))
                for _ in range(cfg.num_layers)]


class GPTPretrainingCriterion(nn.Module):
    """Masked next-token cross entropy (↔ gpt.py:525-537): the mean of the
    per-token losses, or their mean over `loss_mask` when one is given."""

    def __init__(self, config: GPTConfig = None):
        super().__init__()
        self.ce = ParallelCrossEntropy()

    def forward(self, logits, labels, loss_mask=None):
        losses = self.ce(logits, labels)  # [B, S]
        if loss_mask is not None:
            m = loss_mask.reshape(losses.shape).float()
            return (losses.float() * m).sum() / m.sum().clamp(min=1.0)
        return losses.mean()


# ----------------------------------------------------------------------- #
# presets (sizes per GPT-3 paper table 2.1, as in the JAX package)
# ----------------------------------------------------------------------- #


def gpt3_tiny(**kw):
    return GPTConfig(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                     max_position_embeddings=128, **kw)


def gpt3_125m(**kw):
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt3_350m(**kw):
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)


def gpt3_1p3b(**kw):
    return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16, **kw)


def gpt3_6p7b(**kw):
    return GPTConfig(hidden_size=4096, num_layers=32, num_heads=32, **kw)


def gpt3_13b(**kw):
    return GPTConfig(hidden_size=5120, num_layers=40, num_heads=40, **kw)

