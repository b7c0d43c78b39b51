"""LLaMA family (↔ paddle_tpu/models/llama.py): the GPT decoder of
`models.gpt` with RMSNorm, SwiGLU, RoPE, grouped-query attention and an
untied LM head."""

from __future__ import annotations

from .gpt import GPTConfig, GPTForCausalLM, GPTModel

__all__ = [
    "LlamaConfig", "LlamaModel", "LlamaForCausalLM",
    "llama_tiny", "llama_7b", "llama_13b",
]


def LlamaConfig(**kw):
    base = dict(
        vocab_size=32000,
        norm_type="rmsnorm",
        activation="swiglu",
        use_rope=True,
        tie_word_embeddings=False,
        layer_norm_epsilon=1e-6,
        max_position_embeddings=4096,
    )
    base.update(kw)
    return GPTConfig(**base)


LlamaModel = GPTModel
LlamaForCausalLM = GPTForCausalLM


def llama_tiny(**kw):
    return LlamaConfig(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                       num_kv_heads=2, max_position_embeddings=128, **kw)


def llama_7b(**kw):
    return LlamaConfig(hidden_size=4096, num_layers=32, num_heads=32,
                       intermediate_size=11008, **kw)


def llama_13b(**kw):
    return LlamaConfig(hidden_size=5120, num_layers=40, num_heads=40,
                       intermediate_size=13824, **kw)
