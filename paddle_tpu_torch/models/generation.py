"""Autoregressive generation for the causal-LM models
(↔ paddle_tpu/models/generation.py).

`generate` runs one prefill over the prompt and then one decode step per
new token against a static-capacity dense cache written in place, greedy
or sampled (temperature, top-k, top-p). As in the JAX package the caches
are float32 whatever the model's dtype; a decode step's [1, 1, 1, total]
mask is a key-padding mask, so it runs the flash forward kernel on the
card, which, as the JAX `flash_attention_fwd` does, casts the caches to
the query's dtype first. Sampling draws from one `torch.Generator` seeded
with `seed`: the JAX package's `jax.random` keys give other numbers, so
sampled tokens do not match it; greedy tokens do.
"""

from __future__ import annotations

import torch

__all__ = ["generate"]

NEG_INF = -1e30


def _sample(logits, temperature, top_k, top_p, generator):
    """logits [B, V] -> token ids [B] (long), on the logits' device."""
    if temperature == 0.0:
        return torch.argmax(logits, -1)
    logits = logits.float() / temperature
    V = logits.shape[-1]
    if top_k and 0 < top_k < V:
        kth = torch.sort(logits, -1).values[:, V - top_k][:, None]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF),
                             logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, -1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, -1), -1)
        # keep the smallest set whose cumulative probability reaches top_p
        cutoff_idx = (cum < top_p).sum(-1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, torch.full_like(logits, NEG_INF),
                             logits)
    probs = torch.softmax(logits, -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=32, temperature=1.0, top_k=0,
             top_p=1.0, eos_token_id=None, use_cache=True, seed=None):
    """Greedy (`temperature=0`) or sampled decoding. input_ids: a tensor or
    array [B, S_prompt]. Returns a long tensor [B, S_prompt + n] on the
    model's device; generation stops early once every row has emitted
    `eos_token_id` (rows that already did keep emitting it)."""
    dev = model.gpt.embed_tokens.weight.device
    ids = torch.as_tensor(input_ids).to(device=dev, dtype=torch.long)
    B, S0 = ids.shape
    total = S0 + max_new_tokens
    was_training = model.training
    model.eval()
    gen = torch.Generator(device=dev).manual_seed(
        0 if seed is None or temperature == 0.0 else int(seed))

    def pick(logits):
        return _sample(logits[:, -1], temperature, top_k, top_p, gen)

    try:
        if not use_cache:
            # no cache: run the whole growing sequence every step
            seq = ids
            for _ in range(max_new_tokens):
                nxt = pick(model(seq))
                seq = torch.cat([seq, nxt[:, None]], 1)
                if eos_token_id is not None and bool(
                        (nxt == eos_token_id).all()):
                    break
            return seq
        caches = model.init_kv_caches(B, total, dtype=torch.float32)
        pos = torch.arange(S0, device=dev)[None].expand(B, S0)
        logits, _ = model(ids, pos, caches, 0)
        nxt = pick(logits)
        out = [ids, nxt[:, None]]
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        if eos_token_id is not None:
            finished |= nxt == eos_token_id
        for step in range(1, max_new_tokens):
            if eos_token_id is not None and bool(finished.all()):
                break
            off = S0 + step - 1
            pos = torch.full((B, 1), off, dtype=torch.long, device=dev)
            logits, _ = model(nxt[:, None], pos, caches, off)
            nxt = pick(logits)
            if eos_token_id is not None:
                nxt = torch.where(finished, torch.full_like(nxt, eos_token_id),
                                  nxt)
                finished |= nxt == eos_token_id
            out.append(nxt[:, None])
        return torch.cat(out, 1)
    finally:
        if was_training:
            model.train()
