"""Request type, the shared scaffolding of the serving engines, and the
dense continuous-batching engine (↔ paddle_tpu/inference/serving.py).

`_ServingEngineBase` holds what every engine shares: the optional
weight-only int8 convert (`serve_w8`), the batch-1 bucketed prefill,
per-request sampling and the SLO bookkeeping. Prompts pad to power-of-two
length buckets as in the JAX package, so prefill shapes match it (nothing
is compiled here; the bucket only fixes the shapes).

Sampling: each request owns a `torch.Generator` seeded from (engine seed,
arrival index), so its sampled tokens depend only on the seed, its arrival
order and its logits, never on slot assignment, batch composition or
preemption timing. The generators of PyTorch and JAX differ, so sampled
tokens do not match the JAX engine's; greedy tokens do.

Two engines share it: `ContinuousBatchingEngine` here, over a slotted
dense cache that reserves `max_seq_len` rows per slot, and
`inference.paged.PagedServingEngine`, over a block pool of pages.
"""

from __future__ import annotations

import collections
import itertools
import time

import numpy as np
import torch

from .slo import serving_metrics

__all__ = ["ContinuousBatchingEngine", "GenerationRequest"]


class GenerationRequest:
    """One prompt in flight."""

    _ids = itertools.count()

    def __init__(self, prompt_ids, max_new_tokens=32, temperature=0.0,
                 eos_token_id=None, priority=0):
        self.req_id = next(self._ids)
        self.prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_token_id = eos_token_id
        # scheduling weight: higher survives preemption longer
        self.priority = int(priority)
        self.generated: list[int] = []
        self.done = False
        # True iff the engine retired this request because the KV cache hit
        # max_seq_len before max_new_tokens/EOS
        self.truncated = False
        self._t_arrival = time.perf_counter()
        self._t_first: float | None = None
        self._generator: torch.Generator | None = None  # set by the engine

    @property
    def output_ids(self):
        return np.concatenate([self.prompt,
                               np.asarray(self.generated, np.int32)])


def _bucket(n):
    b = 16
    while b < n:
        b *= 2
    return b


def _request_seed(seed: int, arrival: int) -> int:
    """Seed of one request's sampling generator, a function of the engine
    seed and the request's arrival index only."""
    state = np.random.SeedSequence([int(seed), int(arrival)]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(1))  # within torch's int64 seed range


class _ServingEngineBase:
    """Model, bucketed prefill, sampling and SLO bookkeeping shared by the
    engines. Subclasses own the KV representation and admission."""

    engine_label = "base"

    def __init__(self, model, max_batch_size=8, max_seq_len=512, seed=0,
                 serve_w8=False):
        model.eval()
        # the engine runs where the model's parameters live, and the KV
        # cache takes the model's floating dtype (a bf16 model gets bf16
        # pages), read before any int8 convert
        params = [p for p in model.parameters() if p.is_floating_point()]
        self.device = params[0].device
        self.kv_dtype = params[0].dtype
        # weight-only int8 serving: the model's Linears become
        # QuantizedLinear, in place and idempotently (build a fresh model
        # per engine when comparing)
        self.serve_w8 = bool(serve_w8)
        if self.serve_w8:
            from ..quantization import ptq_convert_for_serving

            ptq_convert_for_serving(model)
        self.model = model
        self.cfg = model.config
        self.B = int(max_batch_size)
        self.S = int(max_seq_len)
        self.last_logits = None  # last decode tick's [B, vocab] logits
        self.finished: list[GenerationRequest] = []
        self.seed = int(seed)
        self._req_seq = 0  # arrival index, seeds each request's generator
        self.metrics = serving_metrics()
        for name in ("tokens", "requests", "truncations"):
            self.metrics[name].inc(0, engine=self.engine_label)

    def _make_request(self, prompt_ids, **kw):
        req = GenerationRequest(prompt_ids, **kw)
        req._generator = torch.Generator(device=self.device).manual_seed(
            _request_seed(self.seed, self._req_seq))
        self._req_seq += 1
        return req

    # -- prefill --------------------------------------------------------- #

    @torch.no_grad()
    def _run_prefill(self, req):
        """Batch-1 prefill over a zeroed bucket-length dense cache. Returns
        (logits [1, Sp, V], new_caches per layer [1, Sp, Hkv, D], n, Sp)."""
        n = len(req.prompt)
        Sp = _bucket(n)
        tok = torch.zeros((1, Sp), dtype=torch.long, device=self.device)
        tok[0, :n] = torch.as_tensor(req.prompt, device=self.device)
        pos = torch.arange(Sp, device=self.device)[None]
        caches = self.model.init_kv_caches(1, Sp, dtype=self.kv_dtype)
        logits, new_c = self.model(tok, pos, caches, 0)
        return logits, new_c, n, Sp

    # -- sampling -------------------------------------------------------- #

    def _pick_token(self, logits_row, req):
        """Greedy argmax, or one draw from softmax(logits / T) with the
        request's own generator; both on the logits' device, and only the
        token id crosses to the host."""
        if req.temperature == 0.0:
            return int(torch.argmax(logits_row))
        probs = torch.softmax(logits_row.float() / req.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=req._generator))

    # -- SLO bookkeeping ------------------------------------------------- #

    def _note_token(self, req, tok):
        self.metrics["tokens"].inc(engine=self.engine_label)
        if req._t_first is None:
            req._t_first = time.perf_counter()
            self.metrics["ttft"].observe(req._t_first - req._t_arrival,
                                         engine=self.engine_label)

    def _retire_decision(self, req, tok, row_len):
        """(done, truncated) after appending `tok` with `row_len` tokens
        already in the cache."""
        hit_eos = (req.eos_token_id is not None
                   and int(tok) == req.eos_token_id)
        budget_done = len(req.generated) >= req.max_new_tokens
        cap_hit = row_len + 1 >= self.S
        done = hit_eos or budget_done or cap_hit
        truncated = cap_hit and not hit_eos and not budget_done
        return done, truncated

    def _note_finished(self, req, truncated):
        req.done = True
        m = self.metrics
        m["requests"].inc(engine=self.engine_label)
        if truncated:
            req.truncated = True
            m["truncations"].inc(engine=self.engine_label)
        if req._t_first is not None and len(req.generated) > 1:
            dt = time.perf_counter() - req._t_first
            if dt > 0:
                m["request_tps"].observe(len(req.generated) / dt,
                                         engine=self.engine_label)
        self.finished.append(req)

    def run(self):
        """Drain: step until every queued/live request finishes; returns
        the finished requests in completion order."""
        while self.has_work():
            self.step()
        done, self.finished = self.finished, []
        return done

    # subclass contract
    def has_work(self) -> bool:
        raise NotImplementedError

    def step(self) -> dict:
        raise NotImplementedError


class ContinuousBatchingEngine(_ServingEngineBase):
    """Admit-while-decoding over a slotted DENSE KV cache
    (↔ JAX serving.py:255-375).

    Each layer holds one [max_batch_size, max_seq_len, Hkv, D] cache per
    side, updated in place. `step()` admits waiting requests into free
    slots (a batch-1 prefill each, copied into the slot's rows), then
    advances every live slot by one token in one fixed-shape [B, 1] decode
    with per-slot offsets: each row appends at its own length and attends
    through a [B, 1, 1, S] key-padding mask, which on the card runs the
    flash forward kernel. Parked slots decode at offset 0 and read only
    that column. Greedy tokens are picked on the device; a sampled row
    draws from its own row of logits with the request's generator.
    `run()` drains everything and returns the finished requests."""

    engine_label = "dense"

    def __init__(self, model, max_batch_size=8, max_seq_len=512, seed=0,
                 serve_w8=False):
        super().__init__(model, max_batch_size, max_seq_len, seed,
                         serve_w8=serve_w8)
        cfg = self.cfg
        shape = (self.B, self.S, cfg.kv_heads, cfg.head_dim)
        self.caches = [
            (torch.zeros(shape, dtype=self.kv_dtype, device=self.device),
             torch.zeros(shape, dtype=self.kv_dtype, device=self.device))
            for _ in range(cfg.num_layers)]
        self.lengths = np.zeros(self.B, np.int32)   # tokens in each slot
        self.active: list[GenerationRequest | None] = [None] * self.B
        self.last_tok = np.zeros(self.B, np.int32)
        self.waiting: collections.deque = collections.deque()

    # ------------------------------------------------------------------ #

    def add_request(self, prompt_ids, **kw):
        req = self._make_request(prompt_ids, **kw)
        if len(req.prompt) >= self.S:
            raise ValueError(
                f"prompt length {len(req.prompt)} >= max_seq_len {self.S}")
        self.waiting.append(req)
        return req.req_id

    def has_work(self):
        return bool(self.waiting) or any(r is not None for r in self.active)

    # ------------------------------------------------------------------ #

    def _admit(self):
        free = [i for i in range(self.B) if self.active[i] is None]
        while free and self.waiting:
            slot = free.pop(0)
            req = self.waiting.popleft()
            logits, new_c, n, _ = self._run_prefill(req)
            # the prompt's K/V into this slot's rows [0, n)
            for (bk, bv), (k_, v_) in zip(self.caches, new_c):
                bk[slot, :n] = k_[0, :n]
                bv[slot, :n] = v_[0, :n]
            first = self._pick_token(logits[0, n - 1], req)
            self.active[slot] = req
            self.lengths[slot] = n
            self.last_tok[slot] = first
            self._emit(slot, first)

    def _emit(self, slot, tok):
        req = self.active[slot]
        req.generated.append(int(tok))
        self._note_token(req, tok)
        done, truncated = self._retire_decision(req, tok, self.lengths[slot])
        if done:
            self._note_finished(req, truncated)
            self.active[slot] = None
            self.lengths[slot] = 0

    @torch.no_grad()
    def _decode(self):
        """One fixed-shape [B, 1] decode over every slot: (greedy tokens
        [B] on the host, last logits [B, vocab])."""
        dev = self.device
        tok = torch.tensor(self.last_tok, dtype=torch.long, device=dev)[:, None]
        offs = torch.tensor(self.lengths, dtype=torch.long, device=dev)
        logits, _ = self.model(tok, offs[:, None], self.caches, offs)
        last = logits[:, -1]
        return last.argmax(-1).cpu().numpy(), last

    # ------------------------------------------------------------------ #

    def step(self):
        """One scheduler tick: admit then decode-advance all live slots.
        Returns {req_id: new_token} for the decode advance only — each
        request's FIRST token is emitted at admission."""
        t_tick = time.perf_counter()
        self._admit()
        m = self.metrics
        live = [i for i in range(self.B) if self.active[i] is not None]
        m["queue_depth"].set(len(self.waiting),
                             engine=self.engine_label, queue="prefill")
        m["queue_depth"].set(len(live),
                             engine=self.engine_label, queue="decode")
        if not live:
            return {}
        greedy_np, logits = self._decode()
        self.last_logits = logits
        out = {}
        for i in live:
            req = self.active[i]
            if req.temperature == 0.0:
                tok = int(greedy_np[i])
            else:
                tok = self._pick_token(logits[i], req)
            self.lengths[i] += 1
            self.last_tok[i] = tok
            out[req.req_id] = tok
            self._emit(i, tok)
        m["step_seconds"].observe(time.perf_counter() - t_tick,
                                  engine=self.engine_label)
        return out
