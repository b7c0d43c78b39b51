"""Request type and the shared scaffolding of the serving engines
(↔ paddle_tpu/inference/serving.py).

`_ServingEngineBase` holds what every engine shares: the batch-1 bucketed
prefill, per-request sampling and the SLO bookkeeping. Prompts pad to
power-of-two length buckets as in the JAX package, so prefill shapes match
it (nothing is compiled here; the bucket only fixes the shapes).

Sampling: each request owns a `torch.Generator` seeded from (engine seed,
arrival index), so its sampled tokens depend only on the seed, its arrival
order and its logits, never on slot assignment, batch composition or
preemption timing. The generators of PyTorch and JAX differ, so sampled
tokens do not match the JAX engine's; greedy tokens do.

The paged engine (`inference.paged.PagedServingEngine`) is the one ported;
the dense `ContinuousBatchingEngine` comes with a later slice (ROADMAP A8).
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from .slo import serving_metrics

__all__ = ["GenerationRequest"]


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
        if serve_w8:
            raise NotImplementedError(
                "weight-only int8 serving is ported with the quantized "
                "serving slice (ROADMAP A8 int8)")
        model.eval()
        self.model = model
        self.cfg = model.config
        self.B = int(max_batch_size)
        self.S = int(max_seq_len)
        # the engine runs where the model's parameters live, and the KV
        # cache takes the model's floating dtype (a bf16 model gets bf16
        # pages)
        params = [p for p in model.parameters() if p.is_floating_point()]
        self.device = params[0].device
        self.kv_dtype = params[0].dtype
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
