"""PagedServingEngine: continuous batching over a block-pool paged KV cache
(↔ paddle_tpu/inference/paged/engine.py).

A slot (row of the decode batch) holds only a block table; physical pages
come from the shared `BlockPool` on demand. Admission is by pages available
against the scheduler's watermark, not by slots free.

Every tick runs ONE decode step of fixed shape [max_batch_size, 1]: rows
without a request are parked (block table all -1, length 0), write their
K/V to the null page and read zeros. Block tables and lengths are inputs of
the step, so admission, retirement, preemption and COW never change its
shapes. Page-table maintenance (allocation at page boundaries, COW off
shared pages, preemption spills) happens on the host between steps.

On a CUDA model every LayerNorm of the step runs the fused-norm kernel and
every attention the paged decode kernel; the prefill's LayerNorms run the
norm kernel too.

With `kv_quant=True` the pool holds int8 pages with per-(page, head) f32
scales: the step passes each layer's cache as (k, v, k_scale, v_scale),
appends through `paged_kv_write_q8` and attends through the int8 kernel.
`kv_budget_bytes` sizes the pool by device bytes instead of a page count
(the equal-budget A/B: an int8 pool fits about twice the pages of a bf16
one, four times those of an f32 one).

Preemption: when the pool runs dry mid-decode, the lowest-priority live
request (newest arrival among equals, never the row that asked for the
page) has its pages copied to a host spill buffer and released; it
re-enters through the scheduler's resume queue and continues from exactly
where it stopped — no token is lost or recomputed. Spilled pages that were
prefix-shared re-attach by hash on resume when the shared copy still
exists, and are restored from the host otherwise.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..serving import GenerationRequest, _ServingEngineBase
from .block_pool import BlockPool, prefix_page_key
from .scheduler import TwoQueueScheduler, _pages_for_prompt

__all__ = ["PagedServingEngine", "SpilledRequest"]


class SpilledRequest:
    """A preempted request parked on host: generation state plus page
    contents, enough to resume without recomputing anything."""

    __slots__ = ("req", "length", "last_tok", "kv_host", "keys")

    def __init__(self, req, length, last_tok, kv_host, keys):
        self.req = req
        self.length = int(length)
        self.last_tok = int(last_tok)
        self.kv_host = kv_host   # BlockPool.read_pages output (CPU tensors)
        self.keys = keys         # per logical page: prefix key or None

    @property
    def n_pages(self) -> int:
        return len(self.keys)


class PagedServingEngine(_ServingEngineBase):
    """Admit-while-decoding over paged KV with prefix sharing + preemption.

    `add_request` / `step` / `run`, plus `page_size`, `num_pages` (default:
    `max_batch_size * max_seq_len` tokens worth of pages, plus the null
    page), or `kv_budget_bytes` (the pool's bytes, null page included),
    `prefix_sharing`, `watermark_pages`, `preemption`, `kv_quant` (int8
    pages) and `serve_w8` (int8 weights). The engine runs on the model's
    device."""

    engine_label = "paged"

    def __init__(self, model, max_batch_size=8, max_seq_len=512, seed=0,
                 page_size=16, num_pages=None, prefix_sharing=True,
                 watermark_pages=None, preemption=True, kv_quant=False,
                 kv_budget_bytes=None, serve_w8=False):
        super().__init__(model, max_batch_size, max_seq_len, seed,
                         serve_w8=serve_w8)
        cfg = self.cfg
        self.ps = int(page_size)
        self.P = _pages_for_prompt(self.S, self.ps)  # block-table width
        self.kv_quant = bool(kv_quant)
        if num_pages is not None and kv_budget_bytes is not None:
            raise ValueError(
                "pass num_pages OR kv_budget_bytes, not both: a page count "
                "would silently override the byte budget of an equal-budget "
                "A/B")
        if kv_budget_bytes is not None:
            page_b = BlockPool.page_nbytes(cfg.num_layers, cfg.kv_heads,
                                           cfg.head_dim, self.ps,
                                           self.kv_dtype, self.kv_quant)
            # the budget covers the whole pool, null page included
            num_pages = int(kv_budget_bytes) // page_b
            if num_pages < 2:
                raise ValueError(
                    f"kv_budget_bytes={int(kv_budget_bytes)} fits {num_pages} "
                    f"pages at {page_b} bytes a page; the pool needs >= 2 "
                    "(the reserved null page plus one allocatable)")
        elif num_pages is None:
            num_pages = (self.B * self.S) // self.ps + 1  # +1: null page
        self.pool = BlockPool(cfg.num_layers, cfg.kv_heads, cfg.head_dim,
                              self.ps, num_pages, dtype=self.kv_dtype,
                              prefix_sharing=prefix_sharing,
                              quantized=self.kv_quant, device=self.device,
                              metrics=self.metrics)
        self.sched = TwoQueueScheduler(self.ps, watermark_pages,
                                       metrics=self.metrics)
        self.preemption = bool(preemption)
        self.tables = np.full((self.B, self.P), -1, np.int32)
        self.lengths = np.zeros(self.B, np.int32)
        self.active: list[GenerationRequest | None] = [None] * self.B
        self.last_tok = np.zeros(self.B, np.int32)
        self.pool.update_gauges()
        m = self.metrics
        for name in ("preemptions", "resumes", "preempted_pages",
                     "prefix_hits", "prefix_lookups", "cow_copies",
                     "kv_quant_pages"):
            m[name].inc(0)

    # ------------------------------------------------------------------ #

    def add_request(self, prompt_ids, **kw):
        req = self._make_request(prompt_ids, **kw)
        n = len(req.prompt)
        if n >= self.S:
            raise ValueError(f"prompt length {n} >= max_seq_len {self.S}")
        # lifetime page need (capacity retirement caps a row at S tokens)
        worst = _pages_for_prompt(min(self.S, n + req.max_new_tokens),
                                  self.ps)
        if worst > self.pool.pages_total:
            raise ValueError(
                f"request needs up to {worst} pages but the pool only has "
                f"{self.pool.pages_total}; grow num_pages or shrink the "
                "request")
        self.sched.enqueue_prefill(req)
        return req.req_id

    def has_work(self):
        return (self.sched.has_waiting()
                or any(r is not None for r in self.active))

    @property
    def live_count(self) -> int:
        return sum(r is not None for r in self.active)

    # -- allocation / preemption ---------------------------------------- #

    def _alloc_or_preempt(self, requester_row=None) -> int:
        while True:
            page = self.pool.alloc()
            if page is not None:
                return page
            if not self.preemption or not self._preempt_lowest(requester_row):
                raise RuntimeError(
                    "KV page pool exhausted with no preemptible request; "
                    "pool is too small for the admitted working set")

    def _preempt_lowest(self, exclude_row) -> bool:
        """Spill the lowest-priority live request (newest arrival among
        equals; never `exclude_row`, whose allocation triggered this)."""
        candidates = [i for i in range(self.B)
                      if self.active[i] is not None and i != exclude_row]
        if not candidates:
            return False
        victim = min(candidates,
                     key=lambda i: (self.active[i].priority,
                                    -self.active[i].req_id))
        self._spill_row(victim)
        return True

    def _spill_row(self, row):
        req = self.active[row]
        pages = [int(p) for p in self.tables[row] if p >= 0]
        kv_host = self.pool.read_pages(pages)
        keys = [self.pool.page_key(p) for p in pages]
        for p in pages:
            self.pool.release(p)
        self.sched.enqueue_resume(SpilledRequest(
            req, self.lengths[row], self.last_tok[row], kv_host, keys))
        self.tables[row, :] = -1
        self.active[row] = None
        self.lengths[row] = 0
        self.metrics["preemptions"].inc()
        self.metrics["preempted_pages"].inc(len(pages))

    def _release_row(self, row):
        for p in self.tables[row]:
            if p >= 0:
                self.pool.release(int(p))
        self.tables[row, :] = -1
        self.active[row] = None
        self.lengths[row] = 0

    # -- admission ------------------------------------------------------- #

    def _admit(self):
        free_rows = [i for i in range(self.B) if self.active[i] is None]
        if not free_rows:
            return
        work = self.sched.pick(len(free_rows), self.pool.pages_free,
                               self.live_count)
        for item in work:
            row = free_rows.pop(0)
            if isinstance(item, SpilledRequest):
                self._resume_into(row, item)
            else:
                self._prefill_into(row, item)

    def _stack_pages(self, arr, n, m):
        """[1, Sp, Hkv, D] prefill K/V -> [m, Hkv, ps, D] page-stacked."""
        a = arr[0, :n]
        pad = m * self.ps - n
        if pad:
            a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        return a.reshape(m, self.ps, a.shape[1], a.shape[2]).transpose(1, 2)

    def _prefill_into(self, row, req):
        logits, new_c, n, _ = self._run_prefill(req)
        m = _pages_for_prompt(n, self.ps)
        pages, write_mask = [], []
        for j in range(m):
            key = prefix_page_key(req.prompt, j, self.ps)
            page = self.pool.lookup_prefix(key)
            if page is not None:
                pages.append(page)
                write_mask.append(False)
                continue
            page = self._alloc_or_preempt()
            self.pool.register_prefix(key, page)
            pages.append(page)
            write_mask.append(True)
        if any(write_mask):
            k_layers = [self._stack_pages(k_, n, m) for k_, _ in new_c]
            v_layers = [self._stack_pages(v_, n, m) for _, v_ in new_c]
            self.pool.write_prompt_pages(pages, write_mask,
                                         k_layers, v_layers)
        self.tables[row, :m] = pages
        first = self._pick_token(logits[0, n - 1], req)
        self.active[row] = req
        self.lengths[row] = n
        self.last_tok[row] = first
        self._emit(row, first)

    def _resume_into(self, row, sp: SpilledRequest):
        pages, restore_rows, restore_pages = [], [], []
        for j, key in enumerate(sp.keys):
            page = self.pool.lookup_prefix(key)
            if page is None:
                page = self._alloc_or_preempt()
                if key is not None:
                    self.pool.register_prefix(key, page)
                restore_rows.append(j)
                restore_pages.append(page)
            pages.append(page)
        self.pool.restore_pages(restore_pages, sp.kv_host, restore_rows)
        self.tables[row, :len(pages)] = pages
        self.active[row] = sp.req
        self.lengths[row] = sp.length
        self.last_tok[row] = sp.last_tok
        self.metrics["resumes"].inc()

    # -- decode write-target maintenance -------------------------------- #

    def _ensure_write_target(self, row):
        """Guarantee this row can write its next K/V: allocate at page
        boundaries, copy-on-write off shared pages, unregister a private
        page before its first divergent write."""
        L = int(self.lengths[row])
        j = L // self.ps
        page = int(self.tables[row, j])
        if page < 0:
            self.tables[row, j] = self._alloc_or_preempt(requester_row=row)
        elif self.pool.is_shared(page):
            dst = self._alloc_or_preempt(requester_row=row)
            self.pool.copy_page(page, dst)
            self.pool.release(page)
            self.tables[row, j] = dst
        elif self.pool.is_registered(page):
            self.pool.unregister_page(page)

    # -- token emission -------------------------------------------------- #

    def _emit(self, row, tok):
        req = self.active[row]
        req.generated.append(int(tok))
        self._note_token(req, tok)
        done, truncated = self._retire_decision(req, tok, self.lengths[row])
        if done:
            self._note_finished(req, truncated)
            self._release_row(row)

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _decode(self):
        """One fixed-shape [B, 1] decode step over the paged pool: writes
        every row's K/V into its next slot (parked rows: the null page) and
        returns (greedy tokens [B] on the host, last logits [B, vocab]).
        A quantized pool passes each layer as (k, v, k_scale, v_scale)."""
        dev = self.device
        tok = torch.tensor(self.last_tok, dtype=torch.long, device=dev)[:, None]
        offs = torch.tensor(self.lengths, dtype=torch.int32, device=dev)
        tables = torch.tensor(self.tables, dtype=torch.int32, device=dev)
        logits, _ = self.model(tok, offs[:, None], self.pool.cache_layers(),
                               offs, block_tables=tables)
        last = logits[:, -1]
        return last.argmax(-1).cpu().numpy(), last

    def step(self):
        """One scheduler tick: admit (resumes then prefills), ensure every
        live row has a writable page, advance all live rows by one token.
        Returns {req_id: new_token} for the decode advance only — each
        request's FIRST token is emitted at admission."""
        t_tick = time.perf_counter()
        self._admit()
        live = [i for i in range(self.B) if self.active[i] is not None]
        self.sched.update_gauges(self.engine_label, len(live))
        self.pool.update_gauges()
        if not live:
            return {}
        for i in live:
            if self.active[i] is not None:  # an earlier COW may have spilled i
                self._ensure_write_target(i)
        live = [i for i in range(self.B) if self.active[i] is not None]
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
        self.metrics["step_seconds"].observe(time.perf_counter() - t_tick,
                                             engine=self.engine_label)
        self.pool.update_gauges()
        return out
