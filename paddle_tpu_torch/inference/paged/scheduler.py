"""Two-queue admission scheduler for the paged serving engine
(↔ paddle_tpu/inference/paged/scheduler.py).

Queues:

- **prefill** — waiting `GenerationRequest`s, held in power-of-two length
  buckets (the prefill shape buckets).
- **resume** — preempted requests whose pages were spilled to host; they
  already produced tokens, so they re-admit ahead of fresh prefills.

Admission is against a **page-budget watermark**: a request is admitted
only if, after taking its (upper-bound) page need, the pool still holds
`watermark` free pages. The default watermark is one page per live request:
every live row crosses at most one page boundary per `page_size` decode
steps, so this reserve makes same-tick pool exhaustion (and preemption) the
exception.

Ordering is strict arrival FIFO across buckets, with head-of-line blocking
when the head doesn't fit: no starvation, and admission order equals
arrival order, which keeps each request's sampling stream independent of
scheduling.
"""

from __future__ import annotations

import collections

from ..serving import _bucket
from ..slo import serving_metrics

__all__ = ["TwoQueueScheduler"]


def _pages_for_prompt(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)  # ceil


class TwoQueueScheduler:
    def __init__(self, page_size: int, watermark_pages: int | None = None,
                 metrics=None):
        self.page_size = int(page_size)
        # None -> dynamic: one reserved page per live request (min 1)
        self.watermark_pages = watermark_pages
        self.metrics = metrics if metrics is not None else serving_metrics()
        self._seq = 0
        # bucket -> deque[(seq, req)]; FIFO within, arrival-merged across
        self.prefill: dict[int, collections.deque] = {}
        self.resume: collections.deque = collections.deque()

    # -- enqueue --------------------------------------------------------- #

    def enqueue_prefill(self, req):
        b = _bucket(len(req.prompt))
        self.prefill.setdefault(b, collections.deque()).append(
            (self._seq, req))
        self._seq += 1

    def enqueue_resume(self, spilled):
        self.resume.append(spilled)

    # -- introspection --------------------------------------------------- #

    @property
    def waiting_prefill(self) -> int:
        return sum(len(d) for d in self.prefill.values())

    @property
    def waiting_resume(self) -> int:
        return len(self.resume)

    def has_waiting(self) -> bool:
        return bool(self.resume) or any(self.prefill.values())

    def update_gauges(self, engine: str, live: int):
        g = self.metrics["queue_depth"]
        g.set(self.waiting_prefill, engine=engine, queue="prefill")
        g.set(self.waiting_resume, engine=engine, queue="resume")
        g.set(live, engine=engine, queue="decode")

    # -- admission ------------------------------------------------------- #

    def _watermark(self, live: int) -> int:
        if self.watermark_pages is not None:
            return self.watermark_pages
        return max(1, live)

    def _head_bucket(self):
        """Bucket holding the earliest-arrived waiting request."""
        best = None
        for b, d in self.prefill.items():
            if d and (best is None or d[0][0] < self.prefill[best][0][0]):
                best = b
        return best

    def pick(self, free_rows: int, pages_free: int, live: int) -> list:
        """Admissions for this tick, in order: resumes (FIFO), then prefill
        arrivals (FIFO across buckets). Page needs are charged at their
        upper bound (prefix-sharing hits only under-run the budget). Stops
        at the first request that would dip below the watermark."""
        out = []
        budget = pages_free

        def fits(need):
            # live + 1: the reserve must cover the candidate itself
            if budget - need >= self._watermark(live + 1):
                return True
            # idle engine: the head request admits whenever it fits at all,
            # so a request needing the whole pool cannot deadlock behind
            # its own watermark
            return live == 0 and not out and budget >= need

        while free_rows and self.resume:
            need = self.resume[0].n_pages
            if not fits(need):
                return out
            out.append(self.resume.popleft())
            free_rows -= 1
            live += 1
            budget -= need

        while free_rows:
            b = self._head_bucket()
            if b is None:
                break
            need = _pages_for_prompt(len(self.prefill[b][0][1].prompt),
                                     self.page_size)
            if not fits(need):
                return out
            _, req = self.prefill[b].popleft()
            out.append(req)
            free_rows -= 1
            live += 1
            budget -= need
        return out
