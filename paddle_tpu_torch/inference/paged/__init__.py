"""Paged-KV serving (↔ paddle_tpu/inference/paged/).

- `BlockPool` — fixed-size physical KV pages in the layout the paged decode
  kernel consumes, with free-list allocation, refcounted prefix sharing and
  copy-on-write.
- `TwoQueueScheduler` — power-of-two prefill buckets plus a resume queue,
  admitting against a page-budget watermark.
- `PagedServingEngine` — continuous batching over both, with preemption to
  a host spill buffer and per-engine SLO metrics.
"""

from .block_pool import BlockPool, prefix_page_key
from .engine import PagedServingEngine, SpilledRequest
from .scheduler import TwoQueueScheduler

__all__ = [
    "BlockPool",
    "PagedServingEngine",
    "SpilledRequest",
    "TwoQueueScheduler",
    "prefix_page_key",
]
