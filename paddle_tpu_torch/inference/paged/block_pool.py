"""Block-pool KV cache manager (↔ paddle_tpu/inference/paged/block_pool.py):
fixed-size physical pages, free-list allocation, refcounted prefix sharing,
copy-on-write.

The physical layout is `[n_pages, Hkv, page_size, D]` per layer and side,
the shape `ops.decode_attention.paged_decode_attention` consumes: the
kernel reads each page from its physical slot through the block table, and
no gathered copy of the cache is made.

Host-side metadata (free list, refcounts, prefix map) is plain Python and
numpy, touched once per admission, page-boundary crossing or preemption,
never per token. The page tensors are updated IN PLACE (prompt scatters,
COW copies, restores, and the decode append in `ops.decode_attention`); the
JAX package swaps in fresh arrays instead, which here would double the
largest allocation of the process.

Prefix sharing: a prompt page is keyed by the hash of the ENTIRE token
prefix through that page's end (K/V at position i depends on every token
<= i), so two pages are interchangeable iff their full prefixes match. A
shared page is immutable: the engine copies it (`copy_page`) before the
first divergent write, and unregisters a page that stops being shared
before writing into it, so a later identical prompt cannot adopt a page
that now holds generated tokens.

Physical page 0 is the reserved NULL page: never allocated, never
referenced by a live block table. Parked decode rows write their K/V there,
so the fixed-shape decode step needs no conditional writes.

Quantized layout (`quantized=True`): int8 page payloads with one f32
dequant scale per (page, head) beside them (`scales[layer] =
(k_scale, v_scale)`, each [n_pages, Hkv]; dequant is payload * scale).
Prompt pages quantize with an abs-max per (page, head) (`_quantize_pages`);
decode appends keep a running abs-max per page
(`ops.decode_attention.paged_kv_write_q8`). Prefix sharing keeps the same
keys: quantization is a deterministic function of page content, so two
identical prefixes give bit-identical payloads and scales, and COW, spill
and restore move payload and scales together, bit-exactly.
"""

from __future__ import annotations

import collections
import hashlib

import numpy as np
import torch

from ...device import resolve_device
from ...ops.decode_attention import KV_QMAX
from ..slo import serving_metrics

__all__ = ["BlockPool", "prefix_page_key"]


def prefix_page_key(prompt: np.ndarray, page_index: int, page_size: int):
    """Sharing key for prompt page `page_index`: hash of the full token
    prefix through the page's end (clipped to the prompt length)."""
    end = min(len(prompt), (page_index + 1) * page_size)
    return hashlib.blake2b(
        np.ascontiguousarray(prompt[:end], np.int32).tobytes(),
        digest_size=16).digest()


def _quantize_pages(x):
    """[m, Hkv, ps, D] float pages -> (int8 payload, f32 [m, Hkv] scales):
    symmetric abs-max per (page, head), as paged_kv_write_q8 quantizes
    (±KV_QMAX, so running-max rescales never overflow)."""
    x32 = x.float()
    scale = x32.abs().amax(dim=(2, 3)) / KV_QMAX
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x32 / safe[:, :, None, None]),
                    -KV_QMAX, KV_QMAX).to(torch.int8)
    return q, scale


class BlockPool:
    """Fixed pool of physical KV pages shared by every layer's cache."""

    def __init__(self, num_layers, kv_heads, head_dim, page_size, num_pages,
                 dtype=torch.float32, prefix_sharing=True, quantized=False, *,
                 device=None, metrics=None):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.device = resolve_device(device)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.num_layers = int(num_layers)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype  # the unquantized payload dtype
        self.prefix_sharing = bool(prefix_sharing)
        self.quantized = bool(quantized)
        self.metrics = metrics if metrics is not None else serving_metrics()
        shape = (self.num_pages, kv_heads, self.page_size, head_dim)
        pay = torch.int8 if self.quantized else dtype
        self.kv = [(torch.zeros(shape, dtype=pay, device=self.device),
                    torch.zeros(shape, dtype=pay, device=self.device))
                   for _ in range(num_layers)]
        # per-(page, head) f32 dequant scales beside the int8 payloads
        self.scales = ([(torch.zeros(self.num_pages, kv_heads,
                                     device=self.device),
                         torch.zeros(self.num_pages, kv_heads,
                                     device=self.device))
                        for _ in range(num_layers)]
                       if self.quantized else None)
        self.free: collections.deque = collections.deque(
            range(1, self.num_pages))
        self.ref = np.zeros(self.num_pages, np.int32)
        self._prefix: dict[bytes, int] = {}   # key -> page
        self._page_key: dict[int, bytes] = {}  # page -> key (registered only)
        self.allocs_total = 0  # lifetime allocations (tests/introspection)

    # -- accounting ------------------------------------------------------ #

    @staticmethod
    def page_nbytes(num_layers, kv_heads, head_dim, page_size,
                    dtype=torch.float32, quantized=False) -> int:
        """Device bytes one physical page costs across all layers and both
        K/V sides: the payload plus, when quantized, the per-(page, head)
        f32 scales. The unit of the equal-budget serving A/B."""
        if quantized:
            per_side = kv_heads * page_size * head_dim + kv_heads * 4
        else:
            per_side = kv_heads * page_size * head_dim * dtype.itemsize
        return int(num_layers) * 2 * per_side

    @property
    def bytes_per_page(self) -> int:
        return self.page_nbytes(self.num_layers, self.kv_heads,
                                self.head_dim, self.page_size, self.dtype,
                                self.quantized)

    @property
    def bytes_per_token(self) -> float:
        return self.bytes_per_page / self.page_size

    @property
    def pages_total(self) -> int:
        return self.num_pages - 1  # null page is not allocatable

    @property
    def pages_free(self) -> int:
        return len(self.free)

    def update_gauges(self):
        m = self.metrics
        m["pages_free"].set(self.pages_free)
        m["pages_total"].set(self.pages_total)
        m["kv_bytes_per_token"].set(self.bytes_per_token)

    # -- allocation / refcounts ------------------------------------------ #

    def alloc(self) -> int | None:
        """One free page with refcount 1, or None when the pool is dry."""
        if not self.free:
            return None
        page = self.free.popleft()
        self.ref[page] = 1
        self.allocs_total += 1
        return page

    def incref(self, page: int):
        if self.ref[page] <= 0:
            raise RuntimeError(f"incref on unallocated page {page}")
        self.ref[page] += 1

    def release(self, page: int):
        """Drop one reference; a page at zero is unregistered and freed."""
        if self.ref[page] <= 0:
            raise RuntimeError(f"release of unallocated page {page}")
        self.ref[page] -= 1
        if self.ref[page] == 0:
            self.unregister_page(page)
            self.free.append(page)

    def is_shared(self, page: int) -> bool:
        return self.ref[page] > 1

    # -- prefix sharing -------------------------------------------------- #

    def lookup_prefix(self, key: bytes | None) -> int | None:
        """Shared page for `key` (increfs on hit), else None."""
        if not self.prefix_sharing or key is None:
            return None
        self.metrics["prefix_lookups"].inc()
        page = self._prefix.get(key)
        if page is None:
            return None
        self.incref(page)
        self.metrics["prefix_hits"].inc()
        return page

    def register_prefix(self, key: bytes, page: int):
        if not self.prefix_sharing or key in self._prefix:
            return
        self._prefix[key] = page
        self._page_key[page] = key

    def is_registered(self, page: int) -> bool:
        return page in self._page_key

    def page_key(self, page: int) -> bytes | None:
        return self._page_key.get(page)

    def unregister_page(self, page: int):
        """Remove a page from the prefix map (before an in-place write, or
        on free) so future lookups cannot adopt diverged content."""
        key = self._page_key.pop(page, None)
        if key is not None:
            self._prefix.pop(key, None)

    # -- device page data (all in place) --------------------------------- #

    def _index(self, idx):
        return torch.as_tensor(list(idx), dtype=torch.long, device=self.device)

    def write_prompt_pages(self, pages, write_mask, k_layers, v_layers):
        """Scatter a prefilled prompt into its pages, all layers.

        pages: the request's m physical pages in logical order;
        write_mask[j] False for shared pages (content already present and
        identical by key construction). k_layers/v_layers: per layer
        [m, Hkv, page_size, D] page-stacked prompt K/V. A quantized pool
        quantizes here (abs-max per (page, head)) and writes payload and
        scales together."""
        idx = [j for j, w in enumerate(write_mask) if w]
        if not idx:
            return
        tgt = self._index(pages[j] for j in idx)
        sel = self._index(idx)
        for li, ((k, v), k_new, v_new) in enumerate(zip(self.kv, k_layers,
                                                        v_layers)):
            if self.quantized:
                sk, sv = self.scales[li]
                k[tgt], sk[tgt] = _quantize_pages(k_new[sel])
                v[tgt], sv[tgt] = _quantize_pages(v_new[sel])
            else:
                k[tgt] = k_new[sel].to(k.dtype)
                v[tgt] = v_new[sel].to(v.dtype)
        if self.quantized:
            self.metrics["kv_quant_pages"].inc(len(idx))

    def cache_layers(self):
        """Per layer, the page tensors: (k, v), plus (k_scale, v_scale)
        when quantized."""
        if self.quantized:
            return [kv + sc for kv, sc in zip(self.kv, self.scales)]
        return self.kv

    def copy_page(self, src: int, dst: int):
        """Copy-on-write body: duplicate src's content into dst (all
        layers; payload and scales of a quantized pool). Caller owns
        refcount/table updates."""
        for layer in self.cache_layers():
            for t in layer:
                t[dst] = t[src]
        self.metrics["cow_copies"].inc()

    def read_pages(self, pages) -> list[tuple]:
        """Host copies of the given pages, per layer — the preemption spill
        buffer: [(k, v), ...] of CPU tensors [m, Hkv, page_size, D], or
        [(k, v, k_scale, v_scale), ...] with [m, Hkv] scales when quantized
        (int8 payloads and f32 scales round-trip the host bit-exactly). The
        index gather copies, so the spill never aliases the pool."""
        idx = self._index(pages)
        return [tuple(t[idx].cpu() for t in layer)
                for layer in self.cache_layers()]

    def restore_pages(self, pages, kv_host, rows):
        """Write spilled host pages back: kv_host is read_pages() output for
        the request's full logical page list; `rows` selects which logical
        indices need restoring (prefix-shared hits don't), `pages` the
        freshly allocated physical destinations, aligned with `rows`."""
        if not pages:
            return
        tgt = self._index(pages)
        sel = torch.as_tensor(list(rows), dtype=torch.long)
        for layer, host in zip(self.cache_layers(), kv_host):
            for t, t_h in zip(layer, host):
                t[tgt] = t_h[sel].to(self.device)
