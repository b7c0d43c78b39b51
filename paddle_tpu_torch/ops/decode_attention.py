"""Paged-KV decode attention (↔ paddle_tpu/ops/pallas/decode_attention.py).

`paged_decode_attention` attends one query token per row against a paged
KV cache `[n_pages, Hkv, page_size, D]` through a block table. On CUDA
tensors it launches the kernel of `csrc/decode_attention.cu` (one CTA per
(row, KV head), a loop over the row's pages); on CPU tensors it runs
`paged_decode_attention_plain`, the same semantics in plain PyTorch.
`LAUNCHES` counts kernel launches.

`paged_kv_write` is the decode-step page append, as torch index ops (it is
a jnp scatter in the JAX package, not a Pallas kernel). It writes the pool
IN PLACE: the JAX package returns a fresh array per step, but the page pool
is the largest allocation of a serving process and a copy per layer per
step would double it.

Neither has a gradient (the JAX package gives the decode kernel no VJP), so
both raise when grad mode is on and an input requires grad, rather than
return a result cut from the graph; the serving engine runs under
`torch.no_grad()`.

Later slices: the int8 page layout (`kv_scales=`, `paged_kv_write_q8`) and
the dense-cache variant (`dense_decode_attention`).
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["KV_QMAX", "LAUNCHES", "NEG_INF", "paged_decode_attention",
           "paged_decode_attention_plain", "paged_kv_write"]

# symmetric int8 range of the quantized page layout (±127), kept for the
# int8 slice; the full-precision path does not use it
KV_QMAX = 127.0
NEG_INF = -1e30  # paddle_tpu/ops/pallas/flash_attention.py NEG_INF

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)


def paged_decode_attention_plain(q, key_cache, value_cache, block_tables,
                                 lengths, scale):
    """Plain PyTorch version with the kernel's semantics: pages past the
    length or with a negative table entry are skipped, the last page is
    masked per slot, f32 softmax, and a row with no valid token gives
    zeros. q [B, H, D] -> [B, H, D] in q's dtype."""
    B, H, D = q.shape
    _, Hkv, ps, _ = key_cache.shape
    P = block_tables.shape[1]
    g = H // Hkv
    tables = block_tables.long()
    pages = tables.clamp(min=0)
    # [B, P, Hkv, ps, D] -> [B, Hkv, P*ps, D]
    k = key_cache[pages].permute(0, 2, 1, 3, 4).reshape(B, Hkv, P * ps, D)
    v = value_cache[pages].permute(0, 2, 1, 3, 4).reshape(B, Hkv, P * ps, D)
    slot = torch.arange(P * ps, device=q.device)
    valid = ((slot[None, :] < lengths.long()[:, None])
             & (tables >= 0).repeat_interleave(ps, dim=1))     # [B, P*ps]
    q4 = q.reshape(B, Hkv, g, D).float()
    s = torch.einsum("bhgd,bhtd->bhgt", q4, k.float()) * scale
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgt,bhtd->bhgd", p, v.float())
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(B, H, D).to(q.dtype)


def _refuse_grad(what, *tensors):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no gradient: call it under torch.no_grad() (or on "
            "tensors that do not require grad)")


def _check(q, key_cache, value_cache, block_tables, lengths):
    if q.dim() != 3 or key_cache.dim() != 4:
        raise ValueError("q must be [B, H, D] and the caches "
                         "[n_pages, Hkv, page_size, D]")
    B, H, D = q.shape
    n_pages, Hkv, ps, Dk = key_cache.shape
    if value_cache.shape != key_cache.shape:
        raise ValueError("key and value caches differ in shape")
    if Dk != D:
        raise ValueError(f"head dim of q ({D}) != cache ({Dk})")
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError("block_tables must be [B, P]")
    if lengths.shape != (B,):
        raise ValueError("lengths must be [B]")
    if not (q.dtype == key_cache.dtype == value_cache.dtype):
        raise TypeError("q and the caches must share one dtype (the int8 "
                        "page layout is a later slice)")
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"unsupported dtype {q.dtype}")
    for t in (key_cache, value_cache, block_tables, lengths):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}")


def paged_decode_attention(q, key_cache, value_cache, block_tables, lengths,
                           scale=None, kv_scales=None):
    """q: [B, H, D] (one decode step); key/value_cache:
    [n_pages, Hkv, page_size, D]; block_tables: [B, P] physical page ids
    (-1 unused); lengths: [B] valid tokens including the current one (the
    caller has already written the step's K/V). Returns [B, H, D]."""
    global LAUNCHES
    if kv_scales is not None:
        raise NotImplementedError(
            "int8 KV pages (kv_scales=) are ported with the quantized-serving "
            "slice (ROADMAP A8 int8 / B4 int8 variant)")
    _refuse_grad("paged_decode_attention", q, key_cache, value_cache)
    _check(q, key_cache, value_cache, block_tables, lengths)
    B, H, D = q.shape
    _, Hkv, ps, _ = key_cache.shape
    if scale is None:
        scale = D ** -0.5
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, key_cache, value_cache,
                                            block_tables, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    for t in (q, key_cache, value_cache, block_tables, lengths):
        if not t.is_contiguous():
            raise ValueError("paged_decode_attention: inputs must be contiguous")
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ptt_paged_decode_attention(
        q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, Hkv, H // Hkv, D, ps, block_tables.shape[1], float(scale),
        _build.DTYPE_CODES[str(q.dtype)], stream)
    _build.check(err, "ptt_paged_decode_attention")
    LAUNCHES += 1
    return out


def paged_kv_write(cache, new, block_tables, lengths):
    """Write one decode step's K (or V) rows into the paged cache, in place.

    cache: [n_pages, Hkv, page_size, D]; new: [B, Hkv, D]; block_tables:
    [B, P] (-1 unused); lengths: [B] tokens already present per row. Row b
    lands at logical slot lengths[b], i.e. physical page
    tables[b, lengths[b] // ps], slot lengths[b] % ps. Rows whose target
    entry is -1 (parked rows of the fixed-shape batch) go to physical page
    0, the pool's reserved null page, which no live block table references.
    Returns `cache`."""
    _refuse_grad("paged_kv_write", cache, new)
    B = new.shape[0]
    ps = cache.shape[2]
    lengths = lengths.long()
    rows = torch.arange(B, device=cache.device)
    page = block_tables.long()[rows, lengths // ps]
    page = torch.where(page < 0, torch.zeros_like(page), page)
    cache[page, :, lengths % ps] = new.to(cache.dtype)
    return cache
