"""Decode attention and the decode-step page append
(↔ paddle_tpu/ops/pallas/decode_attention.py).

Three wrappers, one query token per row, each launching a kernel on CUDA
tensors and running its plain PyTorch version (same semantics) on CPU
tensors:

- `paged_decode_attention` over a paged cache `[n_pages, Hkv, page_size, D]`
  through a block table (`csrc/decode_attention.cu`): one kernel template
  `paged_split_kernel<T, KV>`, split over chunks of `paged_chunk_pages`
  pages and combined in the same launch (the last chunk of a row to arrive
  sums the others' f32 partials from a workspace, counted by per-device
  arrival counters that each call leaves at zero). Full precision →
  `<T, T>` (`paged_decode_attention_plain`, counter `LAUNCHES`); int8 pages
  with per-(page, head) f32 scales (`kv_scales=`) → `<T, int8>`
  (`paged_decode_attention_q8_plain`, counter `Q8_LAUNCHES`).
  `paged_decode_partials_plain`, `paged_live_chunks_plain` and
  `dense_decode_combine_plain` are the plain form of that split;
- `dense_decode_attention` over a dense cache `[B, Hkv, S_max, D]` (the
  MMHA path) → `csrc/dense_decode.cu`, split over the sequence in chunks of
  `dense_chunk` tokens: `decode_split_kernel<T>` writes each chunk's f32
  partials (m, l, acc) to a workspace and `decode_combine_kernel<T>`
  rescales and sums them (`dense_decode_attention_plain`, counter
  `DENSE_LAUNCHES`, one a call). `dense_decode_partials_plain` and
  `dense_decode_combine_plain` are the plain form of that split.

`paged_kv_write` and `paged_kv_write_q8` are the decode-step page appends,
as torch index ops (jnp scatters in the JAX package, not Pallas kernels).
They write the pool IN PLACE: the JAX package returns fresh arrays per
step, but the page pool is the largest allocation of a serving process and
a copy per layer per step would double it.

None has a gradient (the JAX package gives the decode kernel no VJP), so
each raises when grad mode is on and an input requires grad, rather than
return a result cut from the graph; the serving engines run under
`torch.no_grad()`.
"""

from __future__ import annotations

import torch

from . import _build
from ..framework.core import report_op

__all__ = ["DENSE_LAUNCHES", "KV_QMAX", "LAUNCHES", "NEG_INF", "Q8_LAUNCHES",
           "dense_chunk", "dense_decode_attention",
           "dense_decode_attention_plain", "dense_decode_combine_plain",
           "dense_decode_partials_plain", "paged_chunk_pages",
           "paged_decode_attention", "paged_decode_attention_plain",
           "paged_decode_attention_q8_plain", "paged_decode_partials_plain",
           "paged_kv_write", "paged_kv_write_q8", "paged_live_chunks_plain"]

# symmetric int8 range of the quantized page layout: ±127 (not -128), so
# the running-max rescale of paged_kv_write_q8 never overflows
KV_QMAX = 127.0
NEG_INF = -1e30  # paddle_tpu/ops/pallas/flash_attention.py NEG_INF

# kernel launches since import (or since a caller reset them)
LAUNCHES = 0        # paged, full precision
Q8_LAUNCHES = 0     # paged, int8 pages
DENSE_LAUNCHES = 0  # dense cache


# shared memory one CTA may use on an H100 (232,448 bytes)
_SMEM_PER_BLOCK = 227 * 1024

# The paged kernel's scratch, per device, grown when a call needs more:
# the f32 workspace of its chunks' partials, and the int32 arrival
# counters of its in-launch combine, one per (row, kv head), zeroed once
# when allocated and left at zero by every call (the last chunk of a row to
# arrive resets its counter). So no call allocates or pays a memset, and a
# CUDA graph may capture the call. Calls on one device share them: they
# must not overlap on two streams.
_WORKSPACE = {}
_ARRIVALS = {}


def _scratch(store, device, n, dtype):
    buf = store.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged_decode_attention: call it once at this batch size "
                "outside CUDA graph capture first (it allocates its scratch "
                "then)")
        buf = torch.zeros(n, dtype=dtype, device=device)
        store[device] = buf
    return buf


def _attend_plain(q, k, v, valid, scale):
    """The softmax core of the plain versions: q [B, H, D]; k, v f32
    [B, Hkv, T, D]; valid bool [B, T]. f32 softmax over the valid tokens;
    a row with none gives zeros. Returns [B, H, D] in q's dtype."""
    B, H, D = q.shape
    Hkv = k.shape[1]
    q4 = q.reshape(B, Hkv, H // Hkv, D).float()
    s = torch.einsum("bhgd,bhtd->bhgt", q4, k) * scale
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgt,bhtd->bhgd", p, v)
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(B, H, D).to(q.dtype)


def _gather_pages(cache, pages, scales=None):
    """[n_pages, Hkv, ps, D] pages of `pages` [B, P] -> f32 [B, Hkv, P*ps, D],
    multiplied by their per-(page, head) scales when given."""
    B, P = pages.shape
    _, Hkv, ps, D = cache.shape
    x = cache[pages].float()                       # [B, P, Hkv, ps, D]
    if scales is not None:
        x = x * scales.float()[pages][..., None, None]
    return x.permute(0, 2, 1, 3, 4).reshape(B, Hkv, P * ps, D)


def _paged_valid(block_tables, lengths, ps):
    """[B, P*ps] bool: slot before the length on a page with a table entry."""
    tables = block_tables.long()
    slot = torch.arange(tables.shape[1] * ps, device=tables.device)
    return ((slot[None, :] < lengths.long()[:, None])
            & (tables >= 0).repeat_interleave(ps, dim=1))


def paged_decode_attention_plain(q, key_cache, value_cache, block_tables,
                                 lengths, scale):
    """Plain PyTorch version with the kernel's semantics: pages past the
    length or with a negative table entry are skipped, the last page is
    masked per slot, f32 softmax, and a row with no valid token gives
    zeros. q [B, H, D] -> [B, H, D] in q's dtype."""
    pages = block_tables.long().clamp(min=0)
    return _attend_plain(q, _gather_pages(key_cache, pages),
                         _gather_pages(value_cache, pages),
                         _paged_valid(block_tables, lengths,
                                      key_cache.shape[2]), scale)


def paged_decode_attention_q8_plain(q, key_cache, value_cache, block_tables,
                                    lengths, scale, k_scale, v_scale):
    """Plain version of the int8 route: each int8 page is dequantized
    (payload * its (page, head) scale, in f32, as the JAX kernel does in
    VMEM), then attended as `paged_decode_attention_plain` does."""
    pages = block_tables.long().clamp(min=0)
    return _attend_plain(q, _gather_pages(key_cache, pages, k_scale),
                         _gather_pages(value_cache, pages, v_scale),
                         _paged_valid(block_tables, lengths,
                                      key_cache.shape[2]), scale)


def paged_chunk_pages(ps, D, kv_itemsize):
    """Pages of a chunk of the paged kernel: the most whose K and V rows
    take at most 32 KB of shared memory together, and at least one.
    Counted in pages, never tokens: any page size works. 32 KB, not 64:
    on an H100 the serving path's rows and ticks ran faster with twice the
    CTAs of half the size (PERF.md)."""
    return max(1, (32 * 1024) // (2 * ps * D * kv_itemsize))


def paged_live_chunks_plain(lengths, P, ps, ppc):
    """Chunks of `ppc` pages that hold tokens of each row: ceil(min(length,
    P * ps) / (ppc * ps)), 0 for a row of length 0. -> int64 [B]."""
    span = ppc * ps
    return (lengths.long().clamp(0, P * ps) + span - 1) // span


def paged_decode_partials_plain(q, key_cache, value_cache, block_tables,
                                lengths, scale, ppc, kv_scales=None):
    """The paged kernel's split as plain PyTorch: per chunk of `ppc` pages
    of the block table, in f32, m = the largest score of its valid tokens
    (before the length, on a page with an entry >= 0), l = sum exp(s - m)
    and acc = sum exp(s - m) v (unnormalised). With `kv_scales` the int8
    pages are dequantized per (page, head) first. A chunk with no valid
    token (past the length, or all -1 pages) has m = NEG_INF, l = 0 and
    acc = 0. `dense_decode_combine_plain` sums them into the output.
    Returns m, l [B, H, C] and acc [B, H, C, D], C = max(1, ceil(P / ppc))."""
    B, H, D = q.shape
    _, Hkv, ps, _ = key_cache.shape
    P = block_tables.shape[1]
    n = max(1, -(-P // ppc))
    span = ppc * ps
    pages = block_tables.long().clamp(min=0)
    ks, vs = kv_scales if kv_scales is not None else (None, None)
    pad = n * span - P * ps
    k = torch.nn.functional.pad(_gather_pages(key_cache, pages, ks),
                                (0, 0, 0, pad))
    v = torch.nn.functional.pad(_gather_pages(value_cache, pages, vs),
                                (0, 0, 0, pad))
    valid = torch.nn.functional.pad(_paged_valid(block_tables, lengths, ps),
                                    (0, pad)).reshape(B, 1, 1, n, span)
    q4 = q.reshape(B, Hkv, H // Hkv, D).float()
    s = (torch.einsum("bhgd,bhtd->bhgt", q4, k) * scale).reshape(
        B, Hkv, H // Hkv, n, span)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    acc = torch.einsum("bhgnt,bhntd->bhgnd", p, v.reshape(B, Hkv, n, span, D))
    return (m.reshape(B, H, n), p.sum(-1).reshape(B, H, n),
            acc.reshape(B, H, n, D))


def dense_decode_attention_plain(q, key_cache, value_cache, lengths, scale):
    """Plain version of the dense route: q [B, H, D] against
    [B, Hkv, S_max, D] caches, the first min(lengths[b], S_max) tokens of
    row b valid. -> [B, H, D] in q's dtype."""
    s_max = key_cache.shape[2]
    valid = (torch.arange(s_max, device=q.device)[None, :]
             < lengths.long()[:, None])
    return _attend_plain(q, key_cache.float(), value_cache.float(), valid,
                         scale)


def dense_chunk(D, itemsize, s_max):
    """Tokens of a chunk of the dense-cache kernel: the largest power of two
    from 16 to 256 whose K and V rows take at most 64 KB of shared memory
    together, and no more than S_max needs (S_max rounded up to a power of
    two, at least 16)."""
    chunk = 256
    while chunk > 16 and (2 * chunk * D * itemsize > 64 * 1024
                          or chunk >= 2 * max(s_max, 16)):
        chunk //= 2
    return chunk


def dense_decode_partials_plain(q, key_cache, value_cache, lengths, scale,
                                chunk):
    """The kernel's first pass as plain PyTorch: per chunk of `chunk`
    tokens, in f32, m = the largest score of its valid tokens, l = sum
    exp(s - m) and acc = sum exp(s - m) v (unnormalised). A chunk with no
    valid token has m = NEG_INF, l = 0 and acc = 0. Returns m, l
    [B, H, C] and acc [B, H, C, D], C = ceil(S_max / chunk)."""
    B, H, D = q.shape
    _, Hkv, s_max, _ = key_cache.shape
    n = -(-s_max // chunk)
    pad = n * chunk - s_max
    k = torch.nn.functional.pad(key_cache.float(), (0, 0, 0, pad))
    v = torch.nn.functional.pad(value_cache.float(), (0, 0, 0, pad))
    q4 = q.reshape(B, Hkv, H // Hkv, D).float()
    s = torch.einsum("bhgd,bhtd->bhgt", q4, k) * scale
    s = s.reshape(B, Hkv, H // Hkv, n, chunk)
    length = torch.clamp(lengths.long(), max=s_max)
    valid = (torch.arange(n * chunk, device=q.device)[None, :]
             < length[:, None]).reshape(B, 1, 1, n, chunk)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    acc = torch.einsum("bhgnt,bhntd->bhgnd", p,
                       v.reshape(B, Hkv, n, chunk, D))
    return (m.reshape(B, H, n), p.sum(-1).reshape(B, H, n),
            acc.reshape(B, H, n, D))


def dense_decode_combine_plain(m, l, acc, dtype):
    """The kernel's second pass: M = max_i m_i, w_i = exp(m_i - M), out =
    sum w_i acc_i / (sum w_i l_i, or 1 where that is 0), in `dtype`. Chunks
    with no valid token carry l = 0 and acc = 0 and add nothing; a row with
    none at all comes back zero."""
    w = torch.exp(m - m.amax(-1, keepdim=True))
    total = (w * l).sum(-1, keepdim=True)
    out = (w[..., None] * acc).sum(-2)
    return (out / torch.where(total == 0, torch.ones_like(total),
                              total)).to(dtype)


def _refuse_grad(what, *tensors):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no gradient: call it under torch.no_grad() (or on "
            "tensors that do not require grad)")


_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def _check(q, key_cache, value_cache, block_tables, lengths, kv_scales=None):
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
    if q.dtype not in _FLOATS:
        raise TypeError(f"unsupported dtype {q.dtype}")
    tensors = [key_cache, value_cache, block_tables, lengths]
    if kv_scales is None:
        if not (q.dtype == key_cache.dtype == value_cache.dtype):
            raise TypeError("q and the caches must share one dtype")
    else:
        if not (key_cache.dtype == value_cache.dtype == torch.int8):
            raise TypeError("kv_scales= takes int8 caches (the quantized "
                            "page layout)")
        for sc in kv_scales:
            if sc.shape != (n_pages, Hkv) or sc.dtype != torch.float32:
                raise ValueError("kv_scales must be two f32 [n_pages, Hkv] "
                                 "tensors")
        tensors += list(kv_scales)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}")


def _cuda_ready(what, q, tensors, int32s):
    """Checks the kernel makes of its CUDA inputs: contiguous, int32 index
    tensors, 16-byte aligned cache rows (tensors[:2] are the caches)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if any(t.dtype != torch.int32 for t in int32s):
        raise TypeError(f"{what}: block tables and lengths must be int32")
    if not all(t.is_contiguous() for t in (q, *tensors, *int32s)):
        raise ValueError(f"{what}: inputs must be contiguous")
    row = q.shape[-1] * tensors[0].element_size()
    if row % 16 or any(t.data_ptr() % 16 for t in tensors[:2]):
        raise ValueError(
            f"{what}: the kernel loads cache rows 16 bytes at a time; a row "
            f"of {row} bytes must be a multiple of 16 and the caches 16-byte "
            "aligned")


def paged_decode_attention(q, key_cache, value_cache, block_tables, lengths,
                           scale=None, kv_scales=None):
    """q: [B, H, D] (one decode step); key/value_cache:
    [n_pages, Hkv, page_size, D]; block_tables: [B, P] physical page ids
    (-1 unused); lengths: [B] valid tokens including the current one (the
    caller has already written the step's K/V). With `kv_scales`
    (= (k_scale, v_scale), f32 [n_pages, Hkv]) the caches are int8
    payloads, dequantized per page (payload * scale) in the kernel.
    Returns [B, H, D] in q's dtype."""
    global LAUNCHES, Q8_LAUNCHES
    scales = () if kv_scales is None else tuple(kv_scales)
    _refuse_grad("paged_decode_attention", q, key_cache, value_cache, *scales)
    _check(q, key_cache, value_cache, block_tables, lengths, kv_scales)
    B, H, D = q.shape
    _, Hkv, ps, _ = key_cache.shape
    if scale is None:
        scale = D ** -0.5
    quantized = kv_scales is not None
    op = "paged_decode_attention_q8" if quantized else "paged_decode_attention"
    if q.device.type == "cpu":
        if kv_scales is None:
            return report_op(op, paged_decode_attention_plain(
                q, key_cache, value_cache, block_tables, lengths, scale))
        return report_op(op, paged_decode_attention_q8_plain(
            q, key_cache, value_cache, block_tables, lengths, scale, *scales))
    _cuda_ready("paged_decode_attention", q,
                (key_cache, value_cache, *scales), (block_tables, lengths))
    es = key_cache.element_size()
    if D * es > 2048 or 2 * ps * D * es > _SMEM_PER_BLOCK:
        raise ValueError(
            f"paged_decode_attention: the kernel takes rows of at most 2 KB "
            f"and pages whose K and V fit {_SMEM_PER_BLOCK} bytes of shared "
            f"memory, got {ps} rows of D = {D} in {key_cache.dtype}")
    P = block_tables.shape[1]
    ppc = min(paged_chunk_pages(ps, D, es), max(P, 1))
    n_chunks = max(1, -(-P // ppc))
    out = torch.empty_like(q)
    if B == 0:
        return out
    ws = _scratch(_WORKSPACE, q.device, B * H * n_chunks * (D + 2),
                  torch.float32)
    arrivals = _scratch(_ARRIVALS, q.device, B * Hkv, torch.int32)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr())
    tail = (block_tables.data_ptr(), lengths.data_ptr(), ws.data_ptr(),
            arrivals.data_ptr(), out.data_ptr(), B, Hkv, H // Hkv, D, ps, P,
            ppc, float(scale), _build.DTYPE_CODES[str(q.dtype)], stream)
    if quantized:
        err = lib.ptt_paged_decode_attention_q8(
            *ptrs, scales[0].data_ptr(), scales[1].data_ptr(), *tail)
        _build.check(err, "ptt_paged_decode_attention_q8")
        Q8_LAUNCHES += 1
    else:
        err = lib.ptt_paged_decode_attention(*ptrs, *tail)
        _build.check(err, "ptt_paged_decode_attention")
        LAUNCHES += 1
    return report_op(op, out)


def dense_decode_attention(q, key_cache, value_cache, lengths, scale=None):
    """MMHA-style decode over a dense cache: q [B, H, D];
    key/value_cache [B, Hkv, S_max, D]; lengths [B] valid tokens including
    the current one (clamped to S_max). Returns [B, H, D] in q's dtype."""
    global DENSE_LAUNCHES
    _refuse_grad("dense_decode_attention", q, key_cache, value_cache)
    if q.dim() != 3 or key_cache.dim() != 4:
        raise ValueError("q must be [B, H, D] and the caches "
                         "[B, Hkv, S_max, D]")
    B, H, D = q.shape
    _, Hkv, s_max, _ = key_cache.shape
    if value_cache.shape != key_cache.shape:
        raise ValueError("key and value caches differ in shape")
    if key_cache.shape[0] != B or key_cache.shape[3] != D:
        raise ValueError(f"caches {tuple(key_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
    if lengths.shape != (B,):
        raise ValueError("lengths must be [B]")
    if q.dtype not in _FLOATS:
        raise TypeError(f"unsupported dtype {q.dtype}")
    for t in (key_cache, value_cache, lengths):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}")
    if scale is None:
        scale = D ** -0.5
    if q.device.type == "cpu":
        return report_op("masked_multihead_attention",
                         dense_decode_attention_plain(q, key_cache, value_cache,
                                                      lengths, scale))
    if not (q.dtype == key_cache.dtype == value_cache.dtype):
        raise TypeError("dense_decode_attention: the kernel takes q and the "
                        "caches in one dtype")
    _cuda_ready("dense_decode_attention", q, (key_cache, value_cache),
                (lengths,))
    if D * q.element_size() > 2048:
        raise ValueError("dense_decode_attention: the kernel takes rows of at "
                         f"most 2 KB, got D = {D} in {q.dtype}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    chunk = dense_chunk(D, q.element_size(), s_max)
    ws = torch.empty(B, H, -(-s_max // chunk), D + 2, device=q.device,
                     dtype=torch.float32)
    lib = _build.load_library()
    err = lib.ptt_dense_decode_attention(
        q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
        lengths.data_ptr(), ws.data_ptr(), out.data_ptr(), B, Hkv, H // Hkv,
        D, s_max, chunk, float(scale), _build.DTYPE_CODES[str(q.dtype)],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ptt_dense_decode_attention")
    DENSE_LAUNCHES += 1
    return report_op("masked_multihead_attention", out)


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


def paged_kv_write_q8(cache, scales, new, block_tables, lengths):
    """The int8 form of `paged_kv_write`, in place (↔ JAX :252): write one
    decode step's K (or V) rows `new` [B, Hkv, D] into the int8 cache
    [n_pages, Hkv, page_size, D] with per-(page, head) f32 `scales`
    [n_pages, Hkv] (dequant = payload * scale).

    A page's scale is a running abs-max. When this step's row raises it, the
    page's payload is requantized under the new scale in the same write
    (round(payload * (old / new)) in f32: bit-exact when the scale does not
    change, one rounding step when it grows). A write at slot 0 restarts
    the running max and zeroes the rest of the page: appends are sequential,
    so slot 0 is a page's first write, and a page recycled through the free
    list must not inherit its last tenant's scale. Page content is then a
    function of the page's appended history only, which the bitwise
    preemption invariance of the quantized engine rests on. Rows whose
    target entry is -1 write null page 0; live rows never share a write page
    (COW), so only parked rows collide, on page 0, where the order of
    duplicate writes does not matter. Returns (cache, scales)."""
    _refuse_grad("paged_kv_write_q8", cache, scales, new)
    B = new.shape[0]
    ps = cache.shape[2]
    lengths = lengths.long()
    rows = torch.arange(B, device=cache.device)
    page = block_tables.long()[rows, lengths // ps]
    page = torch.where(page < 0, torch.zeros_like(page), page)
    slot = lengths % ps

    new32 = new.float()                                    # [B, Hkv, D]
    row_scale = new32.abs().amax(-1) / KV_QMAX             # [B, Hkv]
    old_scale = torch.where(slot[:, None] == 0,
                            torch.zeros_like(row_scale), scales[page])
    new_scale = torch.maximum(old_scale, row_scale)
    safe = torch.where(new_scale == 0, torch.ones_like(new_scale), new_scale)
    ratio = old_scale / safe                               # <= 1
    pg = torch.round(cache[page].float() * ratio[:, :, None, None])
    q_row = torch.clamp(torch.round(new32 / safe[:, :, None]),
                        -KV_QMAX, KV_QMAX)
    at_slot = (torch.arange(ps, device=cache.device)[None, None, :, None]
               == slot[:, None, None, None])
    pg = torch.where(at_slot, q_row[:, :, None, :], pg)
    cache[page] = pg.to(torch.int8)
    scales[page] = new_scale
    return cache, scales
