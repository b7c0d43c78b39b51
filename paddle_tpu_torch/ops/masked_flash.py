"""Flashmask and varlen attention (↔ paddle_tpu/ops/pallas/masked_flash.py).

Flashmask, the file's first half:

`flashmask_attention_fwd(q, k, v, startend_row_indices, causal, scale)`
takes Paddle's layout, q [B, Sq, H, D], k/v [B, Skv, Hkv, D] (GQA: H a
multiple of Hkv) and the index tensor [B, Hm, Skv, n] (H a multiple of
Hm, query head h reading mask head h // (H / Hm)), and returns
[B, Sq, H, D], differentiably through `FlashmaskAttention`, a
`torch.autograd.Function` (the JAX package's custom VJP, :345-377). For
each key column the indices name the query rows that are MASKED OUT
(`_flashmask_keep` :46):

- causal, n = 1: rows >= start; causal, n = 2: rows in [start, end);
- non-causal, n = 2: rows >= LTS or rows < UTE;
- non-causal, n = 4: rows in [LTS, LTE) or in [UTS, UTE).

Causal masking is top-left (key c is visible to query r iff c <= r), not
the bottom-right alignment of `ops.flash_attention`; the two agree only
when Sq == Skv. A row that keeps no key gives zeros and zero gradients,
as the JAX kernel gives (the JAX package's composite route gives the mean
of V there, and aligns its causal mask bottom-right; this port follows the
kernel).

Three kernels of `csrc/masked_flash.cu` under the flashmask policy: in
bf16 and f16 the wgmma kernels of `csrc/flash_fwd_sm90.cuh` (forward) and
`csrc/flash_bwd_sm90.cuh` (dq, dk/dv), in f32 the CUDA-core tile kernels
of `csrc/flash_tiles.cuh`. Each sits beside its plain version and its
launch counter:

- `flashmask_fwd` → (O, LSE): `flashmask_fwd_plain` on CPU tensors;
  `FWD_LAUNCHES`;
- `flashmask_bwd_dq` → dQ: `flashmask_bwd_dq_plain`; `DQ_LAUNCHES`;
- `flashmask_bwd_dkv` → dK, dV of the kv heads in f32, the g query heads
  of a kv head summed as `_fm_bwd` does: `flashmask_bwd_dkv_plain`;
  `DKV_LAUNCHES`. The backward casts them to k's dtype.

The 16-bit kernels read `flashmask_tile_classes`: per 128-row q tile and
128-key kv tile whether no pair is kept (the tile is skipped), every pair
is (no predicate runs) or some are (the predicate runs on the tile), from
per-tile min/max of the index rows. `FlashmaskAttention` derives them once
in the forward and hands them to the backward; the wrappers take them as
`cls` and derive them when it is None. q, k, v and dO reach the 16-bit
kernels through `ops.flash_attention.tma_operands`.

The kernels take the indices as int32 [B, Hm, n, Skv] (the JAX kernel's
`idx` after its moveaxis), one row of n per mask head contiguous over the
keys. The softmax, the 16-bit rounding of P and dS, and LSE = +inf for a row
that keeps no key are those of `ops.flash_attention`.

Varlen, the second half: `varlen_flash_attention_fwd(q, k, v, cu_seqlens_q,
cu_seqlens_k, scale, causal)` takes packed documents, q [Tq, H, D] and k/v
[Tk, Hkv, D] with [B + 1] prefix sums of the documents' lengths, and
returns [Tq, H, D], differentiably through `VarlenAttention` (the JAX
package's custom VJP, `_varlen_vjp_bwd` :669). Each token's segment is the
number of boundaries cu_seqlens[1:-1] at or before it, its position its
index less cu_seqlens[segment] (the JAX entry's encoding, :765-769); row r
keeps key c iff they share a segment and, when causal, pos_q >= pos_k
(top-left within each segment, also when a q segment and its k segment
differ in length). A row that keeps no key (its k segment is empty) gives
zeros and zero gradients, as the JAX kernel does (its composite route,
taken when Pallas is off, gives the mean of V there; this port follows the
kernel). `varlen_layout` turns cu_seqlens into what the kernels read, with
torch ops on the device and no host sync: per key its segment's q-row
range and the offset cu_q - cu_k (the keep test), and per 64-row tile the
key range of a q tile and the q-row range of a key tile (the tiles each CTA
visits). Three kernels of `csrc/varlen_flash.cu` under the varlen policy:
in bf16 and f16 the wgmma kernels of `csrc/flash_fwd_sm90.cuh` (forward)
and `csrc/flash_bwd_sm90.cuh` (dq, dk/dv), which take q, k, v (and dO)
through `ops.flash_attention.tma_operands` and read the tile classes (per
128-row q tile and 128-key kv tile: skipped, full or partial, from
per-tile min/max of the keys' segment ranges) that the forward's entry
derives just before it with `varlen_classes_kernel` (`varlen_tile_classes`;
plain: `varlen_tile_classes_plain`); in f32 the CUDA-core tile kernels of
`csrc/flash_tiles.cuh`. `VarlenAttention` keeps the forward's classes for
the backward; the backward wrappers take them as `cls` and derive them
when it is None. Each kernel sits beside its plain version and its launch
counter:

- `varlen_fwd` → (O, LSE [H, Tq]): `varlen_fwd_plain`; `VL_FWD_LAUNCHES`;
- `varlen_bwd_dq` → dQ: `varlen_bwd_dq_plain`; `VL_DQ_LAUNCHES`;
- `varlen_bwd_dkv` → dK, dV of the kv heads in f32, the g query heads of
  a kv head summed as `_varlen_vjp_bwd` does: `varlen_bwd_dkv_plain`;
  `VL_DKV_LAUNCHES`. The backward casts them to k's dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build
from ..framework.core import report_op
from .flash_attention import (HALF, _attend, _bwd_checks, _bwd_operands,
                              _check, _cut, _device_checks, _dkv, _dq,
                              _fwd_operands, _fwd_outputs, _fwd_result,
                              _group_sum, _logits, _probs_and_ds, _ptr)

__all__ = ["DKV_LAUNCHES", "DQ_LAUNCHES", "FWD_LAUNCHES",
           "FlashmaskAttention", "VL_DKV_LAUNCHES", "VL_DQ_LAUNCHES",
           "VL_FWD_LAUNCHES", "VarlenAttention", "VarlenLayout",
           "flashmask_attention_fwd", "flashmask_bwd_dkv",
           "flashmask_bwd_dkv_plain", "flashmask_bwd_dq",
           "flashmask_bwd_dq_plain", "flashmask_fwd", "flashmask_fwd_plain",
           "flashmask_keep", "flashmask_tile_classes", "varlen_bwd_dkv", "varlen_bwd_dkv_plain",
           "varlen_bwd_dq", "varlen_bwd_dq_plain",
           "varlen_flash_attention_fwd", "varlen_fwd", "varlen_fwd_plain",
           "varlen_keep", "varlen_layout", "varlen_tile_classes",
           "varlen_tile_classes_plain"]

# kernel launches since import (or since a caller reset them)
FWD_LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
VL_FWD_LAUNCHES = 0
VL_DQ_LAUNCHES = 0
VL_DKV_LAUNCHES = 0


def flashmask_keep(idx, sq, skv, causal):
    """bool [B, Hm, Sq, Skv]: query row r keeps key c under the indices idx
    [B, Hm, n, Skv] (`_flashmask_keep`)."""
    n = idx.shape[2]
    rows = torch.arange(sq, device=idx.device)[:, None]
    cols = torch.arange(skv, device=idx.device)[None, :]
    i = idx.long()[:, :, :, None, :]  # [B, Hm, n, 1, Skv]
    if causal:
        keep = (cols <= rows)[None, None]
        if n == 1:
            masked = rows >= i[:, :, 0]
        else:
            masked = (rows >= i[:, :, 0]) & (rows < i[:, :, 1])
    else:
        keep = torch.ones(1, 1, sq, skv, dtype=torch.bool, device=idx.device)
        if n == 2:
            masked = (rows >= i[:, :, 0]) | (rows < i[:, :, 1])
        else:
            masked = (((rows >= i[:, :, 0]) & (rows < i[:, :, 1]))
                      | ((rows >= i[:, :, 2]) & (rows < i[:, :, 3])))
    return keep & ~masked


SM90_TILE = 128  # rows and keys of the sm90 kernels' tiles (csrc/flash_fwd_sm90.cuh)
SKIP_TILE, PARTIAL_TILE, FULL_TILE = 0, 1, 2  # csrc/flash_tiles.cuh TileClass


def flashmask_tile_classes(idx, sq, skv, causal, tile=SM90_TILE):
    """uint8 [B, Hm, ceil(Sq / tile), ceil(Skv / tile)]: the class of each
    (q tile, kv tile) under the integer indices idx [B, Hm, n, Skv], by
    torch ops on idx's device (no host sync), from the min and max of each
    index row over the tile's keys: SKIP_TILE where no pair is kept,
    FULL_TILE where every pair of real rows and keys is (and no key is
    past Skv), PARTIAL_TILE otherwise. Both tests are sufficient
    conditions: a tile they cannot decide is partial, where the kernel
    applies the predicate to each pair."""
    B, Hm, n, _ = idx.shape
    nq, nk = -(-sq // tile), -(-skv // tile)
    pad = nk * tile - skv
    if pad:  # copies of the last key leave the last tile's min and max as they are
        idx = torch.cat([idx, idx[..., -1:].expand(B, Hm, n, pad)], -1)
    lo, hi = torch.aminmax(idx.reshape(B, Hm, n, nk, tile), dim=-1)
    L, U = lo[:, :, :, None, :].unbind(2), hi[:, :, :, None, :].unbind(2)
    r0 = torch.arange(0, nq * tile, tile, device=idx.device)[:, None]
    r1 = (r0 + tile).clamp_(max=sq)  # [nq, 1]: a q tile's rows [r0, r1)
    if causal:  # top-left: k tiles before q's lie below the diagonal
        step = (torch.arange(nq, device=idx.device)[:, None]
                - torch.arange(nk, device=idx.device))
        if n == 1:  # masked rows >= i0
            full = (step > 0) & (r1 <= L[0])
            skip = (step < 0) | (r0 >= U[0])
        else:  # masked rows in [i0, i1)
            full = (step > 0) & ((r1 <= L[0]) | (r0 >= U[1]))
            skip = (step < 0) | ((U[0] <= r0) & (L[1] >= r1))
    elif n == 2:  # kept rows in [i1, i0)
        full = (U[1] <= r0) & (r1 <= L[0])
        skip = (r1 <= L[1]) | (r0 >= U[0])
    else:  # masked rows in [i0, i1) or in [i2, i3)
        full = (((r1 <= L[0]) | (r0 >= U[1]))
                & ((r1 <= L[2]) | (r0 >= U[3])))
        skip = (((U[0] <= r0) & (L[1] >= r1))
                | ((U[2] <= r0) & (L[3] >= r1)))
    if pad:
        full[..., -1] = False
    return (full.to(torch.uint8) + FULL_TILE - PARTIAL_TILE
            ).masked_fill_(skip, SKIP_TILE)


def _mask_logits(q, k, idx, causal, scale):
    keep = flashmask_keep(idx, q.shape[1], k.shape[1], causal)
    return _logits(q, k, scale,
                   keep.repeat_interleave(q.shape[2] // idx.shape[1], dim=1))


def flashmask_fwd_plain(q, k, v, idx, causal, scale):
    """Plain PyTorch version of the forward kernel: (O in q's dtype,
    LSE [B, H, Sq] f32, +inf for a row that keeps no key)."""
    return _attend(q, v, _mask_logits(q, k, idx, causal, scale))


def flashmask_bwd_dq_plain(q, k, v, idx, dout, lse, delta, causal, scale):
    """Plain PyTorch version of the dq kernel: dQ [B, Sq, H, D] in q's
    dtype."""
    s = _mask_logits(q, k, idx, causal, scale)
    return _dq(q, k, _probs_and_ds(q, v, s, dout, lse, delta, scale)[1])


def flashmask_bwd_dkv_plain(q, k, v, idx, dout, lse, delta, causal, scale):
    """Plain PyTorch version of the dk/dv kernel: the kv heads' dK, dV, f32
    [B, Skv, Hkv, D] each (the g query heads of a kv head summed)."""
    s = _mask_logits(q, k, idx, causal, scale)
    dk, dv = _dkv(q, dout, *_probs_and_ds(q, v, s, dout, lse, delta, scale))
    return _group_sum(dk, k.shape[2]), _group_sum(dv, k.shape[2])


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #


def _check_idx(q, k, idx, causal):
    B, _, H, _ = q.shape
    if idx.dim() != 4 or idx.shape[0] != B or idx.shape[3] != k.shape[1]:
        raise ValueError(f"flashmask indices must be [B, Hm, n, Skv] = [{B}, "
                         f"Hm, n, {k.shape[1]}], got {tuple(idx.shape)}")
    Hm, n = idx.shape[1], idx.shape[2]
    if Hm < 1 or H % Hm:
        raise ValueError(f"{H} query heads do not group over {Hm} mask heads")
    if n not in ((1, 2) if causal else (2, 4)):
        raise ValueError(f"flashmask takes n = {'1 or 2' if causal else '2 or 4'} "
                         f"indices per key when causal={bool(causal)}, got {n}")
    if idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise TypeError(f"flashmask indices must be integers, got {idx.dtype}")
    if idx.device != q.device:
        raise ValueError(f"flashmask indices must be on {q.device}")


def _kernel_idx(idx):
    return idx.to(torch.int32).contiguous()


def _tile_classes(idx, cls, sq, skv, causal):
    """The 16-bit kernels' tile classes of the int32 indices: `cls` as given
    (checked) or, when None, derived."""
    if cls is None:
        return flashmask_tile_classes(idx, sq, skv, causal)
    want = (idx.shape[0], idx.shape[1], -(-sq // SM90_TILE),
            -(-skv // SM90_TILE))
    if tuple(cls.shape) != want or cls.dtype != torch.uint8 \
            or cls.device != idx.device:
        raise ValueError(f"flashmask tile classes must be uint8 {list(want)} "
                         f"on {idx.device} (flashmask_tile_classes), got "
                         f"{cls.dtype} {list(cls.shape)} on {cls.device}")
    return cls.contiguous()


def _tail(q, causal, scale):
    """The arguments every flashmask entry point takes after the strides:
    scale, causal, dtype, stream."""
    return (float(scale), int(bool(causal)), _build.DTYPE_CODES[str(q.dtype)],
            torch.cuda.current_stream(q.device).cuda_stream)


def _flashmask_fwd(q, k, v, idx, causal, scale):
    """(O, LSE, the tile classes the 16-bit kernel read or None): the forward
    wrapper, keeping the classes for the backward."""
    global FWD_LAUNCHES
    _check(q, k, v, None)
    _check_idx(q, k, idx, causal)
    if q.device.type == "cpu":
        return (*flashmask_fwd_plain(q, k, v, idx, causal, scale), None)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    q, k, v, _, strides, d = _fwd_operands(q, k, v, None)
    out, lse = _fwd_outputs(q, Sq, H, d)
    if out.numel() == 0 or Skv == 0:
        return (*_fwd_result(out, lse, D, Skv), None)
    idx = _kernel_idx(idx)
    cls = None
    if q.dtype in HALF:
        cls = flashmask_tile_classes(idx, Sq, Skv, causal)
    err = _build.load_library().ptt_flashmask_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(), _ptr(cls),
        out.data_ptr(), lse.data_ptr(), B, H, Hkv, idx.shape[1], idx.shape[2],
        Sq, Skv, d, strides, *_tail(q, causal, scale))
    _build.check(err, "ptt_flashmask_fwd")
    FWD_LAUNCHES += 1
    return (*_fwd_result(out, lse, D, Skv), cls)


def flashmask_fwd(q, k, v, idx, causal, scale):
    """(O [B, Sq, H, D] in q's dtype, LSE [B, H, Sq] f32) under the indices
    idx [B, Hm, n, Skv]. CPU tensors run the plain version; CUDA tensors
    launch the kernel."""
    return _flashmask_fwd(q, k, v, idx, causal, scale)[:2]


def flashmask_bwd_dq(q, k, v, idx, dout, lse, delta, causal, scale, cls=None):
    """dQ [B, Sq, H, D] in q's dtype from the forward's LSE and
    delta = rowsum(dO * O) [B, H, Sq] f32. `cls`: the 16-bit kernel's tile
    classes, `flashmask_tile_classes` of the indices (derived when None).
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    global DQ_LAUNCHES
    _check(q, k, v, None)
    _check_idx(q, k, idx, causal)
    _bwd_checks(q, lse, delta)
    if q.device.type == "cpu":
        return flashmask_bwd_dq_plain(q, k, v, idx, dout, lse, delta, causal,
                                      scale)
    _device_checks(q)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    q, k, v, dout, strides, d = _bwd_operands(q, k, v, dout)
    dq = torch.empty(B, Sq, H, d, device=q.device, dtype=q.dtype)
    if dq.numel() == 0 or Skv == 0:
        return _cut(dq.zero_(), D)
    idx = _kernel_idx(idx)
    cls = (_tile_classes(idx, cls, Sq, Skv, causal)
           if q.dtype in HALF else None)
    lse, delta = lse.contiguous(), delta.contiguous()
    err = _build.load_library().ptt_flashmask_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(), _ptr(cls),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H,
        Hkv, idx.shape[1], idx.shape[2], Sq, Skv, d, strides,
        *_tail(q, causal, scale))
    _build.check(err, "ptt_flashmask_bwd_dq")
    DQ_LAUNCHES += 1
    return _cut(dq, D)


def flashmask_bwd_dkv(q, k, v, idx, dout, lse, delta, causal, scale,
                      cls=None):
    """(dK, dV), each f32 [B, Skv, Hkv, D]: the kv heads' gradients, the g
    query heads of a kv head summed. `cls` as for `flashmask_bwd_dq`. The
    16-bit kernel writes them as they are; the f32 kernel writes one slice
    per query head, which torch sums. CPU tensors run the plain version;
    CUDA tensors launch the kernel."""
    global DKV_LAUNCHES
    _check(q, k, v, None)
    _check_idx(q, k, idx, causal)
    _bwd_checks(q, lse, delta)
    if q.device.type == "cpu":
        return flashmask_bwd_dkv_plain(q, k, v, idx, dout, lse, delta, causal,
                                       scale)
    _device_checks(q)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    half = q.dtype in HALF
    if B * Skv * Hkv * D == 0 or Sq == 0:
        dk = torch.zeros(B, Skv, Hkv, D, device=q.device, dtype=torch.float32)
        return dk, torch.zeros_like(dk)
    q, k, v, dout, strides, d = _bwd_operands(q, k, v, dout)
    dk = torch.empty(B, Skv, Hkv if half else H, d, device=q.device,
                     dtype=torch.float32)
    dv = torch.empty_like(dk)
    idx = _kernel_idx(idx)
    cls = _tile_classes(idx, cls, Sq, Skv, causal) if half else None
    lse, delta = lse.contiguous(), delta.contiguous()
    err = _build.load_library().ptt_flashmask_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(), _ptr(cls),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, H, Hkv, idx.shape[1], idx.shape[2], Sq, Skv, d,
        strides, *_tail(q, causal, scale))
    _build.check(err, "ptt_flashmask_bwd_dkv")
    DKV_LAUNCHES += 1
    return _cut(_group_sum(dk, Hkv), D), _cut(_group_sum(dv, Hkv), D)


# --------------------------------------------------------------------------- #
# autograd and the public entry
# --------------------------------------------------------------------------- #


class FlashmaskAttention(torch.autograd.Function):
    """Flashmask attention with its backward (↔ `_flashmask`'s custom VJP).
    Saves q, k, v, the indices, O, the LSE and the 16-bit kernels' tile
    classes (None elsewhere); the backward computes delta = rowsum(dO * O)
    in f32 with torch (as `_fm_bwd` does with jnp) and runs the dq and dk/dv
    kernels on the same classes; dk/dv come out summed over the g query
    heads of a kv head, and are cast to k's dtype. The indices are data:
    their gradient is None."""

    @staticmethod
    def forward(ctx, q, k, v, idx, causal, scale):
        out, lse, cls = _flashmask_fwd(q, k, v, idx, causal, scale)
        ctx.save_for_backward(q, k, v, idx, out, lse, cls)
        ctx.causal = causal
        ctx.scale = scale
        return report_op("flashmask_attention", out)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, idx, out, lse, cls = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flashmask_bwd_dq(q, k, v, idx, dout, lse, delta, causal, scale,
                              cls)
        dk, dv = flashmask_bwd_dkv(q, k, v, idx, dout, lse, delta, causal,
                                   scale, cls)
        dk, dv = dk.to(k.dtype), dv.to(v.dtype)
        report_op("flashmask_attention_grad", (dq, dk, dv))
        return dq, dk, dv, None, None, None


def flashmask_attention_fwd(q, k, v, startend_row_indices, causal=True,
                            scale=None):
    """Paddle-layout entry: q [B, Sq, H, D], k/v [B, Skv, Hkv, D],
    startend_row_indices [B, Hm, Skv, n] -> [B, Sq, H, D], differentiable
    with respect to q, k and v. k and v are cast to q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    idx = startend_row_indices.detach().transpose(2, 3)  # [B, Hm, n, Skv]
    return FlashmaskAttention.apply(q, k.to(q.dtype), v.to(q.dtype), idx,
                                    bool(causal), float(scale))


# --------------------------------------------------------------------------- #
# varlen: packed documents
# --------------------------------------------------------------------------- #

TILE = 64  # the tile kernels' rows and columns (csrc/flash_tiles.cuh kTile)


class VarlenLayout(NamedTuple):
    """What the varlen kernels read, all int32 on the tensors' device:
    `kinfo` [3, Tk] per key its segment's first q row, one past its last,
    and cu_q[s] - cu_k[s]; `qrange` [2, ceil(Tq / 64)] per q tile the first
    key and one past the last it visits; `krange` [2, ceil(Tk / 64)] per
    key tile the first q row and one past the last."""
    kinfo: torch.Tensor
    qrange: torch.Tensor
    krange: torch.Tensor


def _segments(cu, T):
    """[T] int64: each token's segment, the number of boundaries
    cu[1:-1] at or before it (`jnp.cumsum(zeros.at[cu[1:-1]].add(1))`;
    boundaries outside [0, T) are dropped, as the JAX scatter drops
    them)."""
    b = cu[1:-1].long()
    marks = torch.zeros(T + 1, dtype=torch.long, device=cu.device)
    ok = (b >= 0) & (b < T)
    marks.index_add_(0, torch.where(ok, b, torch.full_like(b, T)),
                     torch.ones_like(b))
    return marks[:T].cumsum(0)


def varlen_layout(cu_seqlens_q, cu_seqlens_k, Tq, Tk, causal):
    """`VarlenLayout` of packed batches with prefix sums cu_seqlens [B + 1]
    (B >= 1), by torch ops on cu's device (no host sync). The tile ranges
    cover every kept pair: a q tile visits the keys from the first key of
    its first segment to the last key of its last segment (causal: to the
    last key its last row can see); a key tile the q rows of its segments
    (causal: from the first row that can see its first key)."""
    if cu_seqlens_q.dim() != 1 or cu_seqlens_q.shape != cu_seqlens_k.shape \
            or cu_seqlens_q.numel() < 2:
        raise ValueError("cu_seqlens_q and cu_seqlens_k must be [B + 1] "
                         "prefix sums with B >= 1, of one length")
    if cu_seqlens_q.dtype.is_floating_point or cu_seqlens_k.dtype.is_floating_point:
        raise TypeError("cu_seqlens must be integers")
    dev = cu_seqlens_q.device
    cu_q, cu_k = cu_seqlens_q.long(), cu_seqlens_k.to(dev).long()
    nseg = cu_q.numel() - 1
    seg_q, seg_k = _segments(cu_q, Tq), _segments(cu_k, Tk)
    s = torch.arange(nseg, device=dev)
    q_lo = torch.searchsorted(seg_q, s)
    q_hi = torch.searchsorted(seg_q, s, right=True)
    k_lo = torch.searchsorted(seg_k, s)
    k_hi = torch.searchsorted(seg_k, s, right=True)
    off = cu_q[:nseg] - cu_k[:nseg]
    kinfo = torch.stack([q_lo[seg_k], q_hi[seg_k], off[seg_k]])

    q0 = torch.arange(0, Tq, TILE, device=dev)
    last = torch.clamp(q0 + TILE - 1, max=max(Tq - 1, 0))
    s0, s1 = seg_q[q0], seg_q[last]
    kv_end = k_hi[s1]
    if causal:
        kv_end = torch.maximum(k_lo[s1], torch.minimum(kv_end,
                                                       last + 1 - off[s1]))
    qrange = torch.stack([k_lo[s0], kv_end])

    k0 = torch.arange(0, Tk, TILE, device=dev)
    last = torch.clamp(k0 + TILE - 1, max=max(Tk - 1, 0))
    s0, s1 = seg_k[k0], seg_k[last]
    q_start = q_lo[s0]
    if causal:
        q_start = torch.minimum(q_hi[s0], torch.maximum(q_start, k0 + off[s0]))
    krange = torch.stack([q_start, q_hi[s1]])
    return VarlenLayout(*(t.to(torch.int32).contiguous()
                          for t in (kinfo, qrange, krange)))


def varlen_keep(layout, Tq, causal):
    """bool [Tq, Tk]: query row r keeps key c (`_vl_keep`), from the keys'
    segment ranges alone."""
    lo, hi, off = layout.kinfo.long()
    rows = torch.arange(Tq, device=lo.device)[:, None]
    keep = (rows >= lo) & (rows < hi)
    if causal:
        cols = torch.arange(lo.numel(), device=lo.device)
        keep &= rows >= cols + off
    return keep


def varlen_tile_classes_plain(layout, Tq, Tk, causal, tile=SM90_TILE):
    """uint8 [ceil(Tq / tile), ceil(Tk / tile)]: the class of each (q tile,
    kv tile) of a pack under `layout`, by torch ops on the layout's device
    (no host sync), from the min and max over the tile's keys of the first
    q row of their segment (lo), one past its last (hi) and, causal, the
    first row that sees them (c + cu_q[s] - cu_k[s]). For the q tile's rows
    [r0, r1), r1 clamped to Tq: SKIP_TILE where r1 <= min lo, r0 >= max hi
    or (causal) r1 - 1 < min(c + off); FULL_TILE where max lo <= r0,
    r1 <= min hi, (causal) r0 >= max(c + off) and no key is past Tk;
    PARTIAL_TILE otherwise. Both tests are sufficient conditions: a tile
    they cannot decide (one that straddles a document edge, say) is
    partial, where the kernel applies the keep test to each pair."""
    lo, hi, off = layout.kinfo.long()
    dev = lo.device
    nq, nk = -(-Tq // tile), -(-Tk // tile)
    if nk == 0:
        return torch.zeros(nq, 0, dtype=torch.uint8, device=dev)
    keys = torch.stack([lo, hi, torch.arange(Tk, device=dev) + off])
    pad = nk * tile - Tk
    if pad:  # copies of the last key leave the last tile's min and max as they are
        keys = torch.cat([keys, keys[:, -1:].expand(3, pad)], 1)
    (lo_min, hi_min, first_min), (lo_max, hi_max, first_max) = torch.aminmax(
        keys.reshape(3, nk, tile), dim=-1)
    r0 = torch.arange(0, nq * tile, tile, device=dev)[:, None]
    r1 = (r0 + tile).clamp_(max=Tq)  # [nq, 1]: a q tile's rows [r0, r1)
    skip = (r1 <= lo_min) | (r0 >= hi_max)
    full = (lo_max <= r0) & (r1 <= hi_min)
    if causal:
        skip |= r1 - 1 < first_min
        full &= r0 >= first_max
    if pad:
        full[:, -1] = False
    return (full.to(torch.uint8) + FULL_TILE - PARTIAL_TILE
            ).masked_fill_(skip, SKIP_TILE)


def varlen_tile_classes(layout, Tq, Tk, causal, tile=SM90_TILE):
    """`varlen_tile_classes_plain`'s classes. A CPU layout runs it; a CUDA
    one launches `varlen_classes_kernel` (128-row tiles only), the kernel
    the 16-bit `varlen_fwd` runs before the forward in the same entry."""
    if layout.kinfo.device.type == "cpu":
        return varlen_tile_classes_plain(layout, Tq, Tk, causal, tile)
    if tile != SM90_TILE:
        raise ValueError(f"the tile classes kernel has {SM90_TILE}-row tiles")
    cls = torch.empty(-(-Tq // tile), -(-Tk // tile), dtype=torch.uint8,
                      device=layout.kinfo.device)
    err = _build.load_library().ptt_varlen_tile_classes(
        layout.kinfo.data_ptr(), cls.data_ptr(), Tq, Tk, int(bool(causal)),
        _stream(layout.kinfo))
    _build.check(err, "ptt_varlen_tile_classes")
    return cls


def _by_kv_head(fn, q, k, v, layout, causal, *rest):
    """`fn(q_j, k_j, v_j, keep, *rest_j)` for each kv head j and the g
    query heads it serves, the results joined over the heads: the plain
    versions hold one kv head's [g, Tq, Tk] logits at a time. `rest` are
    per-query-head tensors, [Tq, H, D] (head axis 1) or [H, Tq] (axis 0)."""
    keep = varlen_keep(layout, q.shape[0], causal)[None, None]
    g = q.shape[1] // k.shape[1]
    outs = []
    for j in range(k.shape[1]):
        hs = slice(j * g, (j + 1) * g)
        outs.append(fn(q[:, hs], k[:, j:j + 1], v[:, j:j + 1], keep,
                       *(t[:, hs] if t.dim() == 3 else t[hs] for t in rest)))
    return tuple(torch.cat([o[i] for o in outs], dim=1 if outs[0][i].dim() == 3
                           else 0) for i in range(len(outs[0])))


def varlen_fwd_plain(q, k, v, layout, causal, scale):
    """Plain PyTorch version of the forward kernel: (O [Tq, H, D] in q's
    dtype, LSE [H, Tq] f32, +inf for a row that keeps no key)."""

    def fwd(qj, kj, vj, keep):
        out, lse = _attend(qj[None], vj[None],
                           _logits(qj[None], kj[None], scale, keep))
        return out[0], lse[0]

    return _by_kv_head(fwd, q, k, v, layout, causal)


def varlen_bwd_dq_plain(q, k, v, layout, dout, lse, delta, causal, scale):
    """Plain PyTorch version of the dq kernel: dQ [Tq, H, D] in q's
    dtype."""

    def dq(qj, kj, vj, keep, doj, lsej, dj):
        s = _logits(qj[None], kj[None], scale, keep)
        _, ds = _probs_and_ds(qj[None], vj[None], s, doj[None], lsej[None],
                              dj[None], scale)
        return (_dq(qj[None], kj[None], ds)[0],)

    return _by_kv_head(dq, q, k, v, layout, causal, dout, lse, delta)[0]


def varlen_bwd_dkv_plain(q, k, v, layout, dout, lse, delta, causal, scale):
    """Plain PyTorch version of the dk/dv kernel: the kv heads' dK, dV, f32
    [Tk, Hkv, D] each (the g query heads of a kv head summed)."""

    def dkv(qj, kj, vj, keep, doj, lsej, dj):
        s = _logits(qj[None], kj[None], scale, keep)
        dk, dv = _dkv(qj[None], doj[None], *_probs_and_ds(
            qj[None], vj[None], s, doj[None], lsej[None], dj[None], scale))
        return _group_sum(dk, 1)[0], _group_sum(dv, 1)[0]

    return _by_kv_head(dkv, q, k, v, layout, causal, dout, lse, delta)


def _vl_check(q, k, v, layout):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("varlen attention wants q [Tq, H, D] and k/v "
                         "[Tk, Hkv, D]")
    _check(q[None], k[None], v[None], None)
    nq, nk = -(-q.shape[0] // TILE), -(-k.shape[0] // TILE)
    if (tuple(layout.kinfo.shape) != (3, k.shape[0])
            or tuple(layout.qrange.shape) != (2, nq)
            or tuple(layout.krange.shape) != (2, nk)):
        raise ValueError("the varlen layout does not fit q and k: build it "
                         "with varlen_layout(cu_q, cu_k, Tq, Tk, causal)")
    if any(t.device != q.device or t.dtype != torch.int32 for t in layout):
        raise ValueError(f"the varlen layout must be int32 on {q.device}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _varlen_fwd(q, k, v, layout, causal, scale):
    """(O, LSE, the tile classes the 16-bit kernel read or None): the forward
    wrapper, keeping the classes for the backward."""
    global VL_FWD_LAUNCHES
    _vl_check(q, k, v, layout)
    if q.device.type == "cpu":
        return (*varlen_fwd_plain(q, k, v, layout, causal, scale), None)
    Tq, H, D = q.shape
    Tk, Hkv = k.shape[0], k.shape[1]
    q4, k4, v4, _, strides, d = _fwd_operands(q[None], k[None], v[None], None)
    out, lse = _fwd_outputs(q4, Tq, H, d)
    if out.numel() == 0 or Tk == 0:
        out, lse = _fwd_result(out, lse, D, Tk)
        return out[0], lse[0], None
    cls = (torch.empty(-(-Tq // SM90_TILE), -(-Tk // SM90_TILE),
                       dtype=torch.uint8, device=q.device)
           if q.dtype in HALF else None)  # written by the entry
    err = _build.load_library().ptt_varlen_fwd(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), layout.kinfo.data_ptr(),
        layout.qrange.data_ptr(), layout.krange.data_ptr(), _ptr(cls),
        out.data_ptr(), lse.data_ptr(), H, Hkv, Tq, Tk, d, strides,
        float(scale), int(bool(causal)), _build.DTYPE_CODES[str(q.dtype)],
        _stream(q))
    _build.check(err, "ptt_varlen_fwd")
    VL_FWD_LAUNCHES += 1
    out, lse = _fwd_result(out, lse, D, Tk)
    return out[0], lse[0], cls


def varlen_fwd(q, k, v, layout, causal, scale):
    """(O [Tq, H, D] in q's dtype, LSE [H, Tq] f32) over the packed
    segments of `layout`. CPU tensors run the plain version; CUDA tensors
    launch the kernels (16 bits: the tile classes of the layout, then the
    forward on them)."""
    return _varlen_fwd(q, k, v, layout, causal, scale)[:2]


def _vl_bwd_checks(q, k, v, layout, lse, delta, cls):
    """The checks of both backward wrappers; `cls`, when given, on any
    device."""
    _vl_check(q, k, v, layout)
    _bwd_checks(q[None], lse[None], delta[None])
    if cls is None:
        return
    want = (-(-q.shape[0] // SM90_TILE), -(-k.shape[0] // SM90_TILE))
    if tuple(cls.shape) != want or cls.dtype != torch.uint8 \
            or cls.device != q.device:
        raise ValueError(f"varlen tile classes must be uint8 {list(want)} on "
                         f"{q.device} (varlen_tile_classes), got {cls.dtype} "
                         f"{list(cls.shape)} on {cls.device}")


def _vl_classes(q, layout, cls, Tk, causal):
    """The tile classes a 16-bit backward kernel reads: `cls` as given or,
    when None, derived; None in f32."""
    if q.dtype not in HALF:
        return None
    if cls is None:
        return varlen_tile_classes(layout, q.shape[0], Tk, causal)
    return cls.contiguous()


def varlen_bwd_dq(q, k, v, layout, dout, lse, delta, causal, scale,
                  cls=None):
    """dQ [Tq, H, D] in q's dtype from the forward's LSE and
    delta = rowsum(dO * O) [H, Tq] f32. `cls`: the 16-bit kernel's tile
    classes, `varlen_tile_classes` of the layout (derived when None).
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    global VL_DQ_LAUNCHES
    _vl_bwd_checks(q, k, v, layout, lse, delta, cls)
    if q.device.type == "cpu":
        return varlen_bwd_dq_plain(q, k, v, layout, dout, lse, delta, causal,
                                   scale)
    _device_checks(q)
    Tq, H, D = q.shape
    Tk = k.shape[0]
    q4, k4, v4, d4, strides, d = _bwd_operands(q[None], k[None], v[None],
                                               dout[None])
    dq = torch.empty(1, Tq, H, d, device=q.device, dtype=q.dtype)
    if dq.numel() == 0 or Tk == 0:
        return _cut(dq.zero_(), D)[0]
    cls = _vl_classes(q, layout, cls, Tk, causal)
    lse, delta = lse.contiguous(), delta.contiguous()
    err = _build.load_library().ptt_varlen_bwd_dq(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), layout.kinfo.data_ptr(),
        layout.qrange.data_ptr(), layout.krange.data_ptr(), _ptr(cls),
        d4.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), H,
        k.shape[1], Tq, Tk, d, strides, float(scale), int(bool(causal)),
        _build.DTYPE_CODES[str(q.dtype)], _stream(q))
    _build.check(err, "ptt_varlen_bwd_dq")
    VL_DQ_LAUNCHES += 1
    return _cut(dq, D)[0]


def varlen_bwd_dkv(q, k, v, layout, dout, lse, delta, causal, scale,
                   cls=None):
    """(dK, dV), each f32 [Tk, Hkv, D]: the kv heads' gradients, the g query
    heads of a kv head summed. `cls` as for `varlen_bwd_dq`. The 16-bit
    kernel writes them as they are; the f32 kernel writes one slice per
    query head, which torch sums. CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    global VL_DKV_LAUNCHES
    _vl_bwd_checks(q, k, v, layout, lse, delta, cls)
    if q.device.type == "cpu":
        return varlen_bwd_dkv_plain(q, k, v, layout, dout, lse, delta, causal,
                                    scale)
    _device_checks(q)
    Tq, H, D = q.shape
    Tk, Hkv = k.shape[0], k.shape[1]
    if Tk * Hkv * D == 0 or Tq == 0:
        dk = torch.zeros(Tk, Hkv, D, device=q.device, dtype=torch.float32)
        return dk, torch.zeros_like(dk)
    half = q.dtype in HALF
    q4, k4, v4, d4, strides, d = _bwd_operands(q[None], k[None], v[None],
                                               dout[None])
    dk = torch.empty(1, Tk, Hkv if half else H, d, device=q.device,
                     dtype=torch.float32)
    dv = torch.empty_like(dk)
    cls = _vl_classes(q, layout, cls, Tk, causal)
    # the CTAs' order, written by the entry (16 bits)
    order = (torch.empty(-(-Tk // SM90_TILE), dtype=torch.int32,
                         device=q.device) if half else None)
    lse, delta = lse.contiguous(), delta.contiguous()
    err = _build.load_library().ptt_varlen_bwd_dkv(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), layout.kinfo.data_ptr(),
        layout.qrange.data_ptr(), layout.krange.data_ptr(), _ptr(cls),
        _ptr(order), d4.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), H, Hkv, Tq, Tk, d, strides,
        float(scale), int(bool(causal)), _build.DTYPE_CODES[str(q.dtype)],
        _stream(q))
    _build.check(err, "ptt_varlen_bwd_dkv")
    VL_DKV_LAUNCHES += 1
    return (_cut(_group_sum(dk, Hkv), D)[0], _cut(_group_sum(dv, Hkv), D)[0])


class VarlenAttention(torch.autograd.Function):
    """Varlen attention with its backward (↔ `_varlen`'s custom VJP, whose
    backward `_varlen_vjp_bwd` :669 this follows). Saves q, k, v, O, the
    LSE, the 16-bit kernels' tile classes (None elsewhere) and the layout;
    the backward computes delta = rowsum(dO * O) in f32 with torch and runs
    the dq and dk/dv kernels on the same classes; dk/dv come out summed
    over the g query heads of a kv head, and are cast to k's dtype. The
    layout is data."""

    @staticmethod
    def forward(ctx, q, k, v, layout, causal, scale):
        out, lse, cls = _varlen_fwd(q, k, v, layout, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse, cls, *layout)
        ctx.causal = causal
        ctx.scale = scale
        return report_op("flash_attn_unpadded", out)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, cls, *lay = ctx.saved_tensors
        layout = VarlenLayout(*lay)
        causal, scale = ctx.causal, ctx.scale
        delta = (dout.float() * out.float()).sum(-1).transpose(0, 1).contiguous()
        dq = varlen_bwd_dq(q, k, v, layout, dout, lse, delta, causal, scale,
                           cls)
        dk, dv = varlen_bwd_dkv(q, k, v, layout, dout, lse, delta, causal,
                                scale, cls)
        dk, dv = dk.to(k.dtype), dv.to(v.dtype)
        report_op("flash_attn_unpadded_grad", (dq, dk, dv))
        return dq, dk, dv, None, None, None


def varlen_flash_attention_fwd(q, k, v, cu_seqlens_q, cu_seqlens_k, scale,
                               causal=False):
    """Packed varlen entry: q [Tq, H, D], k/v [Tk, Hkv, D], cu_seqlens
    [B + 1] -> [Tq, H, D], differentiable with respect to q, k and v. k and
    v are cast to q's dtype."""
    layout = varlen_layout(cu_seqlens_q.to(q.device), cu_seqlens_k.to(q.device),
                           q.shape[0], k.shape[0], bool(causal))
    return VarlenAttention.apply(q, k.to(q.dtype), v.to(q.dtype), layout,
                                 bool(causal), float(scale))
