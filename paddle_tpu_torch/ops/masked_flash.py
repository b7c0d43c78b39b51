"""Flashmask attention (↔ the flashmask half of
paddle_tpu/ops/pallas/masked_flash.py).

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

Three kernels of `csrc/masked_flash.cu` (the tile kernels of
`csrc/flash_tiles.cuh` under the flashmask policy), each beside its plain
version and its launch counter:

- `flashmask_fwd` → (O, LSE): `flashmask_fwd_plain` on CPU tensors;
  `FWD_LAUNCHES`;
- `flashmask_bwd_dq` → dQ: `flashmask_bwd_dq_plain`; `DQ_LAUNCHES`;
- `flashmask_bwd_dkv` → dK, dV per query head in f32:
  `flashmask_bwd_dkv_plain`; `DKV_LAUNCHES`. The backward sums the g heads
  of a kv head and casts to k's dtype, as `_fm_bwd` does.

The kernels take the indices as int32 [B, Hm, n, Skv] (the JAX kernel's
`idx` after its moveaxis), one row of n per mask head contiguous over the
keys. The softmax, the bf16 rounding of P and dS, and LSE = +inf for a row
that keeps no key are those of `ops.flash_attention`.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .flash_attention import (_attend, _bwd_checks, _check, _cuda_operands,
                              _dkv, _dq, _kv_grads, _logits, _probs_and_ds)

__all__ = ["DKV_LAUNCHES", "DQ_LAUNCHES", "FWD_LAUNCHES",
           "FlashmaskAttention", "flashmask_attention_fwd",
           "flashmask_bwd_dkv", "flashmask_bwd_dkv_plain", "flashmask_bwd_dq",
           "flashmask_bwd_dq_plain", "flashmask_fwd", "flashmask_fwd_plain",
           "flashmask_keep"]

# kernel launches since import (or since a caller reset them)
FWD_LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0


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
    """Plain PyTorch version of the dk/dv kernel: dK, dV f32
    [B, Skv, H, D], one slice per query head."""
    s = _mask_logits(q, k, idx, causal, scale)
    return _dkv(q, dout, *_probs_and_ds(q, v, s, dout, lse, delta, scale))


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


def flashmask_fwd(q, k, v, idx, causal, scale):
    """(O [B, Sq, H, D] in q's dtype, LSE [B, H, Sq] f32) under the indices
    idx [B, Hm, n, Skv]. CPU tensors run the plain version; CUDA tensors
    launch the kernel."""
    global FWD_LAUNCHES
    _check(q, k, v, None)
    _check_idx(q, k, idx, causal)
    if q.device.type == "cpu":
        return flashmask_fwd_plain(q, k, v, idx, causal, scale)
    q, k, v, _, _, strides = _cuda_operands(q, k, v, None)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    idx = _kernel_idx(idx)
    out = torch.empty(B, Sq, H, D, device=q.device, dtype=q.dtype)
    lse = torch.empty(B, H, Sq, device=q.device, dtype=torch.float32)
    if out.numel() == 0:
        return out, lse
    err = _build.load_library().ptt_flashmask_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, H, Hkv, idx.shape[1], idx.shape[2],
        Sq, Skv, D, strides, float(scale), int(bool(causal)),
        _build.DTYPE_CODES[str(q.dtype)],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ptt_flashmask_fwd")
    FWD_LAUNCHES += 1
    return out, lse


def flashmask_bwd_dq(q, k, v, idx, dout, lse, delta, causal, scale):
    """dQ [B, Sq, H, D] in q's dtype from the forward's LSE and
    delta = rowsum(dO * O) [B, H, Sq] f32. CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    global DQ_LAUNCHES
    _check(q, k, v, None)
    _check_idx(q, k, idx, causal)
    _bwd_checks(q, lse, delta)
    if q.device.type == "cpu":
        return flashmask_bwd_dq_plain(q, k, v, idx, dout, lse, delta, causal,
                                      scale)
    q, k, v, _, dout, strides = _cuda_operands(q, k, v, None, dout)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    idx = _kernel_idx(idx)
    dq = torch.empty(B, Sq, H, D, device=q.device, dtype=q.dtype)
    if dq.numel() == 0:
        return dq
    lse, delta = lse.contiguous(), delta.contiguous()
    err = _build.load_library().ptt_flashmask_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H,
        Hkv, idx.shape[1], idx.shape[2], Sq, Skv, D, strides, float(scale),
        int(bool(causal)), _build.DTYPE_CODES[str(q.dtype)],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ptt_flashmask_bwd_dq")
    DQ_LAUNCHES += 1
    return dq


def flashmask_bwd_dkv(q, k, v, idx, dout, lse, delta, causal, scale):
    """(dK, dV), each f32 [B, Skv, H, D]: one slice per query head, not yet
    summed over the g heads of a kv head. CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    global DKV_LAUNCHES
    _check(q, k, v, None)
    _check_idx(q, k, idx, causal)
    _bwd_checks(q, lse, delta)
    if q.device.type == "cpu":
        return flashmask_bwd_dkv_plain(q, k, v, idx, dout, lse, delta, causal,
                                       scale)
    q, k, v, _, dout, strides = _cuda_operands(q, k, v, None, dout)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    idx = _kernel_idx(idx)
    dk = torch.empty(B, Skv, H, D, device=q.device, dtype=torch.float32)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk, dv
    lse, delta = lse.contiguous(), delta.contiguous()
    err = _build.load_library().ptt_flashmask_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, H, Hkv, idx.shape[1], idx.shape[2], Sq, Skv, D,
        strides, float(scale), int(bool(causal)),
        _build.DTYPE_CODES[str(q.dtype)],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ptt_flashmask_bwd_dkv")
    DKV_LAUNCHES += 1
    return dk, dv


# --------------------------------------------------------------------------- #
# autograd and the public entry
# --------------------------------------------------------------------------- #


class FlashmaskAttention(torch.autograd.Function):
    """Flashmask attention with its backward (↔ `_flashmask`'s custom VJP).
    Saves q, k, v, the indices, O and the LSE; the backward computes
    delta = rowsum(dO * O) in f32 with torch (as `_fm_bwd` does with jnp),
    runs the dq and dk/dv kernels and group-sums dK/dV for GQA. The indices
    are data: their gradient is None."""

    @staticmethod
    def forward(ctx, q, k, v, idx, causal, scale):
        out, lse = flashmask_fwd(q, k, v, idx, causal, scale)
        ctx.save_for_backward(q, k, v, idx, out, lse)
        ctx.causal = causal
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, idx, out, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flashmask_bwd_dq(q, k, v, idx, dout, lse, delta, causal, scale)
        dk, dv = flashmask_bwd_dkv(q, k, v, idx, dout, lse, delta, causal,
                                   scale)
        return (dq, *_kv_grads(dk, dv, k, v), None, None, None)


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
