"""Flash attention (↔ paddle_tpu/ops/pallas/flash_attention.py).

`flash_attention_fwd(q, k, v, causal, scale, key_bias)` takes Paddle's
layout, q [B, Sq, H, D] and k/v [B, Skv, Hkv, D] with H a multiple of Hkv
(GQA), and returns [B, Sq, H, D]. It is differentiable through
`FlashAttention`, a `torch.autograd.Function` (the JAX package's custom
VJP) whose forward saves the f32 row log-sum-exp and whose backward
recomputes the probabilities from it. Three kernels, each beside its plain
version and its launch counter:

- `flash_fwd` → (O, LSE): on CUDA tensors `csrc/flash_attention.cu`'s
  forward, in bf16 and f16 the wgmma kernel of `csrc/flash_fwd_sm90.cuh` (q, k and
  v through `tma_operands`), in f32 `flash_fwd_kernel`; `flash_fwd_plain`
  on CPU tensors; `FWD_LAUNCHES`;
- `flash_bwd_dq` → dQ in q's dtype: in bf16 and f16 the wgmma kernel of
  `csrc/flash_bwd_sm90.cuh`, in f32 `flash_dq_kernel`;
  `flash_bwd_dq_plain`; `DQ_LAUNCHES`;
- `flash_bwd_dkv` → dK, dV of the kv heads in f32, the g query heads of a
  kv head summed as `_bwd` does with jnp: in 16 bits `flash_bwd_sm90.cuh`'s
  kernel writes them as they are, in f32 `flash_dkv_kernel` writes one
  slice per query head, which torch sums; `flash_bwd_dkv_plain`;
  `DKV_LAUNCHES`. The backward casts them to k's dtype.

Semantics, shared by the kernels and the plain versions:

- Causal masking is bottom-right aligned: query r sees key c iff
  c <= r + Skv - Sq (the flash-attn convention the JAX kernel follows;
  torch's own `is_causal` is top-left).
- `key_bias` [B, Skv] is an additive f32 per-key bias (a padding mask)
  added to every logit; its cotangent is zero (None).
- The softmax is the exact running-max form, the JAX package's
  `PADDLE_TPU_FLASH_SAFE_SOFTMAX=1` kernel. The JAX default is the
  unshifted exp(min(s, 60)) form without a running max: the two agree
  wherever every logit is below 60; where logits reach 60 the JAX default
  saturates to equal weights and this port stays exact.
- A row that sees no key (causal with Sq > Skv, or every key biased to
  -1e30, i.e. a running max at or below -5e29) gives zeros, never NaN and
  never the mean of V, and LSE = +inf, so the backward gives it exactly
  zero gradient: what the JAX default's l == 0 guard gives.
- f32 inputs compute in full f32 (the CUDA-core kernels). bf16 and f16
  inputs (`HALF`) run the tensor-core kernels, one source for both types:
  products of 16-bit operands accumulated in f32, with the probabilities
  and dS rounded to the input's type before they enter the next product
  (as the JAX kernel casts p and ds to the operand type) and the softmax
  statistics in f32. In f16 a value past 65504 (dS or dQ under a large
  loss scale) becomes inf, as in the JAX kernel, and reaches the
  GradScaler: nothing is clamped.
- Head dims up to MAX_HEAD_DIM = 192: the kernels' tiles are 64, 128 or
  192 columns wide (one, two or three 64-column panels, zero-filled past
  D); a wider head raises on the card. The plain versions take any D.
- The 16-bit kernels read q, k, v (and the backward dO) through TMA tensor
  maps, which take a view whose base is 16-byte aligned, whose head dim is
  a multiple of 8 and whose strides are multiples of 16 bytes;
  `tma_operands` passes such views as they are (a fused qkv's slices too)
  and copies any other.
"""

from __future__ import annotations

import math

import torch

from . import _build
from ..framework.core import report_op

__all__ = ["DKV_LAUNCHES", "DQ_LAUNCHES", "FWD_LAUNCHES", "FlashAttention",
           "flash_attention_fwd", "flash_bwd_dkv",
           "flash_bwd_dkv_plain", "flash_bwd_dq", "flash_bwd_dq_plain",
           "flash_fwd", "flash_fwd_plain", "tma_operands"]

NEG_INF = -1e30  # paddle_tpu/ops/pallas/flash_attention.py NEG_INF
EMPTY = -5e29    # a row whose largest logit is at or below this saw no key
MAX_HEAD_DIM = 192  # three 64-column panels (csrc kMaxHeadDim)
HALF = (torch.bfloat16, torch.float16)  # the sm90 kernels' operand types

# kernel launches since import (or since a caller reset them)
FWD_LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #


def _visible(sq, skv, causal, device):
    """[Sq, Skv] bool: query r sees key c (bottom-right causal)."""
    if not causal:
        return torch.ones(sq, skv, dtype=torch.bool, device=device)
    return torch.ones(sq, skv, dtype=torch.bool, device=device).tril(
        diagonal=skv - sq)


def _expand_kv(x, g):
    """[B, S, Hkv, D] -> f32 [B, S, Hkv * g, D]: query head h reads kv head
    h // g."""
    x = x.float()
    return x if g == 1 else x.repeat_interleave(g, dim=2)


def _logits(q, k, scale, keep, key_bias=None):
    """f32 [B, H, Sq, Skv] logits, the key bias [B, Skv] added, -inf where
    `keep` (bool, broadcastable to [B, H, Sq, Skv]) is False. Shared with
    the flashmask plain versions (ops/masked_flash.py)."""
    g = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand_kv(k, g)) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    return s.masked_fill(~keep, float("-inf"))


def _flash_logits(q, k, key_bias, causal, scale):
    return _logits(q, k, scale, _visible(q.shape[1], k.shape[1], causal,
                                         q.device), key_bias)


def _operand(x, like):
    """x rounded to `like`'s dtype and back to f32: what a product of that
    dtype sees (a no-op for f32)."""
    return x.to(like.dtype).float()


def _attend(q, v, s):
    """(O in q's dtype, LSE [B, H, Sq] f32) of the logits s: the f32
    softmax with the row max subtracted, P entering P V in q's dtype; a
    row that saw no key (its max at or below EMPTY) gives zeros and
    LSE = +inf."""
    g = q.shape[2] // v.shape[2]
    m = s.amax(-1, keepdim=True)
    empty = ~(m > EMPTY)
    m_use = torch.where(empty, torch.zeros_like(m), m)
    p = torch.exp(s - m_use)
    l = p.sum(-1, keepdim=True)
    empty = empty | (l == 0)
    inv = torch.where(empty, torch.zeros_like(l), 1.0 / torch.where(
        empty, torch.ones_like(l), l))
    o = torch.einsum("bhqk,bkhd->bqhd", _operand(p, q), _expand_kv(v, g))
    o = o * inv.transpose(1, 2)
    lse = torch.where(empty, torch.full_like(m, float("inf")),
                      m_use + torch.log(torch.where(empty, torch.ones_like(l), l)))
    return o.to(q.dtype), lse[..., 0]


def _probs_and_ds(q, v, s, dout, lse, delta, scale):
    """The backward's recompute from the logits s: P = exp(s - LSE) (0 at
    masked pairs) and dS = P * (dO V^T - delta) * scale, both f32
    [B, H, Sq, Skv]."""
    g = q.shape[2] // v.shape[2]
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), _expand_kv(v, g))
    ds = p * (dp - delta.float()[..., None]) * scale
    return p, ds


def _dq(q, k, ds):
    """dQ = dS K with dS in q's dtype, accumulated in f32, in q's dtype."""
    g = q.shape[2] // k.shape[2]
    return torch.einsum("bhqk,bkhd->bqhd", _operand(ds, q),
                        _expand_kv(k, g)).to(q.dtype)


def _dkv(q, dout, p, ds):
    """dK = dS^T Q and dV = P^T dO per query head, P and dS in q's dtype,
    f32 [B, Skv, H, D] each."""
    dk = torch.einsum("bhqk,bqhd->bkhd", _operand(ds, q), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", _operand(p, q), dout.float())
    return dk, dv


def flash_fwd_plain(q, k, v, causal, scale, key_bias=None):
    """Plain PyTorch version of the forward kernel: the f32 softmax with the
    row max subtracted, the zero-row rule, and LSE = m + log(l) [B, H, Sq]
    f32 (+inf for a row that saw no key); P enters P V in q's dtype. Returns
    (O in q's dtype, LSE)."""
    return _attend(q, v, _flash_logits(q, k, key_bias, causal, scale))


def flash_bwd_dq_plain(q, k, v, key_bias, dout, lse, delta, causal, scale):
    """Plain PyTorch version of the dq kernel: dQ = dS K with dS in q's
    dtype, accumulated in f32, returned in q's dtype [B, Sq, H, D]."""
    s = _flash_logits(q, k, key_bias, causal, scale)
    return _dq(q, k, _probs_and_ds(q, v, s, dout, lse, delta, scale)[1])


def flash_bwd_dkv_plain(q, k, v, key_bias, dout, lse, delta, causal, scale):
    """Plain PyTorch version of the dk/dv kernel: dK = dS^T Q and
    dV = P^T dO with P and dS in q's dtype, the kv heads' f32
    [B, Skv, Hkv, D] each (the g query heads of a kv head summed)."""
    s = _flash_logits(q, k, key_bias, causal, scale)
    dk, dv = _dkv(q, dout, *_probs_and_ds(q, v, s, dout, lse, delta, scale))
    return _group_sum(dk, k.shape[2]), _group_sum(dv, k.shape[2])


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #


def _check(q, k, v, key_bias):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention wants q [B, Sq, H, D] and k/v "
                         "[B, Skv, Hkv, D]")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads do not group over {k.shape[2]} "
                         "kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash attention: q, k and v must share one dtype")
    if q.dtype != torch.float32 and q.dtype not in HALF:
        raise TypeError(f"flash attention: unsupported dtype {q.dtype}")
    for t in (k, v, key_bias):
        if t is not None and t.device != q.device:
            raise ValueError(f"flash attention: all inputs must be on {q.device}")
    if key_bias is not None:
        if key_bias.shape != (B, k.shape[1]):
            raise ValueError(f"key_bias must be [B, Skv] = [{B}, {k.shape[1]}], "
                             f"got {tuple(key_bias.shape)}")
        if key_bias.dtype != torch.float32:
            raise TypeError("key_bias must be float32")


def _device_checks(q):
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernels take head dims up to "
                         f"{MAX_HEAD_DIM}, got {q.shape[-1]} (ROADMAP queue A item 8)")
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {q.device}")


def _strides(q, k, v, dout):
    """The 12 (b, s, h) element strides of q, k, v and dout (q's where
    dout is None), as the kernels take them."""
    strides = []
    for t in (q, k, v, dout if dout is not None else q):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    return _build.longlongs(strides)


def _unit_d(t):
    """t with a unit head-dim stride (copied only if the last axis is
    strided)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _cuda_operands(q, k, v, key_bias, dout=None):
    """Kernel operands: views with a unit head-dim stride, the key bias
    contiguous, and the 12 (b, s, h) element strides of q, k, v and
    dout."""
    _device_checks(q)
    q, k, v = _unit_d(q), _unit_d(k), _unit_d(v)
    dout = None if dout is None else _unit_d(dout.to(q.dtype))
    kb = None if key_bias is None else key_bias.contiguous()
    return q, k, v, kb, dout, _strides(q, k, v, dout)


def _tma_ready(t):
    """Whether a TMA tensor map describes the [B, S, H, D] view as it is:
    unit d stride, D a multiple of 8, the base 16-byte aligned and the
    stride of every axis longer than 1 a non-zero multiple of 16 bytes (an
    expanded gradient, stride 0, is copied)."""
    if t.shape[-1] % 8 or t.stride(-1) != 1 or t.data_ptr() % 16:
        return False
    return all(t.stride(i) and t.stride(i) * t.element_size() % 16 == 0
               for i in range(3) if t.shape[i] > 1)


def tma_operands(*ts):
    """(*ts, D): the [B, S, H, D] operands (q, k, v; the backward adds dO)
    as the 16-bit sm90 kernels take them. Views a TMA map describes pass as
    they are (a slice of a fused qkv, say); any other becomes a contiguous
    copy. When the head dim is not a multiple of 8, all become contiguous
    copies with D zero-padded to the next multiple of 8 (returned): zero
    columns add nothing to Q K^T or dO V^T and give zero output columns,
    which the caller drops. Pure tensor logic: it runs on any device."""
    d = ts[0].shape[-1]
    dp = -(-d // 8) * 8
    if dp != d:
        return (*(torch.nn.functional.pad(t, (0, dp - d)) for t in ts), dp)
    return (*(t if _tma_ready(t) else t.clone(memory_format=torch.contiguous_format)
              for t in ts), d)


def _fwd_operands(q, k, v, key_bias):
    """(q, k, v, key bias, strides, D) of a forward launch: 16 bits through
    `tma_operands` (D the head dim the kernel sees), f32 as
    `_cuda_operands` gives them."""
    if q.dtype not in HALF:
        q, k, v, kb, _, strides = _cuda_operands(q, k, v, key_bias)
        return q, k, v, kb, strides, q.shape[-1]
    _device_checks(q)
    q, k, v, d = tma_operands(q, k, v)
    kb = None if key_bias is None else key_bias.contiguous()
    return q, k, v, kb, _strides(q, k, v, None), d


def _bwd_operands(q, k, v, dout):
    """(q, k, v, dout, strides, D) of a backward launch: 16 bits through
    `tma_operands` (D the head dim the kernels see), f32 with a unit
    head-dim stride. Pure tensor logic: it runs on any device."""
    dout = dout.to(q.dtype)
    if q.dtype not in HALF:
        q, k, v, dout = (_unit_d(t) for t in (q, k, v, dout))
        d = q.shape[-1]
    else:
        q, k, v, dout, d = tma_operands(q, k, v, dout)
    return q, k, v, dout, _strides(q, k, v, dout), d


def _cut(x, D):
    """x [..., d] cut back to the head dim D (the kernels' zero padding)."""
    return x if x.shape[-1] == D else x[..., :D].contiguous()


def _fwd_outputs(q, Sq, H, d):
    """Empty O [B, Sq, H, d] in q's dtype and LSE [B, H, Sq] f32."""
    out = torch.empty(q.shape[0], Sq, H, d, device=q.device, dtype=q.dtype)
    lse = torch.empty(q.shape[0], H, Sq, device=q.device, dtype=torch.float32)
    return out, lse


def _fwd_result(out, lse, D, Skv):
    """(O [B, Sq, H, D] contiguous, LSE) of a forward launch whose kernel
    saw a head dim padded beyond D; with no key every row is empty."""
    if Skv == 0:
        out.zero_()
        lse.fill_(float("inf"))
    if out.shape[-1] != D:
        out = out[..., :D].contiguous()
    return out, lse


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_fwd(q, k, v, causal, scale, key_bias=None):
    """(O [B, Sq, H, D] in q's dtype, LSE [B, H, Sq] f32). CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    global FWD_LAUNCHES
    _check(q, k, v, key_bias)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale, key_bias)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    q, k, v, kb, strides, d = _fwd_operands(q, k, v, key_bias)
    out, lse = _fwd_outputs(q, Sq, H, d)
    if out.numel() == 0 or Skv == 0:
        return _fwd_result(out, lse, D, Skv)
    lib = _build.load_library()
    err = lib.ptt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kb), out.data_ptr(),
        lse.data_ptr(), B, H, Hkv, Sq, Skv, d, strides, float(scale),
        int(bool(causal)), _build.DTYPE_CODES[str(q.dtype)],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ptt_flash_fwd")
    FWD_LAUNCHES += 1
    return _fwd_result(out, lse, D, Skv)


def _bwd_checks(q, lse, delta):
    want = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 [B, H, Sq] = {list(want)}")


def flash_bwd_dq(q, k, v, key_bias, dout, lse, delta, causal, scale):
    """dQ [B, Sq, H, D] in q's dtype, from the forward's LSE and
    delta = rowsum(dO * O) [B, H, Sq] f32. CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    global DQ_LAUNCHES
    _check(q, k, v, key_bias)
    _bwd_checks(q, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, key_bias, dout, lse, delta, causal,
                                  scale)
    _device_checks(q)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    q, k, v, dout, strides, d = _bwd_operands(q, k, v, dout)
    dq = torch.empty(B, Sq, H, d, device=q.device, dtype=q.dtype)
    if dq.numel() == 0 or Skv == 0:
        return _cut(dq.zero_(), D)
    kb = None if key_bias is None else key_bias.contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    err = _build.load_library().ptt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kb), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Hkv, Sq, Skv,
        d, strides, float(scale), int(bool(causal)),
        _build.DTYPE_CODES[str(q.dtype)],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ptt_flash_bwd_dq")
    DQ_LAUNCHES += 1
    return _cut(dq, D)


def flash_bwd_dkv(q, k, v, key_bias, dout, lse, delta, causal, scale):
    """(dK, dV), each f32 [B, Skv, Hkv, D]: the kv heads' gradients, the g
    query heads of a kv head summed. The bf16 kernel writes them as they
    are; the f32 kernel writes one slice per query head, which torch sums.
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    global DKV_LAUNCHES
    _check(q, k, v, key_bias)
    _bwd_checks(q, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, key_bias, dout, lse, delta,
                                   causal, scale)
    _device_checks(q)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if B * Skv * Hkv * D == 0 or Sq == 0:
        dk = torch.zeros(B, Skv, Hkv, D, device=q.device, dtype=torch.float32)
        return dk, torch.zeros_like(dk)
    q, k, v, dout, strides, d = _bwd_operands(q, k, v, dout)
    heads = Hkv if q.dtype in HALF else H
    dk = torch.empty(B, Skv, heads, d, device=q.device, dtype=torch.float32)
    dv = torch.empty_like(dk)
    kb = None if key_bias is None else key_bias.contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    err = _build.load_library().ptt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kb), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H,
        Hkv, Sq, Skv, d, strides, float(scale), int(bool(causal)),
        _build.DTYPE_CODES[str(q.dtype)],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ptt_flash_bwd_dkv")
    DKV_LAUNCHES += 1
    return _cut(_group_sum(dk, Hkv), D), _cut(_group_sum(dv, Hkv), D)


# --------------------------------------------------------------------------- #
# autograd and the public entry
# --------------------------------------------------------------------------- #


class FlashAttention(torch.autograd.Function):
    """Attention with its flash backward (↔ `_flash` / `_flash_kb`'s custom
    VJP). Saves q, k, v, O and the LSE; the backward computes
    delta = rowsum(dO * O) in f32 with torch (as `_bwd` does with jnp) and
    runs the dq and dk/dv kernels; dk/dv come out summed over the g query
    heads of a kv head, and are cast to k's dtype. The key bias is data:
    its gradient is None."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, causal, scale):
        out, lse = flash_fwd(q, k, v, causal, scale, key_bias)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.causal = causal
        ctx.scale = scale
        return report_op("flash_attention", out)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash_bwd_dq(q, k, v, key_bias, dout, lse, delta, causal, scale)
        dk, dv = flash_bwd_dkv(q, k, v, key_bias, dout, lse, delta, causal,
                               scale)
        dk, dv = dk.to(k.dtype), dv.to(v.dtype)
        report_op("flash_attention_grad", (dq, dk, dv))
        return dq, dk, dv, None, None, None


def _group_sum(x, hkv):
    """[B, S, H, D], one slice per query head -> [B, S, Hkv, D]: the g
    query heads of a kv head summed (GQA); [B, S, Hkv, D] as it is."""
    B, S, H, D = x.shape
    return x if H == hkv else x.reshape(B, S, hkv, H // hkv, D).sum(3)


def flash_attention_fwd(q, k, v, causal=False, scale=None, key_bias=None):
    """Paddle-layout entry: q [B, Sq, H, D], k/v [B, Skv, Hkv, D] ->
    [B, Sq, H, D], differentiable. `key_bias`: optional [B, Skv] additive
    per-key bias, treated as data (no gradient). k and v are cast to q's
    dtype, as in the JAX package."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    if key_bias is not None:
        key_bias = key_bias.detach().float()
    return FlashAttention.apply(q, k, v, key_bias, bool(causal), float(scale))
