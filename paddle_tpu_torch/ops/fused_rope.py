"""Fused rotary position embedding (↔ paddle_tpu/ops/pallas/fused_rope.py).

`apply_fused_rope(tensors, cos_half, sin_half, interleaved=False)` rotates
1-3 tensors [B, S, H_i, D] (q and k, and v when the caller rotates it) in
one pass with the half-width f32 tables [Bt, S, D/2], Bt 1 (one table for
every batch row) or B (a table per row, as at decode). Pairs are neox
(x_j, x_{j+D/2}) or, with `interleaved`, (x_{2j}, x_{2j+1}); each becomes
(x_a c - x_b s, x_b c + x_a s) in f32, rounded once to the tensor's dtype.
It is differentiable through `FusedRope`, a `torch.autograd.Function` (the
JAX package's custom VJP): the backward is the same rotation with the sin
table negated, the tables get no gradient and no activation is saved.

`rope` runs `csrc/fused_rope.cu` on CUDA tensors (one launch for every
tensor of the call; `LAUNCHES` counts them) over the grid `rope_plan`
gives, and `rope_plain`, the same arithmetic in plain PyTorch, on CPU
tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build
from ..framework.core import report_op

__all__ = ["FusedRope", "LAUNCHES", "RopePlan", "apply_fused_rope", "rope",
           "rope_plain", "rope_plan"]

LAUNCHES = 0  # kernel launches since import (or since a caller reset them)

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# The plan's sizes, for an H100 (132 SMs of 2,048 resident threads each).
BLOCK = 256                  # threads a CTA, unless a few tokens want it smaller
MIN_BLOCK = 64               # the smallest CTA the few-token plan makes
FILL_CTAS = 128              # the few-token plan's grid: about one CTA an SM
STREAM_THREADS = 132 * 2048  # a wave of resident threads
MAX_TOKENS_A_CTA = 64        # blockDim.z's limit

_PLANS = {}  # the wrapper's plans by call shape: the host path of a decode tick


class RopePlan(NamedTuple):
    """The kernel's launch: `vector` pairs a thread (16 // itemsize, or 1
    on the scalar route); the heads axis (every tensor's heads, q's then
    k's then v's) in `chunks` chunks of `heads_per_thread` heads a token;
    `block` (lanes = D/2 // vector, chunks a CTA, tokens a CTA); `grid`
    (over the tokens, over the chunks)."""
    vector: int
    block: tuple
    heads_per_thread: int
    chunks: int
    grid: tuple


def rope_plan(B, S, heads, D, itemsize, vector=True):
    """The launch of the kernel on tensors [B, S, heads[i], D] of one dtype
    of `itemsize` bytes; `vector` says that every pointer of the call lies
    on the 16-byte line. A thread owns `vector` consecutive pairs (V = 16 //
    itemsize when `vector` and D/2 is a multiple of V, else 1) of each head
    of its chunk at one token.

    - Many tokens (a wave of resident threads or more at about four heads
      a thread: training, long prefills): `chunks` is the power of two
      nearest H / 4 (H the heads of the call), `heads_per_thread`
      ceil(H / chunks), and a CTA holds every chunk of a few tokens, so
      the chunks of a token read its tables from L1.
    - Few tokens (decode, short prefills): one head a thread, and CTAs
      shrink from BLOCK toward MIN_BLOCK threads (fewer tokens a CTA
      first, then fewer chunks) until the grid holds FILL_CTAS CTAs. It
      then holds at least min(FILL_CTAS, ceil(B S H lanes / max(MIN_BLOCK,
      lanes))) CTAs: 128 at the llama_7b decode tick (16 rows, 32 + 32
      heads of 128)."""
    T, H, half = B * S, sum(heads), D // 2
    V = 16 // itemsize
    if not vector or half % V:
        V = 1
    lanes = half // V
    chunks = 2 ** round(math.log2(max(H / 4, 1)))
    hpt = -(-H // chunks)
    chunks = -(-H // hpt)
    stream = T * chunks * lanes >= STREAM_THREADS
    if not stream:
        hpt, chunks = 1, H
    cy = min(chunks, max(1, BLOCK // lanes))
    tb = max(1, min(T, MAX_TOKENS_A_CTA, BLOCK // (lanes * cy)))

    def ctas():
        return -(-T // tb) * -(-chunks // cy)

    while not stream and ctas() < FILL_CTAS and lanes * cy * tb > MIN_BLOCK \
            and (tb > 1 or cy > 1):
        if tb > 1:
            tb = -(-tb // 2)
        else:
            cy = -(-cy // 2)
    return RopePlan(V, (lanes, cy, tb), hpt, chunks,
                    (-(-T // tb), -(-chunks // cy)))


def _halves(x, interleaved):
    """(x_a, x_b) f32 views of the pairs of x [..., D]."""
    xf = x.float()
    if interleaved:
        return xf[..., 0::2], xf[..., 1::2]
    half = x.shape[-1] // 2
    return xf[..., :half], xf[..., half:]


def rope_plain(tensors, cos, sin, interleaved=False, sin_sign=1.0):
    """Plain PyTorch version of the kernel: each tensor [B, S, H, D]
    rotated by the f32 tables [Bt, S, D/2] (sin times `sin_sign`); every
    product and sum rounds once in f32, then the result rounds once to the
    tensor's dtype. Returns a tuple."""
    c = cos.float()[:, :, None, :]
    s = (sin.float() * sin_sign)[:, :, None, :]
    outs = []
    for x in tensors:
        xa, xb = _halves(x, interleaved)
        ra = xa * c - xb * s
        rb = xb * c + xa * s
        if interleaved:
            out = torch.stack([ra, rb], dim=-1).reshape(x.shape)
        else:
            out = torch.cat([ra, rb], dim=-1)
        outs.append(out.to(x.dtype))
    return tuple(outs)


def _check(tensors, cos, sin):
    if not 1 <= len(tensors) <= 3:
        raise ValueError(f"fused rope takes 1 to 3 tensors, got {len(tensors)}")
    x0 = tensors[0]
    if x0.dim() != 4:
        raise ValueError(f"fused rope wants [B, S, H, D] tensors, got {tuple(x0.shape)}")
    B, S, _, D = x0.shape
    if D % 2:
        raise ValueError(f"fused rope needs an even head dim, got {D}")
    for t in tensors:
        if t.dim() != 4 or t.shape[0] != B or t.shape[1] != S or t.shape[3] != D:
            raise ValueError(f"fused rope: {tuple(t.shape)} does not fit "
                             f"{tuple(x0.shape)}")
        if t.dtype != x0.dtype or t.dtype not in _DTYPES:
            raise TypeError("fused rope: the tensors must share one float dtype, "
                            f"got {[str(u.dtype) for u in tensors]}")
        if t.device != x0.device:
            raise ValueError(f"fused rope: all tensors must be on {x0.device}")
    for name, tab in (("cos", cos), ("sin", sin)):
        if tab.dim() != 3 or tab.shape[0] not in (1, B) or \
                tuple(tab.shape[1:]) != (S, D // 2):
            raise ValueError(f"fused rope: {name} table must be [1 or {B}, {S}, "
                             f"{D // 2}], got {tuple(tab.shape)}")
        if tab.device != x0.device:
            raise ValueError(f"fused rope: the {name} table must be on {x0.device}")
    if cos.shape != sin.shape:
        raise ValueError("fused rope: cos and sin tables differ in shape")


def rope(tensors, cos, sin, interleaved=False, sin_sign=1.0):
    """The rotation of every tensor of `tensors` (see `rope_plain`). CPU
    tensors run the plain version; CUDA tensors launch the kernel once for
    all of them."""
    global LAUNCHES
    tensors = tuple(tensors)
    _check(tensors, cos, sin)
    x0 = tensors[0]
    if x0.device.type == "cpu":
        return rope_plain(tensors, cos, sin, interleaved, sin_sign)
    if x0.device.type != "cuda":
        raise ValueError(f"fused rope: unsupported device {x0.device}")
    B, S, _, D = x0.shape
    if D // 2 > 1024:
        raise ValueError(f"fused rope kernel takes head dims up to 2048, got {D}")
    xs = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in xs]
    if outs[0].numel() == 0:
        return tuple(outs)
    c = cos.float().contiguous()
    s = sin.float().contiguous()
    # tensors without heads take no part in the launch
    live = [i for i, t in enumerate(xs) if t.numel()]
    ptrs = [xs[i].data_ptr() for i in live] + [outs[i].data_ptr() for i in live]
    aligned = all(p % 16 == 0 for p in ptrs + [c.data_ptr(), s.data_ptr()])
    heads = [xs[i].shape[2] for i in live]
    key = (B, S, tuple(heads), D, x0.element_size(), aligned)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = rope_plan(*key)
    pad = [None] * (3 - len(live))
    lib = _build.load_library()
    err = lib.ptt_rope(*ptrs[:len(live)], *pad, *ptrs[len(live):], *pad,
                       len(live), *heads, *[0] * len(pad), B, S, D,
                       c.data_ptr(), s.data_ptr(), c.shape[0],
                       int(bool(interleaved)), float(sin_sign),
                       _build.DTYPE_CODES[str(x0.dtype)], plan.vector,
                       plan.heads_per_thread, plan.chunks, *plan.block,
                       *plan.grid,
                       torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check(err, "ptt_rope")
    LAUNCHES += 1
    return tuple(outs)


class FusedRope(torch.autograd.Function):
    """`rope` with its gradient (↔ `_rope`'s custom VJP): the backward
    rotates the output gradients with the sin table negated. Saves only the
    tables; they are position data and get no gradient."""

    @staticmethod
    def forward(ctx, cos, sin, interleaved, *tensors):
        ctx.save_for_backward(cos, sin)
        ctx.interleaved = interleaved
        return report_op("fused_rope", rope(tensors, cos, sin, interleaved))

    @staticmethod
    def backward(ctx, *douts):
        cos, sin = ctx.saved_tensors
        # (an unused output's gradient arrives as zeros: autograd
        # materializes it)
        grads = report_op("fused_rope_grad", rope(
            douts, cos, sin, ctx.interleaved, sin_sign=-1.0))
        return (None, None, None, *grads)


def apply_fused_rope(tensors, cos_half, sin_half, interleaved=False):
    """Rotate 1-3 tensors [B, S, H_i, D] (one dtype) in one pass with the
    position tables cos_half/sin_half [B or 1, S, D/2] (data: no gradient).
    Differentiable with respect to the tensors. Returns a tuple."""
    return FusedRope.apply(cos_half.detach(), sin_half.detach(),
                           bool(interleaved), *tensors)
