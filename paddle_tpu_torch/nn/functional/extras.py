"""The functional tail (↔ paddle_tpu/nn/functional/extras.py): the spatial
transformer (`affine_grid`, `grid_sample`), `pairwise_distance`,
`sequence_mask`, `zeropad2d`, `temporal_shift`, `gather_tree`, the loss
tail (`dice_loss`, `gaussian_nll_loss`, `poisson_nll_loss`,
`soft_margin_loss`, `multi_label_soft_margin_loss`,
`triplet_margin_with_distance_loss`, `npair_loss`) and the qkv-packed
flash wrappers (:334, :343, :354).

All but the flash wrappers are the reference's formulas in torch ops (the
reference's are jnp, with no Pallas kernel). A reducing loss notes its
reduction for a recording step (`loss.note_reduction`), as the port's
other losses do. `flash_attn_qkvpacked` unpacks [B, S, 3, H, D] into three
views and calls `flash_attention`, so on the card it runs the flash
kernels; `flash_attn_varlen_qkvpacked` likewise calls
`flash_attn_unpadded`. `sequence_mask` keeps the int64 it is asked for
(the reference without x64 gives int32: ROADMAP queue C's 64-bit rule).
"""

from __future__ import annotations

import math

import torch

from ... import amp
from ...framework.core import reported
from .flash_attention import flash_attention, flash_attn_unpadded
from .loss import _reduce, note_reduction

__all__ = [
    "affine_grid", "grid_sample", "pairwise_distance", "sequence_mask",
    "zeropad2d", "temporal_shift", "gather_tree", "dice_loss",
    "gaussian_nll_loss", "poisson_nll_loss", "soft_margin_loss",
    "multi_label_soft_margin_loss", "triplet_margin_with_distance_loss",
    "npair_loss", "flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked",
]


# --------------------------------------------------------------------------- #
# the spatial transformer (reference vision.py affine_grid, grid_sample)
# --------------------------------------------------------------------------- #


@reported("affine_grid")
def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta [N, 2, 3] -> the f32 sampling grid [N, H, W, 2]."""
    N, C, H, W = (int(s) for s in out_shape)
    dev = theta.device
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, W, device=dev)
        ys = torch.linspace(-1.0, 1.0, H, device=dev)
    else:
        xs = (torch.arange(W, device=dev) * 2 + 1) / W - 1.0
        ys = (torch.arange(H, device=dev) * 2 + 1) / H - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("nij,hwj->nhwi", theta.float(), base)


def _reflect(f, n, align_corners):
    if align_corners:
        span = 2 * (n - 1)
        f = torch.remainder(f, span).abs()
        return torch.where(f > n - 1, span - f, f)
    span = 2 * n
    f = torch.remainder((f + 0.5).abs(), span)
    f = torch.where(f > n, span - f, f) - 0.5
    return f.clamp(0, n - 1)


@reported("grid_sample")
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """x [N, C, H, W] sampled at grid [N, Hg, Wg, 2] (x, y in [-1, 1]) ->
    [N, C, Hg, Wg], bilinear or nearest (round half to even), outside
    points zero ("zeros"), clamped ("border") or reflected
    ("reflection")."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample: unsupported mode {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"grid_sample: unsupported padding {padding_mode!r}")
    x, grid = amp.cast_inputs("grid_sample", x, grid)
    N, C, H, W = x.shape
    gx, gy = grid[..., 0].float(), grid[..., 1].float()
    if align_corners:
        fx, fy = (gx + 1) * (W - 1) / 2, (gy + 1) * (H - 1) / 2
    else:
        fx, fy = ((gx + 1) * W - 1) / 2, ((gy + 1) * H - 1) / 2
    if padding_mode == "reflection":
        fx, fy = _reflect(fx, W, align_corners), _reflect(fy, H, align_corners)
    flat = x.reshape(N, C, H * W)

    def sample(ix, iy):
        inside = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        cx = ix.clamp(0, W - 1).long()
        cy = iy.clamp(0, H - 1).long()
        idx = (cy * W + cx).reshape(N, 1, -1).expand(N, C, -1)
        vals = flat.gather(2, idx).reshape(N, C, *ix.shape[1:])
        if padding_mode == "zeros":
            vals = torch.where(inside[:, None], vals, torch.zeros_like(vals))
        return vals

    if mode == "nearest":
        return sample(torch.round(fx), torch.round(fy))
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx1, wy1 = fx - x0, fy - y0
    wx0, wy0 = 1 - wx1, 1 - wy1
    out = (sample(x0, y0) * (wx0 * wy0)[:, None]
           + sample(x0 + 1, y0) * (wx1 * wy0)[:, None]
           + sample(x0, y0 + 1) * (wx0 * wy1)[:, None]
           + sample(x0 + 1, y0 + 1) * (wx1 * wy1)[:, None])
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# common
# --------------------------------------------------------------------------- #


@reported("pairwise_distance")
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """||x - y + epsilon||_p over the last axis."""
    a, b = amp.cast_inputs("pairwise_distance", x, y)
    d = a - b + epsilon
    return d.abs().pow(p).sum(dim=-1, keepdim=keepdim).pow(1.0 / p)


@reported("sequence_mask")
def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """lengths [...] -> [..., maxlen] with 1 where the position is below
    the length (maxlen None: the largest length, a read of x)."""
    from ...framework.dtype import convert_dtype

    ml = int(maxlen) if maxlen is not None else int(x.max())
    pos = torch.arange(ml, device=x.device)
    return (pos < x[..., None]).to(convert_dtype(dtype))


@reported("zeropad2d")
def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zeros around the spatial axes: padding (left, right, top, bottom)."""
    (x,) = amp.cast_inputs("zeropad2d", x)
    left, right, top, bottom = (int(p) for p in padding)
    if data_format == "NCHW":
        return torch.nn.functional.pad(x, (left, right, top, bottom))
    return torch.nn.functional.pad(x, (0, 0, left, right, top, bottom))


@reported("temporal_shift")
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM: of [N * T, C, H, W], the first C * ratio channels shift one
    segment back in time, the next as many one forward, zeros filling."""
    (x,) = amp.cast_inputs("temporal_shift", x)
    if data_format != "NCHW":
        x = x.movedim(-1, 1)
    NT, C, H, W = x.shape
    v = x.reshape(NT // seg_num, seg_num, C, H, W)
    fold = int(C * shift_ratio)
    back = torch.zeros_like(v[:, :, :fold])
    back[:, :-1] = v[:, 1:, :fold]
    fwd = torch.zeros_like(v[:, :, fold:2 * fold])
    fwd[:, 1:] = v[:, :-1, fold:2 * fold]
    out = torch.cat([back, fwd, v[:, :, 2 * fold:]], dim=2).reshape(
        NT, C, H, W)
    return out if data_format == "NCHW" else out.movedim(1, -1)


@reported("gather_tree")
def gather_tree(ids, parents, name=None):
    """The beam-search backtrace of ids and parents [T, B, K]: from the
    last step back, each beam's token, then its parent beam."""
    T, B, K = ids.shape
    beam = torch.arange(K, device=ids.device).expand(B, K)
    out = torch.empty_like(ids)
    for t in range(T - 1, -1, -1):
        out[t] = ids[t].gather(-1, beam)
        beam = parents[t].gather(-1, beam).long()
    return out


# --------------------------------------------------------------------------- #
# the loss tail
# --------------------------------------------------------------------------- #


@reported("dice_loss")
def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    """input [N, ..., C] probabilities, label [N, ..., 1] class ids: the
    mean over N of 1 - 2 |p * onehot| / (|p| + |onehot| + epsilon)."""
    (p,) = amp.cast_inputs("dice_loss", input)
    onehot = (label[..., 0].long()[..., None]
              == torch.arange(p.shape[-1], device=p.device)).to(p.dtype)
    red = tuple(range(1, p.dim()))
    inter = (p * onehot).sum(dim=red)
    union = p.sum(dim=red) + onehot.sum(dim=red)
    return _reduce(1 - 2 * inter / (union + epsilon), "mean")


@reported("gaussian_nll_loss")
def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,  # noqa: A002
                      reduction="mean", name=None):
    mu, y, var = amp.cast_inputs("gaussian_nll_loss", input, label, variance)
    var = var.clamp(min=epsilon)
    loss = 0.5 * (torch.log(var) + (y - mu) ** 2 / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


@reported("poisson_nll_loss")
def poisson_nll_loss(input, label, log_input=True, full=False,  # noqa: A002
                     epsilon=1e-8, reduction="mean", name=None):
    x, y = amp.cast_inputs("poisson_nll_loss", input, label)
    loss = torch.exp(x) - y * x if log_input else x - y * torch.log(x + epsilon)
    if full:
        stirling = (y * torch.log(y + epsilon) - y
                    + 0.5 * torch.log(2 * math.pi * (y + epsilon)))
        loss = loss + torch.where(y > 1, stirling, torch.zeros_like(stirling))
    return _reduce(loss, reduction)


@reported("soft_margin_loss")
def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    """log(1 + exp(-label * input)), as softplus (no overflow)."""
    (x,) = amp.cast_inputs("soft_margin_loss", input)
    return _reduce(torch.nn.functional.softplus(-label.to(x.dtype) * x),
                   reduction)


@reported("multi_label_soft_margin_loss")
def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean", name=None):
    x, w = amp.cast_inputs("multi_label_soft_margin_loss", input, weight)
    y = label.to(x.dtype)
    logsig = torch.nn.functional.logsigmoid
    loss = -(y * logsig(x) + (1 - y) * logsig(-x))
    if w is not None:
        loss = loss * w
    return _reduce(loss.mean(dim=-1), reduction)


@reported("triplet_margin_with_distance_loss")
def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """max(d(a, p) - d(a, n) + margin, 0), d `distance_function` (default
    `pairwise_distance`), d(a, n) replaced by d(p, n) where smaller under
    `swap`."""
    a, p, n = amp.cast_inputs("triplet_margin_with_distance_loss", input,
                              positive, negative)
    dist = distance_function or pairwise_distance
    d_ap, d_an = dist(a, p), dist(a, n)
    if swap:
        d_an = torch.minimum(d_an, dist(p, n))
    return _reduce((d_ap - d_an + margin).clamp(min=0.0), reduction)


@reported("npair_loss")
def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """The cross entropy of anchor @ positive^T against the rows' label
    matches (each row normalised), plus l2_reg / 4 times the mean squared
    norms of anchor and positive."""
    a, p = amp.cast_inputs("npair_loss", anchor, positive)
    same = (labels[:, None] == labels[None, :]).to(a.dtype)
    same = same / same.sum(dim=1, keepdim=True)
    ce = -(same * torch.log_softmax(a @ p.T, dim=1)).sum(dim=1).mean()
    reg = l2_reg * (a.square().sum(dim=1).mean()
                    + p.square().sum(dim=1).mean()) * 0.25
    note_reduction("mean", float(a.shape[0]), float(max(a.shape[0], 1)))
    return ce + reg


# --------------------------------------------------------------------------- #
# the qkv-packed flash wrappers
# --------------------------------------------------------------------------- #


def _unpack_qkv(t, axis):
    """(q, k, v): the three slices of `t` along `axis`, as views (the
    kernels read them through their strides)."""
    return t.select(axis, 0), t.select(axis, 1), t.select(axis, 2)


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         *args, **kwargs):
    """qkv [B, S, 3, H, D] -> `flash_attention`'s (out, None): on CUDA
    tensors the flash kernels (forward, dQ, dK/dV), on CPU tensors their
    plain versions."""
    q, k, v = _unpack_qkv(qkv, axis=2)
    return flash_attention(q, k, v, dropout=dropout, causal=causal,
                           return_softmax=return_softmax,
                           training=kwargs.get("training", True))


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                                max_seqlen_k, scale, dropout=0.0,
                                causal=False, varlen_padded=True,
                                return_softmax=False, **kwargs):
    """qkv [T, 3, H, D] of densely packed tokens -> flash_attn_unpadded's
    (out, None). The reference's default varlen_padded=True layout
    ([B * maxlen, ...] with padding rows) is another memory convention,
    and reading it as packed would misalign every sequence, so it raises:
    pass varlen_padded=False."""
    if varlen_padded:
        raise NotImplementedError(
            "flash_attn_varlen_qkvpacked: the padded [B*maxlen, 3, H, D] "
            "layout is not supported; pass varlen_padded=False with densely "
            "packed tokens")
    q, k, v = _unpack_qkv(qkv, axis=1)
    return flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                               max_seqlen_q, max_seqlen_k, scale,
                               dropout=dropout, causal=causal,
                               return_softmax=return_softmax)
