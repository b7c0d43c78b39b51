"""The long-tail tensor ops (↔ paddle_tpu/tensor/tail.py): tril/triu
indices, complex, the diagonal fills, reduce_as, edit_distance,
clip_by_norm, standard_gamma, histogramdd and the cauchy_ / geometric_
fills (drawn from the port's generators)."""

from __future__ import annotations

import numpy as np
import torch

from ..framework import random as rnd
from ..framework.core import Tensor, register_tensor_method, run_op, to_tensor
from ._common import device, dt, v

__all__ = [
    "tril_indices",
    "triu_indices",
    "complex",
    "fill_diagonal_",
    "fill_diagonal_tensor",
    "fill_diagonal_tensor_",
    "reduce_as",
    "edit_distance",
    "clip_by_norm",
    "standard_gamma",
    "histogramdd",
    "cauchy_",
    "geometric_",
]


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return Tensor(torch.tril_indices(int(row), int(col), int(offset),
                                     dtype=dt(dtype), device=device()))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return Tensor(torch.triu_indices(int(row), int(col), int(offset),
                                     dtype=dt(dtype), device=device()))


def complex(real, imag, name=None):  # noqa: A001
    return run_op("complex", torch.complex, [real, imag])


def _diag_rc(h, w, offset):
    n = min(h, w)
    idx = np.arange(n)
    r = idx - min(offset, 0)
    c = idx + max(offset, 0)
    ok = (r < h) & (c < w)
    return r[ok], c[ok]


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    """Fill the diagonal in place (reference fill_diagonal_)."""
    def fn(a):
        out = a.clone()
        if a.dim() == 2 and wrap and a.shape[0] > a.shape[1]:
            H, W = a.shape
            flat = out.reshape(-1)
            flat[torch.arange(0, H * W, W + 1, device=a.device)] = value
            return flat.reshape(H, W)
        r, c = _diag_rc(a.shape[-2], a.shape[-1], offset)
        out[..., torch.as_tensor(r, device=a.device),
            torch.as_tensor(c, device=a.device)] = value
        return out

    out = run_op("fill_diagonal", fn, [x])
    if isinstance(x, Tensor):
        return x._inplace_update(out)
    return out


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    def fn(a, u):
        d1, d2 = dim1 % a.dim(), dim2 % a.dim()
        perm = [d for d in range(a.dim()) if d not in (d1, d2)] + [d1, d2]
        inv = np.argsort(perm).tolist()
        m = a.permute(perm).clone()
        r, c = _diag_rc(m.shape[-2], m.shape[-1], offset)
        m[..., torch.as_tensor(r, device=a.device),
          torch.as_tensor(c, device=a.device)] = u[..., :r.shape[0]].to(a.dtype)
        return m.permute(inv)

    return run_op("fill_diagonal_tensor", fn, [x, y])


def fill_diagonal_tensor_(x, y, offset=0, dim1=0, dim2=1, name=None):
    out = fill_diagonal_tensor(x, y, offset, dim1, dim2)
    if isinstance(x, Tensor):
        return x._inplace_update(out)
    return out


def reduce_as(x, target, name=None):
    """Sum x down to target's shape."""
    tgt = tuple(int(s) for s in v(target).shape)

    def fn(a):
        extra = a.dim() - len(tgt)
        axes = list(range(extra)) + [extra + i for i, s in enumerate(tgt)
                                     if a.shape[extra + i] != s]
        out = a.sum(tuple(axes)) if axes else a
        return out.reshape(tgt)

    return run_op("reduce_as", fn, [x])


def edit_distance(input, label, normalized=True, ignored_tokens=None,  # noqa: A002
                  input_length=None, label_length=None, name=None):
    """Levenshtein distance per sequence pair, on the host (a metric, as in
    the reference). Returns (distance [B, 1], sequence_num [1])."""
    a = v(input).cpu().numpy()
    b = v(label).cpu().numpy()
    il = None if input_length is None else v(input_length).cpu().numpy().reshape(-1)
    ll = None if label_length is None else v(label_length).cpu().numpy().reshape(-1)
    ig = set(ignored_tokens or [])
    B = a.shape[0]
    out = np.zeros((B, 1), np.float32)
    for i in range(B):
        s1 = a[i][: int(il[i])] if il is not None else a[i]
        s2 = b[i][: int(ll[i])] if ll is not None else b[i]
        s1 = [t for t in s1.tolist() if t not in ig]
        s2 = [t for t in s2.tolist() if t not in ig]
        m, n = len(s1), len(s2)
        dp = np.arange(n + 1, dtype=np.int64)
        for r in range(1, m + 1):
            prev = dp.copy()
            dp[0] = r
            for cc in range(1, n + 1):
                dp[cc] = min(prev[cc] + 1, dp[cc - 1] + 1,
                             prev[cc - 1] + (s1[r - 1] != s2[cc - 1]))
        d = float(dp[n])
        if normalized:
            d = d / max(n, 1)
        out[i, 0] = d
    dev = v(input).device
    return to_tensor(out, place=dev), to_tensor(np.asarray([B], np.int64),
                                                place=dev)


def clip_by_norm(x, max_norm, name=None):
    """Scale x so that ||x||_2 <= max_norm."""
    def fn(a):
        nrm = torch.sqrt(torch.clamp(torch.sum(a * a), min=1e-12))
        return a * torch.clamp(max_norm / nrm, max=1.0)

    return run_op("clip_by_norm", fn, [x])


def standard_gamma(x, name=None):
    """Gamma(alpha=x, 1) draws, elementwise. torch's sampler takes no
    generator, so it runs on a forked default generator of the device,
    seeded from the port's generator; the default generator's state is
    restored after."""
    a = v(x)
    s = int(torch.randint(0, 2 ** 62, (), generator=rnd.generator(a.device),
                          device=a.device))
    cuda = a.device.type == "cuda"
    with torch.random.fork_rng(devices=[a.device] if cuda else []):
        if cuda:
            torch.cuda.default_generators[a.device.index or 0].manual_seed(s)
        else:
            torch.random.default_generator.manual_seed(s)
        return run_op("standard_gamma", torch._standard_gamma, [x])


for _name in ("fill_diagonal_", "fill_diagonal_tensor",
              "fill_diagonal_tensor_", "reduce_as", "clip_by_norm"):
    if not hasattr(Tensor, _name):
        register_tensor_method(_name, globals()[_name])


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """On the host, as the reference: (hist, edges list)."""
    sample = v(x).detach().float().cpu().numpy()
    w = None if weights is None else v(weights).detach().float().cpu().numpy()
    if isinstance(bins, (Tensor, torch.Tensor)):
        bins = v(bins).cpu().numpy()
    if isinstance(bins, (list, tuple)):
        bins = [v(b).cpu().numpy() if isinstance(b, (Tensor, torch.Tensor))
                else b for b in bins]
    if ranges is not None:
        flat = [float(r) for r in np.asarray(
            v(ranges).cpu().numpy() if isinstance(ranges, (Tensor, torch.Tensor))
            else ranges).reshape(-1)]
        ranges = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)]
    hist, edges = np.histogramdd(sample, bins=bins, range=ranges,
                                 density=density, weights=w)
    dev = v(x).device
    return (to_tensor(hist.astype(np.float32), place=dev),
            [to_tensor(e.astype(np.float32), place=dev) for e in edges])


def cauchy_(x, loc=0.0, scale=1.0, name=None):
    """In-place Cauchy fill."""
    def fn(a):
        return torch.empty_like(a).cauchy_(loc, scale,
                                           generator=rnd.generator(a.device))

    out = run_op("cauchy", fn, [x])
    return x._inplace_update(out) if isinstance(x, Tensor) else out


def geometric_(x, probs, name=None):
    """In-place Geometric(probs) fill (trials to the first success)."""
    def fn(a):
        u = torch.rand(a.shape, generator=rnd.generator(a.device),
                       device=a.device).clamp(min=1e-7)
        return torch.ceil(torch.log(u) / np.log1p(-probs)).to(a.dtype)

    out = run_op("geometric", fn, [x])
    return x._inplace_update(out) if isinstance(x, Tensor) else out


for _name in ("cauchy_", "geometric_"):
    if not hasattr(Tensor, _name):
        register_tensor_method(_name, globals()[_name])
