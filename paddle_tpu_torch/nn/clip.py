"""Gradient clipping (↔ paddle_tpu/nn/clip.py).

The clip classes take and return a list of (parameter, gradient) pairs, as
Paddle's optimizers hand them over; a gradient of None, or a parameter with
`need_clip = False`, passes through. Norms are taken in f32 and each
clipped gradient keeps its dtype. `clip_grad_norm_` and `clip_grad_value_`
clip `p.grad` in place.

`ClipGradByGlobalNorm` given to an optimizer is applied by `jit.TrainStep`
(and so by `DistributedTrainStep`, whose squared sum spans the ranks that
hold shards) over every gradient, as the JAX step does; an eager
`optimizer.step()` applies it to the pairs it updates.
"""

from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "clip_grad_value_"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002 (Paddle's names)
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    @torch.no_grad()
    def __call__(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                g32 = g.float()
                norm = g32.square().sum().sqrt()
                scale = torch.clamp(self.clip_norm / norm.clamp(min=1e-12),
                                    max=1.0)
                g = (g32 * scale).to(g.dtype)
            out.append((p, g))
        return out


def global_norm_scale(sq_sum, clip_norm):
    """clip_norm / max(||g||, clip_norm) from the squared sum of every
    gradient (reference jit/__init__.py:364-371)."""
    return clip_norm / torch.clamp(sq_sum.sqrt(), min=clip_norm)


def scale_grad(g, scale):
    return (g.float() * scale).to(g.dtype)


class ClipGradByGlobalNorm(ClipGradBase):
    """scale = c / max(c, ||g||_2 over every gradient)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, params_grads):
        sq = [g.float().square().sum() for p, g in params_grads
              if _clipped(p, g)]
        if not sq:
            return params_grads
        scale = global_norm_scale(sum(sq), self.clip_norm)
        return [(p, scale_grad(g, scale) if _clipped(p, g) else g)
                for p, g in params_grads]


def _params(parameters):
    return [parameters] if isinstance(parameters, torch.Tensor) else list(parameters)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every `p.grad` by min(1, max_norm / (total norm + 1e-6));
    returns the total norm (f32). With `error_if_nonfinite` a total that
    is not finite raises (a read of the total)."""
    params = _params(parameters)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = torch.stack([g.float().abs().pow(norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not torch.isfinite(total):
        raise RuntimeError(f"the total norm of the gradients is "
                           f"{float(total)}; error_if_nonfinite=False skips "
                           "this check")
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p in params:
        if p.grad is not None:
            p.grad = scale_grad(p.grad, coef)
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    for p in _params(parameters):
        if p.grad is not None:
            p.grad = p.grad.clamp(-clip_value, clip_value)
