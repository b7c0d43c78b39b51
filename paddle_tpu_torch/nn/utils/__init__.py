"""Parameter reparameterizations and vector helpers (↔
paddle_tpu/nn/utils/__init__.py): `weight_norm` / `remove_weight_norm`,
`spectral_norm`, `parameters_to_vector` / `vector_to_parameters`, and
`clip_grad_norm_` / `clip_grad_value_` (those of `nn.clip`).

Both norms are a forward pre-hook that recomputes the layer's weight from
the parameters that replace it, before every forward, as the reference's:

- `weight_norm(layer, name, dim)`: `<name>_g` (the L2 norm of the weight
  over every axis but `dim`, dims kept) and `<name>_v` (the weight);
  the weight is v * g / max(||v||, 1e-12). `dim=None` is the last axis,
  as in the reference.
- `spectral_norm(layer, name, n_power_iterations, eps, dim)`: the
  parameter `<name>_orig` and the f32 buffers `<name>_u` [h] and
  `<name>_v` [rest], the weight viewed as [h = shape[dim], rest]; u and v
  start from numpy's `default_rng(0)` normalised, the reference's numbers
  exactly. Each training forward runs `n_power_iterations` steps of power
  iteration from them (the gradient flows through the steps, as in the
  reference's traced function) and stores the new u and v; an eval
  forward runs none. The weight is <name>_orig / (u W v).

The state_dict names are the reference's, so `convert.load_paddle_tpu_state`
carries a reparameterized layer across. The functions take and return
torch tensors, as the port's other functionals do.
"""

from __future__ import annotations

import numpy as np
import torch

from ...framework.core import Parameter, Tensor
from ..clip import clip_grad_norm_, clip_grad_value_

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters", "clip_grad_norm_",
           "clip_grad_value_"]


def _norm_except(w, dim):
    """The L2 norm of w over every axis but `dim`, dims kept."""
    axes = tuple(i for i in range(w.dim()) if i != dim)
    return w.square().sum(dim=axes, keepdim=True).sqrt()


def _weight_norm_value(v, g, dim):
    return v * (g / _norm_except(v, dim).clamp(min=1e-12))


def weight_norm(layer, name="weight", dim=0):
    """Reparameterize `layer.<name>` as g * v / ||v|| (module docstring);
    returns the layer."""
    w = getattr(layer, name)
    dim = (w.dim() - 1 if dim is None else dim) % w.dim()
    with torch.no_grad():
        g = Parameter(_norm_except(w.detach(), dim))
        v = Parameter(w.detach().clone())
    del layer._parameters[name]
    layer.register_parameter(name + "_g", g)
    layer.register_parameter(name + "_v", v)

    def hook(lyr, inputs):
        setattr(lyr, name, _weight_norm_value(v, g, dim))

    hook(layer, None)
    layer._weight_norm_hook = (layer.register_forward_pre_hook(hook), name,
                               dim)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold g * v / ||v|| back into a plain parameter `<name>`; returns the
    layer."""
    handle, name, dim = layer._weight_norm_hook
    handle.remove()
    g = layer._parameters.pop(name + "_g")
    v = layer._parameters.pop(name + "_v")
    with torch.no_grad():
        w = Parameter(_weight_norm_value(v, g, dim))
    delattr(layer, name)
    layer.register_parameter(name, w)
    del layer._weight_norm_hook
    return layer


def _sigma(w, u, v, dim, iters, eps):
    """(u W v, u, v) after `iters` steps of power iteration from u and v,
    W the weight viewed as [shape[dim], rest]."""
    wm = w.movedim(dim, 0).reshape(w.shape[dim], -1)
    u, v = u.to(wm.dtype), v.to(wm.dtype)
    for _ in range(iters):
        v = wm.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return u @ wm @ v, u, v


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Divide `layer.<name>` by its largest singular value, estimated by
    power iteration (module docstring); returns the layer."""
    w = getattr(layer, name)
    dim = 0 if dim is None else dim
    h = int(w.shape[dim])
    rest = w.numel() // h
    rng = np.random.default_rng(0)
    u0 = rng.standard_normal(h).astype("float32")
    v0 = rng.standard_normal(rest).astype("float32")
    u0 /= np.linalg.norm(u0) + eps
    v0 /= np.linalg.norm(v0) + eps
    layer.register_buffer(name + "_u", torch.from_numpy(u0).to(w.device))
    layer.register_buffer(name + "_v", torch.from_numpy(v0).to(w.device))
    orig = Parameter(w.detach().clone())
    del layer._parameters[name]
    layer.register_parameter(name + "_orig", orig)

    def compute(lyr, iters):
        ub, vb = getattr(lyr, name + "_u"), getattr(lyr, name + "_v")
        sigma, u, v = _sigma(orig, ub, vb, dim, iters, eps)
        with torch.no_grad():
            ub.copy_(u)
            vb.copy_(v)
        setattr(lyr, name, orig / sigma)

    def hook(lyr, inputs):
        compute(lyr, n_power_iterations if lyr.training else 0)

    compute(layer, n_power_iterations)
    layer.register_forward_pre_hook(hook)
    return layer


def parameters_to_vector(parameters, name=None):
    """The parameters flattened and concatenated, one tensor (with their
    gradient)."""
    return torch.cat([p.reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    """Write consecutive pieces of `vec` (a tensor, `Tensor` or array) into
    the parameters, in place; returns them."""
    params = list(parameters)
    if isinstance(vec, Tensor):
        vec = vec._value
    vec = torch.as_tensor(np.asarray(vec) if not isinstance(
        vec, torch.Tensor) else vec)
    off = 0
    for p in params:
        n = p.numel()
        p.copy_(vec[off:off + n].reshape(p.shape).to(p.device, p.dtype))
        off += n
    return params
