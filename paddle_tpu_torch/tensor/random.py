"""Random draws (↔ paddle_tpu/tensor/random.py), each from the port's
generator of the device it lands on (`framework.random.generator`), which
`paddle.seed` seeds; never from torch's global generator. The two packages
draw different numbers (threefry against Philox): the tests hold the
draws by shape, dtype and distribution."""

from __future__ import annotations

import torch

from ..framework import random as rnd
from ..framework.core import Tensor, register_tensor_method
from ._common import device, dt, shape_tuple, v

__all__ = [
    "rand",
    "randn",
    "randint",
    "randint_like",
    "randperm",
    "uniform",
    "uniform_",
    "normal",
    "normal_",
    "standard_normal",
    "gaussian",
    "poisson",
    "bernoulli",
    "multinomial",
    "exponential_",
    "binomial",
]


def _gen(dev, seed=0):
    """The port's generator on `dev`, or a fresh one seeded with `seed`."""
    if seed:
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        return g
    return rnd.generator(dev)


def rand(shape, dtype=None, name=None):
    dev = device()
    return Tensor(torch.rand(shape_tuple(shape), generator=_gen(dev),
                             dtype=dt(dtype), device=dev))


def randn(shape, dtype=None, name=None):
    dev = device()
    return Tensor(torch.randn(shape_tuple(shape), generator=_gen(dev),
                              dtype=dt(dtype), device=dev))


standard_normal = randn


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dev = device()
    out = torch.randn(shape_tuple(shape), generator=_gen(dev, seed),
                      dtype=dt(dtype), device=dev)
    return Tensor(out * std + mean)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, (Tensor, torch.Tensor)) or isinstance(
            std, (Tensor, torch.Tensor)):
        m = v(mean)
        s = v(std, m if isinstance(m, torch.Tensor) else None)
        m = v(mean, s)
        shp = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.randn(shp, generator=_gen(m.device), device=m.device)
        return Tensor(m + s * z)
    return gaussian(shape if shape is not None else [1], mean, std)


def _fill(x, draw):
    a = v(x)
    with torch.no_grad():
        a.copy_(draw(a))
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    return _fill(x, lambda a: torch.randn(
        a.shape, generator=_gen(a.device), device=a.device,
        dtype=a.dtype if a.is_floating_point() else torch.float32)
        * std + mean)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    dev = device()
    out = torch.rand(shape_tuple(shape), generator=_gen(dev, seed),
                     dtype=dt(dtype), device=dev)
    return Tensor(out * (max - min) + min)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    return _fill(x, lambda a: torch.rand(
        a.shape, generator=_gen(a.device, seed), device=a.device,
        dtype=a.dtype) * (max - min) + min)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = device()
    return Tensor(torch.randint(int(low), int(high), shape_tuple(shape),
                                generator=_gen(dev), device=dev,
                                dtype=dt(dtype, torch.int64)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    a = v(x)
    if high is None:
        low, high = 0, low
    return Tensor(torch.randint(int(low), int(high), a.shape,
                                generator=_gen(a.device), device=a.device,
                                dtype=dt(dtype, a.dtype)))


def randperm(n, dtype=None, name=None):
    dev = device()
    return Tensor(torch.randperm(int(n), generator=_gen(dev), device=dev,
                                 dtype=dt(dtype, torch.int64)))


def poisson(x, name=None):
    a = v(x)
    return Tensor(torch.poisson(a.float(), generator=_gen(a.device)).to(a.dtype))


def bernoulli(x, name=None):
    a = v(x)
    return Tensor(torch.bernoulli(a.float(), generator=_gen(a.device)).to(a.dtype))


def binomial(count, prob, name=None):
    c = v(count)
    p = v(prob, c)
    c, p = torch.broadcast_tensors(c.float(), p.float())
    return Tensor(torch.binomial(c, p, generator=_gen(c.device)).to(torch.int64))


def multinomial(x, num_samples=1, replacement=False, name=None):
    a = v(x)
    return Tensor(torch.multinomial(a.float(), int(num_samples),
                                    replacement=replacement,
                                    generator=_gen(a.device)))


def exponential_(x, lam=1.0, name=None):
    return _fill(x, lambda a: torch.empty_like(a).exponential_(
        lam, generator=_gen(a.device)))


for _name in ("uniform_", "normal_", "exponential_", "multinomial",
              "bernoulli"):
    register_tensor_method(_name, globals()[_name])
