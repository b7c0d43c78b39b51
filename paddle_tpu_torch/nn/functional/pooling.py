"""Pooling functionals (↔ paddle_tpu/nn/functional/pooling.py).

The reference lowers every pool to `lax.reduce_window` (no Pallas body);
here a pool is torch's max or average pool over an input padded as Paddle
pads it:

- `padding` takes the forms of `nn.functional.conv2d`'s (an int, one int
  a dim, a flat [lo, hi] pair a dim, the nested form, "SAME": XLA's, out =
  ceil(in / stride) with the odd row at the high end, or "VALID"). A max
  pool pads with -inf, an average pool with zeros;
- `exclusive=True` (Paddle's default; torch's count_include_pad=False)
  divides a window's sum by the count of input elements in it,
  `exclusive=False` by the window's size;
- `ceil_mode=True` takes out = ceil((in + lo + hi - k) / stride) + 1
  windows: the last ones reach past the high padding, where the input is
  padded further (-inf or zeros, counted by no window). The reference's
  `_pool` accepts `ceil_mode` and ignores it (ROADMAP queue C);
- the adaptive pools split each spatial dim of `in` into `out` bins
  [floor(i in / out), ceil((i + 1) in / out)), the reference's `_adaptive`
  (:139-170) on sizes that do not divide too; torch's adaptive pools use
  the same bins. `data_format` "N*C" pools the spatial dims of a
  channels-last input (the reference's `_adaptive` reads dims 2.. whatever
  the layout; ROADMAP queue C).

Inputs are cast for AMP as the ops "pool" and "adaptive_pool". Not ported
(NotImplementedError naming ROADMAP queue A item 8): `return_mask`,
`divisor_override` (which the reference accepts and ignores), the unpools,
the lp and fractional pools.
"""

from __future__ import annotations

import math

import torch

from ... import amp
from .conv import _tuple, conv_pads, pad_input, padding_spec

__all__ = ["adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
           "avg_pool1d", "avg_pool2d", "avg_pool3d", "fractional_max_pool2d",
           "fractional_max_pool3d", "lp_pool1d", "lp_pool2d", "max_pool1d",
           "max_pool2d", "max_pool3d", "max_unpool1d", "max_unpool2d",
           "max_unpool3d"]

F = torch.nn.functional
_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
# window sums: avg_pool with divisor 1 (1-d through the 2-d pool)
_AVG = {2: F.avg_pool2d, 3: F.avg_pool3d}
_ADAPTIVE = {(1, True): F.adaptive_avg_pool1d, (2, True): F.adaptive_avg_pool2d,
             (3, True): F.adaptive_avg_pool3d, (1, False): F.adaptive_max_pool1d,
             (2, False): F.adaptive_max_pool2d, (3, False): F.adaptive_max_pool3d}


def _unported(what):
    raise NotImplementedError(f"{what} is ported with ROADMAP queue A item 8")


def pool_pads(padding, sizes, k, s, ceil_mode):
    """[(lo, hi)] a spatial dim, the high side grown by what ceil_mode's
    last windows reach past it."""
    n = len(sizes)
    pads = conv_pads(padding_spec(padding, n), sizes, k, s, (1,) * n)
    if ceil_mode:
        grown = []
        for size, kk, ss, (lo, hi) in zip(sizes, k, s, pads):
            out = math.ceil((size + lo + hi - kk) / ss) + 1
            grown.append((lo, hi + max(0, (out - 1) * ss + kk - size - lo - hi)))
        pads = grown
    return pads


def _window_sum(x, k, s, n):
    if n == 1:
        return F.avg_pool2d(x[..., None], (k[0], 1), (s[0], 1),
                            divisor_override=1)[..., 0]
    return _AVG[n](x, k, s, divisor_override=1)


def _pool(x, kernel_size, stride, padding, n, is_max, ceil_mode, exclusive,
          data_format):
    (x,) = amp.cast_inputs("pool", x)
    channels_last = not data_format.startswith("NC")
    a = x.movedim(-1, 1) if channels_last else x
    k = _tuple(kernel_size, n)
    s = _tuple(stride if stride is not None else kernel_size, n)
    pads = pool_pads(padding, a.shape[2:], k, s, ceil_mode)
    if is_max:
        if all(lo == hi and 2 * lo <= kk for (lo, hi), kk in zip(pads, k)):
            # torch pads a max pool with -inf itself
            out = _MAX[n](a, k, s, tuple(lo for lo, _ in pads))
        else:
            out = _MAX[n](pad_input(a, pads, -math.inf), k, s)
    else:
        total = _window_sum(pad_input(a, pads), k, s, n)
        if exclusive:
            ones = torch.ones((1, 1) + tuple(a.shape[2:]), dtype=a.dtype,
                              device=a.device)
            out = total / _window_sum(pad_input(ones, pads), k, s, n)
        else:
            out = total / math.prod(k)
        out = out.to(a.dtype)
    return out.movedim(1, -1) if channels_last else out


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool(x, kernel_size, stride, padding, 1, False, ceil_mode,
                 exclusive, "NCL")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    if divisor_override is not None:
        _unported("avg_pool2d(divisor_override=...)")
    return _pool(x, kernel_size, stride, padding, 2, False, ceil_mode,
                 exclusive, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    if divisor_override is not None:
        _unported("avg_pool3d(divisor_override=...)")
    return _pool(x, kernel_size, stride, padding, 3, False, ceil_mode,
                 exclusive, data_format)


def _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode, n,
              data_format):
    if return_mask:
        _unported(f"max_pool{n}d(return_mask=True)")
    return _pool(x, kernel_size, stride, padding, n, True, ceil_mode, True,
                 data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     1, "NCL")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     2, data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     3, data_format)


def _adaptive(x, output_size, n, is_avg, data_format="NCHW"):
    (x,) = amp.cast_inputs("adaptive_pool", x)
    channels_last = not data_format.startswith("NC")
    a = x.movedim(-1, 1) if channels_last else x
    size = ((output_size,) * n if output_size is None
            or isinstance(output_size, int) else tuple(output_size))
    out = _ADAPTIVE[(n, is_avg)](a, size)
    return out.movedim(1, -1) if channels_last else out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, True)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, True, data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, True, data_format)


def _adaptive_max(x, output_size, return_mask, n):
    if return_mask:
        _unported(f"adaptive_max_pool{n}d(return_mask=True)")
    return _adaptive(x, output_size, n, False)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, return_mask, 1)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, return_mask, 2)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, return_mask, 3)


def max_unpool1d(*args, **kwargs):
    _unported("max_unpool1d")


def max_unpool2d(*args, **kwargs):
    _unported("max_unpool2d")


def max_unpool3d(*args, **kwargs):
    _unported("max_unpool3d")


def lp_pool1d(*args, **kwargs):
    _unported("lp_pool1d")


def lp_pool2d(*args, **kwargs):
    _unported("lp_pool2d")


def fractional_max_pool2d(*args, **kwargs):
    _unported("fractional_max_pool2d")


def fractional_max_pool3d(*args, **kwargs):
    _unported("fractional_max_pool3d")
