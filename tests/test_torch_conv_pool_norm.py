"""The port's conv, pooling and batch-norm functionals and `Momentum` held
to the JAX package on the CPU in f32, on the same numpy inputs: outputs
and the input (and weight) gradients of a random cotangent.

Conv covers every padding form of the reference's `_padding` (an int, one
int a dim, a flat [lo, hi] pair a dim, the nested form with the batch and
channel dims, "SAME" with stride 2, "VALID"), strides, dilations, groups
and both layouts. Where the reference is at fault (ROADMAP queue C) the
port is held to an independent oracle instead: the nested form of a 2-d
conv (the reference reads it as a flat list and fails) and of a
channels-last conv (the reference takes its batch and channel pairs) to
the port's own flat form; `ceil_mode` (the reference ignores it) to
torch's own pools; a channels-last adaptive pool (the reference pools
dims 2.. whatever the layout) to the channels-first one.

Batch norm: training and eval, `use_global_stats`, NCHW, NHWC and [N, C]
inputs, and the running statistics after two calls, beside torch's own
`batch_norm` as a control that must miss them (its momentum is the other
side's, its running variance unbiased).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum

# f32 on both sides; convs and window sums add in other orders: values of
# magnitude ~1-10 agree to a few 1e-6
TOL = dict(rtol=1e-5, atol=2e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _jax_grads(fn, x, w=None, seed=0):
    """The JAX package's fn(x[, w]) and the gradients of sum(out * g) for a
    random g, through its eager tape: (out, g, dx[, dw])."""
    xs = [paddle.to_tensor(x, stop_gradient=False)]
    if w is not None:
        xs.append(paddle.to_tensor(w, stop_gradient=False))
    out = fn(*xs)
    g = _rng(seed + 100).normal(size=tuple(out.shape)).astype(np.float32)
    (out * paddle.to_tensor(g)).sum().backward()
    return (out.numpy(), g) + tuple(t.grad.numpy() for t in xs)


def _port_grads(fn, x, g, w=None):
    xs = [torch.tensor(x, requires_grad=True)]
    if w is not None:
        xs.append(torch.tensor(w, requires_grad=True))
    out = fn(*xs)
    (out * torch.from_numpy(g)).sum().backward()
    return (out.detach().numpy(),) + tuple(t.grad.numpy() for t in xs)


def _held(port, ref):
    assert len(port) == len(ref)
    for got, want in zip(port, ref):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


# name: (n, in shape (channels first), out channels, kernel, stride,
# padding, dilation, groups, channels last)
CONV_CASES = {
    "1d_int": (1, (2, 4, 11), 6, 3, 1, 1, 1, 1, False),
    "1d_pair_dil_groups": (1, (2, 4, 13), 6, 3, 2, [1, 2], 2, 2, False),
    "1d_nested": (1, (2, 4, 11), 6, 4, 1, [[0, 0], [0, 0], [2, 1]], 1, 1, False),
    "1d_same_s2_nlc": (1, (2, 4, 12), 6, 4, 2, "SAME", 1, 1, True),
    "2d_stem": (2, (2, 3, 15, 15), 8, 7, 2, 3, 1, 1, False),
    "2d_per_dim_nhwc": (2, (2, 4, 9, 8), 6, 3, (2, 1), [1, 2], 1, 1, True),
    "2d_flat_dil_groups": (2, (2, 4, 10, 9), 6, 3, 1, [1, 0, 2, 1], 2, 2, False),
    "2d_same_s2": (2, (2, 3, 10, 11), 4, 4, 2, "same", 1, 1, False),
    "2d_valid_s3_nhwc_depthwise": (2, (2, 4, 11, 10), 4, 3, 3, "VALID", 1, 4, True),
    "3d_nested": (3, (1, 2, 5, 6, 7), 3, 3, 2,
                  [[0, 0], [0, 0], [1, 0], [0, 1], [1, 1]], 1, 1, False),
    "3d_same_ndhwc_dil": (3, (1, 2, 6, 7, 5), 4, 3, 1, "SAME", (1, 2, 1), 1, True),
}


def _conv_inputs(name):
    n, shape, cout, k, stride, pad, dil, groups, last = CONV_CASES[name]
    rng = _rng(sum(map(ord, name)))
    x = rng.normal(size=shape).astype(np.float32)
    if last:
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    w = rng.normal(size=(cout, shape[1] // groups) + (k,) * n).astype(np.float32)
    fmt = {1: "NCL", 2: "NCHW", 3: "NCDHW"}[n]
    if last:
        fmt = fmt[0] + fmt[2:] + "C"
    kw = dict(stride=stride, padding=pad, dilation=dil, groups=groups,
              data_format=fmt)
    return n, x, w, kw


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_conv_matches_jax(name):
    n, x, w, kw = _conv_inputs(name)
    jfn, tfn = getattr(JF, f"conv{n}d"), getattr(F, f"conv{n}d")
    ref = _jax_grads(lambda a, b: jfn(a, b, **kw), x, w)
    got = _port_grads(lambda a, b: tfn(a, b, **kw), x, ref[1], w)
    _held(got, (ref[0],) + ref[2:])


def test_conv_bias_is_added_per_channel_in_both_layouts():
    rng = _rng(7)
    x = rng.normal(size=(2, 3, 6, 5)).astype(np.float32)
    w = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    want = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                     paddle.to_tensor(b), padding=1).numpy()
    got = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), padding=1).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    last = F.conv2d(torch.from_numpy(x).permute(0, 2, 3, 1), torch.from_numpy(w),
                    torch.from_numpy(b), padding=1, data_format="NHWC")
    np.testing.assert_allclose(last.permute(0, 3, 1, 2).numpy(), want, **TOL)


def test_nested_padding_where_the_reference_misreads_it():
    """Queue C: the reference's `_padding` (conv.py:36-51) tests the flat
    2n form before the nested one, so a nested 2-d padding (4 pairs) fails
    there, and it takes pairs 2.. of a channels-last nested padding (the
    last spatial dim and the channel dim). The port reads both by the
    layout; each equals its flat form."""
    rng = _rng(8)
    x = torch.from_numpy(rng.normal(size=(2, 3, 7, 6)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 3, 3, 3)).astype(np.float32))
    flat = F.conv2d(x, w, padding=[2, 1, 0, 1], stride=2)
    nested = F.conv2d(x, w, padding=[[0, 0], [0, 0], [2, 1], [0, 1]], stride=2)
    last = F.conv2d(x.permute(0, 2, 3, 1), w, stride=2, data_format="NHWC",
                    padding=[[0, 0], [2, 1], [0, 1], [0, 0]])
    torch.testing.assert_close(nested, flat, rtol=0, atol=0)
    torch.testing.assert_close(last.permute(0, 3, 1, 2), flat, rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(TypeError):
        JF.conv2d(paddle.to_tensor(x.numpy()), paddle.to_tensor(w.numpy()),
                  padding=[[0, 0], [0, 0], [2, 1], [0, 1]], stride=2)


def test_transposed_convs_raise_naming_their_item():
    for fn in (F.conv1d_transpose, F.conv2d_transpose, F.conv3d_transpose):
        with pytest.raises(NotImplementedError, match="item 8"):
            fn(torch.zeros(1, 2, 4), torch.zeros(2, 2, 3))


# name: (function, in shape (channels first), kwargs, channels last)
POOL_CASES = {
    "max2d_resnet": ("max_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1), False),
    "max1d_pair": ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=[0, 2]), False),
    "max3d_same_ndhwc": ("max_pool3d", (1, 2, 5, 6, 7), dict(kernel_size=2, stride=2, padding="SAME"), True),
    "avg2d_exclusive": ("avg_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1), False),
    "avg2d_inclusive": ("avg_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1, exclusive=False), False),
    "avg1d_pair": ("avg_pool1d", (2, 3, 11), dict(kernel_size=4, stride=3, padding=[2, 1]), False),
    "avg2d_same_nhwc": ("avg_pool2d", (2, 3, 7, 10), dict(kernel_size=3, stride=2, padding="SAME"), True),
    "avg3d_per_dim": ("avg_pool3d", (1, 2, 6, 5, 7), dict(kernel_size=(2, 3, 3), stride=(2, 1, 2), padding=[1, 1, 0]), False),
    "adaptive_avg2d_odd": ("adaptive_avg_pool2d", (2, 3, 7, 11), dict(output_size=(3, 5)), False),
    "adaptive_avg2d_one": ("adaptive_avg_pool2d", (2, 3, 7, 7), dict(output_size=1), False),
    "adaptive_max1d_odd": ("adaptive_max_pool1d", (2, 3, 10), dict(output_size=4), False),
    "adaptive_avg3d_odd": ("adaptive_avg_pool3d", (1, 2, 5, 7, 4), dict(output_size=(2, 3, 1)), False),
    "adaptive_max2d_odd": ("adaptive_max_pool2d", (2, 3, 9, 6), dict(output_size=(4, 4)), False),
}


def _pool_input(name):
    fn, shape, kw, last = POOL_CASES[name]
    x = _rng(sum(map(ord, name))).normal(size=shape).astype(np.float32)
    kw = dict(kw)
    if last:
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
        kw["data_format"] = "NDHWC" if x.ndim == 5 else "NHWC"
    return fn, x, kw


@pytest.mark.parametrize("name", sorted(POOL_CASES))
def test_pool_matches_jax(name):
    fn, x, kw = _pool_input(name)
    ref = _jax_grads(lambda a: getattr(JF, fn)(a, **kw), x)
    got = _port_grads(lambda a: getattr(F, fn)(a, **kw), x, ref[1])
    _held(got, (ref[0],) + ref[2:])


@pytest.mark.parametrize("kind", ["max", "avg_exclusive", "avg_inclusive"])
def test_ceil_mode_against_torch_pools(kind):
    """Queue C: the reference's `_pool` (pooling.py:47) accepts ceil_mode
    and ignores it (its output keeps the floor-mode size); the port's is
    held to torch's own pools with ceil_mode, windows that start inside
    the input."""
    x = torch.from_numpy(_rng(3).normal(size=(2, 3, 10, 9)).astype(np.float32))
    tf = torch.nn.functional
    if kind == "max":
        got = F.max_pool2d(x, 3, 2, 1, ceil_mode=True)
        want = tf.max_pool2d(x, 3, 2, 1, ceil_mode=True)
        ref = JF.max_pool2d(paddle.to_tensor(x.numpy()), 3, 2, 1, ceil_mode=True)
    else:
        exclusive = kind == "avg_exclusive"
        got = F.avg_pool2d(x, 3, 2, 1, ceil_mode=True, exclusive=exclusive)
        # an inclusive window divides by its full size, past the padding
        # too (Paddle's pool_size = k_h * k_w when not exclusive)
        want = tf.avg_pool2d(x, 3, 2, 1, ceil_mode=True,
                             count_include_pad=not exclusive,
                             divisor_override=None if exclusive else 9)
        ref = JF.avg_pool2d(paddle.to_tensor(x.numpy()), 3, 2, 1,
                            ceil_mode=True, exclusive=exclusive)
    assert tuple(got.shape) == (2, 3, 6, 5)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert tuple(ref.shape) == (2, 3, 5, 5)


def test_adaptive_pool_reads_the_channels_last_layout():
    """Queue C: the reference's `_adaptive` (pooling.py:139-170) pools dims
    2.. whatever `data_format` says; the port pools H and W of an NHWC
    input, as the NCHW pool of the same tensor."""
    x = torch.from_numpy(_rng(4).normal(size=(2, 3, 7, 11)).astype(np.float32))
    first = F.adaptive_avg_pool2d(x, (3, 5))
    last = F.adaptive_avg_pool2d(x.permute(0, 2, 3, 1), (3, 5),
                                 data_format="NHWC")
    torch.testing.assert_close(last.permute(0, 3, 1, 2), first, rtol=0, atol=0)


def test_unported_pool_branches_raise_naming_their_item():
    """Queue C: the reference accepts `divisor_override` and a conv
    `padding_mode` and ignores them; the port raises on them, as on the
    branches it has not ported."""
    x = torch.zeros(1, 1, 4, 4)
    for call in (lambda: F.max_pool2d(x, 2, return_mask=True),
                 lambda: F.adaptive_max_pool2d(x, 2, return_mask=True),
                 lambda: F.avg_pool2d(x, 2, divisor_override=3),
                 lambda: pnn.Conv2D(1, 1, 3, padding_mode="reflect",
                                    device="cpu")):
        with pytest.raises(NotImplementedError, match="item 8"):
            call()


# name: (input shape, data_format, training, use_global_stats)
BN_CASES = {
    "train_nchw": ((4, 3, 5, 6), "NCHW", True, None),
    "train_nhwc": ((4, 5, 6, 3), "NHWC", True, None),
    "train_nc": ((8, 3), "NCHW", True, None),
    "train_ncdhw": ((2, 3, 3, 4, 5), "NCHW", True, None),
    "eval_nchw": ((4, 3, 5, 6), "NCHW", False, None),
    "global_stats_in_training": ((4, 3, 5, 6), "NCHW", True, True),
}


def _bn_inputs(name):
    shape, fmt, training, ugs = BN_CASES[name]
    rng = _rng(sum(map(ord, name)))
    # a mean and spread per channel far from the running statistics'
    x = (rng.normal(size=shape) * 3.0 + 2.0).astype(np.float32)
    C = shape[-1] if fmt == "NHWC" else shape[1]
    w = (1 + 0.1 * rng.normal(size=C)).astype(np.float32)
    b = (0.1 * rng.normal(size=C)).astype(np.float32)
    rm = (0.5 * rng.normal(size=C)).astype(np.float32)
    rv = (1 + rng.random(C)).astype(np.float32)
    return x, w, b, rm, rv, dict(training=training, data_format=fmt,
                                 use_global_stats=ugs, momentum=0.9,
                                 epsilon=1e-5)


@pytest.mark.parametrize("name", sorted(BN_CASES))
def test_batch_norm_matches_jax(name):
    """Output, the gradients of x, weight and bias, and the running
    statistics after two calls."""
    x, w, b, rm, rv, kw = _bn_inputs(name)
    jx, jw, jb = (paddle.to_tensor(a, stop_gradient=False) for a in (x, w, b))
    jrm, jrv = paddle.to_tensor(rm), paddle.to_tensor(rv)
    JF.batch_norm(jx, jrm, jrv, jw, jb, **kw)
    out = JF.batch_norm(jx, jrm, jrv, jw, jb, **kw)
    g = _rng(5).normal(size=tuple(out.shape)).astype(np.float32)
    (out * paddle.to_tensor(g)).sum().backward()

    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    trm, trv = torch.tensor(rm), torch.tensor(rv)
    F.batch_norm(tx, trm, trv, tw, tb, **kw)
    got = F.batch_norm(tx, trm, trv, tw, tb, **kw)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), out.numpy(), **TOL)
    for t, j in ((tx, jx), (tw, jw), (tb, jb)):
        np.testing.assert_allclose(t.grad.numpy(), j.grad.numpy(), **TOL)
    np.testing.assert_allclose(trm.numpy(), jrm.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(trv.numpy(), jrv.numpy(), rtol=1e-6, atol=1e-6)
    moved = kw["training"] and not kw["use_global_stats"]
    assert moved == (not np.array_equal(trm.numpy(), rm))


def test_torch_batch_norm_misses_paddle_running_statistics():
    """The control: torch's batch_norm given Paddle's momentum (0.9) or its
    own complement (0.1) updates the running statistics otherwise (its
    momentum weighs the batch, its variance is unbiased), which is why
    the port computes them itself."""
    x, w, b, rm, rv, kw = _bn_inputs("train_nchw")
    want_m, want_v = paddle.to_tensor(rm), paddle.to_tensor(rv)
    JF.batch_norm(paddle.to_tensor(x), want_m, want_v, paddle.to_tensor(w),
                  paddle.to_tensor(b), **kw)
    for mom in (0.9, 0.1):
        m, v = torch.tensor(rm), torch.tensor(rv)
        torch.nn.functional.batch_norm(torch.from_numpy(x), m, v,
                                       torch.from_numpy(w), torch.from_numpy(b),
                                       training=True, momentum=mom, eps=1e-5)
        assert not np.allclose(v.numpy(), want_v.numpy(), rtol=1e-5, atol=1e-6)
    # at 0.1 the mean moves as Paddle's: only the variance tells them apart
    np.testing.assert_allclose(m.numpy(), want_m.numpy(), rtol=1e-5, atol=1e-6)


MOMENTUM_CASES = {
    "f32_nesterov_decay": (torch.float32, True, 1e-2),
    "f32_plain": (torch.float32, False, None),
    "bf16_param_decay": (torch.bfloat16, False, 1e-2),
}


@pytest.mark.parametrize("name", sorted(MOMENTUM_CASES))
def test_momentum_matches_jax(name):
    """Three updates of the rule on the same gradients: the parameter and
    the velocity (f32 for a bf16 parameter), against the JAX rule with its
    state fed back as its compiled step does."""
    dtype, nesterov, wd = MOMENTUM_CASES[name]
    rng = _rng(9)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jo = jopt.Momentum(learning_rate=0.1, momentum=0.9, use_nesterov=nesterov,
                       weight_decay=wd, parameters=[])
    jp = jnp.asarray(p0).astype(jdt)
    jst = jo.init_state(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0).to(dtype))
    opt = Momentum(learning_rate=0.1, momentum=0.9, use_nesterov=nesterov,
                   weight_decay=wd, parameters=[p])
    for t, g in enumerate(grads, 1):
        ctx = {"step": t, "weight_decay": wd or 0.0}
        jp, jst = jo.update(jp, jnp.asarray(g).astype(jdt), jst, 0.1, ctx)
        p.grad = torch.from_numpy(g).to(dtype)
        opt.step()
    st = opt._states[id(p)]
    assert st["velocity"].dtype == torch.float32
    tol = dict(rtol=0, atol=0) if dtype == torch.bfloat16 else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p.detach().float().numpy(),
                               np.asarray(jp.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(st["velocity"].numpy(),
                               np.asarray(jst["velocity"].astype(jnp.float32)),
                               **tol)
