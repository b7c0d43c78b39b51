"""The port's fused-norm gradient (paddle_tpu_torch.ops.fused_norm.FusedNorm:
the dx kernel's plain version on the CPU, dweight/dbias as f32 reductions)
held against `jax.vjp` of the JAX package's `layer_norm_fwd` /
`rms_norm_fwd` (Pallas dx kernel in interpret mode), for f32 and bf16, odd
widths and mean-dominated rows. Also the repair that the port's LayerNorm
stays in the autograd graph."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_norm as jax_norm
from paddle_tpu_torch.nn import LayerNorm, RMSNorm
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import fused_norm as port_norm


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


# f32: the same formulas, summed over a row (dx) or over the rows (dw, db)
# in other orders: a few ulps of O(1) values.
# bf16: inputs and cotangents agree, both compute in f32 and round once to
# bf16, so a result may land on the neighbouring bf16 value: two ulps
# (2^-7 relative each) at the outputs' scale.
TOL = {"float32": dict(rtol=1e-5, atol=2e-5),
       "bfloat16": dict(rtol=1.6e-2, atol=3.2e-2)}

# (rows, N, offset): an odd width, a width that is not a multiple of 128,
# a mean-dominated row set (|mean| = 100 std, where a one-pass variance
# would cancel), 3-D input
SHAPES = [((7,), 37, 0.0), ((5,), 130, 0.0), ((6,), 96, 100.0), ((2, 3), 64, 0.0)]


def _case(lead, n, seed, offset):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(lead + (n,)) + offset).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    dy = rng.standard_normal(lead + (n,)).astype(np.float32)
    return x, w, b, dy


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _jax_grads(kind, x, w, b, dy, dtype):
    jd = getattr(jnp, dtype)
    args = [a.astype(jd) for a in (x, w) + ((b,) if kind == "ln" else ())]
    if kind == "ln":
        def f(x_, w_, b_):
            return jax_norm.layer_norm_fwd(x_, w_, b_, 1e-5)
    else:
        def f(x_, w_):
            return jax_norm.rms_norm_fwd(x_, w_, 1e-6)
    _, vjp = jax.vjp(f, *args)
    return vjp(dy.astype(jd))


KINDS = ["ln", "rms"]
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module")
def jax_refs():
    """`jax.vjp` of every (kind, shape, dtype) case, traced into one jit: the
    Pallas kernels in interpret mode, as the conftest fixture sets it up for
    a single test, lower and compile once."""
    keys = [(kind, i, dtype) for kind in KINDS for i in range(len(SHAPES))
            for dtype in DTYPES]

    def run(inputs):
        return [_jax_grads(kind, *a, dtype)
                for (kind, _, dtype), a in zip(keys, inputs)]

    inputs = []
    for _, i, _ in keys:
        lead, n, offset = SHAPES[i]
        inputs.append(_case(lead, n, seed=n, offset=offset))
    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        out = jax.jit(run)(inputs)
    return dict(zip(keys, out))


def _port_grads(kind, x, w, b, dy, dtype):
    td = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(td).requires_grad_()
    wt = torch.from_numpy(w).to(td).requires_grad_()
    if kind == "ln":
        bt = torch.from_numpy(b).to(td).requires_grad_()
        out = port_norm.layer_norm_fwd(xt, wt, bt, 1e-5)
        ins = (xt, wt, bt)
    else:
        out = port_norm.rms_norm_fwd(xt, wt, 1e-6)
        ins = (xt, wt)
    out.backward(torch.from_numpy(dy).to(td))
    return [t.grad for t in ins]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,n,offset", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_gradients_match_jax_vjp(kind, lead, n, offset, dtype, jax_refs):
    x, w, b, dy = _case(lead, n, seed=n, offset=offset)
    want = jax_refs[(kind, SHAPES.index((lead, n, offset)), dtype)]
    got = _port_grads(kind, x, w, b, dy, dtype)
    for g, j, what in zip(got, want, ("dx", "dweight", "dbias")):
        assert g.dtype == getattr(torch, dtype), what
        tol = dict(TOL[dtype])
        if what != "dx":
            # a sum over the rows of values O(1): the tolerance scales with
            # the largest entry
            tol["atol"] = tol["atol"] * max(1.0, float(np.abs(_np(j)).max()))
        np.testing.assert_allclose(_np(g), _np(j), err_msg=what, **tol)


def test_dx_kernel_plain_version_matches_autograd_of_the_forward():
    """norm_bwd_dx_plain is the kernel's formula written out; it equals
    autograd through the plain forward (both compute in f32: a few ulps)."""
    x, w, _, dy = _case((4,), 19, seed=2, offset=3.0)
    for kind in ("ln", "rms"):
        x64 = torch.from_numpy(x).double().requires_grad_()
        w64 = torch.from_numpy(w).double()
        out, rstd, mean = port_norm.norm_fwd_plain(x64, w64, None, kind, 1e-5)
        out.backward(torch.from_numpy(dy).double())
        got = port_norm.norm_bwd_dx_plain(x64.detach(), w64,
                                          torch.from_numpy(dy).double(),
                                          rstd.detach(), None if mean is None
                                          else mean.detach(), kind)
        np.testing.assert_allclose(got.numpy(), x64.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_layer_norm_output_carries_a_grad_fn():
    """A LayerNorm of a tensor that requires grad stays in the graph:
    the output has the FusedNorm grad_fn, and a loss below it reaches the
    input and both parameters."""
    ln = LayerNorm(24, device="cpu")
    rms = RMSNorm(24, device="cpu")
    x = torch.randn(3, 5, 24, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = ln(x)
    assert y.grad_fn is not None and "FusedNorm" in y.grad_fn.name()
    (rms(y) * torch.arange(24.0)).sum().backward()
    for t in (x, ln.weight, ln.bias, rms.weight):
        assert t.grad is not None and torch.isfinite(t.grad).all()
        assert t.grad.abs().max() > 0
    assert "FusedNorm" in TF.layer_norm(x, 24).grad_fn.name()
    assert port_norm.LAUNCHES == port_norm.DX_LAUNCHES == 0
