"""The port's fused LayerNorm/RMSNorm forward (paddle_tpu_torch.ops.fused_norm)
held against the JAX package's Pallas kernel (paddle_tpu.ops.pallas.fused_norm,
run in interpret mode on the CPU). On CPU tensors the port runs its plain
PyTorch version, which is what the CUDA kernel is held to on the card
(chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_norm as jax_norm
from paddle_tpu_torch.nn import LayerNorm, RMSNorm
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import fused_norm as port_norm


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


# f32: same formula in both, only the order of the row sums differs, so
# the outputs agree to a few f32 ulps of O(1) values.
# bf16: inputs, weights and the f32 statistics agree; the final cast to
# bf16 may land on the neighbouring bf16 value (one ulp is 2^-8 relative,
# 0.0078 at |y| < 2), so the bound is two ulps at the outputs' scale.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1.6e-2, atol=1.6e-2)}


def _case(rows_shape, n, seed, offset=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(rows_shape + (n,)) + offset).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, w, b


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _port(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


# (leading shape, N): odd N, rows that are not a multiple of 8, 3-D input
SHAPES = [((5,), 64), ((13,), 37), ((2, 3), 130), ((7,), 257)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead,n", SHAPES)
def test_layer_norm_matches_jax(lead, n, dtype):
    x, w, b = _case(lead, n, seed=n)
    want = jax_norm.layer_norm_fwd(_jax(x, dtype), _jax(w, dtype),
                                   _jax(b, dtype), 1e-5)
    got = port_norm.layer_norm_fwd(_port(x, dtype), _port(w, dtype),
                                   _port(b, dtype), 1e-5)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead,n", SHAPES)
def test_rms_norm_matches_jax(lead, n, dtype):
    x, w, _ = _case(lead, n, seed=n + 1)
    want = jax_norm.rms_norm_fwd(_jax(x, dtype), _jax(w, dtype), 1e-6)
    got = port_norm.rms_norm_fwd(_port(x, dtype), _port(w, dtype), 1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_no_weight_no_bias_matches_jax(kind):
    x, _, _ = _case((9,), 50, seed=3)
    if kind == "ln":
        want = jax_norm.layer_norm_fwd(jnp.asarray(x), None, None, 1e-5)
        got = port_norm.layer_norm_fwd(torch.from_numpy(x), None, None, 1e-5)
    else:
        want = jax_norm.rms_norm_fwd(jnp.asarray(x), None, 1e-6)
        got = port_norm.rms_norm_fwd(torch.from_numpy(x), None, 1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


def test_mean_dominated_rows_use_the_centred_variance():
    """|mean| >> std: the one-pass E[x^2]-E[x]^2 form would cancel in f32;
    the two-pass form the kernel keeps stays at the JAX package's result
    and at a float64 reference."""
    x, w, b = _case((6,), 96, seed=5, offset=1e4)
    want = jax_norm.layer_norm_fwd(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), 1e-5)
    got = port_norm.layer_norm_fwd(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), 1e-5)
    x64 = x.astype(np.float64)
    mu = x64.mean(-1, keepdims=True)
    ref = (x64 - mu) / np.sqrt(((x64 - mu) ** 2).mean(-1, keepdims=True)
                               + 1e-5) * w + b
    # the f32 sum of 96 values near 1e4 rounds by ~1e-3 depending on the
    # order the two frameworks add in, and that error shifts every centred
    # value (std 1) alike; the one-pass form would be off by O(1) here
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-2)
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=1e-2)


def test_stats_match_float64():
    """norm_fwd also returns the f32 rstd and mean the training slice's
    backward will consume."""
    x, w, b = _case((4,), 33, seed=7)
    _, rstd, mean = port_norm.norm_fwd(torch.from_numpy(x), None, None,
                                       "ln", 1e-5)
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(mean.numpy(), x64.mean(-1), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(x64.var(-1) + 1e-5),
                               rtol=1e-5)
    _, rstd, mean = port_norm.norm_fwd(torch.from_numpy(x), None, None,
                                       "rms", 1e-6)
    assert mean is None
    np.testing.assert_allclose(
        rstd.numpy(), 1 / np.sqrt((x64 ** 2).mean(-1) + 1e-6), rtol=1e-5)


def test_layers_route_through_the_fused_norm():
    """nn.LayerNorm / nn.RMSNorm and the functionals reach the fused
    forward (its plain version on the CPU), leaving the kernel launch
    counter at 0."""
    before = port_norm.LAUNCHES
    x, _, _ = _case((3, 5), 24, seed=11)
    xt = torch.from_numpy(x)
    ln = LayerNorm(24, device="cpu")
    rms = RMSNorm(24, device="cpu")
    want_ln = jax_norm.layer_norm_fwd(jnp.asarray(x), jnp.ones(24),
                                      jnp.zeros(24), 1e-5)
    want_rms = jax_norm.rms_norm_fwd(jnp.asarray(x), jnp.ones(24), 1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(_np(ln(xt)), _np(want_ln), **TOL["float32"])
        np.testing.assert_allclose(_np(rms(xt)), _np(want_rms), **TOL["float32"])
        two_axis = TF.layer_norm(xt, [5, 24])
    x64 = x.astype(np.float64)
    mu = x64.mean((1, 2), keepdims=True)
    ref = (x64 - mu) / np.sqrt(x64.var((1, 2), keepdims=True) + 1e-5)
    np.testing.assert_allclose(_np(two_axis), ref, rtol=1e-5, atol=1e-5)
    assert port_norm.LAUNCHES == before == 0


def test_wrapper_checks_its_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="weight shape"):
        port_norm.layer_norm_fwd(x, torch.ones(7), None)
    with pytest.raises(TypeError, match="dtype"):
        port_norm.layer_norm_fwd(x.double(), None, None)
    with pytest.raises(TypeError, match="differ"):
        port_norm.layer_norm_fwd(x, torch.ones(8), torch.zeros(8).half())
