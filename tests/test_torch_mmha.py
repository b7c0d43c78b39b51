"""The port's incubate `masked_multihead_attention` (MMHA) held against the
JAX package's: three decode steps over a [2, B, H, S_max, D] cache with
per-row lengths, without `src_mask` (the dense-cache decode, the JAX
Pallas kernel in interpret mode against the port's plain version) and with
an additive `src_mask` (the exact composite in both); the quant, beam and
rotary arguments raise in both."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as jax_if
from paddle_tpu_torch.incubate.nn.functional import masked_multihead_attention
from paddle_tpu_torch.ops import decode_attention as port_da

B, H, D, S_MAX = 3, 2, 16, 24
# the same products in another order; dequantization is not involved
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


@pytest.mark.parametrize("with_mask", [False, True])
def test_three_steps_match_jax(with_mask):
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((2, B, H, S_MAX, D)).astype(np.float32)
    lens = np.asarray([0, 5, 22], np.int32)  # the last row fills S_max
    bias = rng.standard_normal(3 * H * D).astype(np.float32)
    mask = (rng.standard_normal((B, 1, 1, S_MAX)).astype(np.float32)
            if with_mask else None)
    j_cache = paddle.to_tensor(cache)
    t_cache = torch.from_numpy(cache.copy())
    for step in range(3):
        x = rng.standard_normal((B, 3 * H * D)).astype(np.float32)
        seq = lens + step
        j_out, j_cache = jax_if.masked_multihead_attention(
            paddle.to_tensor(x), j_cache, bias=paddle.to_tensor(bias),
            src_mask=None if mask is None else paddle.to_tensor(mask),
            sequence_lengths=paddle.to_tensor(seq))
        t_out, t_ret = masked_multihead_attention(
            torch.from_numpy(x), t_cache, bias=torch.from_numpy(bias),
            src_mask=None if mask is None else torch.from_numpy(mask),
            sequence_lengths=torch.from_numpy(seq))
        assert t_ret is t_cache  # updated in place
        assert t_out.shape == (B, H * D)
        np.testing.assert_array_equal(t_cache.numpy(), j_cache.numpy())
        np.testing.assert_allclose(t_out.numpy(), j_out.numpy(), **TOL)
    assert port_da.DENSE_LAUNCHES == 0


def test_unported_arguments_raise():
    x = torch.zeros(1, 48)
    cache = torch.zeros(2, 1, 2, 4, 8)
    for kw in (dict(out_scale=0.5), dict(rotary_tensor=torch.zeros(1)),
               dict(beam_cache_offset=torch.zeros(1)),
               dict(qkv_out_scale=torch.zeros(1))):
        with pytest.raises(NotImplementedError):
            masked_multihead_attention(x, cache, **kw)
        with pytest.raises(NotImplementedError):
            jax_if.masked_multihead_attention(
                paddle.to_tensor(x.numpy()), paddle.to_tensor(cache.numpy()),
                **{k: (paddle.to_tensor(v.numpy()) if torch.is_tensor(v) else v)
                   for k, v in kw.items()})
