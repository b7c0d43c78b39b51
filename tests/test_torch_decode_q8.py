"""The port's int8 page append, page quantizer, int8 paged decode and
dense-cache decode (paddle_tpu_torch.ops.decode_attention,
paddle_tpu_torch.inference.paged.block_pool) held against the JAX
package's (the Pallas kernel in interpret mode on the CPU). On CPU tensors
the port runs its plain PyTorch versions, which the CUDA kernels are held
to on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference.paged.block_pool import _quantize_pages as jax_quantize
from paddle_tpu.ops.pallas import decode_attention as jax_da
from paddle_tpu_torch.inference.paged.block_pool import _quantize_pages
from paddle_tpu_torch.ops import decode_attention as port_da


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------- #
# paged_kv_write_q8: the five cases of tests/test_serving_quant.py, bitwise
# --------------------------------------------------------------------------- #


def _q8_case(name):
    """(cache, scales, tables, steps) as numpy, one per JAX case; each step
    is a (new, lengths) append applied in turn."""
    one = np.asarray([[1]], np.int32)
    small = np.full((1, 1, 4), 0.5, np.float32)
    big = np.full((1, 1, 4), 4.0, np.float32)
    at = [np.asarray([0], np.int32), np.asarray([1], np.int32)]
    empty = (np.zeros((2, 1, 4, 4), np.int8), np.zeros((2, 1), np.float32))
    if name == "append":  # rows land at (page 2, slot 1) and (page 3, slot 2)
        new = np.random.default_rng(0).standard_normal((2, 2, 8))
        return (np.zeros((5, 2, 4, 8), np.int8), np.zeros((5, 2), np.float32),
                np.asarray([[1, 2], [3, -1]], np.int32),
                [(new.astype(np.float32), np.asarray([5, 2], np.int32))])
    if name == "scale_grows":
        return (*empty, one, [(small, at[0]), (big, at[1])])
    if name == "scale_unchanged":
        return (*empty, one, [(big, at[0]), (small, at[1])])
    if name == "recycled_slot0":  # a stale tenant's payload and big scale
        return (np.full((2, 1, 4, 4), 111, np.int8),
                np.full((2, 1), 100.0, np.float32), one, [(small, at[0])])
    if name == "parked_row":
        return (np.zeros((3, 1, 4, 4), np.int8), np.zeros((3, 1), np.float32),
                np.asarray([[1], [-1]], np.int32),
                [(np.ones((2, 1, 4), np.float32),
                  np.asarray([1, 0], np.int32))])
    raise KeyError(name)


Q8_CASES = ["append", "parked_row", "recycled_slot0", "scale_grows",
            "scale_unchanged"]


@pytest.mark.parametrize("name", Q8_CASES)
def test_paged_kv_write_q8_is_bitwise_equal_to_jax(name):
    """The five cases of tests/test_serving_quant.py::TestPagedKvWriteQ8:
    after every append the port's in-place int8 cache and scales equal the
    JAX package's bit for bit."""
    cache, scales, tables, steps = _q8_case(name)
    want_c, want_s = jnp.asarray(cache), jnp.asarray(scales)
    got_c, got_s = _t(cache.copy()), _t(scales.copy())
    for new, lengths in steps:
        want_c, want_s = jax_da.paged_kv_write_q8(
            want_c, want_s, jnp.asarray(new), jnp.asarray(tables),
            jnp.asarray(lengths))
        out_c, out_s = port_da.paged_kv_write_q8(got_c, got_s, _t(new),
                                                 _t(tables), _t(lengths))
        assert out_c is got_c and out_s is got_s  # in place
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if name == "recycled_slot0":  # the stale slots are zeroed
        assert not got_c[1, :, 1:].any()
        assert got_s[1, 0].item() == pytest.approx(0.5 / port_da.KV_QMAX)
    if name == "scale_grows":
        assert got_s[1, 0].item() == pytest.approx(4.0 / port_da.KV_QMAX)


def test_quantize_pages_is_bitwise_equal_to_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 2, 4, 8)).astype(np.float32) * 2.0
    x[1, 0] = 0.0  # an all-zero (page, head) keeps scale 0
    x[2, 1, 0, 0] = 1e-3  # a tiny abs-max
    want_q, want_s = jax_quantize(jnp.asarray(x))
    got_q, got_s = _quantize_pages(_t(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[1, 0].item() == 0.0


# --------------------------------------------------------------------------- #
# int8 paged decode (kv_scales=)
# --------------------------------------------------------------------------- #


def _q8_decode_case(B, H, Hkv, D, ps, P, lengths, holes=(), zero_scale=None,
                    seed=0):
    """Random int8 pages and scales behind block tables covering `lengths`;
    (row, page) pairs in `holes` are punched to -1, and `zero_scale`
    (row, page) gets K and V scales of 0 (a page of zeros)."""
    rng = np.random.default_rng(seed)
    need = [-(-L // ps) if L else 0 for L in lengths]
    n_pages = 1 + sum(need) + 2
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc = rng.integers(-127, 128, (n_pages, Hkv, ps, D)).astype(np.int8)
    vc = rng.integers(-127, 128, (n_pages, Hkv, ps, D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.03, (n_pages, Hkv)).astype(np.float32)
    vs = rng.uniform(0.001, 0.03, (n_pages, Hkv)).astype(np.float32)
    tables = np.full((B, P), -1, np.int32)
    nxt = 1
    for b, m in enumerate(need):
        for j in range(m):
            tables[b, j] = nxt
            nxt += 1
    for b, j in holes:
        tables[b, j] = -1
    if zero_scale is not None:
        page = tables[zero_scale]
        ks[page] = vs[page] = 0.0
    return q, kc, vc, ks, vs, tables, np.asarray(lengths, np.int32)


Q8_DECODE = {
    # name: (B, H, Hkv, D, ps, P, lengths, holes, zero-scale page)
    "mha_partial_pages": (2, 4, 4, 32, 8, 4, [21, 13], (), None),
    "gqa4_minus_one_entry": (2, 8, 2, 16, 8, 4, [17, 31], [(1, 1)], None),
    "zero_length_row": (3, 4, 2, 16, 8, 3, [16, 0, 9], (), None),
    "page_with_scale_0": (2, 4, 2, 16, 8, 3, [20, 9], (), (0, 1)),
}

# the Pallas kernel dequantizes and runs a per-page online softmax, the
# plain version one softmax over the dequantized row: equal algebra,
# different f32 rounding, a few ulps of O(1) outputs
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(Q8_DECODE))
def test_q8_decode_plain_matches_jax_kernel(name):
    B, H, Hkv, D, ps, P, lengths, holes, zero = Q8_DECODE[name]
    q, kc, vc, ks, vs, tables, lens = _q8_decode_case(
        B, H, Hkv, D, ps, P, lengths, holes, zero)
    want = np.asarray(jax_da.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(tables),
        jnp.asarray(lens), kv_scales=(jnp.asarray(ks), jnp.asarray(vs))))
    got = port_da.paged_decode_attention(_t(q), _t(kc), _t(vc), _t(tables),
                                         _t(lens), kv_scales=(_t(ks), _t(vs)))
    assert got.shape == (B, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for b, L in enumerate(lengths):
        if L == 0:
            assert not got[b].any()
    assert port_da.Q8_LAUNCHES == 0 and port_da.LAUNCHES == 0


def test_q8_plain_equals_full_precision_on_dequantized_pages():
    """The int8 route is the full-precision route on payload * scale."""
    q, kc, vc, ks, vs, tables, lens = _q8_decode_case(2, 4, 2, 16, 8, 3,
                                                      [20, 9], seed=5)
    got = port_da.paged_decode_attention(_t(q), _t(kc), _t(vc), _t(tables),
                                         _t(lens), kv_scales=(_t(ks), _t(vs)))
    deq_k = _t(kc).float() * _t(ks)[:, :, None, None]
    deq_v = _t(vc).float() * _t(vs)[:, :, None, None]
    ref = port_da.paged_decode_attention(_t(q), deq_k, deq_v, _t(tables),
                                         _t(lens))
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


def test_q8_route_checks_its_inputs():
    q, kc, vc, ks, vs, tables, lens = _q8_decode_case(1, 2, 2, 16, 8, 2, [8])
    with pytest.raises(TypeError, match="int8"):
        port_da.paged_decode_attention(
            _t(q), _t(kc).float(), _t(vc).float(), _t(tables), _t(lens),
            kv_scales=(_t(ks), _t(vs)))
    with pytest.raises(ValueError, match="kv_scales"):
        port_da.paged_decode_attention(
            _t(q), _t(kc), _t(vc), _t(tables), _t(lens),
            kv_scales=(_t(ks[:1]), _t(vs)))
    with pytest.raises(TypeError, match="dtype"):  # int8 without scales
        port_da.paged_decode_attention(_t(q), _t(kc), _t(vc), _t(tables),
                                       _t(lens))


# --------------------------------------------------------------------------- #
# dense-cache decode
# --------------------------------------------------------------------------- #

DENSE = {
    # name: (B, H, Hkv, D, S_max, lengths); the first is
    # tests/test_decode_attention.py::test_dense_decode_matches_reference
    "gqa2_reference_shape": (2, 4, 2, 32, 64, [37, 64]),
    "mha_g1": (3, 4, 4, 16, 48, [5, 48, 17]),
    "length_0_and_s_max": (3, 4, 2, 16, 32, [0, 32, 1]),
}


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_decode_plain_matches_jax(name):
    B, H, Hkv, D, S, lengths = DENSE[name]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(jax_da.dense_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens)))
    got = port_da.dense_decode_attention(_t(q), _t(kc), _t(vc), _t(lens))
    assert got.shape == (B, H, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for b, L in enumerate(lengths):
        if L == 0:
            assert not got[b].any()
    assert port_da.DENSE_LAUNCHES == 0


def test_dense_decode_checks_its_inputs():
    q = torch.zeros(2, 4, 16)
    kc = torch.zeros(2, 2, 8, 16)
    with pytest.raises(ValueError, match="lengths"):
        port_da.dense_decode_attention(q, kc, kc, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="do not fit"):
        port_da.dense_decode_attention(q[:1], kc, kc,
                                       torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="group"):
        port_da.dense_decode_attention(q[:, :3], kc, kc,
                                       torch.zeros(2, dtype=torch.int32))
