"""The port's paged decode attention and page append
(paddle_tpu_torch.ops.decode_attention) held against the JAX package's
(paddle_tpu.ops.pallas.decode_attention, the Pallas kernel in interpret
mode on the CPU). On CPU tensors the port runs its plain PyTorch version,
which the CUDA kernel is held to on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import decode_attention as jax_da
from paddle_tpu_torch.ops import decode_attention as port_da


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


def _make_case(B, H, Hkv, D, ps, P, lengths, seed=0, holes=()):
    """Random paged cache + block tables covering `lengths` tokens; entries
    past a row's last page are -1, and (row, page) pairs in `holes` are
    punched to -1 as well (a page the kernel must skip)."""
    rng = np.random.default_rng(seed)
    need = [-(-L // ps) if L else 0 for L in lengths]
    n_pages = 1 + sum(need) + 2  # page 0 = null, two stale spare pages
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc = rng.standard_normal((n_pages, Hkv, ps, D)).astype(np.float32)
    vc = rng.standard_normal((n_pages, Hkv, ps, D)).astype(np.float32)
    tables = np.full((B, P), -1, np.int32)
    nxt = 1
    for b, m in enumerate(need):
        for j in range(m):
            tables[b, j] = nxt
            nxt += 1
    for b, j in holes:
        tables[b, j] = -1
    return q, kc, vc, tables, np.asarray(lengths, np.int32)


CASES = {
    # name: (B, H, Hkv, D, ps, P, lengths, holes)
    "mha_full_pages": (2, 4, 4, 32, 16, 4, [64, 32], ()),
    "gqa2_partial_last_page": (3, 8, 4, 32, 8, 5, [13, 27, 5], ()),
    "gqa4_minus_one_entries": (2, 8, 2, 16, 8, 4, [17, 31], [(1, 1)]),
    "zero_length_row": (3, 4, 2, 16, 8, 4, [16, 0, 9], ()),
}

# the Pallas kernel runs a per-page online softmax, the plain version one
# softmax over the gathered row: equal algebra, different f32 rounding, a
# few ulps of O(1) outputs
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_decode_matches_jax(name):
    B, H, Hkv, D, ps, P, lengths, holes = CASES[name]
    q, kc, vc, tables, lens = _make_case(B, H, Hkv, D, ps, P, lengths,
                                         holes=holes)
    want = np.asarray(jax_da.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(lens)))
    got = port_da.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(tables), torch.from_numpy(lens))
    assert got.shape == (B, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for b, L in enumerate(lengths):
        if L == 0:  # the l == 0 guard: zeros, never NaN
            assert not got[b].any()
    assert np.isfinite(got.numpy()).all()
    assert port_da.LAUNCHES == 0  # CPU tensors never reach the kernel


def test_bf16_matches_jax():
    """bf16 caches and query: both accumulate in f32 and cast once, so the
    outputs differ by at most a bf16 rounding step or two (2^-8 relative)."""
    q, kc, vc, tables, lens = _make_case(2, 8, 4, 64, 16, 3, [40, 7], seed=4)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    want = jax_da.paged_decode_attention(bf(q), bf(kc), bf(vc),
                                         jnp.asarray(tables), jnp.asarray(lens))
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = port_da.paged_decode_attention(tb(q), tb(kc), tb(vc),
                                         torch.from_numpy(tables),
                                         torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1.6e-2, atol=1.6e-2)


def test_stale_pages_behind_minus_one_do_not_contribute():
    """A -1 entry skips its page although the physical page still holds
    data: the result equals the same row with that page's tokens left out
    (the JAX package's contract, checked here against itself)."""
    q, kc, vc, tables, lens = _make_case(1, 2, 2, 16, 8, 4, [32], seed=2)
    holed = tables.copy()
    holed[0, 2] = -1
    got = port_da.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(holed), torch.from_numpy(lens))
    want = np.asarray(jax_da.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(holed),
        jnp.asarray(lens)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    full = port_da.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(tables), torch.from_numpy(lens))
    assert not torch.allclose(got, full)


def test_paged_kv_write_is_bitwise_equal_to_jax():
    """The decode append, including a parked row (table entry -1) routed
    to null page 0: the port's in-place index write leaves exactly the
    cache the JAX scatter returns."""
    rng = np.random.default_rng(9)
    B, Hkv, D, ps, P, n_pages = 4, 2, 8, 4, 3, 9
    cache = rng.standard_normal((n_pages, Hkv, ps, D)).astype(np.float32)
    tables = np.full((B, P), -1, np.int32)
    tables[0, :2] = [3, 5]
    tables[1, :1] = [2]
    tables[2, :3] = [1, 4, 6]
    lengths = np.asarray([5, 2, 11, 0], np.int32)  # row 3 is parked
    new = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    want = np.asarray(jax_da.paged_kv_write(
        jnp.asarray(cache), jnp.asarray(new), jnp.asarray(tables),
        jnp.asarray(lengths)))
    got = torch.from_numpy(cache.copy())
    out = port_da.paged_kv_write(got, torch.from_numpy(new),
                                 torch.from_numpy(tables),
                                 torch.from_numpy(lengths))
    assert out is got  # in place
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, :, 0].numpy(), new[3])  # null page
    np.testing.assert_array_equal(got[6, :, 3].numpy(), new[2])


def test_int8_pages_raise_and_kv_qmax_matches():
    """kv_scales= takes the int8 page layout only: full-precision caches
    with scales raise; KV_QMAX is the JAX package's."""
    assert port_da.KV_QMAX == jax_da.KV_QMAX
    q, kc, vc, tables, lens = _make_case(1, 2, 2, 16, 8, 2, [8])
    t = torch.from_numpy
    with pytest.raises(TypeError, match="int8"):
        port_da.paged_decode_attention(t(q), t(kc), t(vc), t(tables), t(lens),
                                       kv_scales=(torch.ones(4, 2),) * 2)


def test_wrapper_checks_its_inputs():
    q, kc, vc, tables, lens = _make_case(2, 4, 2, 16, 8, 2, [8, 3])
    t = torch.from_numpy
    with pytest.raises(ValueError, match="group"):
        port_da.paged_decode_attention(t(q[:, :3]), t(kc), t(vc), t(tables),
                                       t(lens))
    with pytest.raises(ValueError, match="lengths"):
        port_da.paged_decode_attention(t(q), t(kc), t(vc), t(tables),
                                       t(lens[:1]))
    with pytest.raises(TypeError, match="dtype"):
        port_da.paged_decode_attention(t(q).double(), t(kc), t(vc), t(tables),
                                       t(lens))


# --------------------------------------------------------------------------- #
# the dense-cache decode split over the sequence (csrc/dense_decode.cu)
# --------------------------------------------------------------------------- #

DENSE_S_MAX = 40  # not a multiple of the chunks below: a ragged last chunk


def _dense_split_case(chunk, g):
    """q, caches and lengths 0, 1, chunk - 1, chunk, chunk + 1 and S_max (one
    row each) at Hkv = 2 kv heads of 16, g query heads a kv head."""
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, DENSE_S_MAX]
    B, Hkv, D = len(lengths), 2, 16
    rng = np.random.default_rng(chunk + g)
    q = rng.standard_normal((B, Hkv * g, D)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, DENSE_S_MAX, D)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, DENSE_S_MAX, D)).astype(np.float32)
    return q, kc, vc, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_dense_split_and_combine_match_jax(chunk, g):
    """The kernel pair's algorithm as plain PyTorch: per-chunk m, l and
    unnormalised acc, then the rescaled sum over the chunks that hold
    tokens. Held to the JAX package's dense decode (the Pallas kernel in
    interpret mode) and to the port's one-softmax plain version, f32 to
    1e-5; a row of length 0 is exactly zero, and a chunk past a row's
    length carries l = 0 and acc = 0."""
    q, kc, vc, lens = _dense_split_case(chunk, g)
    t = torch.from_numpy
    scale = q.shape[-1] ** -0.5
    m, l, acc = port_da.dense_decode_partials_plain(t(q), t(kc), t(vc), t(lens),
                                                    scale, chunk)
    n = -(-DENSE_S_MAX // chunk)
    assert m.shape == (len(lens), q.shape[1], n) and acc.shape[-2:] == (n, 16)
    past = (torch.arange(n) * chunk)[None, :] >= t(lens).long()[:, None]
    assert not l[past[:, None, :].expand_as(l)].any()
    assert not acc[past[:, None, :].expand_as(l)].any()
    got = port_da.dense_decode_combine_plain(m, l, acc, torch.float32)
    want = np.asarray(jax_da.dense_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = port_da.dense_decode_attention_plain(t(q), t(kc), t(vc), t(lens),
                                                 scale)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    assert not got[0].any() and got[1:].abs().amax(-1).min() > 0


def test_dense_chunk_sizes():
    """The chunk of the dense kernel: K and V of a chunk within 64 KB, a
    power of two from 16 to 256, no longer than S_max needs."""
    assert port_da.dense_chunk(128, 2, 2048) == 128  # the MMHA shape, bf16
    assert port_da.dense_chunk(128, 4, 2048) == 64   # f32
    assert port_da.dense_chunk(64, 2, 301) == 256
    assert port_da.dense_chunk(128, 2, 10) == 16
    assert port_da.dense_chunk(1024, 2, 4096) == 16
    for D, es, s_max in ((128, 2, 2048), (64, 4, 301), (16, 4, 40)):
        c = port_da.dense_chunk(D, es, s_max)
        assert 2 * c * D * es <= 64 * 1024 and c & (c - 1) == 0
