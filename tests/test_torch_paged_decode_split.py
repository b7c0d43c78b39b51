"""The paged decode kernel's split (csrc/decode_attention.cu
`paged_split_kernel`) as plain PyTorch: per-chunk partials of `ppc` pages
(`paged_decode_partials_plain`) summed by the dense kernel's combine
(`dense_decode_combine_plain`), held to the JAX package's
`paged_decode_attention` (the Pallas kernel in interpret mode on the CPU)
in full precision and with int8 pages, and the chunk rule
`paged_chunk_pages`. The CUDA kernel is held to the same plain versions on
the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import decode_attention as jax_da
from paddle_tpu_torch.ops import decode_attention as port_da


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


P, HKV, D = 8, 2, 16
HOLE_ROW = 1    # length P * ps, pages 4-7 all -1: a whole chunk of holes
PARKED_ROW = 2  # length 1, table all -1
EMPTY_ROW = 3   # length 0


def _lengths(ps):
    # a hole at page 1, the hole row, the parked row, an empty row, a row
    # one token into its second page, a row past P * ps (not attended)
    return [7 * ps + 3, P * ps, 1, 0, ps + 1, P * ps + 5]


def _split_case(ps, g, kind):
    """numpy q, caches, block tables, lengths and (int8) scales at B = 6,
    2 kv heads of 16, P = 8 pages a row. int8 scales differ from page to
    page, and row 0's page 0 has scales 0 (a page of zeros)."""
    rng = np.random.default_rng(ps * 10 + g + (kind == "int8"))
    lengths = _lengths(ps)
    B = len(lengths)
    n_pages = 1 + B * P
    q = rng.standard_normal((B, HKV * g, D)).astype(np.float32)
    if kind == "int8":
        kc = rng.integers(-127, 128, (n_pages, HKV, ps, D)).astype(np.int8)
        vc = rng.integers(-127, 128, (n_pages, HKV, ps, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.03, (n_pages, HKV)).astype(np.float32)
        vs = rng.uniform(0.001, 0.03, (n_pages, HKV)).astype(np.float32)
    else:
        kc = rng.standard_normal((n_pages, HKV, ps, D)).astype(np.float32)
        vc = rng.standard_normal((n_pages, HKV, ps, D)).astype(np.float32)
        ks = vs = None
    tables = np.full((B, P), -1, np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    nxt = 0
    for b, L in enumerate(lengths):
        for j in range(min(P, -(-L // ps))):
            tables[b, j] = perm[nxt]
            nxt += 1
    tables[0, 1] = -1
    tables[HOLE_ROW, 4:] = -1
    tables[PARKED_ROW] = -1
    if ks is not None:
        ks[tables[0, 0]] = vs[tables[0, 0]] = 0.0
    return q, kc, vc, tables, np.asarray(lengths, np.int32), ks, vs


_JAX = {}


def _jax_out(ps, g, kind):
    """The JAX package's paged decode of `_split_case(ps, g, kind)`, once
    per case: the reference does not depend on the split."""
    if (ps, g, kind) not in _JAX:
        q, kc, vc, tables, lens, ks, vs = _split_case(ps, g, kind)
        scales = None if ks is None else (jnp.asarray(ks), jnp.asarray(vs))
        _JAX[ps, g, kind] = np.asarray(jax_da.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(tables), jnp.asarray(lens), kv_scales=scales))
    return _JAX[ps, g, kind]


# the Pallas kernel runs a per-page online softmax, the split one softmax
# per chunk and a rescaled sum: equal algebra, different f32 rounding, a
# few ulps of O(1) outputs
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["full", "int8"])
@pytest.mark.parametrize("ps", [8, 13])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("ppc", [1, 2, 4])
def test_paged_split_and_combine_match_jax(ppc, g, ps, kind):
    """Chunks of 1, 2 and 4 pages at g 1 and 4, page sizes 8 and 13: the
    partials summed by the combine equal the JAX kernel and the one-softmax
    plain version; a chunk past the length, or whose pages are all -1,
    carries m = NEG_INF, l = 0, acc = 0; the parked and empty rows come
    out exactly zero; the live-chunk count is ceil(min(length, P * ps) /
    (ppc * ps))."""
    q, kc, vc, tables, lens, ks, vs = _split_case(ps, g, kind)
    t = torch.from_numpy
    scales = None if ks is None else (t(ks), t(vs))
    scale = D ** -0.5
    m, l, acc = port_da.paged_decode_partials_plain(
        t(q), t(kc), t(vc), t(tables), t(lens), scale, ppc, kv_scales=scales)
    B, H = q.shape[:2]
    n = -(-P // ppc)
    assert m.shape == l.shape == (B, H, n) and acc.shape == (B, H, n, D)

    live = port_da.paged_live_chunks_plain(t(lens), P, ps, ppc)
    want_live = [-(-min(int(L), P * ps) // (ppc * ps)) for L in lens]
    assert live.tolist() == want_live
    assert want_live[EMPTY_ROW] == 0 and want_live[PARKED_ROW] == 1
    chunk = torch.arange(n)
    past = chunk[None, :] >= live[:, None]                # [B, n]
    holes = torch.tensor(                                 # every page -1
        [[(tables[b, c * ppc:(c + 1) * ppc] < 0).all() for c in range(n)]
         for b in range(B)])
    assert holes[HOLE_ROW, 4 // ppc:].all() and holes[PARKED_ROW, 0]
    assert holes[0, 1] == (ppc == 1)  # row 0's hole at page 1
    empty = (past | holes)[:, None, :].expand(B, H, n)
    assert (m[empty] == port_da.NEG_INF).all()
    assert not l[empty].any() and not acc[empty].any()
    assert (l[~empty] > 0).all()

    got = port_da.dense_decode_combine_plain(m, l, acc, torch.float32)
    np.testing.assert_allclose(got.numpy(), _jax_out(ps, g, kind), **TOL)
    if scales is None:
        plain = port_da.paged_decode_attention_plain(
            t(q), t(kc), t(vc), t(tables), t(lens), scale)
    else:
        plain = port_da.paged_decode_attention_q8_plain(
            t(q), t(kc), t(vc), t(tables), t(lens), scale, *scales)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    assert not got[PARKED_ROW].any() and not got[EMPTY_ROW].any()
    assert got[[0, 1, 4, 5]].abs().amax(-1).min() > 0


def test_int8_chunk_takes_each_page_scale():
    """A chunk of several int8 pages: each token's score and probability
    take their own page's scales. Scaling one page's V scale by 2 moves
    only what that page contributes, and a split that gave the chunk its
    first page's scales would differ from the JAX kernel."""
    q, kc, vc, tables, lens, ks, vs = _split_case(8, 1, "int8")
    t = torch.from_numpy
    one_scale = vs.copy()
    for b in range(tables.shape[0]):   # every page of a 4-page chunk
        for j in range(P):              # takes its chunk's first page's
            first = tables[b, (j // 4) * 4]
            if tables[b, j] >= 0 and first >= 0:
                one_scale[tables[b, j]] = vs[first]
    m, l, acc = port_da.paged_decode_partials_plain(
        t(q), t(kc), t(vc), t(tables), t(lens), D ** -0.5, 4,
        kv_scales=(t(ks), t(one_scale)))
    wrong = port_da.dense_decode_combine_plain(m, l, acc, torch.float32)
    assert not np.allclose(wrong.numpy(), _jax_out(8, 1, "int8"), **TOL)


def test_paged_chunk_pages():
    """The chunk rule: 2 pages at the serving path (page 32, D 128) in
    bf16, 4 in int8, 1 in f32; K and V of a chunk within 32 KB, at least
    one page (a page larger than that is a chunk of its own); counted in
    pages, so a page size of 13 works."""
    assert port_da.paged_chunk_pages(32, 128, 2) == 2
    assert port_da.paged_chunk_pages(32, 128, 1) == 4
    assert port_da.paged_chunk_pages(32, 128, 4) == 1
    assert port_da.paged_chunk_pages(256, 128, 4) == 1
    for ps, d, es in ((13, 64, 2), (8, 16, 4), (16, 64, 1), (32, 128, 2),
                      (1, 16, 1), (512, 256, 2)):
        ppc = port_da.paged_chunk_pages(ps, d, es)
        assert ppc >= 1
        if 2 * ps * d * es <= 32 * 1024:
            assert 2 * ppc * ps * d * es <= 32 * 1024
            assert 2 * (ppc + 1) * ps * d * es > 32 * 1024
