"""What the port's bf16 varlen forward (csrc/flash_fwd_sm90.cuh under
csrc/varlen_flash.cu's `Varlen` policy) reads from Python, on the CPU:

- the varlen tile classes (ops.masked_flash.varlen_tile_classes), held to
  the keep-mask of the pack (ops.masked_flash.varlen_keep, itself held to
  the JAX package's segment rule in tests/test_torch_varlen.py) over that
  file's cases: equal and unequal q/k lengths, an empty k segment, causal
  and not, T off the 128-row tile. Every kept pair lies in a full or
  partial tile, every skipped tile keeps none, every full tile keeps all
  pairs of its real rows and keys, and no key past Tk sits in a full tile.
  The kernel's loop end (the last key of the q tile's 64-row `qrange`s)
  covers every kept pair.
- a plain emulation of the class-driven loop (SKIP tiles never read, FULL
  tiles without the keep test, PARTIAL tiles with it, the running-max
  softmax over 128-key tiles) reproduces the JAX package's Pallas varlen
  forward (interpret mode) in f32, its O and its LSE.
- the operand preparation (ops.flash_attention.tma_operands) of a pack:
  the [1, T, H, D] view of q, k, v and the slices of a packed qkv
  [T, 3, H, D] pass as they are.

The kernel itself runs only on the card (chip_smoke.py)."""

import functools
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import masked_flash as jax_mf
from paddle_tpu_torch.ops import flash_attention as port_fa
from paddle_tpu_torch.ops import masked_flash as port_mf

from test_torch_varlen import CASES, _case


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


# The JAX forward in f32 against the emulation: the same running-max
# softmax over the same kept keys, sums in other orders and over other key
# tiles (128 here, the JAX kernel's own blocks there): outputs of magnitude
# ~1 to a few ulps, as in tests/test_torch_varlen.py.
VAL_TOL = 1e-5
LSE_TOL = 1e-5


def _layout(name):
    _, _, _, _, cq, ck, causal = _case(name)
    Tq, Tk = int(cq[-1]), int(ck[-1])
    layout = port_mf.varlen_layout(torch.from_numpy(cq), torch.from_numpy(ck),
                                   Tq, Tk, causal)
    return layout, Tq, Tk, causal


@pytest.mark.parametrize("tile", [128, 32])
@pytest.mark.parametrize("name", list(CASES))
def test_tile_classes_hold_to_the_keep_mask(name, tile):
    layout, Tq, Tk, causal = _layout(name)
    keep = port_mf.varlen_keep(layout, Tq, causal).numpy()
    cls = port_mf.varlen_tile_classes(layout, Tq, Tk, causal, tile)
    nq, nk = math.ceil(Tq / tile), math.ceil(Tk / tile)
    assert cls.dtype == torch.uint8 and tuple(cls.shape) == (nq, nk)
    cls = cls.numpy()
    assert set(np.unique(cls)) <= {port_mf.SKIP_TILE, port_mf.PARTIAL_TILE,
                                   port_mf.FULL_TILE}
    padded = np.zeros((nq * tile, nk * tile), bool)
    padded[:Tq, :Tk] = keep
    kept = padded.reshape(nq, tile, nk, tile).sum((1, 3))
    real_q = np.minimum(tile, Tq - np.arange(nq) * tile)
    real_k = np.minimum(tile, Tk - np.arange(nk) * tile)
    skip, full = cls == port_mf.SKIP_TILE, cls == port_mf.FULL_TILE
    assert not kept[skip].any(), "a skipped tile keeps a pair"
    assert (kept == real_q[:, None] * real_k[None, :])[full].all(), \
        "a full tile masks a pair"
    assert not full[:, real_k < tile].any(), "a key past Tk sits in a full tile"


@pytest.mark.parametrize("name", list(CASES))
def test_tiles_that_straddle_a_document_edge_are_partial(name):
    """A 128-row q tile whose rows lie in two segments keeps pairs in a
    kv tile without keeping all of them: such tiles are partial, never
    full, and never skipped."""
    layout, Tq, Tk, causal = _layout(name)
    keep = port_mf.varlen_keep(layout, Tq, causal).numpy()
    cls = port_mf.varlen_tile_classes(layout, Tq, Tk, causal).numpy()
    tile = port_mf.SM90_TILE
    for qt in range(cls.shape[0]):
        for kt in range(cls.shape[1]):
            block = keep[qt * tile:(qt + 1) * tile, kt * tile:(kt + 1) * tile]
            if block.any() and not block.all():
                assert cls[qt, kt] == port_mf.PARTIAL_TILE, (qt, kt)


@pytest.mark.parametrize("name", list(CASES))
def test_loop_end_covers_every_kept_pair(name):
    """The kernel visits the kv tiles [0, ceil(end / 128)) of a q tile,
    `end` the largest key end of its 64-row `qrange`s (Varlen::kv_tiles):
    no kept pair lies past it."""
    layout, Tq, Tk, causal = _layout(name)
    keep = port_mf.varlen_keep(layout, Tq, causal).numpy()
    qr = layout.qrange.numpy()
    tile = port_mf.SM90_TILE
    for qt in range(math.ceil(Tq / tile)):
        halves = range(qt * 2, min(qt * 2 + 2, qr.shape[1]))
        n_kv = -(-max(int(qr[1, t]) for t in halves) // tile)
        rows = keep[qt * tile:(qt + 1) * tile]
        assert not rows[:, n_kv * tile:].any(), qt
        assert n_kv <= math.ceil(Tk / tile)


def _emulate(q, k, v, layout, cls, causal, scale, tile=port_mf.SM90_TILE):
    """The class-driven loop of the sm90 forward in plain f32 PyTorch:
    per 128-row q tile, the kv tiles [0, kv_tiles) that are not skipped,
    the keep test on partial tiles only, an exact running-max softmax.
    (O [Tq, H, D], LSE [H, Tq]; +inf and zeros for rows that keep no
    key)."""
    Tq, H, D = q.shape
    Tk, Hkv = k.shape[0], k.shape[1]
    g = H // Hkv
    keep = port_mf.varlen_keep(layout, Tq, causal)
    qr = layout.qrange
    out = torch.zeros(Tq, H, D)
    lse = torch.full((H, Tq), math.inf)
    for qt in range(cls.shape[0]):
        r0, r1 = qt * tile, min((qt + 1) * tile, Tq)
        end = int(qr[1, 2 * qt:2 * qt + 2].max())
        m = torch.full((H, r1 - r0), -math.inf)
        l = torch.zeros(H, r1 - r0)
        acc = torch.zeros(H, r1 - r0, D)
        for kt in range(-(-end // tile)):
            c = int(cls[qt, kt])
            if c == port_mf.SKIP_TILE:
                continue
            c0, c1 = kt * tile, min((kt + 1) * tile, Tk)
            kh = k[c0:c1].repeat_interleave(g, 1).transpose(0, 1)  # [H, n, D]
            vh = v[c0:c1].repeat_interleave(g, 1).transpose(0, 1)
            s = q[r0:r1].transpose(0, 1) @ kh.transpose(1, 2) * scale
            if c == port_mf.PARTIAL_TILE:
                s = s.masked_fill(~keep[r0:r1, c0:c1], -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            m_use = torch.where(torch.isinf(m_new), 0.0, m_new)
            p = torch.exp(s - m_use[..., None])
            alpha = torch.exp(m - m_use)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vh
            m = m_new
        empty = torch.isinf(m) | (l == 0)
        inv = torch.where(empty, 0.0, 1.0 / l)
        out[r0:r1] = (acc * inv[..., None]).transpose(0, 1)
        lse[:, r0:r1] = torch.where(empty, math.inf, m + torch.log(l))
    return out, lse


def _jax_lse(q, k, v, cq, ck, causal):
    """The JAX package's varlen forward LSE [H, Tq] (its Pallas kernel's
    residual, at the entry's default blocks), from segments and positions
    made as `varlen_flash_attention_fwd` makes them."""
    Tq, Tk = q.shape[0], k.shape[0]
    seg_q = jnp.cumsum(jnp.zeros(Tq, jnp.int32).at[cq[1:-1]].add(1))
    seg_k = jnp.cumsum(jnp.zeros(Tk, jnp.int32).at[ck[1:-1]].add(1))
    pos_q = jnp.arange(Tq, dtype=jnp.int32) - jnp.take(cq, seg_q)
    pos_k = jnp.arange(Tk, dtype=jnp.int32) - jnp.take(ck, seg_k)
    bq, bk = jax_mf._block_sizes(Tq, Tk, d=q.shape[-1])
    _, res = jax_mf._varlen_fwd_res(
        jnp.swapaxes(q, 0, 1), jnp.swapaxes(k, 0, 1), jnp.swapaxes(v, 0, 1),
        seg_q, seg_k, pos_q, pos_k, causal, 1.0 / np.sqrt(q.shape[-1]), bq,
        bk)
    return res[-1][:, :Tq, 0]


@pytest.fixture(scope="module")
def jax_fwds():
    """The JAX package's varlen forward (Pallas, interpret mode) of every
    case, each in a jit of its own, copied out into numpy arrays: O from
    the entry, and the kernel's LSE."""

    def fwd(q, k, v, cq, ck, causal):
        out = jax_mf.varlen_flash_attention_fwd(
            q, k, v, cq, ck, 1.0 / np.sqrt(q.shape[-1]), causal=causal)
        return out, _jax_lse(q, k, v, cq.astype(jnp.int32),
                             ck.astype(jnp.int32), causal)

    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        for name in CASES:
            q, k, v, _, cq, ck, causal = _case(name)
            refs[name] = tuple(np.array(a, copy=True) for a in jax.jit(
                functools.partial(fwd, causal=causal))(q, k, v, cq, ck))
    return refs


@pytest.mark.parametrize("name", list(CASES))
def test_class_driven_loop_matches_jax(name, jax_fwds):
    """Skipping SKIP tiles and dropping the keep test on FULL ones changes
    nothing: the emulated loop gives the JAX kernel's O and LSE in f32. A
    row that keeps no key has LSE NEG_INF (-1e30) there and +inf in the
    port (its gradients are zero either way)."""
    q, k, v, _, cq, ck, causal = _case(name)
    layout, Tq, Tk, _ = _layout(name)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    scale = 1.0 / np.sqrt(q.shape[-1])
    cls = port_mf.varlen_tile_classes(layout, Tq, Tk, causal)
    out, lse = _emulate(qt, kt, vt, layout, cls, causal, scale)
    jax_out, jax_lse = jax_fwds[name]
    np.testing.assert_allclose(out.numpy(), jax_out, rtol=VAL_TOL,
                               atol=VAL_TOL)
    empty = jax_lse == jax_mf.NEG_INF
    assert np.isposinf(lse.numpy()[empty]).all()
    np.testing.assert_allclose(lse.numpy()[~empty], jax_lse[~empty],
                               rtol=LSE_TOL, atol=LSE_TOL)


def test_tile_classes_of_an_empty_k_pack():
    """No key at all: no kv tile, so nothing to classify (the wrapper
    gives zeros and LSE = +inf without a launch)."""
    cu_q = torch.tensor([0, 70, 200], dtype=torch.int32)
    cu_k = torch.zeros(3, dtype=torch.int32)
    layout = port_mf.varlen_layout(cu_q, cu_k, 200, 0, True)
    cls = port_mf.varlen_tile_classes(layout, 200, 0, True)
    assert cls.dtype == torch.uint8 and tuple(cls.shape) == (2, 0)


def test_documents_of_a_long_pack_are_full_below_their_diagonal():
    """8192 tokens in 4 causal documents: inside a document the tiles
    below its diagonal are full and those of other documents skipped, so
    partial tiles are only the diagonals and the tiles across an edge."""
    cu = torch.tensor([0, 1000, 4000, 4100, 8192], dtype=torch.int32)
    layout = port_mf.varlen_layout(cu, cu, 8192, 8192, True)
    cls = port_mf.varlen_tile_classes(layout, 8192, 8192, True).numpy()
    assert cls[20, 10] == port_mf.FULL_TILE  # rows 2560-2687, keys 1280-1407
    assert cls[20, 0] == port_mf.SKIP_TILE  # document 1's keys
    assert cls[20, 21] == port_mf.SKIP_TILE  # above the diagonal
    assert cls[20, 20] == port_mf.PARTIAL_TILE
    edges = {0, 1000 // 128, 4000 // 128, 4100 // 128}
    partial = np.argwhere(cls == port_mf.PARTIAL_TILE)
    assert all(qt == kt or kt in edges or qt in edges for qt, kt in partial)
    assert (cls == port_mf.PARTIAL_TILE).sum() < 3 * cls.shape[0]


def test_tma_operands_of_a_pack_are_views():
    """The bf16 forward takes q, k, v as [1, T, H, D] views of the pack:
    contiguous packs and the slices of a packed qkv [T, 3, H, D] pass
    through tma_operands without a copy; a head dim of 36 is padded to 40
    (the wrapper cuts the output back)."""
    rng = np.random.default_rng(5)
    T, H, D = 300, 4, 64

    def tensor(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).bfloat16()

    q, k, v = tensor(T, H, D), tensor(T, 2, D), tensor(T, 2, D)
    qkv = tensor(T, 3, H, D)
    for views in ((q, k, v), tuple(qkv.unbind(1))):
        ts = tuple(t[None] for t in views)
        got = port_fa.tma_operands(*ts)
        assert got[-1] == D
        for t, tp in zip(ts, got[:-1]):
            assert tp is t and port_fa._tma_ready(tp)
    odd = tuple(t[None] for t in (tensor(T, H, 36), tensor(T, 2, 36),
                                  tensor(T, 2, 36)))
    *padded, d = port_fa.tma_operands(*odd)
    assert d == 40
    for t, tp in zip(odd, padded):
        assert tp.shape == (1, T, t.shape[2], 40) and port_fa._tma_ready(tp)
        torch.testing.assert_close(tp[..., :36], t, rtol=0, atol=0)
        assert not tp[..., 36:].any()
