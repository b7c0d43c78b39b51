"""What the port's bf16 attention kernels (csrc/flash_fwd_sm90.cuh,
csrc/flash_bwd_sm90.cuh) read from Python, on the CPU:

- the flashmask tile classes (ops.masked_flash.flashmask_tile_classes),
  held to the keep-mask of the JAX package's Pallas kernel
  (paddle_tpu.ops.pallas.masked_flash._flashmask_keep) and of the port:
  every kept pair lies in a full or partial tile, every full tile keeps
  all its pairs, every skipped tile keeps none; over causal n = 1 and
  n = 2, non-causal n = 2 and n = 4, one mask head and one per query head,
  S off the tile, and rows that keep no key. Under the trivial causal
  index only the diagonal tiles are partial. The dK/dV kernel's 64-row q
  steps read the class of the 128-row tile that holds them: each half of
  a full tile keeps every pair, each half of a skipped one none. The
  backward wrappers take the forward's classes (checked) or derive them.
- the operand preparation (ops.flash_attention.tma_operands): views a TMA
  map describes pass as they are; an unaligned base or stride, a stride of
  0 (an expanded gradient), or a head dim that is not a multiple of 8,
  gives a contiguous copy (zero-padded to a multiple of 8), and the plain
  forwards on the copy give the unpadded result.

The kernels themselves run only on the card (chip_smoke.py)."""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import masked_flash as jax_mf
from paddle_tpu_torch.ops import flash_attention as port_fa
from paddle_tpu_torch.ops import masked_flash as port_mf


def _docs(rng, S, n_docs):
    """Column -> first row of the next document (S in the last one)."""
    cuts = np.sort(rng.choice(np.arange(1, S), n_docs - 1, replace=False))
    bounds = np.concatenate([cuts, [S]])
    return bounds[np.searchsorted(bounds, np.arange(S), side="right")]


def _index(rng, B, Hm, S, n, kind):
    """Indices in the kernels' layout, int32 [B, Hm, n, S], of a mask kind:
    "trivial" (causal, nothing masked beyond the diagonal), "docs" (causal,
    3 documents a row; n = 2 masks only the next S/4 rows past a document),
    "band" (non-causal n = 2: rows >= col + w1 or < col - w2), "holes"
    (non-causal n = 4) and "empty_rows" (non-causal n = 2: the last 5 rows
    keep no key)."""
    idx = np.empty((B, Hm, n, S), np.int32)
    cols = np.arange(S)
    for b in range(B):
        for hm in range(Hm):
            if kind == "trivial":
                idx[b, hm] = S
            elif kind == "docs":
                idx[b, hm, 0] = _docs(rng, S, 3)
                if n == 2:
                    idx[b, hm, 1] = np.minimum(idx[b, hm, 0] + S // 4, S)
            elif kind == "band":
                idx[b, hm, 0] = np.minimum(cols + int(rng.integers(20, 90)), S)
                idx[b, hm, 1] = np.maximum(cols - int(rng.integers(20, 90)), 0)
            elif kind == "holes":
                lts = rng.integers(0, S // 2, S)
                uts = rng.integers(S // 2, S, S)
                idx[b, hm] = [lts, lts + rng.integers(0, S // 4, S), uts,
                              uts + rng.integers(0, S // 4, S)]
            elif kind == "empty_rows":
                idx[b, hm, 0], idx[b, hm, 1] = S - 5, 0
    return idx


# name: (B, Hm, S, causal, n, kind)
MASKS = {
    "causal_n1_trivial": (2, 1, 256, True, 1, "trivial"),
    "causal_n1_docs_s1000": (2, 1, 1000, True, 1, "docs"),
    "causal_n2_docs_per_head_s300": (1, 4, 300, True, 2, "docs"),
    "full_n2_band_s517": (2, 1, 517, False, 2, "band"),
    "full_n4_holes_per_head_s300": (1, 2, 300, False, 4, "holes"),
    "full_n2_empty_rows_s200": (2, 1, 200, False, 2, "empty_rows"),
}


def _jax_keep(idx, S, causal):
    """bool [B, Hm, S, S] from the JAX kernel's `_flashmask_keep`."""
    B, Hm, n, _ = idx.shape
    rows = jnp.arange(S)[:, None]
    cols = jnp.arange(S)[None, :]
    return np.stack([np.stack([np.asarray(jax_mf._flashmask_keep(
        jnp.asarray(idx[b, hm]), rows, cols, S, S, causal, n))
        for hm in range(Hm)]) for b in range(B)])


@functools.lru_cache(maxsize=None)
def _mask(name):
    """(indices [B, Hm, n, S] int32, the JAX keep-mask) of a MASKS case,
    made once per process."""
    B, Hm, S, causal, n, kind = MASKS[name]
    idx = _index(np.random.default_rng(len(name)), B, Hm, S, n, kind)
    return idx, _jax_keep(idx, S, causal)


@pytest.mark.parametrize("tile", [128, 32])
@pytest.mark.parametrize("name", list(MASKS))
def test_tile_classes_hold_to_the_keep_mask(name, tile):
    B, Hm, S, causal, n, kind = MASKS[name]
    idx, keep = _mask(name)
    np.testing.assert_array_equal(
        port_mf.flashmask_keep(torch.from_numpy(idx), S, S, causal).numpy(),
        keep)
    cls = port_mf.flashmask_tile_classes(torch.from_numpy(idx), S, S, causal,
                                         tile)
    nt = math.ceil(S / tile)
    assert cls.dtype == torch.uint8 and tuple(cls.shape) == (B, Hm, nt, nt)
    cls = cls.numpy()
    padded = np.zeros((B, Hm, nt * tile, nt * tile), bool)
    padded[:, :, :S, :S] = keep
    blocks = padded.reshape(B, Hm, nt, tile, nt, tile)
    kept = blocks.sum((3, 5))
    real = np.minimum(tile, S - np.arange(nt) * tile)  # real rows (keys) a tile
    skip, full = cls == port_mf.SKIP_TILE, cls == port_mf.FULL_TILE
    assert set(np.unique(cls)) <= {port_mf.SKIP_TILE, port_mf.PARTIAL_TILE,
                                   port_mf.FULL_TILE}
    assert not kept[skip].any(), "a skipped tile keeps a pair"
    # a full tile keeps every pair of its real rows against a whole kv tile
    assert (kept == real[:, None] * tile)[full].all(), \
        "a full tile masks a pair"
    assert not full[..., real < tile].any(), "a ragged kv tile is full"
    if kind != "holes":  # structured masks: the classes skip or clear tiles
        assert skip.any() or full.any()


@pytest.mark.parametrize("name", list(MASKS))
def test_64_row_halves_of_full_and_skipped_tiles(name):
    """The dK/dV kernel's 64-row q steps read the class of the 128 x 128
    tile that holds them: every 64-row half of a full tile keeps every
    pair of its real rows against the tile's 128 keys, every half of a
    skipped tile keeps none."""
    B, Hm, S, causal, n, kind = MASKS[name]
    idx, keep = _mask(name)
    cls = port_mf.flashmask_tile_classes(torch.from_numpy(idx), S, S,
                                         causal).numpy()
    tile, half = port_mf.SM90_TILE, port_mf.SM90_TILE // 2
    nt = math.ceil(S / tile)
    padded = np.zeros((B, Hm, nt * tile, nt * tile), bool)
    padded[:, :, :S, :S] = keep
    # [B, Hm, q tile, half, kv tile]: pairs kept in each 64-row half
    kept = padded.reshape(B, Hm, nt, 2, half, nt, tile).sum((4, 6))
    real = np.clip(S - np.arange(2 * nt) * half, 0, half).reshape(nt, 2)
    full = np.broadcast_to((cls == port_mf.FULL_TILE)[:, :, :, None],
                           kept.shape)
    skip = np.broadcast_to((cls == port_mf.SKIP_TILE)[:, :, :, None],
                           kept.shape)
    assert (kept == real[:, :, None] * tile)[full].all(), \
        "a half of a full tile masks a pair"
    assert not kept[skip].any(), "a half of a skipped tile keeps a pair"


def test_backward_takes_the_forward_tile_classes():
    """The backward wrappers' classes: the forward's as given, checked
    against the indices' shape, or derived when None."""
    idx = torch.full((2, 1, 1, 300), 300, dtype=torch.int32)
    cls = port_mf.flashmask_tile_classes(idx, 300, 300, True)
    assert port_mf._tile_classes(idx, cls, 300, 300, True) is cls
    torch.testing.assert_close(port_mf._tile_classes(idx, None, 300, 300, True),
                               cls, rtol=0, atol=0)
    for bad in (cls[:, :, :2], cls.int(), cls[:1]):
        with pytest.raises(ValueError, match="tile classes"):
            port_mf._tile_classes(idx, bad, 300, 300, True)


@pytest.mark.parametrize("S", [256, 384, 1000])
def test_trivial_causal_index_is_partial_only_on_the_diagonal(S):
    """The LLaMA step's index: below the diagonal full, on it partial,
    above it skipped (never visited by the causal kernel either)."""
    idx = torch.full((2, 1, 1, S), S, dtype=torch.int32)
    cls = port_mf.flashmask_tile_classes(idx, S, S, True).numpy()
    nt = math.ceil(S / port_mf.SM90_TILE)
    qt, kt = np.meshgrid(np.arange(nt), np.arange(nt), indexing="ij")
    want = np.where(kt < qt, port_mf.FULL_TILE,
                    np.where(kt == qt, port_mf.PARTIAL_TILE,
                             port_mf.SKIP_TILE))
    np.testing.assert_array_equal(cls, np.broadcast_to(want, cls.shape))


def _views(layout, B=2, S=40, H=4, Hkv=2, D=64):
    """(q, k, v) bf16 views of a layout on the CPU, values from a seed."""
    rng = np.random.default_rng(7)

    def tensor(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).bfloat16()

    if layout == "fused_qkv":  # one [B, S, 3, H, D] buffer, H == Hkv
        qkv = tensor(B, S, 3, H, D)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if layout == "unaligned_base":  # every base 2 bytes past a 16-byte line
        flat = tensor(3 * B * S * H * D + 1)[1:]
        q = flat[:B * S * H * D].view(B, S, H, D)
        k = flat[B * S * H * D:B * S * (H + Hkv) * D].view(B, S, Hkv, D)
        v = flat[B * S * (H + Hkv) * D:B * S * (H + 2 * Hkv) * D].view(
            B, S, Hkv, D)
        return q, k, v
    if layout == "strided_head":  # h stride D + 4: 136 bytes
        return (tensor(B, S, H, D + 4)[..., :D], tensor(B, S, Hkv, D + 4)[..., :D],
                tensor(B, S, Hkv, D + 4)[..., :D])
    if layout == "odd_d":
        D = 36
    return tensor(B, S, H, D), tensor(B, S, Hkv, D), tensor(B, S, Hkv, D)


@pytest.mark.parametrize("layout", ["contiguous", "fused_qkv",
                                    "unaligned_base", "strided_head", "odd_d"])
def test_tma_operands_copy_only_what_a_map_cannot_describe(layout):
    q, k, v = _views(layout)
    D = q.shape[-1]
    qp, kp, vp, d = port_fa.tma_operands(q, k, v)
    passes = layout in ("contiguous", "fused_qkv")
    assert d == (40 if layout == "odd_d" else D)
    for t, tp in ((q, qp), (k, kp), (v, vp)):
        assert (tp is t) == passes
        if not passes:
            assert tp.is_contiguous() and tp.data_ptr() % 16 == 0
            assert tp.shape == (*t.shape[:-1], d)
        assert port_fa._tma_ready(tp)
        torch.testing.assert_close(tp[..., :D], t, rtol=0, atol=0)
        assert not tp[..., D:].any()
    # the plain forwards (in f32, on the same bf16 values) on what the
    # kernel would read, padding dropped, against the same forwards on the
    # views: zero columns add nothing
    q, k, v, qp, kp, vp = (t.float() for t in (q, k, v, qp, kp, vp))
    scale = D ** -0.5
    for causal, kb in ((True, None),
                       (False, torch.zeros(q.shape[0], q.shape[1]))):
        out, lse = port_fa.flash_fwd_plain(q, k, v, causal, scale, kb)
        out_p, lse_p = port_fa.flash_fwd_plain(qp, kp, vp, causal, scale, kb)
        torch.testing.assert_close(out_p[..., :D], out, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(lse_p, lse, rtol=1e-6, atol=1e-6)
    idx = torch.from_numpy(_index(np.random.default_rng(3), q.shape[0], 1,
                                  q.shape[1], 1, "docs"))
    out, lse = port_mf.flashmask_fwd_plain(q, k, v, idx, True, scale)
    out_p, lse_p = port_mf.flashmask_fwd_plain(qp, kp, vp, idx, True, scale)
    torch.testing.assert_close(out_p[..., :D], out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse_p, lse, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", ["contiguous", "fused_qkv",
                                    "unaligned_base", "strided_head", "odd_d"])
def test_bwd_operands_feed_the_plain_backward_unchanged(layout):
    """The backward's operand preparation (ops.flash_attention._bwd_operands,
    shared by the flash and flashmask wrappers): q, k, v and dO as
    tma_operands gives them (views a map describes as they are, others
    copied, D 36 zero-padded to 40) with their 12 (b, s, h) strides; the
    plain dQ and dK/dV on what the kernels would read, cut back to D
    (`_cut`), equal the plain versions on the views: flash causal and with
    a padding key bias, flashmask with a document index."""
    q, k, v = _views(layout)
    B, S, H, D = q.shape
    dout = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, S, H, D)).astype(np.float32)).bfloat16()
    qp, kp, vp, dp, strides, d = port_fa._bwd_operands(q, k, v, dout)
    assert d == (40 if layout == "odd_d" else D)
    assert list(strides) == [t.stride(i) for t in (qp, kp, vp, dp)
                             for i in range(3)]
    for t, tp in ((q, qp), (k, kp), (v, vp), (dout, dp)):
        passes = layout in ("contiguous", "fused_qkv") or (
            t is dout and layout != "odd_d")
        assert (tp is t) == passes
        assert port_fa._tma_ready(tp) and tp.shape == (*t.shape[:-1], d)
        torch.testing.assert_close(tp[..., :D], t, rtol=0, atol=0)
        assert not tp[..., D:].any()
    q, k, v, dout, qp, kp, vp, dp = (t.float() for t in (
        q, k, v, dout, qp, kp, vp, dp))
    scale = D ** -0.5
    kb = torch.zeros(B, S)
    kb[:, S - 7:] = -1e30
    idx = torch.from_numpy(_index(np.random.default_rng(3), B, 1, S, 1,
                                  "docs"))
    flash = (port_fa.flash_fwd_plain, port_fa.flash_bwd_dq_plain,
             port_fa.flash_bwd_dkv_plain)
    mask = (port_mf.flashmask_fwd_plain, port_mf.flashmask_bwd_dq_plain,
            port_mf.flashmask_bwd_dkv_plain)
    for (fwd, bwd_dq, bwd_dkv), extra, causal in (
            (flash, None, True), (flash, kb, False), (mask, idx, True)):
        if fwd is flash[0]:
            out, lse = fwd(q, k, v, causal, scale, extra)
        else:
            out, lse = fwd(q, k, v, extra, causal, scale)
        delta = (dout * out).sum(-1).transpose(1, 2).contiguous()
        tail = (lse, delta, causal, scale)
        dq = bwd_dq(q, k, v, extra, dout, *tail)
        dk, dv = bwd_dkv(q, k, v, extra, dout, *tail)
        dq_p = port_fa._cut(bwd_dq(qp, kp, vp, extra, dp, *tail), D)
        dk_p, dv_p = (port_fa._cut(t, D)
                      for t in bwd_dkv(qp, kp, vp, extra, dp, *tail))
        assert dk.shape == dk_p.shape == k.shape
        for got, want in ((dq_p, dq), (dk_p, dk), (dv_p, dv)):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_tma_operands_copy_a_gradient_no_map_describes():
    """The backward hands dO through tma_operands beside q, k and v: an
    expanded gradient (stride 0, as `out.sum().backward()` gives) or one
    whose head stride is not a multiple of 16 bytes becomes a contiguous
    copy, while q, k and v pass."""
    q, k, v = _views("contiguous")
    B, S, H, D = q.shape
    for dout in (torch.ones((), dtype=torch.bfloat16).expand(q.shape),
                 torch.randn(B, S, H, D + 4).bfloat16()[..., :D]):
        qp, kp, vp, dp, d = port_fa.tma_operands(q, k, v, dout)
        assert qp is q and kp is k and vp is v and d == q.shape[-1]
        assert dp is not dout and dp.is_contiguous() and port_fa._tma_ready(dp)
        torch.testing.assert_close(dp, dout, rtol=0, atol=0)


def test_tma_ready_reads_only_axes_longer_than_one():
    """A decode query [B, 1, H, D] may carry any s stride (a view of a
    longer buffer): the map never steps along an axis of length 1. A
    stride of a longer axis that is not a multiple of 16 bytes fails."""
    buf = torch.zeros(3 * 4 * 65, dtype=torch.bfloat16)
    assert port_fa._tma_ready(buf.as_strided((3, 1, 4, 64), (256, 3, 64, 1)))
    assert not port_fa._tma_ready(buf.as_strided((3, 1, 4, 64),
                                                 (260, 3, 65, 1)))
