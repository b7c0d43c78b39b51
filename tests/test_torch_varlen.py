"""The port's varlen (packed-sequence) attention
(paddle_tpu_torch.ops.masked_flash's varlen half and the entry points
nn.functional.flash_attn_unpadded / flash_attn_varlen_qkvpacked) held
against the JAX package's Pallas varlen kernels
(paddle_tpu.ops.pallas.masked_flash, run in interpret mode on the CPU, the
kernel route of `flash_attn_unpadded`): values and dq/dk/dv against
`jax.vjp`, in f32, over the cases of tests/test_masked_flash.py:198
(causal and not, GQA, boundaries off the 64-row tile, a single-tile pack,
q lengths != k lengths) and a cross case whose middle k segment is empty
(its rows give zeros and zero gradients, as the JAX kernel gives); also
bf16, the tile ranges the kernels visit, and the entry points with their
raises. On CPU tensors the port runs its plain versions, which the CUDA
kernels are held to on the card (chip_smoke.py)."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import masked_flash as jax_mf
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import masked_flash as port_mf


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


# f32 on both sides, logits of magnitude < 5: the running-max softmax over
# the same kept keys with sums in other orders: outputs of magnitude ~1 to
# a few ulps (1e-5), gradients, whose sums cancel more, to 1e-4 of each
# tensor's largest entry.
VAL_TOL = 1e-5
GRAD_TOL = 1e-4

# name: (q lengths, k lengths or None for the q lengths, H, Hkv, D, causal)
CASES = {
    "causal_two_docs": ([60, 68], None, 4, 4, 64, True),
    "causal_gqa_unaligned": ([33, 50, 45], None, 4, 2, 32, True),
    "full_two_docs": ([100, 156], None, 2, 2, 64, False),
    "causal_single_tile": ([7, 9, 11], None, 2, 1, 32, True),
    "full_cross": ([40, 60], [90, 30], 2, 2, 32, False),
    "causal_cross_empty_k_segment": ([20, 25, 30], [30, 0, 40], 4, 2, 32,
                                     True),
    "causal_many_tiles_gqa": ([100, 37, 150, 3], None, 4, 2, 64, True),
}


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _case(name):
    lens_q, lens_k, H, Hkv, D, causal = CASES[name]
    lens_k = lens_k or lens_q
    rng = np.random.default_rng(len(name))
    Tq, Tk = sum(lens_q), sum(lens_k)
    q, do = (rng.standard_normal((Tq, H, D)).astype(np.float32) for _ in "qd")
    k, v = (rng.standard_normal((Tk, Hkv, D)).astype(np.float32) for _ in "kv")
    return q, k, v, do, _cu(lens_q), _cu(lens_k), causal


def _bf16_case():
    q, k, v, do, cq, ck, causal = _case("causal_gqa_unaligned")
    return [np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
            for a in (q, k, v, do)], cq, ck, causal


@pytest.fixture(scope="module")
def jax_refs():
    """JAX outputs and gradients of every case and of the bf16 case, each
    case in a jit of its own (one program never carries another case's
    interpret-mode kernels), copied out of JAX's buffers into numpy arrays
    that this module owns."""

    def vjp(q, k, v, do, cq, ck, causal):
        scale = 1.0 / np.sqrt(q.shape[-1])
        out, pull = jax.vjp(lambda a, b, c: jax_mf.varlen_flash_attention_fwd(
            a, b, c, cq, ck, scale, causal=causal), q, k, v)
        return (out,) + tuple(pull(do))

    def bf16_vjp(q, k, v, do, cq, ck):
        return tuple(x.astype(jnp.float32) for x in vjp(
            *(a.astype(jnp.bfloat16) for a in (q, k, v, do)), cq, ck, True))

    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        for name in CASES:
            *args, causal = _case(name)
            refs[name] = jax.jit(functools.partial(vjp, causal=causal))(*args)
        bf, bcq, bck, _ = _bf16_case()
        refs["bf16"] = jax.jit(bf16_vjp)(*bf, bcq, bck)
        return {n: [np.array(x, copy=True) for x in r]
                for n, r in refs.items()}


def _port_run(q, k, v, do, cq, ck, causal, dtype=torch.float32):
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    out = port_mf.varlen_flash_attention_fwd(
        qt, kt, vt, torch.from_numpy(cq), torch.from_numpy(ck),
        1.0 / np.sqrt(q.shape[-1]), causal=causal)
    out.backward(torch.from_numpy(do).to(dtype))
    return [t.float().numpy() for t in (out.detach(), qt.grad, kt.grad, vt.grad)]


def _assert_matches(got, want):
    assert all(np.isfinite(g).all() for g in got)
    off = np.argwhere(np.abs(got[0] - want[0]) > VAL_TOL * (1 + np.abs(want[0])))
    np.testing.assert_allclose(
        got[0], want[0], rtol=VAL_TOL, atol=VAL_TOL,
        err_msg=f"(token, head, d) out of tolerance: {off[:16].tolist()}")
    for g, w, what in zip(got[1:], want[1:], ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_values_and_grads_match_jax(name, jax_refs):
    _assert_matches(_port_run(*_case(name)), jax_refs[name])


def test_empty_k_segment_gives_zeros_and_zero_gradient(jax_refs):
    """The middle document of "causal_cross_empty_k_segment" has 25 query
    rows and no keys: zeros and no gradient into q, as the JAX kernel
    gives (never NaN, never the mean of V); the plain forward marks them
    with LSE = +inf. Its neighbours keep their keys."""
    q, k, v, do, cq, ck, causal = _case("causal_cross_empty_k_segment")
    out, dq, _, _ = _port_run(q, k, v, do, cq, ck, causal)
    rows = slice(cq[1], cq[2])
    np.testing.assert_array_equal(out[rows], 0.0)
    np.testing.assert_array_equal(dq[rows], 0.0)
    np.testing.assert_array_equal(
        jax_refs["causal_cross_empty_k_segment"][0][rows], 0.0)
    others = np.r_[0:cq[1], cq[2]:cq[3]]
    assert np.abs(out[others]).min(axis=-1).min() > 0
    layout = port_mf.varlen_layout(torch.from_numpy(cq), torch.from_numpy(ck),
                                   q.shape[0], k.shape[0], causal)
    _, lse = port_mf.varlen_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), layout,
        causal, q.shape[-1] ** -0.5)
    assert torch.isinf(lse[:, rows]).all()
    assert torch.isfinite(lse[:, others]).all()


def test_bf16_values_and_grads_match_jax(jax_refs):
    """bf16 inputs: the port rounds P and dS to bf16 before its second and
    third products, the JAX varlen kernel keeps them in f32 (it computes
    in f32 from bf16 operands); both keep the statistics in f32, and
    outputs and gradients round once to bf16, so they agree to a few bf16
    ulps (2^-8 relative each) of the largest value."""
    bf, cq, ck, causal = _bf16_case()
    got = _port_run(*bf, cq, ck, causal, dtype=torch.bfloat16)
    for g, w, what in zip(got, jax_refs["bf16"], ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=4 * 2 ** -8 * np.abs(w).max(),
                                   err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_tile_ranges_cover_every_kept_pair(name):
    """The kernels visit only the tile ranges of `varlen_layout`: every pair
    the segments keep lies in its q tile's key range and in its key tile's
    q-row range, and the keep mask from the keys' segment ranges equals the
    JAX package's segment-id rule (`_vl_keep` :428)."""
    _, _, _, _, cq, ck, causal = _case(name)
    Tq, Tk = int(cq[-1]), int(ck[-1])
    layout = port_mf.varlen_layout(torch.from_numpy(cq), torch.from_numpy(ck),
                                   Tq, Tk, causal)
    keep = port_mf.varlen_keep(layout, Tq, causal).numpy()
    seg_q = np.cumsum(np.bincount(cq[1:-1], minlength=Tq))[:Tq]
    seg_k = np.cumsum(np.bincount(ck[1:-1], minlength=Tk))[:Tk]
    want = seg_q[:, None] == seg_k[None, :]
    if causal:
        want &= (np.arange(Tq) - cq[seg_q])[:, None] >= \
            (np.arange(Tk) - ck[seg_k])[None, :]
    np.testing.assert_array_equal(keep, want)
    rows, cols = np.nonzero(keep)
    qr, kr = layout.qrange.numpy(), layout.krange.numpy()
    assert ((qr[0][rows // 64] <= cols) & (cols < qr[1][rows // 64])).all()
    assert ((kr[0][cols // 64] <= rows) & (rows < kr[1][cols // 64])).all()


def test_tile_ranges_skip_other_documents():
    """A pack of 8192 tokens in 4 causal documents: a q tile visits the
    keys of its own documents only, up to its last row, so the visited
    pairs are a small part of the pack's (1 - 1/4 of the pairs lie in other
    documents or above a diagonal)."""
    cu = torch.tensor([0, 1000, 4000, 4100, 8192], dtype=torch.int32)
    layout = port_mf.varlen_layout(cu, cu, 8192, 8192, True)
    qr = layout.qrange.long()
    visited = int(((qr[1] + 63) // 64 - qr[0] // 64).sum()) * 64 * 64
    kept = sum(n * (n + 1) // 2 for n in (1000, 3000, 100, 4092))
    assert kept <= visited < 1.2 * kept
    assert qr[0, 20] == 1000 and qr[1, 20] == 21 * 64  # a tile of document 2


def test_entry_points_match_jax_and_raise():
    """nn.functional.flash_attn_unpadded and flash_attn_varlen_qkvpacked:
    the JAX package's kernel route's (out, None), its q/k/v gradients, the
    packed form read as views, and the raises."""
    q, k, v, do, cq, ck, causal = _case("causal_gqa_unaligned")
    k, v = np.repeat(k, 2, axis=1), np.repeat(v, 2, axis=1)  # packed qkv: H kv heads
    scale = 0.2
    jq, jk, jv = (paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v))
    jout, jnone = JF.flash_attn_unpadded(
        jq, jk, jv, paddle.to_tensor(cq), paddle.to_tensor(ck), 50, 50, scale,
        causal=True)
    (jout * paddle.to_tensor(do)).sum().backward()
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tout, tnone = TF.flash_attn_unpadded(
        tq, tk, tv, torch.from_numpy(cq), torch.from_numpy(ck), 50, 50, scale,
        causal=True)
    (tout * torch.from_numpy(do)).sum().backward()
    assert jnone is None and tnone is None
    _assert_matches([tout.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(),
                     tv.grad.numpy()],
                    [jout.numpy(), jq.grad.numpy(), jk.grad.numpy(),
                     jv.grad.numpy()])

    qkv = np.stack([q, k, v], axis=1)  # [T, 3, H, D]
    jqkv = paddle.to_tensor(qkv, stop_gradient=False)
    jpo, _ = JF.flash_attn_varlen_qkvpacked(
        jqkv, paddle.to_tensor(cq), paddle.to_tensor(ck), 50, 50, scale,
        causal=True, varlen_padded=False)
    (jpo * paddle.to_tensor(do)).sum().backward()
    tqkv = torch.from_numpy(qkv).requires_grad_()
    tpo, tnone = TF.flash_attn_varlen_qkvpacked(
        tqkv, torch.from_numpy(cq), torch.from_numpy(ck), 50, 50, scale,
        causal=True, varlen_padded=False)
    (tpo * torch.from_numpy(do)).sum().backward()
    assert tnone is None
    np.testing.assert_allclose(tpo.detach().numpy(), jpo.numpy(),
                               rtol=VAL_TOL, atol=VAL_TOL)
    np.testing.assert_allclose(tpo.detach().numpy(), tout.detach().numpy(),
                               rtol=0, atol=0)
    g = jqkv.grad.numpy()
    np.testing.assert_allclose(tqkv.grad.numpy(), g, rtol=0,
                               atol=GRAD_TOL * np.abs(g).max())

    cqt, ckt = torch.from_numpy(cq), torch.from_numpy(ck)
    # dropout in training: the composite under the kernels' masking, which
    # at a rate that keeps every entry gives the kernel route's output
    kept, _ = TF.flash_attn_unpadded(tq, tk, tv, cqt, ckt, 50, 50, scale,
                                     dropout=1e-12, causal=True)
    torch.testing.assert_close(kept, tout, rtol=1e-5, atol=1e-6)
    dropped, _ = TF.flash_attn_unpadded(tq, tk, tv, cqt, ckt, 50, 50, scale,
                                        dropout=0.5, causal=True)
    assert dropped.shape == tout.shape and (dropped - tout).abs().max() > 1e-2
    out_eval, _ = TF.flash_attn_unpadded(tq, tk, tv, cqt, ckt, 50, 50, scale,
                                         dropout=0.1, causal=True,
                                         training=False)
    torch.testing.assert_close(out_eval, tout, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="varlen_padded=False"):
        TF.flash_attn_varlen_qkvpacked(tqkv, cqt, ckt, 50, 50, scale)
    with pytest.raises(ValueError, match="prefix sums"):
        TF.flash_attn_unpadded(tq, tk, tv, cqt[:1], ckt[:1], 50, 50, scale)
    with pytest.raises(ValueError, match="kv heads"):
        TF.flash_attn_unpadded(tq, tk[:, :3], tv[:, :3], cqt, ckt, 50, 50,
                               scale)
    assert port_mf.VL_FWD_LAUNCHES == port_mf.VL_DQ_LAUNCHES == \
        port_mf.VL_DKV_LAUNCHES == 0  # CPU tensors never launch the kernels
