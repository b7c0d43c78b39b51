"""The port's flashmask attention (paddle_tpu_torch.ops.masked_flash) held
against the JAX package's Pallas flashmask kernel
(paddle_tpu.ops.pallas.masked_flash, run in interpret mode on the CPU, the
kernel route of `flashmask_attention`): values and dq/dk/dv against
`jax.vjp`, in f32, over causal document masks with n = 1 (several
documents a row) and n = 2, non-causal n = 2 and n = 4, one mask head and
one per query head, GQA, S = 37 and 128 (not a multiple of the 64-row
tile), the trivial index of the model's path, and rows that keep no key
(zeros and zero gradients). Also bf16, and the functional dispatch with its
raises. Mirrors tests/test_masked_flash.py:112, :148, :303. On CPU tensors
the port runs its plain versions, which the CUDA kernels are held to on the
card (chip_smoke.py)."""

import os

import numpy as np
from paddle_tpu_torch.framework import random as port_random
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


# f32 on both sides, logits of magnitude < 5: the running-max softmax of
# both kernels over the same kept keys, sums in other orders: outputs of
# magnitude ~1 agree to a few ulps (1e-5), gradients, whose sums cancel
# more, to 1e-4 of each tensor's largest entry.
VAL_TOL = 1e-5
GRAD_TOL = 1e-4


def _docs(rng, S, n_docs):
    """Column -> first row of the next document (S in the last one): the
    causal n = 1 start index of a row of `n_docs` documents."""
    cuts = np.sort(rng.choice(np.arange(1, S), n_docs - 1, replace=False))
    bounds = np.concatenate([cuts, [S]])
    return bounds[np.searchsorted(bounds, np.arange(S), side="right")]


def _index(rng, B, Hm, S, causal, n, kind):
    """startend_row_indices [B, Hm, S, n] int32 of a mask kind."""
    idx = np.empty((B, Hm, S, n), np.int32)
    cols = np.arange(S)
    for b in range(B):
        for hm in range(Hm):
            if kind == "trivial":
                idx[b, hm] = S
            elif kind == "docs":      # causal, 3 documents: rows past the doc
                idx[b, hm, :, 0] = _docs(rng, S, 3)
                if n == 2:            # [start, end): the next document only
                    idx[b, hm, :, 1] = np.minimum(idx[b, hm, :, 0] + S // 4, S)
            elif kind == "band":      # non-causal n = 2: rows >= LTS or < UTE
                idx[b, hm, :, 0] = np.minimum(cols + int(rng.integers(8, 24)), S)
                idx[b, hm, :, 1] = np.maximum(cols - int(rng.integers(8, 24)), 0)
            elif kind == "two_holes":  # non-causal n = 4
                lts = rng.integers(0, S // 2, S)
                uts = rng.integers(S // 2, S, S)
                idx[b, hm, :, 0] = lts
                idx[b, hm, :, 1] = lts + rng.integers(0, S // 4, S)
                idx[b, hm, :, 2] = uts
                idx[b, hm, :, 3] = uts + rng.integers(0, S // 4, S)
            elif kind == "empty_rows":  # non-causal n = 2: rows >= S - 5 see nothing
                idx[b, hm, :, 0] = S - 5
                idx[b, hm, :, 1] = 0
    return idx


# name: (B, S, H, Hkv, Hm, D, causal, n, mask kind)
CASES = {
    "causal_n1_docs_gqa": (2, 128, 4, 2, 1, 32, True, 1, "docs"),
    "causal_n1_docs_per_head_s37": (1, 37, 4, 4, 4, 32, True, 1, "docs"),
    "causal_n2_docs_gqa": (1, 128, 4, 2, 1, 32, True, 2, "docs"),
    "causal_n2_per_head_s37": (2, 37, 4, 2, 4, 32, True, 2, "docs"),
    "full_n2_band": (1, 128, 4, 4, 1, 32, False, 2, "band"),
    "full_n4_per_head_s37_gqa": (1, 37, 4, 2, 4, 32, False, 4, "two_holes"),
    "causal_trivial_gqa": (2, 128, 4, 2, 1, 32, True, 1, "trivial"),
    "full_n2_empty_rows": (2, 37, 2, 2, 1, 32, False, 2, "empty_rows"),
}


def _case(name):
    B, S, H, Hkv, Hm, D, causal, n, kind = CASES[name]
    rng = np.random.default_rng(len(name))
    q, do = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in "qd")
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in "kv")
    return q, k, v, do, _index(rng, B, Hm, S, causal, n, kind), causal


def _bf16_case():
    q, k, v, do, idx, causal = _case("causal_n2_docs_gqa")
    return [np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
            for a in (q, k, v, do)], idx, causal


@pytest.fixture(scope="module")
def jax_refs():
    """JAX outputs and gradients of every case and of the bf16 case, traced
    into one jit: the interpret-mode kernels lower and compile once."""

    def vjp(q, k, v, do, idx, causal):
        out, pull = jax.vjp(lambda a, b, c: jax_mf.flashmask_attention_fwd(
            a, b, c, idx, causal=causal), q, k, v)
        return (out,) + tuple(pull(do))

    args = {n: _case(n)[:5] for n in CASES}
    bf, bf_idx, _ = _bf16_case()

    def run(args, bf):
        refs = {n: vjp(*a, CASES[n][6]) for n, a in args.items()}
        refs["bf16"] = tuple(x.astype(jnp.float32) for x in vjp(
            *(a.astype(jnp.bfloat16) for a in bf), bf_idx, True))
        return refs

    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        refs = jax.jit(run)(args, bf)
    return {n: [np.asarray(x) for x in r] for n, r in refs.items()}


def _port_run(q, k, v, do, idx, causal, dtype=torch.float32):
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    out = port_mf.flashmask_attention_fwd(qt, kt, vt, torch.from_numpy(idx),
                                          causal=causal)
    out.backward(torch.from_numpy(do).to(dtype))
    return [t.float().numpy() for t in (out.detach(), qt.grad, kt.grad, vt.grad)]


@pytest.mark.parametrize("name", list(CASES))
def test_values_and_grads_match_jax(name, jax_refs):
    got = _port_run(*_case(name))
    want = jax_refs[name]
    assert all(np.isfinite(g).all() for g in got)
    np.testing.assert_allclose(got[0], want[0], rtol=VAL_TOL, atol=VAL_TOL)
    for g, w, what in zip(got[1:], want[1:], ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=what)


@pytest.mark.parametrize("name", ["causal_n1_docs_gqa", "causal_n2_per_head_s37",
                                  "full_n4_per_head_s37_gqa"])
def test_dkv_returns_the_kv_heads_gradients(name, jax_refs):
    """flashmask_bwd_dkv (on CPU tensors its plain version) returns the kv
    heads' dK and dV, f32 [B, Skv, Hkv, D]: the g query heads of a kv head
    summed, as the JAX package's `_fm_bwd` returns them (through jax.vjp
    here), at GQA 4/2 with one mask head and with a mask per query head;
    held to GRAD_TOL of each tensor's largest entry."""
    q, k, v, do, idx, causal = _case(name)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    it = torch.from_numpy(idx).transpose(2, 3)  # the kernels' [B, Hm, n, Skv]
    scale = q.shape[-1] ** -0.5
    out, lse = port_mf.flashmask_fwd(qt, kt, vt, it, causal, scale)
    delta = (dot * out).sum(-1).transpose(1, 2).contiguous()
    dk, dv = port_mf.flashmask_bwd_dkv(qt, kt, vt, it, dot, lse, delta, causal,
                                       scale)
    pk, pv = port_mf.flashmask_bwd_dkv_plain(qt, kt, vt, it, dot, lse, delta,
                                             causal, scale)
    assert dk.shape == dv.shape == kt.shape and dk.dtype == torch.float32
    torch.testing.assert_close(dk, pk, rtol=0, atol=0)
    torch.testing.assert_close(dv, pv, rtol=0, atol=0)
    for g, w, what in zip((dk, dv), jax_refs[name][2:], ("dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=what)


def test_rows_that_keep_no_key_give_zeros_and_zero_gradient(jax_refs):
    """Rows S - 5 .. S - 1 of "full_n2_empty_rows" keep no key: zeros, as
    the JAX kernel gives (never NaN, never the mean of V), and no gradient
    into q; the plain forward marks them with LSE = +inf."""
    q, k, v, do, idx, causal = _case("full_n2_empty_rows")
    out, dq, _, _ = _port_run(q, k, v, do, idx, causal)
    S = q.shape[1]
    np.testing.assert_array_equal(out[:, S - 5:], 0.0)
    np.testing.assert_array_equal(dq[:, S - 5:], 0.0)
    np.testing.assert_array_equal(jax_refs["full_n2_empty_rows"][0][:, S - 5:], 0.0)
    assert np.abs(out[:, :S - 5]).min(axis=-1).max() > 0
    _, lse = port_mf.flashmask_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(idx).transpose(2, 3), causal, q.shape[-1] ** -0.5)
    assert torch.isinf(lse[:, :, S - 5:]).all()
    assert torch.isfinite(lse[:, :, :S - 5]).all()


def test_bf16_values_and_grads_match_jax(jax_refs):
    """bf16 inputs: both round P and dS to bf16 before their second and
    third products and keep the statistics in f32; outputs and gradients
    round once to bf16, so they agree to a few bf16 ulps (2^-8 relative
    each) of the largest value."""
    bf, idx, causal = _bf16_case()
    got = _port_run(*bf, idx, causal, dtype=torch.bfloat16)
    for g, w, what in zip(got, jax_refs["bf16"], ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=4 * 2 ** -8 * np.abs(w).max(),
                                   err_msg=what)


def test_top_left_causal_differs_from_flash_when_sq_lt_skv():
    """Flashmask's causal mask is top-left (key c visible to row r iff
    c <= r); flash attention's is bottom-right. They agree when Sq == Skv
    and not otherwise."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 12, 2, 16)).astype(np.float32))
    idx = torch.full((1, 1, 12, 1), 8, dtype=torch.int32)
    out = port_mf.flashmask_attention_fwd(q, k, k, idx, causal=True)
    keep = np.tril(np.ones((8, 12), bool))  # top-left
    s = np.einsum("qhd,khd->hqk", q[0].numpy(), k[0].numpy()) / 4.0
    p = np.where(keep, np.exp(s - s.max(-1, keepdims=True)), 0.0)
    want = np.einsum("hqk,khd->qhd", p / p.sum(-1, keepdims=True), k[0].numpy())
    np.testing.assert_allclose(out[0].numpy(), want, rtol=1e-5, atol=1e-5)
    same = port_mf.flashmask_attention_fwd(q, q, q, idx[:, :, :8], causal=True)
    np.testing.assert_allclose(
        same.numpy(), TF.scaled_dot_product_attention(
            q, q, q, is_causal=True).numpy(), rtol=1e-5, atol=1e-6)


def test_functional_dispatch_matches_jax_and_raises():
    """nn.functional.flashmask_attention: the JAX kernel route's values and
    q gradient; without indices nothing is masked beyond causal; the seed
    offset slot; and the raises of what the kernels do not take."""
    rng = np.random.default_rng(3)
    S = 40
    qv, kv, vv = (rng.standard_normal((1, S, 2, 32)).astype(np.float32)
                  for _ in range(3))
    idxv = _index(rng, 1, 1, S, True, 1, "docs")
    jq = paddle.to_tensor(qv, stop_gradient=False)
    jout = JF.flashmask_attention(jq, paddle.to_tensor(kv), paddle.to_tensor(vv),
                                  startend_row_indices=paddle.to_tensor(idxv),
                                  causal=True)
    jout.sum().backward()
    tq = torch.from_numpy(qv).requires_grad_()
    tout = TF.flashmask_attention(tq, torch.from_numpy(kv), torch.from_numpy(vv),
                                  startend_row_indices=torch.from_numpy(idxv),
                                  causal=True)
    tout.sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                               rtol=VAL_TOL, atol=VAL_TOL)
    np.testing.assert_allclose(tq.grad.numpy(), jq.grad.numpy(), rtol=0,
                               atol=GRAD_TOL * np.abs(jq.grad.numpy()).max())

    q, k, v = (torch.from_numpy(a) for a in (qv, kv, vv))
    for causal in (True, False):
        np.testing.assert_allclose(
            TF.flashmask_attention(q, k, v, causal=causal).numpy(),
            TF.scaled_dot_product_attention(q, k, v, is_causal=causal).numpy(),
            rtol=1e-5, atol=1e-6)
    out, seed = TF.flashmask_attention(q, k, v, causal=True,
                                       return_seed_offset=True)
    assert seed is None and out.shape == q.shape
    idx = torch.from_numpy(idxv)
    # dropout in training: the composite under the kernels' masking; at a
    # rate that keeps every entry it is the kernel route's output, and at
    # 0.5 a drawn mask (the same one again from the same generator state)
    kernel = TF.flashmask_attention(q, k, v, idx, causal=True)
    kept = TF.flashmask_attention(q, k, v, idx, dropout=1e-12, causal=True)
    torch.testing.assert_close(kept, kernel, rtol=1e-5, atol=1e-6)
    state = port_random.get_rng_state()
    d1 = TF.flashmask_attention(q, k, v, idx, dropout=0.5, causal=True)
    port_random.set_rng_state(state)
    d2 = TF.flashmask_attention(q, k, v, idx, dropout=0.5, causal=True)
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)
    assert (d1 - kernel).abs().max() > 1e-2
    torch.testing.assert_close(
        TF.flashmask_attention(q, k, v, idx, dropout=0.5, causal=True,
                               training=False), kernel, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="window_size"):
        TF.flashmask_attention(q, k, v, idx, causal=True, window_size=(8, 0))
    with pytest.raises(NotImplementedError, match="return_softmax_lse"):
        TF.flashmask_attention(q, k, v, idx, causal=True,
                               return_softmax_lse=True)
    with pytest.raises(ValueError, match="n = 2 or 4"):
        TF.flashmask_attention(q, k, v, idx, causal=False)
    with pytest.raises(ValueError, match="mask heads"):
        TF.flashmask_attention(q, k, v, idx.expand(1, 3, S, 1), causal=True)
    assert port_mf.FWD_LAUNCHES == port_mf.DQ_LAUNCHES == \
        port_mf.DKV_LAUNCHES == 0  # CPU tensors never launch the kernels
