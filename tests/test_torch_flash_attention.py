"""The port's flash attention (paddle_tpu_torch.ops.flash_attention) held
against the JAX package's Pallas kernel (paddle_tpu.ops.pallas.flash_attention,
run in interpret mode on the CPU): values and dq/dk/dv against `jax.vjp`, in
f32, over causal and full attention, Sq = Skv and Sq != Skv (bottom-right
alignment), ragged lengths, D 64 and 128, the diffusion UNet's D 80 and
160 (self-attention, and cross-attention over 13 keys, off every tile),
GQA with g = 1, 2 and 4, and a key bias with a fully padded batch row. On CPU tensors the port runs its plain
versions, which the CUDA kernels are held to on the card (chip_smoke.py).
Also the sdpa dispatch: which calls reach the kernel."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as port_fa


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


# f32 on both sides with logits of magnitude < 5: the JAX default's
# unshifted softmax and the port's running-max form are the same function
# there, and the two differ only in the order of the f32 sums (over D and
# over at most 61 keys), a few ulps of O(1) values.
TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(B, Sq, Skv, H, Hkv, D, seed, scale_q=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Sq, H, D)) * scale_q).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    return q, k, v, do


def _jax_run(q, k, v, do, causal, kb):
    kbj = None if kb is None else jnp.asarray(kb)

    def f(q_, k_, v_):
        return jax_fa.flash_attention_fwd(q_, k_, v_, causal=causal,
                                          key_bias=kbj)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(do))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_run(q, k, v, do, causal, kb):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    kbt = None if kb is None else torch.from_numpy(kb)
    out = port_fa.flash_attention_fwd(qt, kt, vt, causal=causal, key_bias=kbt)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


def _bias(B, Skv, seed, padded_row=None):
    """Additive key bias: 0 for kept keys, -1e30 for a padded tail; batch
    row `padded_row` is padded entirely."""
    rng = np.random.default_rng(seed)
    kb = np.zeros((B, Skv), np.float32)
    for b in range(B):
        kb[b, Skv - int(rng.integers(1, Skv // 2)):] = -1e30
    if padded_row is not None:
        kb[padded_row] = -1e30
    return kb


# (B, Sq, Skv, H, Hkv, D, causal, bias)
CASES = {
    "causal_square_d64": (2, 16, 16, 4, 4, 64, True, None),
    "full_square_d64": (2, 16, 16, 4, 4, 64, False, None),
    "causal_ragged_sq_lt_skv_g2": (1, 37, 61, 4, 2, 64, True, None),
    "full_ragged_g4_d128": (1, 37, 61, 8, 2, 128, False, None),
    "causal_sq_gt_skv_g4_d128": (1, 61, 37, 4, 1, 128, True, None),
    "bias_padded_row_g4_d128": (2, 24, 24, 8, 2, 128, False, "padded_row"),
    "bias_causal_ragged_g2": (2, 20, 33, 4, 2, 64, True, "tail"),
    # the unet_sd rung's heads: 80 (the 128 tile, zero-filled) and 160 (the
    # 192 tile), self-attention and cross-attention over a short context
    "full_self_d80": (2, 24, 24, 4, 4, 80, False, None),
    "full_cross_skv13_d80": (2, 24, 13, 4, 4, 80, False, None),
    "full_self_d160": (1, 20, 20, 2, 2, 160, False, None),
    "full_cross_skv13_d160": (1, 20, 13, 2, 2, 160, False, None),
}


def _case(name):
    """(q, k, v, dO, causal, key bias) of a case, from its seed."""
    B, Sq, Skv, H, Hkv, D, causal, bias = CASES[name]
    q, k, v, do = _inputs(B, Sq, Skv, H, Hkv, D, seed=len(name))
    kb = None
    if bias is not None:
        kb = _bias(B, Skv, seed=3, padded_row=1 if bias == "padded_row" else None)
    return q, k, v, do, causal, kb


def _bf16_case():
    """The bf16 case's inputs, rounded to bf16 values (held as f32)."""
    q, k, v, do = _inputs(2, 40, 40, 4, 2, 64, seed=21)
    return [np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
            for a in (q, k, v, do)], _bias(2, 40, seed=5)


@pytest.fixture(scope="module")
def jax_refs():
    """JAX outputs and gradients of every case and of the bf16 case, traced
    into one jit: the Pallas kernels in interpret mode, as the conftest
    fixture sets it up for a single test, lower and compile once."""
    names = list(CASES)
    bf, bf_kb = _bf16_case()

    def vjp(q, k, v, do, causal, kb):
        out, pull = jax.vjp(lambda q_, k_, v_: jax_fa.flash_attention_fwd(
            q_, k_, v_, causal=causal, key_bias=kb), q, k, v)
        return (out,) + tuple(pull(do))

    def run(cases, bf_args):
        refs = {n: vjp(*a, CASES[n][6], kb) for n, (a, kb) in zip(names, cases)}
        q, k, v, do, kb = bf_args
        refs["bf16"] = tuple(x.astype(jnp.float32) for x in vjp(
            *(a.astype(jnp.bfloat16) for a in (q, k, v, do)), True, kb))
        return refs

    cases = []
    for n in names:
        q, k, v, do, _, kb = _case(n)
        cases.append(((q, k, v, do), kb))
    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        refs = jax.jit(run)(cases, (*bf, bf_kb))
    return {n: [np.asarray(x) for x in r] for n, r in refs.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_values_and_grads_match_jax(name, jax_refs):
    q, k, v, do, causal, kb = _case(name)
    want_o, *want_g = jax_refs[name]
    got_o, got_g = _port_run(q, k, v, do, causal, kb)
    assert np.isfinite(got_o).all() and all(np.isfinite(g).all() for g in got_g)
    np.testing.assert_allclose(got_o, want_o, **TOL)
    for got, want, what in zip(got_g, want_g, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)


@pytest.mark.parametrize("name", ["bias_causal_ragged_g2",
                                  "causal_ragged_sq_lt_skv_g2",
                                  "full_ragged_g4_d128",
                                  "causal_sq_gt_skv_g4_d128"])
def test_dkv_returns_the_kv_heads_gradients(name, jax_refs):
    """flash_bwd_dkv (on CPU tensors its plain version) returns the kv
    heads' dK and dV, f32 [B, Skv, Hkv, D]: the g query heads of a kv head
    summed, as the JAX package's `_bwd` returns them (through jax.vjp
    here), at GQA 4/2 with Sq != Skv, causal and with a key bias, at g = 4
    full, and where rows see no key (Sq > Skv); held to TOL."""
    q, k, v, do, causal, kb = _case(name)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    kbt = None if kb is None else torch.from_numpy(kb)
    scale = q.shape[-1] ** -0.5
    out, lse = port_fa.flash_fwd(qt, kt, vt, causal, scale, kbt)
    delta = (dot * out).sum(-1).transpose(1, 2).contiguous()
    dk, dv = port_fa.flash_bwd_dkv(qt, kt, vt, kbt, dot, lse, delta, causal,
                                   scale)
    pk, pv = port_fa.flash_bwd_dkv_plain(qt, kt, vt, kbt, dot, lse, delta,
                                         causal, scale)
    assert dk.shape == dv.shape == kt.shape
    assert dk.dtype == dv.dtype == torch.float32
    torch.testing.assert_close(dk, pk, rtol=0, atol=0)
    torch.testing.assert_close(dv, pv, rtol=0, atol=0)
    for got, want, what in zip((dk, dv), jax_refs[name][2:], ("dk", "dv")):
        np.testing.assert_allclose(got.numpy(), want, err_msg=what, **TOL)


def test_bf16_values_and_grads_match_jax(jax_refs):
    """bf16 inputs: both packages round P and dS to bf16 before their second
    and third products and keep the statistics in f32; outputs and
    gradients are rounded once to bf16, so they agree to a few bf16 ulps
    (2^-8 relative each) of the largest value."""
    bf, kb = _bf16_case()
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                  for a in bf[:3])
    out = port_fa.flash_attention_fwd(qt, kt, vt, causal=True,
                                      key_bias=torch.from_numpy(kb))
    out.backward(torch.from_numpy(bf[3]).to(torch.bfloat16))
    got = [t.float().numpy() for t in (out.detach(), qt.grad, kt.grad, vt.grad)]
    for g, w, what in zip(got, jax_refs["bf16"], ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, rtol=0, atol=4 * 2 ** -8 * np.abs(w).max(),
                                   err_msg=what)


def test_rows_that_see_no_key_give_zeros_and_zero_gradient(jax_refs):
    """Causal with Sq > Skv: query rows r < Sq - Skv see no key. A batch row
    whose key bias is all -1e30 sees none either. Both give zeros (never
    NaN, never the mean of V) and pass no gradient, as the JAX default
    kernel does."""
    name = "causal_sq_gt_skv_g4_d128"
    Sq, Skv = CASES[name][1:3]
    q, k, v, do, causal, _ = _case(name)
    got_o, (dq, dk, dv) = _port_run(q, k, v, do, causal, None)
    np.testing.assert_array_equal(got_o[:, :Sq - Skv], 0.0)
    np.testing.assert_array_equal(dq[:, :Sq - Skv], 0.0)
    want_o = jax_refs[name][0]
    np.testing.assert_array_equal(want_o[:, :Sq - Skv], 0.0)

    B, Sq, Skv, H, D = 2, 20, 12, 2, 64
    q, k, v, do = _inputs(B, Sq, Skv, H, H, D, seed=9)
    kb = np.zeros((B, Skv), np.float32)
    kb[0] = -1e30
    got_o, (dq, dk, dv) = _port_run(q[:, :Skv], k, v, do[:, :Skv], False, kb)
    for a in (got_o[0], dq[0], dk[0], dv[0]):
        np.testing.assert_array_equal(a, 0.0)
    assert np.abs(got_o[1]).max() > 0
    # the plain forward says so through its LSE: +inf for those rows
    _, lse = port_fa.flash_fwd_plain(torch.from_numpy(q[:, :Skv]),
                                     torch.from_numpy(k), torch.from_numpy(v),
                                     False, D ** -0.5, torch.from_numpy(kb))
    assert torch.isinf(lse[0]).all() and torch.isfinite(lse[1]).all()


def test_large_logits_match_the_exact_safe_softmax(monkeypatch):
    """Logits of 60 and more: the JAX default saturates exp(min(s, 60));
    the port is the exact running-max form, so it is held to the JAX
    package's PADDLE_TPU_FLASH_SAFE_SOFTMAX=1 kernel."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_SAFE_SOFTMAX", "1")
    B, S, H, D = 1, 24, 2, 64
    q, k, v, do = _inputs(B, S, S, H, H, D, seed=11, scale_q=25.0)
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)
    assert logits.max() > 60
    want_o, want_g = _jax_run(q, k, v, do, True, None)
    got_o, got_g = _port_run(q, k, v, do, True, None)
    # near-one-hot softmax rows: the outputs agree to f32 rounding of
    # values O(1), the gradients (O(10) through the scaled q) to 1e-3
    np.testing.assert_allclose(got_o, want_o, rtol=1e-4, atol=1e-4)
    for got, want in zip(got_g, want_g):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def _uses_kernel(out):
    return out.grad_fn is not None and "FlashAttention" in out.grad_fn.name()


def test_sdpa_dispatch_and_key_padding_match_jax():
    """No mask and a [B, 1, 1, Skv] key-padding mask go to the flash
    attention (its plain version here); a full [B, 1, Sq, Skv] mask and a
    mask that needs a gradient go to the composite."""
    B, S, H, D = 2, 10, 2, 64
    q, k, v, _ = _inputs(B, S, S, H, H, D, seed=13)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    keep = np.ones((B, 1, 1, S), bool)
    keep[0, ..., 7:] = False
    full = np.tril(np.ones((S, S), bool))[None, None].repeat(B, 0)

    assert _uses_kernel(TF.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    got = TF.scaled_dot_product_attention(qt, kt, vt, attn_mask=torch.from_numpy(keep))
    assert _uses_kernel(got)
    assert not _uses_kernel(TF.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=torch.from_numpy(full)))
    learned = torch.zeros(B, 1, 1, S, requires_grad=True)
    assert not _uses_kernel(TF.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=learned))
    out, none = TF.flash_attention(qt, kt, vt, causal=True)
    assert _uses_kernel(out) and none is None

    want = paddle.nn.functional.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=paddle.to_tensor(keep)).numpy()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_wrapper_checks_its_inputs():
    q = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="group"):
        port_fa.flash_fwd(q, torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8),
                          True, 1.0)
    with pytest.raises(ValueError, match="key_bias"):
        port_fa.flash_fwd(q, q, q, True, 1.0, torch.zeros(1, 5))
    with pytest.raises(TypeError, match="dtype"):
        port_fa.flash_fwd(q, q.double(), q, True, 1.0)
    assert port_fa.FWD_LAUNCHES == port_fa.DQ_LAUNCHES == port_fa.DKV_LAUNCHES == 0


def test_head_dims_past_192_raise_before_any_launch():
    """The kernels' widest tiles are 192 columns: a wider head raises
    naming the limit, whatever the device; up to 192 the CPU tensor gets
    as far as the device check (on the card: the launch)."""
    assert port_fa.MAX_HEAD_DIM == 192
    for d, match in ((193, "head dims up to 192"), (192, "unsupported device"),
                     (160, "unsupported device")):
        with pytest.raises(ValueError, match=match):
            port_fa._device_checks(torch.zeros(1, 2, 1, d))
