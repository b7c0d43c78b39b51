"""float16 through the port's attention and grouped-GEMM entry points held
against the JAX package's Pallas kernels run in float16 in interpret mode
on the CPU: flash attention (causal GQA with a padded key bias), flashmask
(causal documents, n = 2, GQA), varlen (causal packed documents with
unaligned lengths, GQA) and the grouped GEMM (the port's row tile), values
and gradients. On CPU tensors the port runs the plain versions, which the
CUDA kernels' f16 instantiations are held to on the card (chip_smoke.py).

Before the port took float16, each of these entry points raised TypeError
on float16 inputs (flash attention "unsupported dtype torch.float16", the
grouped GEMM "takes float32 or bfloat16") where the reference computes:
`test_float16_inputs_compute_where_the_reference_does` is that case.

Tolerances: both packages round P and dS to fp16 before their second and
third products and keep the softmax statistics in f32, and outputs and
gradients round once to fp16, so the two agree to a few fp16 ulps (2^-11
relative each) of the largest value: 4 ulps, as the bf16 tests hold 4 bf16
ulps. The JAX varlen kernel keeps P and dS in f32 where the port rounds
them (the same holds in bf16, test_torch_varlen.py); the limit covers
that. The grouped GEMM multiplies fp16 operands exactly and accumulates in
f32 on both sides: 2 ulps."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu.ops.pallas import grouped_gemm as jax_gg
from paddle_tpu.ops.pallas import masked_flash as jax_mf
from paddle_tpu_torch.ops import flash_attention as port_fa
from paddle_tpu_torch.ops import grouped_gemm as port_gg
from paddle_tpu_torch.ops import masked_flash as port_mf

ULP = 2 ** -11  # half an fp16 step at 1: the rounding of one result
ATT_TOL = 4 * ULP
GG_TOL = 2 * ULP


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


def _f16(*arrays):
    """The arrays rounded to fp16 values (as numpy float16)."""
    return [np.asarray(a, np.float32).astype(np.float16) for a in arrays]


def _flash_case():
    rng = np.random.default_rng(31)
    B, S, H, Hkv, D = 2, 48, 4, 2, 64
    q, do = (rng.standard_normal((B, S, H, D)) for _ in "qd")
    k, v = (rng.standard_normal((B, S, Hkv, D)) for _ in "kv")
    kb = np.zeros((B, S), np.float32)
    kb[1, S - 13:] = -1e30
    return (*_f16(q, k, v, do), kb)


def _flashmask_case():
    rng = np.random.default_rng(32)
    B, S, H, Hkv, D = 1, 64, 4, 2, 32
    q, do = (rng.standard_normal((B, S, H, D)) for _ in "qd")
    k, v = (rng.standard_normal((B, S, Hkv, D)) for _ in "kv")
    starts = np.sort(rng.choice(np.arange(1, S), 3, replace=False))
    bounds = np.concatenate([starts, [S]])
    end = bounds[np.searchsorted(bounds, np.arange(S), side="right")]
    idx = np.stack([end, np.minimum(end + S // 4, S)])[None, None]
    idx = np.moveaxis(idx.astype(np.int32), 2, -1)  # [B, Hm, S, n]
    return (*_f16(q, k, v, do), idx)


def _varlen_case():
    rng = np.random.default_rng(33)
    lens = [13, 30, 21]
    H, Hkv, D, T = 4, 2, 64, sum(lens)
    q, do = (rng.standard_normal((T, H, D)) for _ in "qd")
    k, v = (rng.standard_normal((T, Hkv, D)) for _ in "kv")
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return (*_f16(q, k, v, do), cu)


def _gg_case():
    rng = np.random.default_rng(34)
    E, R, K, N = 3, 128, 32, 48
    lhs = rng.standard_normal((E * R, K))
    rhs = rng.standard_normal((E, K, N)) * K ** -0.5
    co = rng.standard_normal((E * R, N))
    return (*_f16(lhs, rhs, co), np.asarray([5, 0, 128], np.int32))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's fp16 outputs and gradients of the four cases, each
    through its Pallas kernel in interpret mode, in f32 numpy."""

    def vjp(fn, co, *args):
        out, pull = jax.vjp(fn, *args)
        return [x.astype(jnp.float32) for x in (out,) + pull(co)]

    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        q, k, v, do, kb = _flash_case()
        refs["flash"] = jax.jit(lambda *a: vjp(
            lambda x, y, z: jax_fa.flash_attention_fwd(
                x, y, z, causal=True, key_bias=jnp.asarray(kb)),
            jnp.asarray(do), *a))(q, k, v)
        q, k, v, do, idx = _flashmask_case()
        refs["flashmask"] = jax.jit(lambda *a: vjp(
            lambda x, y, z: jax_mf.flashmask_attention_fwd(
                x, y, z, jnp.asarray(idx), causal=True),
            jnp.asarray(do), *a))(q, k, v)
        q, k, v, do, cu = _varlen_case()
        scale = 1.0 / np.sqrt(q.shape[-1])
        refs["varlen"] = jax.jit(lambda *a: vjp(
            lambda x, y, z: jax_mf.varlen_flash_attention_fwd(
                x, y, z, jnp.asarray(cu), jnp.asarray(cu), scale,
                causal=True), jnp.asarray(do), *a))(q, k, v)
        lhs, rhs, co, sizes = _gg_case()
        refs["grouped_gemm"] = jax.jit(lambda *a: vjp(
            lambda x, y: jax_gg.grouped_matmul(
                x, y, jnp.asarray(sizes), block=(port_gg.BM, 128)),
            jnp.asarray(co), *a))(lhs, rhs)
        return {n: [np.array(x, copy=True) for x in r]
                for n, r in refs.items()}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port(name):
    """The port's fp16 outputs and gradients of case `name` through the
    differentiable entry points, as f32 numpy."""
    if name == "flash":
        q, k, v, do, kb = _flash_case()
        ins = [_t(a).requires_grad_() for a in (q, k, v)]
        out = port_fa.flash_attention_fwd(*ins, causal=True, key_bias=_t(kb))
    elif name == "flashmask":
        q, k, v, do, idx = _flashmask_case()
        ins = [_t(a).requires_grad_() for a in (q, k, v)]
        out = port_mf.flashmask_attention_fwd(*ins, _t(idx), causal=True)
    elif name == "varlen":
        q, k, v, do, cu = _varlen_case()
        ins = [_t(a).requires_grad_() for a in (q, k, v)]
        out = port_mf.varlen_flash_attention_fwd(
            *ins, _t(cu), _t(cu), 1.0 / np.sqrt(q.shape[-1]), causal=True)
    else:
        lhs, rhs, do, sizes = _gg_case()
        ins = [_t(a).requires_grad_() for a in (lhs, rhs)]
        out = port_gg.grouped_matmul(*ins, _t(sizes))
    out.backward(_t(do))
    assert out.dtype == torch.float16
    assert all(t.grad.dtype == torch.float16 for t in ins)
    return [t.float().numpy() for t in (out.detach(), *(t.grad for t in ins))]


@pytest.mark.parametrize("name", ["flash", "flashmask", "varlen",
                                  "grouped_gemm"])
def test_float16_values_and_grads_match_jax(name, jax_refs):
    tol = GG_TOL if name == "grouped_gemm" else ATT_TOL
    got, want = _port(name), jax_refs[name]
    for g, w, what in zip(got, want, ("out", "d0", "d1", "d2")):
        assert np.isfinite(g).all(), what
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=f"{name} {what}")


@pytest.mark.parametrize("name", ["flash", "flashmask", "varlen",
                                  "grouped_gemm"])
def test_float16_inputs_compute_where_the_reference_does(name, jax_refs):
    """The parent of this change raised TypeError here: the same fp16
    inputs now give the reference's value (held to the tolerance above),
    and a type no kernel takes (float64) still raises."""
    got = _port(name)[0]
    want = jax_refs[name][0]
    tol = GG_TOL if name == "grouped_gemm" else ATT_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    x = torch.zeros(1, 8, 2, 16, dtype=torch.float64)
    with pytest.raises(TypeError):
        if name == "grouped_gemm":
            port_gg.grouped_matmul(torch.zeros(64, 16, dtype=torch.float64),
                                   torch.zeros(1, 16, 8, dtype=torch.float64),
                                   torch.tensor([3]))
        elif name == "flash":
            port_fa.flash_fwd(x, x, x, True, 0.25)
        elif name == "flashmask":
            port_mf.flashmask_fwd(x, x, x, torch.full((1, 1, 8, 1), 8,
                                                      dtype=torch.int32),
                                  True, 0.25)
        else:
            cu = torch.tensor([0, 8], dtype=torch.int32)
            port_mf.varlen_flash_attention_fwd(x[0], x[0], x[0], cu, cu, 0.25)


def test_float16_plain_versions_round_p_and_ds_to_float16():
    """The plain versions round P and dS to q's type before their products
    (as the JAX kernels cast them to the operand type): in fp16 a forward
    with P kept in f32 differs from the port's, and the port's equals the
    one that rounds P to fp16."""
    q, k, v, _, _ = _flash_case()
    qt, kt, vt = (_t(a) for a in (q, k, v))
    scale = q.shape[-1] ** -0.5
    out, lse = port_fa.flash_fwd(qt, kt, vt, True, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", qt.float(),
                     kt.float().repeat_interleave(2, 2)) * scale
    vis = port_fa._visible(q.shape[1], k.shape[1], True, "cpu")
    s = s.masked_fill(~vis, float("-inf"))
    p = torch.exp(s - lse[..., None])
    v2 = vt.float().repeat_interleave(2, 2)
    rounded = torch.einsum("bhqk,bkhd->bqhd", p.half().float(), v2).half()
    kept = torch.einsum("bhqk,bkhd->bqhd", p, v2).half()
    assert out.dtype == torch.float16
    torch.testing.assert_close(out.float(), rounded.float(), rtol=0,
                               atol=2 * ULP * rounded.abs().max().item())
    assert not torch.equal(out, kept)
