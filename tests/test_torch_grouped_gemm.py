"""The port's grouped GEMM (paddle_tpu_torch.ops.grouped_gemm) held against
the JAX package's Pallas grouped GEMM (paddle_tpu.ops.pallas.grouped_gemm,
run in interpret mode on the CPU) at the same row tile: the forward over
groups with no live rows, some and all, with garbage in the dead rows (a
dead tile must come back zero, a partly live tile is computed whole), and
the VJP (dlhs through the same kernel against the transposed weights, drhs
over the computed rows), in f32 and bf16. Mirrors tests/test_moe.py:254.
Tolerances, not bitwise: the reference's own bitwise VJP test is red on
this tree (ROADMAP queue C). On CPU tensors the port runs its plain
version, which the CUDA kernel is held to on the card (chip_smoke.py)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import grouped_gemm as jax_gg
from paddle_tpu_torch.ops import grouped_gemm as port_gg


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


# f32: the same products summed over K <= 64 in other orders, values of
# magnitude ~10: a few ulps (1e-5 relative). bf16: both multiply bf16
# operands exactly and accumulate in f32, then round once to bf16: one ulp
# (2^-8 relative) of the largest value, two for safety.
F32_TOL = 1e-5
BF16_TOL = 2 * 2 ** -8

# name: (E, R, K, N, live rows per group, row tile, dtype)
CASES = {
    "f32_bm8_zero_partial_full": (4, 16, 16, 24, [5, 0, 16, 9], 8, "float32"),
    "f32_bm16_k40": (3, 32, 40, 20, [17, 32, 0], 16, "float32"),
    "bf16_bm16": (4, 32, 32, 48, [3, 31, 0, 32], 16, "bfloat16"),
    # the port's own row tile (BM = 64), with a group past one tile
    "f32_bm64": (3, 128, 24, 40, [70, 0, 128], 64, "float32"),
    "bf16_bm64": (2, 128, 32, 16, [1, 65], 64, "bfloat16"),
}


def _case(name):
    E, R, K, N, sizes, bm, dtype = CASES[name]
    rng = np.random.default_rng(len(name))
    lhs = rng.standard_normal((E * R, K)).astype(np.float32)  # garbage in dead rows
    rhs = rng.standard_normal((E, K, N)).astype(np.float32)
    co = rng.standard_normal((E * R, N)).astype(np.float32)
    if dtype == "bfloat16":  # values a bf16 holds exactly on both sides
        lhs, rhs, co = (np.array(jnp.asarray(a, jnp.bfloat16).astype(
            jnp.float32)) for a in (lhs, rhs, co))
    return lhs, rhs, np.asarray(sizes, np.int32), co, bm, dtype


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX forward and VJP of every case, traced into one jit: the
    interpret-mode kernels lower and compile once."""

    def run(args):
        refs = {}
        for name, (lhs, rhs, sizes, co) in args.items():
            bm, dtype = CASES[name][5], CASES[name][6]
            dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
            out, pull = jax.vjp(lambda a, b: jax_gg.grouped_matmul(
                a, b, sizes, block=(bm, 128)), lhs.astype(dt), rhs.astype(dt))
            refs[name] = tuple(x.astype(jnp.float32)
                               for x in (out,) + pull(co.astype(dt)))
        return refs

    args = {n: _case(n)[:4] for n in CASES}
    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        refs = jax.jit(run)(args)
    return {n: [np.asarray(x) for x in r] for n, r in refs.items()}


def _tol(dtype, want):
    return (F32_TOL if dtype == "float32" else BF16_TOL) * max(
        np.abs(want).max(), 1.0)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name, jax_refs):
    lhs, rhs, sizes, _, bm, dtype = _case(name)
    dt = getattr(torch, dtype)
    got = port_gg.grouped_matmul_plain(
        torch.from_numpy(lhs).to(dt), torch.from_numpy(rhs).to(dt),
        torch.from_numpy(sizes), bm=bm).float().numpy()
    want = jax_refs[name][0]
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(dtype, want))
    # dead tiles are exactly zero on both sides; partly live tiles computed
    E, R = CASES[name][0], CASES[name][1]
    computed = np.minimum(-(-sizes // bm) * bm, R)
    dead = (np.arange(R)[None, :] >= computed[:, None]).reshape(E * R)
    assert not got[dead].any() and not want[dead].any()
    assert np.abs(got[~dead]).min(axis=-1).max() > 0


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][5] == port_gg.BM])
def test_vjp_matches_jax(name, jax_refs):
    """The autograd Function runs at the port's row tile, so it is held at
    the cases whose JAX block is the same (bm = 64)."""
    lhs, rhs, sizes, co, _, dtype = _case(name)
    dt = getattr(torch, dtype)
    lt = torch.from_numpy(lhs).to(dt).requires_grad_()
    rt = torch.from_numpy(rhs).to(dt).requires_grad_()
    out = port_gg.grouped_matmul(lt, rt, torch.from_numpy(sizes))
    out.backward(torch.from_numpy(co).to(dt))
    for got, want, what in zip((out.detach(), lt.grad, rt.grad),
                               jax_refs[name], ("out", "dlhs", "drhs")):
        assert got.dtype == dt
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=_tol(dtype, want), err_msg=what)


def test_dlhs_is_the_kernel_against_transposed_weights():
    """dlhs = grouped_gemm(dout, rhs, sizes, trans_rhs=True): the plain
    version read through the flag equals the product against a transposed
    copy, and dead tiles of dlhs are zero."""
    rng = np.random.default_rng(5)
    E, R, K, N = 2, 128, 24, 40
    rhs = torch.from_numpy(rng.standard_normal((E, K, N)).astype(np.float32))
    dout = torch.from_numpy(rng.standard_normal((E * R, N)).astype(np.float32))
    sizes = torch.tensor([0, 65], dtype=torch.int32)
    got = port_gg.grouped_gemm(dout, rhs, sizes, trans_rhs=True)
    want = port_gg.grouped_matmul_plain(dout, rhs.transpose(1, 2).contiguous(),
                                        sizes)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert not got[:R].any() and not got[R + 128:].any()
    assert got[R:R + 128].abs().amax(-1).min() > 0
    assert port_gg.LAUNCHES == 0  # CPU tensors never launch the kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trans", [False, True], ids=["forward", "dlhs"])
def test_tma_padding_feeds_the_plain_version_unchanged(trans, dtype):
    """The bf16 kernel's TMA maps take rows of a multiple of 16 bytes, so
    `tma_operands` pads K = 100 to 104 (lhs's columns and the weights' K
    axis) with zero columns. The padded operands through the plain version,
    cut back to N, equal the JAX package's grouped GEMM at bm = 64 (the
    dlhs form against the swapped weights, as `_gmm_bwd` runs it) and the
    unpadded plain version; operands that need no padding pass as they
    are."""
    E, R, K, N = 2, 128, 100, 96
    sizes = np.asarray([100, 1], np.int32)
    rng = np.random.default_rng(17)
    lhs = rng.standard_normal((E * R, K)).astype(np.float32)
    rhs = rng.standard_normal((E, N, K) if trans else (E, K, N)).astype(np.float32)
    dt = getattr(torch, dtype)
    if dtype == "bfloat16":  # values a bf16 holds exactly on both sides
        lhs, rhs = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                    for a in (lhs, rhs))
    lt, rt, st = (torch.from_numpy(lhs).to(dt), torch.from_numpy(rhs).to(dt),
                  torch.from_numpy(sizes))
    pl, pr, n_out = port_gg.tma_operands(lt, rt, trans)
    assert pl.shape == (E * R, 104) and n_out == N
    assert pr.shape == ((E, N, 104) if trans else (E, 104, N))
    assert not pl[:, K:].any() and not (pr[..., K:] if trans else pr[:, K:]).any()
    got = port_gg.grouped_matmul_plain(pl, pr, st, 64, trans)[:, :N]
    torch.testing.assert_close(
        got, port_gg.grouped_matmul_plain(lt, rt, st, 64, trans), rtol=0,
        atol=_tol(dtype, got.float().numpy()))
    w = np.swapaxes(rhs, 1, 2) if trans else rhs
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jax_gg.grouped_matmul(
        jnp.asarray(lhs, jdt), jnp.asarray(w, jdt), jnp.asarray(sizes),
        block=(64, 128)).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_tol(dtype, want))
    aligned = port_gg.tma_operands(pl, pr, trans)
    assert aligned[0] is pl and aligned[1] is pr and aligned[2] == N


def test_row_stride_and_checks():
    for rows in (1, 15, 16, 17, 64, 65, 77, 1229, 1280):
        assert port_gg.row_stride(rows) == jax_gg.row_stride(rows)
    assert port_gg.row_stride(1229) == 1280
    torch.testing.assert_close(
        port_gg.computed_rows(torch.tensor([0, 1, 64, 65, 1229]), 1280),
        torch.tensor([0, 64, 64, 128, 1280]))
    lhs, rhs = torch.zeros(30, 8), torch.zeros(4, 8, 16)
    sizes = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of the group count"):
        port_gg.grouped_gemm(lhs, rhs, sizes)
    with pytest.raises(ValueError, match="depth"):
        port_gg.grouped_gemm(torch.zeros(32, 7), rhs, sizes)
    with pytest.raises(TypeError, match="one dtype"):
        port_gg.grouped_gemm(torch.zeros(32, 8), rhs.bfloat16(), sizes)
    with pytest.raises(ValueError, match="group_sizes"):
        port_gg.grouped_gemm(torch.zeros(32, 8), rhs, sizes[:3])
