"""The port's fused RoPE (paddle_tpu_torch.ops.fused_rope) and incubate
`fused_rotary_position_embedding` held against the JAX package's
(paddle_tpu.ops.pallas.fused_rope, run in interpret mode on the CPU):
neox and interleaved pairings, 1, 2 and 3 tensors with GQA head counts,
shared [1, S, D/2] and per-row [B, S, D/2] tables, values and the VJP
(the same rotation with sin negated) in f32 and bf16; the functional with
given tables ([S, D] and [1, S, 1, D], full and half width), with
`position_ids`, with neither, and `time_major`. Mirrors
tests/test_fused_norm_rope.py::TestFusedRope. On CPU tensors the port runs
its plain version, which the CUDA kernel is held to on the card
(chip_smoke.py)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as jax_inc
from paddle_tpu.ops.pallas import fused_rope as jax_rope
from paddle_tpu_torch.incubate.nn import functional as port_inc
from paddle_tpu_torch.ops import fused_rope as port_rope


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


# f32, the same tables on both sides: both compute x_a c - x_b s and
# x_b c + x_a s in f32 with one rounding per product and sum, so values of
# magnitude < 6 agree to an ulp or two (1e-6).
TOL = dict(rtol=1e-6, atol=1e-6)


def _tables(rng, Bt, S, D):
    ang = rng.uniform(0, 2 * np.pi, (Bt, S, D // 2)).astype(np.float32)
    return np.cos(ang), np.sin(ang)


# name: (B, S, head counts, D, neox, per-row tables)
CASES = {
    "qk_gqa_neox_shared": (2, 37, (4, 2), 32, True, False),
    "qk_gqa_interleaved_shared": (2, 37, (4, 2), 32, False, False),
    "qk_neox_per_row": (3, 20, (4, 4), 64, True, True),
    "q_only_interleaved_per_row": (2, 9, (2,), 16, False, True),
    "qkv_neox_shared": (1, 16, (4, 2, 2), 16, True, False),
    "qkv_interleaved_per_row": (2, 12, (4, 2, 2), 32, False, True),
}


def _case(name, dtype=np.float32):
    B, S, heads, D, neox, per_row = CASES[name]
    rng = np.random.default_rng(len(name))
    xs = [rng.standard_normal((B, S, h, D)).astype(dtype) for h in heads]
    gs = [rng.standard_normal((B, S, h, D)).astype(dtype) for h in heads]
    c, s = _tables(rng, B if per_row else 1, S, D)
    return xs, gs, c, s, not neox


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


BF16_CASES = ("qk_gqa_neox_shared", "qkv_interleaved_per_row")


@pytest.fixture(scope="module")
def jax_refs():
    """Outputs and input gradients of every case (f32) and of the bf16
    cases, from the JAX kernel and its custom VJP, traced into one jit so
    the interpret-mode kernels lower and compile once. Returns them with
    the bf16 cases' inputs (bf16 values held as f32)."""

    def vjp(xs, gs, c, s, interleaved, dt):
        xs = tuple(x.astype(dt) for x in xs)
        outs, pull = jax.vjp(lambda *t: jax_rope.apply_fused_rope(
            t, c, s, interleaved=interleaved), *xs)
        grads = pull(tuple(g.astype(dt) for g in gs))
        return ([o.astype(jnp.float32) for o in outs],
                [g.astype(jnp.float32) for g in grads])

    args = {n: _case(n)[:4] for n in CASES}
    bf_args = {n: ([_bf16(x) for x in xs], [_bf16(g) for g in gs], c, s)
               for n, (xs, gs, c, s) in ((n, args[n]) for n in BF16_CASES)}

    def run(args, bf_args):
        refs = {n: vjp(*a, not CASES[n][4], jnp.float32)
                for n, a in args.items()}
        refs.update({"bf16 " + n: vjp(*a, not CASES[n][4], jnp.bfloat16)
                     for n, a in bf_args.items()})
        return refs

    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        refs = jax.jit(run)(args, bf_args)
    refs = {n: ([np.asarray(o) for o in outs], [np.asarray(g) for g in grads])
            for n, (outs, grads) in refs.items()}
    return refs, bf_args


def _port(xs, gs, c, s, interleaved, dtype=torch.float32):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in xs]
    outs = port_rope.apply_fused_rope(ts, torch.from_numpy(c),
                                      torch.from_numpy(s), interleaved)
    torch.autograd.backward(outs, [torch.from_numpy(g).to(dtype) for g in gs])
    return ([o.detach().float().numpy() for o in outs],
            [t.grad.float().numpy() for t in ts])


@pytest.mark.parametrize("name", list(CASES))
def test_values_and_vjp_match_jax(name, jax_refs):
    refs, _ = jax_refs
    want_o, want_g = refs[name]
    got_o, got_g = _port(*_case(name))
    assert len(got_o) == len(want_o) == len(CASES[name][2])
    for got, want in zip(got_o + got_g, want_o + want_g):
        np.testing.assert_allclose(got, want, **TOL)


def _bf16_ulp(v):
    """One bf16 ulp at each |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("name", BF16_CASES)
def test_bf16_within_one_ulp_of_jax(name, jax_refs):
    """bf16 inputs: both compute in f32 from the same bf16 values and round
    once, so they agree to one bf16 ulp (the f32 results may straddle a
    rounding boundary)."""
    refs, bf = jax_refs
    want_o, want_g = refs["bf16 " + name]
    got_o, got_g = _port(*bf[name], not CASES[name][4], dtype=torch.bfloat16)
    for got, want in zip(got_o + got_g, want_o + want_g):
        assert np.all(np.abs(got - want) <= _bf16_ulp(want)), name


def test_backward_is_the_rotation_with_sin_negated():
    xs, gs, c, s, il = _case("qk_gqa_neox_shared")
    _, grads = _port(xs, gs, c, s, il)
    neg = port_rope.rope_plain([torch.from_numpy(g) for g in gs],
                               torch.from_numpy(c), -torch.from_numpy(s), il)
    for g, want in zip(grads, neg):
        np.testing.assert_array_equal(g, want.numpy())


def test_kernel_wrapper_checks_its_inputs():
    x = torch.zeros(2, 4, 2, 8)
    c = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError, match="1 to 3"):
        port_rope.rope([x] * 4, c, c)
    with pytest.raises(ValueError, match="even head dim"):
        port_rope.rope([torch.zeros(2, 4, 2, 7)], c, c)
    with pytest.raises(ValueError, match="table"):
        port_rope.rope([x], torch.zeros(3, 4, 4), torch.zeros(3, 4, 4))
    with pytest.raises(TypeError, match="one float dtype"):
        port_rope.rope([x, x.bfloat16()], c, c)
    assert port_rope.LAUNCHES == 0  # CPU tensors never launch the kernel


# --------------------------------------------------------------------------- #
# the incubate functional
# --------------------------------------------------------------------------- #

B, S, H, HKV, D = 2, 12, 4, 2, 16


def _qk(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, HKV, D)).astype(np.float32))


def _given_tables(shape, neox, seed):
    """Tables as callers pass them: [S, D] / [1, S, 1, D] full width (each
    angle twice, in the pairing's layout) or [S, D/2] half width."""
    ang = np.random.default_rng(seed).uniform(0, 6, (S, D // 2)).astype(np.float32)
    if shape.endswith("full"):
        ang = np.concatenate([ang, ang], -1) if neox else np.repeat(ang, 2, -1)
    c, s = np.cos(ang), np.sin(ang)
    if shape.startswith("1s1d"):
        c, s = c[None, :, None, :], s[None, :, None, :]
    return c, s


# name: (tables, position_ids, neox, time_major, tensors)
FUNCTIONAL = {
    "sd_full_neox": ("sd_full", False, True, False, 2),
    "1s1d_half_interleaved": ("1s1d_half", False, False, False, 2),
    "1s1d_full_interleaved_pid": ("1s1d_full", True, False, False, 2),
    "position_ids_neox": (None, True, True, False, 2),
    "neither_time_major_interleaved": (None, False, False, True, 2),
    "neither_q_only": (None, False, True, False, 1),
}


@pytest.mark.parametrize("name", list(FUNCTIONAL))
def test_functional_matches_jax(name):
    """Given or computed tables: the computed ones come from each
    package's own f32 pow, sin and cos, which differ by at most an ulp
    (see the next test), so the values hold to TOL either way."""
    tables, with_pid, neox, time_major, n = FUNCTIONAL[name]
    q, k = _qk(len(name))
    pid = np.random.default_rng(7).integers(0, S, (B, S)).astype(np.int32)
    c = s = None
    if tables is not None:
        c, s = _given_tables(tables, neox, len(name))
    if time_major:
        q, k = q.swapaxes(0, 1).copy(), k.swapaxes(0, 1).copy()
    ins = [q, k][:n]
    kw = dict(use_neox_rotary_style=neox, time_major=time_major)

    def call(fn, conv):
        args = [conv(a) for a in ins] + [None] * (2 - n)
        return fn(*args, None,
                  sin=None if s is None else conv(s),
                  cos=None if c is None else conv(c),
                  position_ids=conv(pid) if with_pid else None, **kw)

    want = call(jax_inc.fused_rotary_position_embedding, paddle.to_tensor)
    got = call(port_inc.fused_rotary_position_embedding, torch.from_numpy)
    assert len(got) == 3 and got[n:] == (None,) * (3 - n)
    tol = TOL
    for g, w in zip(got[:n], want[:n]):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), w.numpy(), **tol)


def test_functional_tables_are_f32_as_the_reference_makes_them():
    c, s = port_inc._rope_tables(2048, 128, 10000.0)
    assert c.dtype == s.dtype == torch.float32 and c.shape == (1, 2048, 64)
    jc, js = jax_inc._rope_tables(2048, 128, 10000.0, jnp.float32)
    # the same f32 angles (positions to 2047, f32 inverse frequencies), so
    # the tables differ by the sin/cos implementations only: an ulp of a
    # value near 1 (6e-8)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1.2e-7)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1.2e-7)
