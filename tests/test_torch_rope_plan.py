"""The fused-RoPE kernel's launch plan (paddle_tpu_torch.ops.fused_rope.
rope_plan) and its index arithmetic, on the CPU.

`rope_planned_plain` below runs the kernel's indexing with torch ops: for
every CTA and thread of the plan, the thread's token, its chunk of the
heads axis (walked head by head as the kernel walks it, crossing from q
into k and from k into v), the two vectors of each head it loads (the
neox halves, or two consecutive vectors of interleaved pairs), the table
row of its token and its V table entries. It must equal `rope_plain` bit
for bit, and match the JAX kernel (interpret mode) on one case per
pairing; a copy whose neox second half is read one vector late must not.
The plan must cover every (token, head, pair) exactly once at the paths'
shapes, and fill the card at the decode tick. The CUDA kernel itself is
held to `rope_plain` on the card (chip_smoke.py)."""

import os

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.ops.pallas import fused_rope as jax_rope
from paddle_tpu_torch.ops import fused_rope as fr


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


def _walk(plan, heads, c):
    """(tensor, head) of each head of chunk c, in the kernel's order: from
    the chunk's first head on, stepping into the next tensor where one
    ends."""
    H = sum(heads)
    g0 = c * plan.heads_per_thread
    n = min(plan.heads_per_thread, H - g0)
    starts = np.cumsum([0] + list(heads))
    t = int(np.searchsorted(starts, g0, side="right") - 1)
    h = g0 - starts[t]
    out = [(t, h)]
    for _ in range(n - 1):
        h += 1
        while t < len(heads) - 1 and h == heads[t]:
            t, h = t + 1, 0
        out.append((t, h))
    return out


def _threads(plan, B, S):
    """The token of each thread row of the plan (CTA x, thread z), those
    past the last token dropped, and each chunk (CTA y, thread y)."""
    gx, gy = plan.grid
    lanes, cy, tb = plan.block
    r = (np.arange(gx)[:, None] * tb + np.arange(tb)).ravel()
    c = (np.arange(gy)[:, None] * cy + np.arange(cy)).ravel()
    return r[r < B * S], c[c < plan.chunks]


def rope_planned_plain(tensors, cos, sin, interleaved=False, sin_sign=1.0,
                       vector=True, b_shift=0):
    """The kernel's arithmetic at the kernel's indices under `rope_plan`,
    with torch ops. Outputs start as NaN, so an element no thread writes
    shows; `b_shift` moves the neox second half's loads by that many
    elements (a planted fault)."""
    x0 = tensors[0]
    B, S, _, D = x0.shape
    heads = [t.shape[2] for t in tensors]
    plan = fr.rope_plan(B, S, heads, D, x0.element_size(), vector)
    V, half = plan.vector, D // 2
    lanes = plan.block[0]
    r, chunks = _threads(plan, B, S)
    r = torch.from_numpy(r)
    lane = torch.arange(lanes)
    lane_off = 2 * lane * V if interleaved else lane * V  # [lanes]
    off_b = V if interleaved else half
    trow = r if cos.shape[0] > 1 else r % S
    tab = (trow[:, None] * half + lane * V)[..., None] + torch.arange(V)
    c = cos.float().reshape(-1)[tab]  # [tokens, lanes, V]
    s = sin.float().reshape(-1)[tab] * sin_sign
    # flat inputs with a spare vector, so a shifted load stays in bounds
    flat = [torch.cat([t.reshape(-1), t.new_zeros(V)]) for t in tensors]
    outs = [torch.full((t.numel(),), float("nan"), dtype=t.dtype)
            for t in tensors]
    writes = [torch.zeros(t.numel(), dtype=torch.int32) for t in tensors]
    i = torch.arange(V)
    ia, ib = (2 * i, 2 * i + 1) if interleaved else (i, V + i)
    for ch in chunks:
        for t, h in _walk(plan, heads, int(ch)):
            base = ((r * heads[t] + h) * D)[:, None] + lane_off  # [tokens, lanes]
            ea = base[..., None] + i
            eb = ea + off_b + (0 if interleaved else b_shift)
            e = torch.cat([flat[t][ea], flat[t][eb]], -1).float()  # [.., 2V]
            xa, xb = e[..., ia], e[..., ib]
            o = torch.empty_like(e)
            o[..., ia] = xa * c - xb * s
            o[..., ib] = xb * c + xa * s
            where = torch.cat([ea, ea + off_b], -1)
            outs[t][where.reshape(-1)] = o.reshape(-1).to(outs[t].dtype)
            writes[t][where.reshape(-1)] += 1
    return (tuple(o.reshape(x.shape) for o, x in zip(outs, tensors)),
            [w for w in writes])


def _inputs(B, S, heads, D, Bt, dtype, seed=0):
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(2 * rng.standard_normal((B, S, h, D))
                           .astype(np.float32)).to(dtype) for h in heads]
    ang = rng.uniform(0, 2048, (Bt, S, D // 2)).astype(np.float32)
    return xs, torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang))


# name: (B, S, heads, D, table rows, interleaved, dtype, vector)
CASES = {
    "qk_neox_bf16_per_row": (2, 9, (8, 2), 64, 2, False, torch.bfloat16, True),
    "qk_interleaved_f16_shared": (2, 9, (8, 2), 64, 1, True, torch.float16, True),
    "s37_qkv_interleaved_f32": (3, 37, (8, 2, 2), 64, 1, True, torch.float32, True),
    "s37_qkv_neox_bf16_per_row": (3, 37, (8, 2, 2), 64, 3, False, torch.bfloat16, True),
    "d36_scalar_neox_bf16": (2, 5, (4, 2), 36, 2, False, torch.bfloat16, True),
    "d36_scalar_interleaved_f32": (2, 5, (4, 2), 36, 1, True, torch.float32, True),
    "unaligned_scalar_neox_f16": (2, 7, (6, 2), 128, 2, False, torch.float16, False),
    "decode_tick_bf16": (16, 1, (32, 32), 128, 16, False, torch.bfloat16, True),
    "q_only_f32": (1, 11, (5,), 16, 1, False, torch.float32, True),
}


@pytest.fixture(params=["few_tokens", "many_tokens"])
def regime(request, monkeypatch):
    """The plan of each case as it comes, and with every case taken as
    many tokens (the training plan: several heads a thread, chunks that
    cross from q into k)."""
    if request.param == "many_tokens":
        monkeypatch.setattr(fr, "STREAM_THREADS", 0)
    return request.param


@pytest.mark.parametrize("name", list(CASES))
def test_planned_emulation_equals_rope_plain(name, regime):
    B, S, heads, D, Bt, il, dtype, vector = CASES[name]
    xs, c, s = _inputs(B, S, heads, D, Bt, dtype, seed=len(name))
    plan = fr.rope_plan(B, S, heads, D, xs[0].element_size(), vector)
    want_v = 16 // xs[0].element_size() if vector and (D // 2) % (
        16 // xs[0].element_size()) == 0 else 1
    assert plan.vector == want_v
    for sign in (1.0, -1.0):
        got, writes = rope_planned_plain(xs, c, s, il, sign, vector)
        want = fr.rope_plain(xs, c, s, il, sign)
        for g, w, n in zip(got, want, writes):
            assert torch.equal(n, torch.ones_like(n)), "an element written " \
                "other than once"
            assert torch.equal(g.view(torch.int16 if g.element_size() == 2
                                      else torch.int32),
                               w.view(torch.int16 if w.element_size() == 2
                                      else torch.int32)), name


def test_second_half_read_one_vector_late_fails():
    """The control: the emulation with the neox second half's loads one
    vector late differs from rope_plain (so the comparison above sees
    such a fault)."""
    xs, c, s = _inputs(2, 9, (8, 2), 64, 2, torch.bfloat16)
    got, _ = rope_planned_plain(xs, c, s, False, 1.0, True, b_shift=8)
    want = fr.rope_plain(xs, c, s, False)
    assert not all(torch.equal(g, w) for g, w in zip(got, want))


def _axis_cover(plan, B, S, heads, D, interleaved):
    """Counts of the plan's writes on each axis: tokens, heads of the
    concatenated axis, and (element, table entry) pairs of a head. The
    kernel's index is the product of the three, so each count all ones
    means every (token, head, pair) is covered exactly once."""
    r, chunks = _threads(plan, B, S)
    tok = np.bincount(r, minlength=B * S)
    head = np.zeros(sum(heads), int)
    starts = np.cumsum([0] + list(heads))
    for ch in chunks:
        for t, h in _walk(plan, heads, int(ch)):
            head[starts[t] + h] += 1
    V, half = plan.vector, D // 2
    elem = np.zeros(D, int)
    pair_of = {}
    for lane in range(plan.block[0]):
        lo = 2 * lane * V if interleaved else lane * V
        for i in range(V):
            j = lane * V + i  # table entry
            a, b = ((lo + 2 * i, lo + 2 * i + 1) if interleaved
                    else (lo + i, lo + half + i))
            elem[a] += 1
            elem[b] += 1
            pair_of[j] = (a, b)
    want_pairs = {j: ((2 * j, 2 * j + 1) if interleaved else (j, j + half))
                  for j in range(half)}
    return tok, head, elem, pair_of == want_pairs


# (B, S, heads, D, itemsize, vector): the paths' shapes and ragged ones
SHAPES = [
    (4, 2048, (32, 8), 128, 2, True),    # llama_7bshape training, bf16
    (4, 2048, (32, 8), 128, 4, True),    # the same in f32
    (4, 2048, (32, 8), 128, 2, False),   # off the 16-byte line: scalar
    (16, 1, (32, 32), 128, 2, True),     # llama_7b decode tick
    (1, 192, (32, 32), 128, 2, True),    # llama_7b prefill
    (3, 37, (8, 2, 2), 64, 4, True),
    (3, 37, (8, 2, 2), 64, 2, True),
    (2, 512, (16, 4), 36, 2, True),      # D 36: scalar
    (1, 3, (1,), 2048, 4, True),
    (1, 3, (1,), 2048, 2, False),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:2]))
                         + f"_h{'+'.join(map(str, s[2]))}_d{s[3]}_i{s[4]}"
                         + ("" if s[5] else "_unaligned"))
@pytest.mark.parametrize("interleaved", [False, True])
def test_plan_covers_every_pair_once(shape, interleaved):
    B, S, heads, D, itemsize, vector = shape
    plan = fr.rope_plan(B, S, heads, D, itemsize, vector)
    lanes, cy, tb = plan.block
    assert lanes * plan.vector == D // 2
    assert lanes * cy * tb <= (1024 if plan.vector == 1 else fr.BLOCK)
    assert tb <= fr.MAX_TOKENS_A_CTA
    assert plan.chunks == -(-sum(heads) // plan.heads_per_thread)
    tok, head, elem, pairs = _axis_cover(plan, B, S, heads, D, interleaved)
    assert (tok == 1).all() and (head == 1).all() and (elem == 1).all()
    assert pairs


def test_training_plan_walks_heads_and_crosses_from_q_into_k():
    plan = fr.rope_plan(4, 2048, (32, 8), 128, 2, True)
    assert plan.vector == 8 and plan.heads_per_thread == 5
    assert plan.block == (8, 8, 4) and plan.grid == (2048, 1)
    crossing = [ch for ch in range(plan.chunks)
                if {t for t, _ in _walk(plan, (32, 8), ch)} == {0, 1}]
    assert crossing == [6]
    assert _walk(plan, (32, 8), 6) == [(0, 30), (0, 31), (1, 0), (1, 1), (1, 2)]


def test_many_token_plan_of_three_tensors_crosses_both_boundaries(monkeypatch):
    monkeypatch.setattr(fr, "STREAM_THREADS", 0)
    plan = fr.rope_plan(3, 37, (8, 2, 2), 64, 2, True)
    assert plan.heads_per_thread == 3 and plan.chunks == 4
    assert _walk(plan, (8, 2, 2), 2) == [(0, 6), (0, 7), (1, 0)]
    assert _walk(plan, (8, 2, 2), 3) == [(1, 1), (2, 0), (2, 1)]


@pytest.mark.parametrize("shape", [(16, 1, (32, 32), 128, 2), (16, 1, (32, 8), 128, 2),
                                   (4, 1, (32, 32), 128, 4), (1, 1, (8, 8), 64, 2),
                                   (1, 192, (32, 32), 128, 2)])
def test_decode_plan_fills_the_card(shape):
    """The docstring's promise: one head a thread and at least
    min(FILL_CTAS, ceil(B S H lanes / max(MIN_BLOCK, lanes))) CTAs."""
    B, S, heads, D, itemsize = shape
    plan = fr.rope_plan(B, S, heads, D, itemsize, True)
    lanes = plan.block[0]
    ctas = plan.grid[0] * plan.grid[1]
    promise = min(fr.FILL_CTAS, -(-B * S * sum(heads) * lanes
                                  // max(fr.MIN_BLOCK, lanes)))
    assert plan.heads_per_thread == 1 and ctas >= promise
    if shape == (16, 1, (32, 32), 128, 2):  # the llama_7b tick
        assert ctas == 128 and plan.block == (8, 8, 1)


# --------------------------------------------------------------------------- #
# against the JAX kernel, one case per pairing
# --------------------------------------------------------------------------- #

JAX_CASES = ("s37_qkv_neox_bf16_per_row", "s37_qkv_interleaved_f32")


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX kernel's outputs (interpret mode) on the f32 values of the
    JAX cases, traced into one jit."""
    args = {}
    for name in JAX_CASES:
        B, S, heads, D, Bt, il, _, _ = CASES[name]
        xs, c, s = _inputs(B, S, heads, D, Bt, torch.float32, seed=len(name))
        args[name] = ([x.numpy() for x in xs], c.numpy(), s.numpy())

    def run(args):
        return {n: jax_rope.apply_fused_rope(tuple(xs), c, s,
                                             interleaved=CASES[n][5])
                for n, (xs, c, s) in args.items()}

    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        outs = jax.jit(run)(args)
    return {n: [np.asarray(o) for o in v] for n, v in outs.items()}


@pytest.mark.parametrize("name", JAX_CASES)
def test_planned_emulation_matches_jax(name, jax_outputs, monkeypatch):
    """f32 on both sides, the same tables: within test_torch_rope.py's
    tolerance (1e-6), under the training plan (chunks crossing tensors)."""
    monkeypatch.setattr(fr, "STREAM_THREADS", 0)
    B, S, heads, D, Bt, il, _, vector = CASES[name]
    xs, c, s = _inputs(B, S, heads, D, Bt, torch.float32, seed=len(name))
    got, _ = rope_planned_plain(xs, c, s, il, 1.0, vector)
    for g, w in zip(got, jax_outputs[name]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
