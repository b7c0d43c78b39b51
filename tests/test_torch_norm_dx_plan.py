"""The norm dx kernel's launch plan (paddle_tpu_torch.ops.fused_norm.dx_plan)
and its thread-to-column map, on the CPU.

`dx_planned_plain` below runs the kernel's arithmetic in the kernel's
order with torch ops: each thread's partial sums of g and g * x_hat over
its columns as the plan lays them out (16-byte accesses j of V elements
from column (t + j gsize) V on the rows and scalar routes; every
gsize-th column on the wide route), then the shuffles within each warp
and the sum over the group's warps, and dx written only where the plan's
walk reaches. It must match `norm_bwd_dx_plain` within the CPU tolerance
of tests/test_torch_norm_backward.py, and the JAX kernel (interpret mode)
on one LayerNorm and one RMSNorm case; a copy that skips each row's last
vector must not. The plan must cover every (row, column) exactly once
for any grid the card sizes. The CUDA kernel itself is held to
`norm_bwd_dx_plain` on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_norm as jax_norm
from paddle_tpu_torch.ops import fused_norm as fn


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


# tests/test_torch_norm_backward.py's dx tolerance: f32 sums in another
# order; bf16 rounds once from f32, so two ulps at the outputs' scale
TOL = {"float32": dict(rtol=1e-5, atol=2e-5),
       "bfloat16": dict(rtol=1.6e-2, atol=3.2e-2)}


def _thread_cols(plan, n, itemsize):
    """[gsize, elems] column of each thread's elements in the order the
    kernel sums them; columns at or past n hold zeros there."""
    t = np.arange(plan.gsize)[:, None]
    if plan.route == "wide":
        return t + np.arange(plan.elems)[None, :] * plan.gsize
    V = 16 // itemsize
    j, e = np.divmod(np.arange(plan.elems), V)
    return (t + j[None, :] * plan.gsize) * V + e[None, :]


def _walk(plan, rows, n, itemsize, grid):
    """How many times the kernel writes each (row, column) under `grid`
    CTAs: CTA b's group g takes rows b * per_cta + g + k * grid * per_cta,
    each thread its columns below n."""
    per_cta = plan.rows_per_cta
    counts = np.zeros(rows, np.int64)
    for b in range(grid):
        for g in range(per_cta):
            counts[b * per_cta + g::grid * per_cta] += 1
    cols = _thread_cols(plan, n, itemsize).ravel()
    col_counts = np.bincount(cols[cols < n], minlength=n)
    return counts[:, None] * col_counts[None, :]


def _tree(v):
    """The kernel's sum over a group's threads: v [..., gsize] summed by
    xor shuffles within each warp (offsets 16 to 1), then lane 0 of each
    warp added in warp order."""
    w = v.reshape(*v.shape[:-1], -1, 32)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[..., lane ^ o]
    w = w[..., 0]
    if w.shape[-1] == 1:
        return w[..., 0]
    total = torch.zeros(w.shape[:-1])
    for k in range(w.shape[-1]):
        total = total + w[..., k]
    return total


def dx_planned_plain(x2, weight, dy2, rstd, mean, kind, aligned=True,
                     skip_last=False):
    """The dx kernel at the kernel's indices under `dx_plan`, with torch
    ops. The output starts as NaN, so an element no thread writes shows;
    `skip_last` leaves each row's last vector unread and unwritten (a
    planted fault)."""
    R, n = x2.shape
    itemsize = x2.element_size()
    plan = fn.dx_plan(R, n, itemsize, aligned)
    x = x2.float()
    g = dy2.float()
    if weight is not None:
        g = g * weight.float()
    m = mean[:, None] if kind == "ln" else torch.zeros(R, 1)
    r = rstd[:, None]
    xh = (x - m) * r
    keep = torch.ones(n, dtype=torch.bool)
    if skip_last:
        V = 16 // itemsize
        keep[(n - 1) // V * V:] = False
    cols = torch.from_numpy(_thread_cols(plan, n, itemsize))
    width = int(cols.max()) + 1

    def per_thread(v):  # [R, gsize, elems], zeros past n and where skipped
        pad = torch.zeros(R, max(width, n))
        pad[:, :n] = torch.where(keep, v, torch.zeros(()))
        return pad[:, cols]

    gt, xt = per_thread(g), per_thread(xh)
    s1 = torch.zeros(R, plan.gsize)
    s2 = torch.zeros(R, plan.gsize)
    for k in range(plan.elems):
        s1 = s1 + gt[..., k]
        s2 = s2 + gt[..., k] * xt[..., k]
    inv_n = torch.tensor(1.0) / n
    c1 = _tree(s1)[:, None] * inv_n if kind == "ln" else 0.0
    c2 = _tree(s2)[:, None] * inv_n
    dx = r * (g - c1 - xh * c2)
    grid = -(-R // plan.rows_per_cta)
    written = torch.from_numpy(_walk(plan, R, n, itemsize, grid) > 0) & keep
    out = torch.full((R, n), float("nan"))
    out[written] = dx[written]
    return out.to(x2.dtype)


def _case(R, n, kind, dtype, seed, offset=0.5):
    rng = np.random.default_rng(seed)
    td = getattr(torch, dtype)
    x = torch.from_numpy((rng.standard_normal((R, n)) + offset)
                         .astype(np.float32)).to(td)
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(n))
                         .astype(np.float32)).to(td)
    dy = torch.from_numpy(rng.standard_normal((R, n)).astype(np.float32)).to(td)
    _, rstd, mean = fn.norm_fwd_plain(x, w, None, kind, 1e-5)
    return x, w, dy, rstd, mean


@pytest.mark.parametrize("rows,n,itemsize,gsize,per_cta", [
    (8192, 2048, 4, 128, 2),   # gpt3_1p3b's LayerNorm
    (8192, 4096, 4, 256, 1),   # llama_7bshape's RMSNorm
    (8192, 1024, 4, 64, 4),    # gpt3_moe's LayerNorm
    (8192, 2048, 2, 128, 2),   # bf16, off the paths
])
def test_plan_at_the_steps_shapes_takes_whole_warps(rows, n, itemsize, gsize,
                                                    per_cta):
    plan = fn.dx_plan(rows, n, itemsize, True)
    assert plan == fn.DxPlan("rows", gsize, 16, per_cta)
    assert plan.gsize % 32 == 0 and plan.gsize * plan.elems == n
    assert plan.gsize * plan.rows_per_cta <= fn.ROW_CTA


@pytest.mark.parametrize("rows,n,itemsize,aligned,route", [
    (37, 1031, 4, True, "scalar"),     # N % 4
    (37, 1031, 2, True, "scalar"),     # N % 8
    (512, 2052, 2, True, "scalar"),    # N % 8, N % 4 == 0
    (8192, 2048, 4, False, "scalar"),  # a view off the 16-byte line
    (16, 8192, 4, True, "rows"),       # the register design's widest row
    (64, 8193, 2, True, "wide"),
    (64, 12288, 4, True, "wide"),
    (64, 12288, 4, False, "wide"),
])
def test_plan_routes(rows, n, itemsize, aligned, route):
    plan = fn.dx_plan(rows, n, itemsize, aligned)
    assert plan.route == route
    if route == "wide":
        assert plan.rows_per_cta == 1 and plan.gsize == 1024
        assert plan.gsize * plan.elems >= n
    else:
        assert plan.gsize <= fn.ROW_MAX_THREADS and plan.elems == 16
    # fewer rows than SMs: one row a CTA, the rows spread over the card
    assert fn.dx_plan(fn.SMS, n, itemsize, aligned).rows_per_cta == 1


@pytest.mark.parametrize("rows,n,itemsize,aligned", [
    (8192, 2048, 4, True), (8192, 4096, 4, True), (8191, 1024, 4, True),
    (8190, 2048, 2, True), (37, 1031, 4, True), (1001, 2050, 2, True),
    (999, 200, 4, False), (64, 12288, 4, True), (5, 9001, 2, True),
])
@pytest.mark.parametrize("grid", [1, 7, 264, None])
def test_plan_covers_every_element_once(rows, n, itemsize, aligned, grid):
    plan = fn.dx_plan(rows, n, itemsize, aligned)
    full = -(-rows // plan.rows_per_cta)
    counts = _walk(plan, rows, n, itemsize, min(grid or full, full))
    assert counts.min() == 1 and counts.max() == 1


SHAPES = [(37, 1031), (24, 2048), (9, 96), (3, 8192), (3, 9000)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("R,n", SHAPES)
def test_planned_plain_matches_plain(R, n, kind, dtype):
    x, w, dy, rstd, mean = _case(R, n, kind, dtype, seed=n)
    got = dx_planned_plain(x, w, dy, rstd, mean, kind)
    want = fn.norm_bwd_dx_plain(x, w, dy, rstd, mean, kind)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **TOL[dtype])


def test_planned_plain_off_the_line_and_at_a_large_mean():
    """The scalar route (aligned=False) walks the same columns; at a mean
    of 1000 x - mean stays exact in f32, so both still agree."""
    for aligned, offset in ((False, 0.5), (True, 1000.0)):
        x, w, dy, rstd, mean = _case(16, 1024, "ln", "float32", seed=3,
                                     offset=offset)
        got = dx_planned_plain(x, w, dy, rstd, mean, "ln", aligned=aligned)
        want = fn.norm_bwd_dx_plain(x, w, dy, rstd, mean, "ln")
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL["float32"])


@pytest.mark.parametrize("kind,R,n", [("ln", 37, 1031), ("rms", 16, 256)])
def test_planned_plain_matches_the_jax_kernel(kind, R, n):
    x, w, dy, rstd, mean = _case(R, n, kind, "float32", seed=7)
    br = 8
    nl = jax_norm._pad_lanes(n)
    rp = -(-R // br) * br

    def col(v):
        return jnp.asarray(np.pad(v.numpy(), (0, rp - R))[:, None])

    xp = jax_norm._pad2(jnp.asarray(x.numpy()), br, nl)
    dyp = jax_norm._pad2(jnp.asarray(dy.numpy()), br, nl)
    ref = jax_norm._norm_bwd_dx(xp, jnp.asarray(w.numpy()), dyp, col(rstd),
                                None if mean is None else col(mean), kind, n,
                                br)
    got = dx_planned_plain(x, w, dy, rstd, mean, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:R, :n],
                               **TOL["float32"])


@pytest.mark.parametrize("R,n", [(37, 1031), (24, 2048)])
def test_skipping_each_rows_last_vector_fails(R, n):
    x, w, dy, rstd, mean = _case(R, n, "ln", "float32", seed=5)
    want = fn.norm_bwd_dx_plain(x, w, dy, rstd, mean, "ln")
    bad = dx_planned_plain(x, w, dy, rstd, mean, "ln", skip_last=True)
    assert torch.isnan(bad).any()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad.numpy(), want.numpy(), **TOL["float32"])
