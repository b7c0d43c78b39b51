"""What the port's bf16 varlen backward (csrc/flash_bwd_sm90.cuh's dQ and
dK/dV under csrc/varlen_flash.cu's `Varlen` policy) reads from Python, on
the CPU, over tests/test_torch_varlen.py's cases:

- the q steps of a dK/dV CTA: a CTA owns 128 keys of a kv head, 64 a
  warpgroup, and walks the 64-row q steps from `first_q_tile` of its keys
  to `q_tiles(k0, 128)`, the largest `krange` end of its two 64-key
  halves, skipping the steps whose 128 x 128 class is SKIP; those steps
  cover every kept pair. The first half's range alone does not: a
  document that starts in the second half is seen by rows past it.
- a plain emulation of the class-driven backward (dQ over each 128-row q
  tile's kv tiles that are not skipped, dK/dV over the CTAs' q steps for
  the g query heads of a kv head, the keep test on partial tiles only)
  reproduces the JAX package's Pallas varlen backward (interpret mode) in
  f32: dq, dk and dv.
- the wrappers' contract: dK and dV of the kv heads, f32 [Tk, Hkv, D],
  the g query heads' gradients summed; tile classes of the wrong shape or
  dtype raise.

The kernels themselves run only on the card (chip_smoke.py)."""

import functools
import math
import os

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.ops.pallas import masked_flash as jax_mf
from paddle_tpu_torch.ops import masked_flash as port_mf

from test_torch_varlen import CASES, GRAD_TOL, _case


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


STEP = 64  # a dK/dV q step and the layout's tiles (csrc/flash_bwd_sm90.cuh kStep)
TILE = port_mf.SM90_TILE


def _pack(name):
    """(q, k, v, dO as f32 tensors, layout, classes, causal, scale)."""
    q, k, v, do, cq, ck, causal = _case(name)
    Tq, Tk = q.shape[0], k.shape[0]
    layout = port_mf.varlen_layout(torch.from_numpy(cq), torch.from_numpy(ck),
                                   Tq, Tk, causal)
    cls = port_mf.varlen_tile_classes(layout, Tq, Tk, causal)
    return (*(torch.from_numpy(a) for a in (q, k, v, do)), layout, cls,
            causal, 1.0 / np.sqrt(q.shape[-1]))


# Varlen's tile ranges as the kernels read them (csrc/varlen_flash.cu)

def _first_q_tile(layout, k0):
    return int(layout.krange[0, k0 // STEP]) // STEP


def _q_tiles(layout, k0, bn=STEP):
    """The end of the 64-row q steps that see a key of [k0, k0 + bn): the
    largest `krange` end of its 64-key tiles (bn = 64: `q_tiles(p, k0)`)."""
    n_kt = layout.krange.shape[1]
    end = max(int(layout.krange[1, t])
              for t in range(k0 // STEP, min((k0 + bn) // STEP, n_kt)))
    return -(-end // STEP)


def _dkv_steps(layout, cls, Tk, bn_range):
    """{(64-key tile, 64-row q step)} that the dK/dV kernel computes, with
    each CTA's steps ending at `_q_tiles(layout, k0, bn_range)`."""
    steps = set()
    for k0 in range(0, Tk, TILE):
        t0, n_q = _first_q_tile(layout, k0), _q_tiles(layout, k0, bn_range)
        for key0 in range(k0, min(k0 + TILE, Tk), STEP):
            t_wg = _first_q_tile(layout, key0)
            for t in range(max(t0, t_wg), n_q):
                if cls[t * STEP // TILE, k0 // TILE] != port_mf.SKIP_TILE:
                    steps.add((key0 // STEP, t))
    return steps


def _missed(keep, steps):
    rows, cols = np.nonzero(keep)
    return sum((c // STEP, r // STEP) not in steps
               for r, c in zip(rows.tolist(), cols.tolist()))


def test_dkv_steps_cover_every_kept_pair():
    """For every case, the steps of each 128-key CTA up to
    `q_tiles(k0, 128)` that are not skipped cover every pair `varlen_keep`
    keeps. The control: with each CTA's steps ending at its first 64 keys'
    range (`q_tiles(k0)`), causal_many_tiles_gqa misses pairs (its key tile
    0's first half ends at row 100, its second half is seen by rows
    100-136), so the test sees that trap."""
    misses_of_first_half = {}
    for name in CASES:
        q, k, _, _, layout, cls, causal, _ = _pack(name)
        Tq, Tk = q.shape[0], k.shape[0]
        keep = port_mf.varlen_keep(layout, Tq, causal).numpy()
        cls = cls.numpy()
        assert _missed(keep, _dkv_steps(layout, cls, Tk, TILE)) == 0, name
        misses_of_first_half[name] = _missed(keep,
                                             _dkv_steps(layout, cls, Tk, STEP))
    assert misses_of_first_half["causal_many_tiles_gqa"] > 0, misses_of_first_half


def _dq_emulated(q, k, v, do, lse, delta, layout, cls, causal, scale):
    """The dQ kernel's class-driven loop in f32: per 128-row q tile, the kv
    tiles [0, kv_tiles) that are not skipped, the keep test on partial
    tiles only. [Tq, H, D]."""
    Tq, H, _ = q.shape
    Tk, g = k.shape[0], H // k.shape[1]
    keep = port_mf.varlen_keep(layout, Tq, causal)
    qr = layout.qrange
    kh, vh = (t.repeat_interleave(g, 1).transpose(0, 1) for t in (k, v))
    dq = torch.zeros_like(q)
    for qt in range(cls.shape[0]):
        r0, r1 = qt * TILE, min((qt + 1) * TILE, Tq)
        end = int(qr[1, 2 * qt:2 * qt + 2].max())
        qs, dos = q[r0:r1].transpose(0, 1), do[r0:r1].transpose(0, 1)
        acc = torch.zeros_like(qs)
        for kt in range(-(-end // TILE)):
            c = int(cls[qt, kt])
            if c == port_mf.SKIP_TILE:
                continue
            c0, c1 = kt * TILE, min((kt + 1) * TILE, Tk)
            p = torch.exp(qs @ kh[:, c0:c1].transpose(1, 2) * scale
                          - lse[:, r0:r1, None])
            if c == port_mf.PARTIAL_TILE:
                p = torch.where(keep[r0:r1, c0:c1], p, 0.0)
            dp = dos @ vh[:, c0:c1].transpose(1, 2)
            acc += p * (dp - delta[:, r0:r1, None]) * scale @ kh[:, c0:c1]
        dq[r0:r1] = acc.transpose(0, 1)
    return dq


def _dkv_emulated(q, k, v, do, lse, delta, layout, cls, causal, scale):
    """The dK/dV kernel's loop in f32: per 128-key CTA and kv head, each
    warpgroup's 64 keys over the g query heads and the CTA's 64-row q steps
    (from the later of the CTA's and the warpgroup's first step to
    `q_tiles(k0, 128)`, SKIP classes left out), the keep test on partial
    tiles only; the query heads summed. ([Tk, Hkv, D],) * 2."""
    Tq, H, _ = q.shape
    Tk, Hkv = k.shape[0], k.shape[1]
    g = H // Hkv
    keep = port_mf.varlen_keep(layout, Tq, causal)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, Tk, TILE):
        t0, n_q = _first_q_tile(layout, k0), _q_tiles(layout, k0, TILE)
        for key0 in range(k0, min(k0 + TILE, Tk), STEP):
            keys = slice(key0, min(key0 + STEP, Tk))
            t_wg = _first_q_tile(layout, key0)
            for j in range(Hkv):
                heads = slice(j * g, (j + 1) * g)
                for t in range(max(t0, t_wg), n_q):
                    c = int(cls[t * STEP // TILE, k0 // TILE])
                    if c == port_mf.SKIP_TILE:
                        continue
                    rows = slice(t * STEP, min((t + 1) * STEP, Tq))
                    qs = q[rows, heads].transpose(0, 1)  # [g, rows, D]
                    dos = do[rows, heads].transpose(0, 1)
                    pt = torch.exp(k[keys, j] @ qs.transpose(1, 2) * scale
                                   - lse[heads, None, rows])  # [g, keys, rows]
                    if c == port_mf.PARTIAL_TILE:
                        pt = torch.where(keep[rows, keys].T, pt, 0.0)
                    dpt = v[keys, j] @ dos.transpose(1, 2)
                    dst = pt * (dpt - delta[heads, None, rows]) * scale
                    dv[keys, j] += (pt @ dos).sum(0)
                    dk[keys, j] += (dst @ qs).sum(0)
    return dk, dv


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX package's varlen VJP (Pallas, interpret mode) of every case,
    each in a jit of its own, copied out into numpy arrays: dq, dk, dv."""

    def vjp(q, k, v, do, cq, ck, causal):
        _, pull = jax.vjp(lambda a, b, c: jax_mf.varlen_flash_attention_fwd(
            a, b, c, cq, ck, 1.0 / np.sqrt(q.shape[-1]), causal=causal),
            q, k, v)
        return pull(do)

    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        for name in CASES:
            *args, causal = _case(name)
            refs[name] = tuple(np.array(a, copy=True) for a in jax.jit(
                functools.partial(vjp, causal=causal))(*args))
    return refs


@pytest.mark.parametrize("name", list(CASES))
def test_class_driven_backward_matches_jax(name, jax_grads):
    """Skipping SKIP tiles and steps, dropping the keep test on FULL ones
    and ending a CTA's steps at `q_tiles(k0, 128)` change nothing: the
    emulated dQ and dK/dV loops give the JAX kernels' dq, dk and dv in f32,
    to GRAD_TOL of each tensor's largest entry."""
    q, k, v, do, layout, cls, causal, scale = _pack(name)
    out, lse = port_mf.varlen_fwd_plain(q, k, v, layout, causal, scale)
    delta = (do * out).sum(-1).transpose(0, 1)
    got = (_dq_emulated(q, k, v, do, lse, delta, layout, cls, causal, scale),
           *_dkv_emulated(q, k, v, do, lse, delta, layout, cls, causal,
                          scale))
    for g, w, what in zip(got, jax_grads[name], ("dq", "dk", "dv")):
        assert torch.isfinite(g).all(), what
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=what)


def _per_head_grads(q, k, v, do, layout, causal, scale):
    """dK, dV of each query head, [Tk, H, D] f32, by autograd through dense
    attention over the keep-mask with k and v expanded to the query
    heads."""
    g = q.shape[1] // k.shape[1]
    ke, ve = (t.repeat_interleave(g, 1).requires_grad_() for t in (k, v))
    keep = port_mf.varlen_keep(layout, q.shape[0], causal)
    s = torch.einsum("qhd,khd->hqk", q, ke) * scale
    p = torch.softmax(s.masked_fill(~keep, -math.inf), -1)
    torch.einsum("hqk,khd->qhd", p, ve).backward(do)
    return ke.grad, ve.grad


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "wrapper"])
def test_dkv_of_the_kv_heads(plain):
    """varlen_bwd_dkv and its plain version give the kv heads' dK and dV,
    f32 [Tk, Hkv, D]: the sum of the g query heads' gradients."""
    q, k, v, do, layout, cls, causal, scale = _pack("causal_gqa_unaligned")
    out, lse = port_mf.varlen_fwd_plain(q, k, v, layout, causal, scale)
    delta = (do * out).sum(-1).transpose(0, 1).contiguous()
    fn = port_mf.varlen_bwd_dkv_plain if plain else port_mf.varlen_bwd_dkv
    dk, dv = fn(q, k, v, layout, do, lse, delta, causal, scale)
    Tk, Hkv, D = k.shape
    for got, per_head in zip((dk, dv), _per_head_grads(q, k, v, do, layout,
                                                       causal, scale)):
        assert got.dtype == torch.float32 and tuple(got.shape) == (Tk, Hkv, D)
        want = per_head.reshape(Tk, Hkv, -1, D).sum(2)
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_wrong_tile_classes_raise(bad):
    """Both backward wrappers reject classes that are not uint8
    [ceil(Tq / 128), ceil(Tk / 128)]."""
    q, k, v, do, layout, cls, causal, scale = _pack("causal_many_tiles_gqa")
    out, lse = port_mf.varlen_fwd_plain(q, k, v, layout, causal, scale)
    delta = (do * out).sum(-1).transpose(0, 1).contiguous()
    wrong = cls[:, :-1] if bad == "shape" else cls.int()
    for fn in (port_mf.varlen_bwd_dq, port_mf.varlen_bwd_dkv):
        with pytest.raises(ValueError, match="varlen tile classes"):
            fn(q, k, v, layout, do, lse, delta, causal, scale, wrong)
    dq = port_mf.varlen_bwd_dq(q, k, v, layout, do, lse, delta, causal, scale,
                               cls)
    torch.testing.assert_close(dq, port_mf.varlen_bwd_dq_plain(
        q, k, v, layout, do, lse, delta, causal, scale), rtol=0, atol=0)
