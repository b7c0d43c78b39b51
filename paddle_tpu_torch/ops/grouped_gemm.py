"""Grouped (ragged) GEMM for the MoE experts (↔
paddle_tpu/ops/pallas/grouped_gemm.py).

`grouped_matmul(lhs, rhs, group_sizes)` computes out[r] = lhs[r] @
rhs[r // R] over the uniform-stride layout of the MoE dispatch: lhs
[E * R, K] with group e owning rows [e R, (e + 1) R) of which the first
group_sizes[e] are live, rhs [E, K, N] the stacked expert weights, f32
accumulation, the output in lhs's dtype. It is differentiable through
`GroupedMatmul` (the JAX package's custom VJP, `_gmm_bwd` :182).

Semantics depend on the row tile, `BM` = 64 rows here (the TPU kernel's
`bm` is autotuned over divisors of R): a tile whose first row is at or past
its group's live count is dead and comes back zero; every row of a tile
that holds a live row is computed, the rows past the live count included.
Unlike the TPU kernel, BM need not divide R: a group's last tile ends at
the group's own end. Callers that scatter zeros into the dead rows (the MoE
layer does) get the dense batched product's values on every live row.

One kernel entry, `csrc/grouped_gemm.cu`, beside its plain version and
its launch counter:

- `grouped_gemm(lhs, rhs, sizes, trans_rhs)` → out: the kernel on CUDA
  tensors, `grouped_matmul_plain` on CPU tensors; `LAUNCHES`. With
  `trans_rhs` it reads rhs [E, N, K] transposed through a flag, which is
  how the backward's dlhs runs against the weights without copying them.
  bf16 and f16 run the Hopper kernel of `csrc/grouped_gemm_sm90.cuh` (wgmma fed
  by TMA, 128 x 128 tiles of two 64-row units, a persistent schedule);
  f32 the CUDA-core kernel of `csrc/grouped_gemm.cu`.

The kernels read `sizes` from device memory (the TPU kernel's scalar
prefetch), so nothing on the path syncs with the host. The 16-bit kernel
reads its operands through TMA tensor maps, which take 16-byte aligned
rows of a multiple of 16 bytes: `tma_operands` passes such operands as
they are (every shape of the MoE path) and pads any other with zero
columns, which add nothing to a product.
"""

from __future__ import annotations

import torch

from . import _build
from ..framework.core import report_op
from .flash_attention import HALF

__all__ = ["BM", "GroupedMatmul", "LAUNCHES", "computed_rows",
           "grouped_gemm", "grouped_matmul", "grouped_matmul_plain",
           "row_stride", "tma_operands"]

BM = 64  # the kernel's row tile: the unit of "computed rows"

# kernel launches since import (or since a caller reset them)
LAUNCHES = 0


def _pad_to(n, m):
    return -(-n // m) * m


def row_stride(max_rows: int) -> int:
    """The uniform per-group row stride for `max_rows` live rows a group
    (a copy of the JAX package's `row_stride` :68): 16 k for up to 64
    rows, else a multiple of 128."""
    q = 16 if max_rows <= 64 else 128
    return _pad_to(max(max_rows, 1), q)


def computed_rows(sizes, R, bm=BM):
    """[E] int: the rows of each group that a tiled kernel computes,
    min(ceil(sizes / bm) * bm, R)."""
    return torch.clamp((sizes.long() + bm - 1) // bm * bm, max=R)


def _computed_mask(sizes, E, R, bm, device):
    rows = torch.arange(R, device=device)
    return rows[None, :] < computed_rows(sizes.to(device), R, bm)[:, None]


def grouped_matmul_plain(lhs, rhs, sizes, bm=BM, trans_rhs=False):
    """Plain PyTorch version of the kernel at row tile `bm`: the batched
    product in f32 over [E, R, K] x [E, K, N] (rhs [E, N, K] transposed with
    `trans_rhs`), rows past each group's computed rows set to zero, cast to
    lhs's dtype. [E * R, N]."""
    E = rhs.shape[0]
    R = lhs.shape[0] // E
    w = rhs.transpose(1, 2) if trans_rhs else rhs
    out = torch.bmm(lhs.reshape(E, R, -1).float(), w.float())
    live = _computed_mask(sizes, E, R, bm, lhs.device)
    out = torch.where(live[..., None], out, torch.zeros((), device=lhs.device))
    return out.reshape(E * R, -1).to(lhs.dtype)


def _check(lhs, rhs, sizes, trans_rhs):
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError("grouped_matmul wants lhs [E*R, K] and rhs [E, K, N]")
    E = rhs.shape[0]
    if E < 1 or lhs.shape[0] % E:
        raise ValueError(
            f"lhs rows {lhs.shape[0]} not a multiple of the group count {E}: "
            "the uniform-stride layout needs rows padded per group (see "
            "row_stride())")
    K = rhs.shape[2] if trans_rhs else rhs.shape[1]
    if lhs.shape[1] != K:
        raise ValueError(f"lhs depth {lhs.shape[1]} != the weights' {K}")
    if lhs.dtype != rhs.dtype or lhs.dtype not in (torch.float32, *HALF):
        raise TypeError(f"grouped_matmul takes float32, bfloat16 or float16 "
                        f"in one dtype, got {lhs.dtype} and {rhs.dtype}")
    if tuple(sizes.shape) != (E,) or sizes.dtype.is_floating_point:
        raise ValueError(f"group_sizes must be integers [E] = [{E}], got "
                         f"{sizes.dtype} {tuple(sizes.shape)}")
    if rhs.device != lhs.device or sizes.device != lhs.device:
        raise ValueError(f"grouped_matmul: all inputs must be on {lhs.device}")


def tma_operands(lhs, rhs, trans_rhs=False):
    """(lhs, rhs, N) as the 16-bit kernel's tensor maps take them: contiguous,
    16-byte aligned, K (lhs's columns and rhs's K axis) and N (rhs's N axis)
    multiples of 8. Operands that are so pass as they are; any other is
    copied with zero columns appended, which add nothing to a product. N is
    the padded output width; the caller cuts the output back to rhs's."""
    K = lhs.shape[1]
    N = rhs.shape[1] if trans_rhs else rhs.shape[2]
    dk, dn = _pad_to(max(K, 1), 8) - K, _pad_to(N, 8) - N
    if dk:
        lhs = torch.nn.functional.pad(lhs, (0, dk))
    if dk or dn:
        rhs = torch.nn.functional.pad(
            rhs, (0, dk, 0, dn) if trans_rhs else (0, dn, 0, dk))
    lhs, rhs = lhs.contiguous(), rhs.contiguous()
    lhs, rhs = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (lhs, rhs))
    return lhs, rhs, N + dn


def grouped_gemm(lhs, rhs, sizes, trans_rhs=False):
    """out [E * R, N] in lhs's dtype (see the module docstring). CPU tensors
    run the plain version; CUDA tensors launch the kernel."""
    global LAUNCHES
    _check(lhs, rhs, sizes, trans_rhs)
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, rhs, sizes, BM, trans_rhs)
    if lhs.device.type != "cuda":
        raise ValueError(f"grouped_matmul: unsupported device {lhs.device}")
    E = rhs.shape[0]
    R = lhs.shape[0] // E
    N = rhs.shape[1] if trans_rhs else rhs.shape[2]
    if lhs.shape[0] == 0 or N == 0:
        return torch.empty(E * R, N, device=lhs.device, dtype=lhs.dtype)
    if lhs.dtype in HALF:
        lhs, rhs, n_out = tma_operands(lhs, rhs, trans_rhs)
    else:
        lhs, rhs, n_out = lhs.contiguous(), rhs.contiguous(), N
    sizes = sizes.to(torch.int32).contiguous()
    out = torch.empty(E * R, n_out, device=lhs.device, dtype=lhs.dtype)
    err = _build.load_library().ptt_grouped_gemm(
        lhs.data_ptr(), rhs.data_ptr(), sizes.data_ptr(), out.data_ptr(), E,
        R, lhs.shape[1], n_out, int(bool(trans_rhs)),
        _build.DTYPE_CODES[str(lhs.dtype)],
        torch.cuda.current_stream(lhs.device).cuda_stream)
    _build.check(err, "ptt_grouped_gemm")
    LAUNCHES += 1
    return out if n_out == N else out[:, :N].contiguous()


class GroupedMatmul(torch.autograd.Function):
    """The grouped GEMM with its backward (↔ `_gmm_bwd` :182): dlhs is the
    same kernel against the transposed weights (dead tiles give zero
    cotangent by the same semantics); drhs[e] = lhs_e^T dout_e over the rows
    the forward computed, one batched product in the operands' dtype with
    f32 accumulation (the reference's jnp einsum outside any kernel), so
    garbage in dead rows never reaches it. `sizes` is data."""

    @staticmethod
    def forward(ctx, lhs, rhs, sizes):
        ctx.save_for_backward(lhs, rhs, sizes)
        return grouped_gemm(lhs, rhs, sizes)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, sizes = ctx.saved_tensors
        E = rhs.shape[0]
        R = lhs.shape[0] // E
        dout = dout.to(lhs.dtype)
        dlhs = grouped_gemm(dout, rhs, sizes, trans_rhs=True)
        live = _computed_mask(sizes, E, R, BM, lhs.device)[..., None]
        zero = torch.zeros((), dtype=lhs.dtype, device=lhs.device)
        l3 = torch.where(live, lhs.reshape(E, R, -1), zero)
        d3 = torch.where(live, dout.reshape(E, R, -1), zero)
        drhs = torch.bmm(l3.transpose(1, 2), d3)
        report_op("expert_ffn_grad", (dlhs, drhs))
        return dlhs, drhs.to(rhs.dtype), None


def grouped_matmul(lhs, rhs, group_sizes):
    """Ragged grouped GEMM: out[r] = lhs[r] @ rhs[r // R] with
    R = lhs.shape[0] // rhs.shape[0], differentiable in lhs and rhs (see
    the module docstring for the dead-tile semantics)."""
    return GroupedMatmul.apply(lhs, rhs, group_sizes)
