"""Linear algebra (↔ paddle_tpu/tensor/linalg.py), on torch.linalg.

`matmul` of bf16 or f16 accumulates in f32 (torch's GEMMs do) and returns
the promoted input dtype. `histogram` counts on the device with
`torch.histc`; the randomized low-rank factorizations draw their test
matrix from the port's generator (`framework.random`)."""

from __future__ import annotations

import numpy as np
import torch

from ..framework.core import Tensor, register_tensor_method, run_op
from ._common import axis_arg

__all__ = [
    "matmul",
    "mm",
    "bmm",
    "dot",
    "mv",
    "norm",
    "dist",
    "cross",
    "cholesky",
    "cholesky_solve",
    "inverse",
    "pinv",
    "det",
    "slogdet",
    "matrix_rank",
    "matrix_power",
    "qr",
    "svd",
    "eig",
    "eigh",
    "eigvals",
    "eigvalsh",
    "solve",
    "triangular_solve",
    "lstsq",
    "lu",
    "histogram",
    "bincount",
    "cov",
    "corrcoef",
    "einsum",
    "svdvals",
]


def _promote(a, b):
    d = torch.promote_types(a.dtype, b.dtype)
    return a.to(d), b.to(d)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def fn(a, b):
        if transpose_x and a.dim() >= 2:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() >= 2:
            b = b.transpose(-1, -2)
        return torch.matmul(*_promote(a, b))

    return run_op("matmul", fn, [x, y])


def mm(input, mat2, name=None):  # noqa: A002
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)


def dot(x, y, name=None):
    return run_op("dot", lambda a, b: torch.sum(a * b, -1), [x, y])


def mv(x, vec, name=None):
    return matmul(x, vec)


def _dims(axis):
    ax = axis_arg(axis)
    return ax if ax is None or isinstance(ax, tuple) else (ax,)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2
    d = _dims(axis)

    def fn(a):
        if p == "fro":
            return torch.sqrt(torch.sum(a * a, d, keepdim=keepdim))
        dd = d if d is not None else tuple(range(a.dim()))
        if p == np.inf or p == "inf":
            return torch.amax(torch.abs(a), dd, keepdim=keepdim)
        if p == -np.inf:
            return torch.amin(torch.abs(a), dd, keepdim=keepdim)
        if p == 0:
            return torch.sum((a != 0).to(a.dtype), d, keepdim=keepdim)
        return torch.sum(torch.abs(a) ** p, d, keepdim=keepdim) ** (1.0 / p)

    return run_op("norm", fn, [x])


def dist(x, y, p=2, name=None):
    return norm(run_op("subtract", torch.subtract, [x, y]), p=p)


def cross(x, y, axis=9, name=None):
    def fn(a, b):
        ax = axis
        if ax == 9:
            ax = next((i for i, s in enumerate(a.shape) if s == 3), -1)
        return torch.linalg.cross(a, b, dim=ax)

    return run_op("cross", fn, [x, y])


def cholesky(x, upper=False, name=None):
    return run_op("cholesky", lambda a: torch.linalg.cholesky(a, upper=upper),
                  [x])


def cholesky_solve(x, y, upper=False, name=None):
    def fn(b, L):
        Lm = L.transpose(-1, -2) if upper else L
        z = torch.linalg.solve_triangular(Lm, b, upper=False)
        return torch.linalg.solve_triangular(Lm.transpose(-1, -2), z, upper=True)

    return run_op("cholesky_solve", fn, [x, y])


def inverse(x, name=None):
    return run_op("inverse", torch.linalg.inv, [x])


inv = inverse


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return run_op("pinv", lambda a: torch.linalg.pinv(
        a, rtol=rcond, hermitian=hermitian), [x])


def det(x, name=None):
    return run_op("det", torch.linalg.det, [x])


def slogdet(x, name=None):
    return run_op("slogdet", lambda a: torch.stack(
        list(torch.linalg.slogdet(a))), [x])


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return run_op("matrix_rank", lambda a: torch.linalg.matrix_rank(
        a, atol=tol, hermitian=hermitian), [x])


def matrix_power(x, n, name=None):
    return run_op("matrix_power", lambda a: torch.linalg.matrix_power(a, int(n)),
                  [x])


def qr(x, mode="reduced", name=None):
    if mode == "r":
        return run_op("qr_r", lambda a: torch.linalg.qr(a, mode="r")[1], [x])
    return run_op("qr", lambda a: tuple(torch.linalg.qr(a, mode=mode)), [x])


def svd(x, full_matrices=False, name=None):
    return run_op("svd", lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices)), [x])


def eig(x, name=None):
    return run_op("eig", lambda a: tuple(torch.linalg.eig(a)), [x])


def eigh(x, UPLO="L", name=None):
    return run_op("eigh", lambda a: tuple(torch.linalg.eigh(a, UPLO=UPLO)), [x])


def eigvals(x, name=None):
    return run_op("eigvals", torch.linalg.eigvals, [x])


def eigvalsh(x, UPLO="L", name=None):
    return run_op("eigvalsh", lambda a: torch.linalg.eigvalsh(a, UPLO=UPLO),
                  [x])


def solve(x, y, name=None):
    def fn(a, b):
        if b.dim() == a.dim() - 1:
            return torch.linalg.solve(a, b.unsqueeze(-1)).squeeze(-1)
        return torch.linalg.solve(a, b)

    return run_op("solve", fn, [x, y])


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def fn(a, b):
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)

    return run_op("triangular_solve", fn, [x, y])


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values), as numpy's lstsq:
    the residuals are the squared residual sums when the system is
    overdetermined and of full rank, else empty."""
    def fn(a, b):
        vec = b.dim() == a.dim() - 1
        bm = b.unsqueeze(-1) if vec else b
        sol = torch.linalg.pinv(a, rtol=rcond) @ bm if rcond is not None \
            else torch.linalg.pinv(a) @ bm
        sv = torch.linalg.svdvals(a)
        rank = torch.linalg.matrix_rank(a, rtol=rcond)
        m, n = a.shape[-2], a.shape[-1]
        if m > n and int(rank.min()) == n:
            res = ((a @ sol - bm) ** 2).sum(-2)
        else:
            res = torch.zeros(0, dtype=a.dtype, device=a.device)
        if vec:
            sol = sol.squeeze(-1)
            res = res.squeeze(-1) if res.numel() else res
        return sol, res, rank, sv

    return run_op("lstsq", fn, [x, y])


def lu(x, pivot=True, get_infos=False, name=None):
    def fn(a):
        lu_, piv = torch.linalg.lu_factor(a, pivot=pivot)
        return lu_, piv.to(torch.int32)

    lu_t, piv_t = run_op("lu", fn, [x])
    if get_infos:
        return lu_t, piv_t, Tensor(torch.zeros((), dtype=torch.int32,
                                               device=lu_t._value.device))
    return lu_t, piv_t


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    def fn(a):
        a = a.float()
        lo, hi = (float(min), float(max)) if (min != 0 or max != 0) else (
            float(a.min()), float(a.max()))
        return torch.histc(a, int(bins), lo, hi).to(torch.int64)

    return run_op("histogram", fn, [input])


def bincount(x, weights=None, minlength=0, name=None):
    if weights is None:
        return run_op("bincount", lambda a: torch.bincount(
            a.long(), minlength=minlength), [x])
    return run_op("bincount", lambda a, w: torch.bincount(
        a.long(), w, minlength=minlength), [x, weights])


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return run_op("cov", lambda a: torch.cov(
        a if rowvar else a.transpose(-1, -2), correction=1 if ddof else 0), [x])


def corrcoef(x, rowvar=True, name=None):
    return run_op("corrcoef", lambda a: torch.corrcoef(
        a if rowvar else a.transpose(-1, -2)), [x])


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return run_op("einsum", lambda *vs: torch.einsum(equation, *vs),
                  list(operands))


# ----------------------------------------------------------------------- #
# linalg tail (reference :? onwards)
# ----------------------------------------------------------------------- #

def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    d = _dims(axis)

    def fn(a):
        a = a.float()
        dd = d if d is not None else tuple(range(a.dim()))
        if p == float("inf"):
            return torch.abs(a).amax(dd, keepdim=keepdim)
        if p == float("-inf"):
            return torch.abs(a).amin(dd, keepdim=keepdim)
        if p == 0:
            return torch.sum((a != 0).float(), d, keepdim=keepdim)
        return torch.sum(torch.abs(a) ** p, d, keepdim=keepdim) ** (1.0 / p)

    return run_op("vector_norm", fn, [x])


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    def fn(a):
        a = a.float()
        a0, a1 = axis[0] % a.dim(), axis[1] % a.dim()
        m = a.movedim((a0, a1), (-2, -1))
        if p == "fro":
            out = torch.sqrt(torch.sum(m * m, (-2, -1)))
        elif p == "nuc":
            out = torch.linalg.svdvals(m).sum(-1)
        elif p in (1, 1.0):
            out = torch.abs(m).sum(-2).amax(-1)
        elif p in (np.inf, float("inf")):
            out = torch.abs(m).sum(-1).amax(-1)
        elif p in (2, 2.0):
            out = torch.linalg.svdvals(m).amax(-1)
        else:
            raise ValueError(f"unsupported matrix norm order {p!r}")
        if keepdim:
            out = out.unsqueeze(min(a0, a1)).unsqueeze(max(a0, a1))
        return out

    return run_op("matrix_norm", fn, [x])


def cond(x, p=None, name=None):
    def fn(a):
        a = a.float()
        if p is None or p in (2, 2.0):
            s = torch.linalg.svdvals(a)
            return s.amax(-1) / s.amin(-1)
        if p == "fro":
            ia = torch.linalg.inv(a)
            return (torch.sqrt((a * a).sum((-2, -1)))
                    * torch.sqrt((ia * ia).sum((-2, -1))))
        if p in (np.inf, float("inf"), 1, 1.0):
            ax = -2 if p in (1, 1.0) else -1
            ia = torch.linalg.inv(a)
            return (torch.abs(a).sum(ax).amax(-1)
                    * torch.abs(ia).sum(ax).amax(-1))
        raise ValueError(f"unsupported cond order {p!r}")

    return run_op("cond", fn, [x])


def matrix_exp(x, name=None):
    return run_op("matrix_exp", lambda a: torch.linalg.matrix_exp(a.float()),
                  [x])


def vecdot(x, y, axis=-1, name=None):
    return run_op("vecdot", lambda a, b: torch.sum(a * b, axis), [x, y])


def householder_product(x, tau, name=None):
    return run_op("householder_product", torch.linalg.householder_product,
                  [x, tau])


def ormqr(x, tau, other, left=True, transpose=False, name=None):
    return run_op("ormqr", lambda a, t, o: torch.ormqr(
        a, t, o, left=left, transpose=transpose), [x, tau, other])


def _lowrank(a, q, g, niter=2):
    """Randomized range finder (Halko et al. 2011), as the reference's."""
    n = a.shape[-1]
    omega = torch.randn(a.shape[:-2] + (n, q), generator=g, device=a.device,
                        dtype=a.dtype)
    y = a @ omega
    for _ in range(niter):
        y = a @ (a.transpose(-2, -1) @ y)
    qmat, _ = torch.linalg.qr(y)
    b = qmat.transpose(-2, -1) @ a
    u, s, vt = torch.linalg.svd(b, full_matrices=False)
    return qmat @ u, s, vt.transpose(-2, -1)


def svdvals(x, name=None):
    return run_op("svdvals", torch.linalg.svdvals, [x])


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    from ..framework import random as rnd

    def fn(a, *rest):
        a = a.float()
        if rest:
            a = a - rest[0].float()
        g = rnd.generator(a.device)
        return _lowrank(a, min(q, min(a.shape[-2:])), g, niter)

    return run_op("svd_lowrank", fn, [x] + ([M] if M is not None else []))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    from ..framework import random as rnd

    def fn(a):
        a = a.float()
        if center:
            a = a - a.mean(-2, keepdim=True)
        k = q if q is not None else min(6, *a.shape[-2:])
        return _lowrank(a, min(k, min(a.shape[-2:])), rnd.generator(a.device),
                        niter)

    return run_op("pca_lowrank", fn, [x])


__all__ += ["vector_norm", "matrix_norm", "cond", "matrix_exp", "vecdot",
            "householder_product", "ormqr", "svd_lowrank", "pca_lowrank"]

# aliases that live elsewhere in the tensor namespace (the reference exports
# them from linalg too)
from .extras import lu_unpack, matrix_transpose, multi_dot  # noqa: E402,F401

__all__ += ["lu_unpack", "matrix_transpose", "multi_dot"]

for _name in __all__:
    if _name not in ("einsum", "lu_unpack", "matrix_transpose", "multi_dot"):
        register_tensor_method(_name, globals()[_name])

