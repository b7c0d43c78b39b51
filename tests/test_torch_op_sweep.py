"""The op sweep of the port's tensor surface: every name of
`paddle_tpu.tensor.__all__` is a case here, held to `paddle_tpu` on the
same seeded inputs (forward, and the gradients of the float inputs where
the op is differentiable), or is listed with the reason it is held another
way. Random draws are held by shape, dtype and distribution (the two
packages' generators give different numbers); in-place `<op>_` variants by
their values and by returning their own tensor."""

import zlib

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.device._default = "cuda"


# --------------------------------------------------------------------------- #
# inputs
# --------------------------------------------------------------------------- #

def F(*shape, lo=-2.0, hi=2.0):
    return ("f", shape, lo, hi)


def P(*shape):
    return F(*shape, lo=0.2, hi=2.0)


def U(*shape):
    return F(*shape, lo=-0.9, hi=0.9)


def I(*shape, lo=0, hi=5):  # noqa: E743
    return ("i", shape, lo, hi)


def B(*shape):
    return ("b", shape, 0, 1)


def _make(spec, rng):
    if isinstance(spec, tuple) and spec and spec[0] in ("f", "i", "b"):
        kind, shape, lo, hi = spec
        if kind == "f":
            return rng.uniform(lo, hi, shape).astype(np.float32)
        if kind == "i":
            return rng.integers(lo, hi, shape).astype(np.int64)
        return rng.random(shape) > 0.5
    if isinstance(spec, list):
        return [_make(s, rng) for s in spec]
    if callable(spec):
        return spec(rng)
    return spec


def _tensors(pkg, arg, grad):
    if isinstance(arg, np.ndarray):
        t = pkg.to_tensor(arg)
        if grad and arg.dtype == np.float32:
            t.stop_gradient = False
        return t
    if isinstance(arg, list) and arg and isinstance(arg[0], np.ndarray):
        return [_tensors(pkg, a, grad) for a in arg]
    return arg


class C:
    """One case: `args` (specs or values), `kw`, whether gradients are
    held, tolerances, an optional caller `call(pkg, *args, **kw)` and an
    optional checker `check(ref_out, port_out, arrays)` in place of the
    value comparison."""

    def __init__(self, *args, grad=True, rtol=1e-5, atol=1e-5, call=None,
                 check=None, **kw):
        self.args, self.kw, self.grad = list(args), kw, grad
        self.rtol, self.atol, self.call, self.check = rtol, atol, call, check


def _flat(o):
    if o is None:
        return
    if isinstance(o, (list, tuple)):
        for x in o:
            yield from _flat(x)
    elif hasattr(o, "numpy"):
        yield np.asarray(o.numpy())
    else:
        yield np.asarray(o)


def _close(a, b, rtol, atol, what):
    a, b = list(_flat(a)), list(_flat(b))
    assert len(a) == len(b), f"{what}: {len(a)} vs {len(b)} outputs"
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape, f"{what}[{i}]: shape {x.shape} vs {y.shape}"
        if x.dtype == np.bool_ or y.dtype == np.bool_:
            np.testing.assert_array_equal(x.astype(bool), y.astype(bool),
                                          err_msg=f"{what}[{i}]")
            continue
        np.testing.assert_allclose(y.astype(np.complex128 if np.iscomplexobj(y)
                                            else np.float64),
                                   x.astype(np.complex128 if np.iscomplexobj(x)
                                            else np.float64),
                                   rtol=rtol, atol=atol, equal_nan=True,
                                   err_msg=f"{what}[{i}]")


def _sorted_complex(o):
    v = np.asarray(o.numpy()).reshape(-1)
    return v[np.lexsort((np.round(v.imag, 4), np.round(v.real, 4)))]


def _check_eig(r, p, arrays):
    pv, pw = p
    a = arrays[0]
    np.testing.assert_allclose(_sorted_complex(pv), _sorted_complex(r[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(a @ pw.numpy(), pw.numpy() * pv.numpy()[None],
                               rtol=1e-3, atol=1e-4)


def _check_svd(r, p, arrays):
    u, s, vh = (np.asarray(x.numpy()) for x in p)
    np.testing.assert_allclose(s, r[1].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((u * s[None]) @ vh, arrays[0], rtol=1e-4,
                               atol=1e-4)


def _check_eigh(r, p, arrays):
    np.testing.assert_allclose(p[0].numpy(), r[0].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.abs(p[1].numpy()), np.abs(r[1].numpy()),
                               rtol=1e-3, atol=1e-4)


def _check_qr(r, p, arrays):
    q, rr = (np.asarray(x.numpy()) for x in p)
    np.testing.assert_allclose(q @ rr, arrays[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.abs(rr), np.abs(r[1].numpy()), rtol=1e-4,
                               atol=1e-4)


def _check_lowrank(r, p, arrays):
    u, s, vv = (np.asarray(x.numpy()) for x in p)
    a = arrays[0]
    np.testing.assert_allclose(s, np.linalg.svd(a, compute_uv=False)[:len(s)],
                               rtol=1e-3, atol=1e-3)


def _check_lowrank_centered(r, p, arrays):
    a = arrays[0] - arrays[0].mean(0, keepdims=True)
    _check_lowrank(r, p, [a])


def _spd(rng):
    a = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
    return (a @ a.T + 3 * np.eye(3)).astype(np.float32)


def _chol(rng):
    return np.linalg.cholesky(_spd(rng)).astype(np.float32)


def _sorted_seq(rng):
    return np.sort(rng.uniform(-2, 2, (8,))).astype(np.float32)


def _geqrf(rng):
    import scipy.linalg

    a = rng.uniform(-1, 1, (4, 3))
    (qr, tau), _ = scipy.linalg.qr(a, mode="raw")
    return qr.astype(np.float32), tau.astype(np.float32)


_GEQRF = _geqrf(np.random.default_rng(7))


def _lu_parts(pkg, a):
    lu, piv = pkg.linalg.lu(pkg.to_tensor(a))
    return pkg.linalg.lu_unpack(lu, piv)


# --------------------------------------------------------------------------- #
# the cases, by module
# --------------------------------------------------------------------------- #

X = F(3, 4)
X2 = [F(3, 4), F(3, 4)]

CASES = {
    # creation -------------------------------------------------------------
    "to_tensor": C(F(2, 3), grad=False),
    "zeros": C([2, 3], grad=False),
    "zeros_like": C(X, grad=False),
    "ones": C([2, 3], grad=False),
    "ones_like": C(X, grad=False),
    "full": C([2, 3], 1.5, grad=False),
    "full_like": C(X, 2.5, grad=False),
    "empty": C([2, 3], grad=False, check=lambda r, p, a: p.shape == [2, 3]),
    "empty_like": C(X, grad=False, check=lambda r, p, a: p.shape == [3, 4]),
    "arange": C(0, 7, 2, grad=False),
    "linspace": C(0.0, 1.0, 5, grad=False),
    "logspace": C(0.0, 2.0, 5, grad=False, rtol=1e-5),
    "eye": C(3, 4, grad=False),
    "diag": C(F(4), offset=1),
    "diagflat": C(F(2, 2)),
    "meshgrid": C(F(3), F(4), call=lambda pkg, a, b: pkg.meshgrid(a, b)),
    "tril": C(F(4, 4), diagonal=-1),
    "triu": C(F(4, 4), diagonal=1),
    "assign": C(X),
    "clone": C(X),
    "create_parameter": C([4, 3], grad=False, check=lambda r, p, a: (
        p.shape == (4, 3) and np.abs(p.numpy()).max() <= np.sqrt(6 / 7) + 1e-6)),
    # math: unary ----------------------------------------------------------
    "exp": C(X), "expm1": C(X), "log": C(P(3, 4)), "log2": C(P(3, 4)),
    "log10": C(P(3, 4)), "log1p": C(P(3, 4)), "sqrt": C(P(3, 4)),
    "rsqrt": C(P(3, 4)), "abs": C(P(3, 4)), "sign": C(X, grad=False),
    "sin": C(X), "cos": C(X), "tan": C(U(3, 4)), "asin": C(U(3, 4)),
    "acos": C(U(3, 4)), "atan": C(X), "sinh": C(X), "cosh": C(X),
    "tanh": C(X), "asinh": C(X), "acosh": C(F(3, 4, lo=1.1, hi=3.0)),
    "atanh": C(U(3, 4)), "ceil": C(X, grad=False), "floor": C(X, grad=False),
    "round": C(X, grad=False), "trunc": C(X, grad=False), "frac": C(X),
    "reciprocal": C(P(3, 4)), "square": C(X), "neg": C(X), "erf": C(X),
    "erfinv": C(U(3, 4)), "sigmoid": C(X), "logit": C(F(3, 4, lo=0.1, hi=0.9)),
    "lgamma": C(P(3, 4)), "digamma": C(P(3, 4), rtol=1e-4),
    "angle": C(X, grad=False), "conj": C(X), "real": C(X), "imag": C(X),
    "deg2rad": C(X), "rad2deg": C(X), "i0": C(X, rtol=1e-4),
    "i1": C(X, rtol=1e-4), "arcsin": C(U(3, 4)), "arccos": C(U(3, 4)),
    "arctan": C(X),
    # math: binary ---------------------------------------------------------
    "add": C(*X2), "subtract": C(*X2), "multiply": C(*X2),
    "divide": C(X, P(3, 4)),
    "floor_divide": C(F(3, 4, lo=1, hi=9), P(3, 4), grad=False),
    "mod": C(F(3, 4, lo=0.5, hi=4), F(3, 4, lo=1, hi=3), grad=False),
    "remainder": C(F(3, 4, lo=0.5, hi=4), F(3, 4, lo=1, hi=3), grad=False),
    "floor_mod": C(F(3, 4, lo=0.5, hi=4), F(3, 4, lo=1, hi=3), grad=False),
    "pow": C(P(3, 4), F(3, 4, lo=0.5, hi=2.0)),
    "maximum": C(*X2), "minimum": C(*X2), "fmax": C(*X2), "fmin": C(*X2),
    "atan2": C(*X2), "hypot": C(P(3, 4), P(3, 4)), "logaddexp": C(*X2),
    "heaviside": C(X, F(3, 4), grad=False), "copysign": C(*X2, grad=False),
    "nextafter": C(*X2, grad=False), "ldexp": C(X, I(3, 4), grad=False),
    "gcd": C(I(3, 4, lo=1, hi=30), I(3, 4, lo=1, hi=30), grad=False),
    "lcm": C(I(3, 4, lo=1, hi=12), I(3, 4, lo=1, hi=12), grad=False),
    "inner": C(F(2, 4), F(3, 4)), "outer": C(F(3), F(4)),
    "kron": C(F(2, 2), F(3, 2)),
    "scale": C(X, 2.0, 0.5),
    "multiplex": C([F(3, 4), F(3, 4)], I(3, 1, lo=0, hi=2), grad=False),
    # math: reductions -----------------------------------------------------
    "sum": C(F(3, 4, 5), axis=1), "prod": C(F(3, 4, lo=0.5, hi=1.5), axis=0),
    "max": C(F(3, 4, 5), axis=-1, keepdim=True), "min": C(F(3, 4, 5)),
    "amax": C(F(3, 4, 5), axis=[0, 2]), "amin": C(F(3, 4, 5), axis=1),
    "mean": C(F(3, 4, 5), axis=[0, 2]), "nanmean": C(F(3, 4), axis=1),
    "nansum": C(F(3, 4), axis=0), "logsumexp": C(F(3, 4), axis=1),
    "all": C(B(3, 4), axis=1, grad=False), "any": C(B(3, 4), grad=False),
    "count_nonzero": C(I(3, 4, lo=0, hi=3), axis=1, grad=False),
    "cumsum": C(X, axis=1), "cumprod": C(F(3, 4, lo=0.5, hi=1.5), dim=1),
    "cummax": C(X, axis=1), "cummin": C(X, axis=0),
    "clip": C(X, -0.5, 0.5), "isnan": C(X, grad=False),
    "isinf": C(X, grad=False), "isfinite": C(X, grad=False),
    "nan_to_num": C(lambda r: np.array([1.0, np.nan, np.inf, -np.inf],
                                       np.float32), grad=False),
    "increment": C(F(1), 2.0, grad=False),
    "stanh": C(X), "lerp": C(X, F(3, 4), 0.3),
    "addmm": C(F(3, 5), F(3, 4), F(4, 5), beta=0.5, alpha=2.0),
    "trace": C(F(4, 4), offset=1), "diff": C(X, axis=1),
    # manipulation ---------------------------------------------------------
    "reshape": C(X, [4, 3]), "flatten": C(F(2, 3, 4), 1, 2),
    "transpose": C(F(2, 3, 4), [2, 0, 1]), "t": C(X),
    "moveaxis": C(F(2, 3, 4), 0, 2), "swapaxes": C(F(2, 3, 4), 0, 2),
    "squeeze": C(F(3, 1, 4), 1), "unsqueeze": C(X, [0, 3]),
    "concat": C([F(2, 4), F(3, 4)], axis=0), "stack": C(X2, axis=1),
    "hstack": C(X2), "vstack": C(X2), "dstack": C(X2),
    "split": C(F(6, 4), [1, 2, -1], axis=0), "chunk": C(F(7, 2), 3),
    "unbind": C(X, axis=1), "tile": C(X, [2, 1]),
    "expand": C(F(1, 4), [3, -1]), "expand_as": C(F(1, 4), F(3, 4)),
    "broadcast_to": C(F(1, 4), [2, 4]),
    "broadcast_tensors": C([F(1, 4), F(3, 1)]),
    "flip": C(X, [0, 1]), "rot90": C(X, k=1, axes=[0, 1]),
    "roll": C(X, 1, axis=1),
    "gather": C(F(5, 3), I(4, lo=0, hi=5), axis=0),
    "gather_nd": C(F(3, 4), I(5, 2, lo=0, hi=3)),
    "scatter": C(F(5, 3), lambda r: np.array([0, 2], np.int64), F(2, 3)),
    "scatter_nd_add": C(F(4, 3), lambda r: np.array([[1], [3], [1]], np.int64),
                        F(3, 3)),
    "index_select": C(F(5, 3), I(4, lo=0, hi=5), axis=0),
    "index_add": C(F(5, 3), lambda r: np.array([0, 2, 4], np.int64), 0,
                   F(3, 3)),
    "index_put": C(F(4, 3), [lambda r: np.array([0, 2], np.int64),
                             lambda r: np.array([1, 2], np.int64)], F(2)),
    "take_along_axis": C(X, I(3, 2, lo=0, hi=4), 1),
    "put_along_axis": C(X, lambda r: np.array([[0], [3], [1]], np.int64),
                        F(3, 1), 1, grad=False),
    # the reference selects on the host: its output carries no gradient
    "masked_select": C(X, B(3, 4), grad=False), "masked_fill": C(X, B(3, 4), 0.5),
    "slice": C(F(4, 5), [0, 1], [1, -3], [3, 100]),
    "strided_slice": C(F(6, 5), [0, 1], [0, 1], [6, 5], [2, 2]),
    "pad": C(F(2, 3, 4), [1, 2], value=0.5),
    "repeat_interleave": C(X, 2, axis=0),
    "unique": C(I(12, lo=0, hi=5), return_index=True, return_inverse=True,
                return_counts=True, grad=False),
    "unique_consecutive": C(lambda r: np.array([1, 1, 2, 2, 3, 1], np.int64),
                            return_inverse=True, return_counts=True,
                            grad=False),
    "as_strided": C(F(12), [3, 2], [2, 1], grad=False),
    "view": C(X, [2, 6]), "view_as": C(X, F(6, 2)),
    "unfold": C(F(2, 7), 1, 3, 2), "tensordot": C(F(3, 4), F(4, 5), axes=1),
    "atleast_1d": C(lambda r: np.float32(1.5), grad=False),
    "atleast_2d": C(F(3), grad=False), "atleast_3d": C(F(3, 4), grad=False),
    "tolist": C(X, grad=False), "crop": C(F(4, 5), [2, 3], [1, 1]),
    # linalg ---------------------------------------------------------------
    "matmul": C(F(3, 4), F(5, 4), transpose_y=True), "mm": C(F(3, 4), F(4, 2)),
    "bmm": C(F(2, 3, 4), F(2, 4, 3)), "dot": C(F(6), F(6)),
    "mv": C(F(3, 4), F(4)), "norm": C(X, p=2, axis=1),
    "dist": C(*X2, p=2), "cross": C(F(4, 3), F(4, 3), axis=1),
    "cholesky": C(_spd, grad=False), "cholesky_solve": C(F(3, 2), _chol),
    "inverse": C(_spd, rtol=1e-4), "pinv": C(F(4, 3), grad=False, rtol=1e-4,
                                              atol=1e-4),
    "det": C(_spd, rtol=1e-4), "slogdet": C(_spd, rtol=1e-4),
    "matrix_rank": C(F(4, 3), grad=False), "matrix_power": C(F(3, 3), 3),
    "qr": C(F(4, 3), grad=False, check=_check_qr),
    "svd": C(F(4, 3), grad=False, check=_check_svd),
    "eig": C(F(3, 3), grad=False, check=_check_eig),
    "eigh": C(_spd, grad=False, check=_check_eigh),
    "eigvals": C(F(3, 3), grad=False, check=lambda r, p, a: np.testing.
                 assert_allclose(_sorted_complex(p), _sorted_complex(r),
                                 rtol=1e-4, atol=1e-4)),
    "eigvalsh": C(_spd, rtol=1e-4),
    "solve": C(_spd, F(3), rtol=1e-4),
    "triangular_solve": C(lambda r: np.triu(_spd(r)), F(3, 2), upper=True,
                          rtol=1e-4),
    "lstsq": C(F(5, 3), F(5, 2), grad=False, rtol=1e-4, atol=1e-4,
               check=lambda r, p, a: _close(r[0], p[0], 1e-4, 1e-4, "lstsq")),
    "lu": C(F(3, 3), grad=False, rtol=1e-4),
    "histogram": C(F(40), bins=5, min=-2, max=2, grad=False),
    "bincount": C(I(20, lo=0, hi=6), grad=False),
    "cov": C(F(3, 6)), "corrcoef": C(F(3, 6), rtol=1e-4),
    "einsum": C("ij,jk->ik", F(3, 4), F(4, 2)),
    "svdvals": C(F(4, 3), rtol=1e-4),
    "vector_norm": C(X, p=3.0, axis=1), "matrix_norm": C(F(2, 3, 4)),
    "cond": C(_spd, rtol=1e-4, grad=False), "matrix_exp": C(F(3, 3, lo=-.5,
                                                             hi=.5), rtol=1e-4),
    "vecdot": C(*X2), "householder_product": C(
        lambda r: _GEQRF[0], lambda r: _GEQRF[1], grad=False, rtol=1e-4),
    "ormqr": C(lambda r: _GEQRF[0], lambda r: _GEQRF[1], F(4, 2), grad=False,
               rtol=1e-4),
    "svd_lowrank": C(F(6, 4), q=4, grad=False, check=_check_lowrank),
    "pca_lowrank": C(F(6, 4), q=4, grad=False, check=_check_lowrank_centered),
    "lu_unpack": C(F(3, 3), grad=False, call=_lu_parts, rtol=1e-4),
    "matrix_transpose": C(F(2, 3, 4)),
    "multi_dot": C([F(3, 4), F(4, 5), F(5, 2)]),
    # logic ----------------------------------------------------------------
    "equal": C(I(3, 4), I(3, 4), grad=False),
    "not_equal": C(I(3, 4), I(3, 4), grad=False),
    "greater_than": C(*X2, grad=False), "greater_equal": C(*X2, grad=False),
    "less_than": C(*X2, grad=False), "less_equal": C(*X2, grad=False),
    "equal_all": C(X, lambda r: None, grad=False,
                   call=lambda pkg, a, _: pkg.equal_all(a, a)),
    "allclose": C(*X2, grad=False), "isclose": C(*X2, grad=False),
    "logical_and": C(B(3, 4), B(3, 4), grad=False),
    "logical_or": C(B(3, 4), B(3, 4), grad=False),
    "logical_not": C(B(3, 4), grad=False),
    "logical_xor": C(B(3, 4), B(3, 4), grad=False),
    "bitwise_and": C(I(3, 4, hi=16), I(3, 4, hi=16), grad=False),
    "bitwise_or": C(I(3, 4, hi=16), I(3, 4, hi=16), grad=False),
    "bitwise_not": C(I(3, 4, hi=16), grad=False),
    "bitwise_xor": C(I(3, 4, hi=16), I(3, 4, hi=16), grad=False),
    "bitwise_left_shift": C(I(3, 4, hi=16), I(3, 4, hi=4), grad=False),
    "bitwise_right_shift": C(I(3, 4, hi=64), I(3, 4, hi=4), grad=False),
    "is_empty": C(X, grad=False), "is_tensor": C(X, grad=False),
    # search ---------------------------------------------------------------
    "argmax": C(X, axis=1, grad=False), "argmin": C(X, grad=False),
    "argsort": C(X, axis=1, descending=True, grad=False), "sort": C(X, axis=0),
    "topk": C(X, 2, axis=1), "where": C(B(3, 4), *X2),
    "nonzero": C(I(3, 4, lo=0, hi=2), grad=False),
    "searchsorted": C(_sorted_seq, F(5), grad=False),
    "index_sample": C(X, I(3, 2, lo=0, hi=4)),
    "kthvalue": C(X, 2, axis=1), "mode": C(I(3, 6, lo=0, hi=3), grad=False),
    "masked_fill_": C(X, B(3, 4), 0.5, grad=False),
    "bucketize": C(F(5), _sorted_seq, grad=False),
    # stat -----------------------------------------------------------------
    "std": C(X, axis=1), "var": C(X), "median": C(F(3, 5), axis=1, grad=False),
    "nanmedian": C(F(3, 5), grad=False),
    "quantile": C(F(3, 5), 0.3, axis=1, grad=False),
    "nanquantile": C(F(3, 5), 0.6, grad=False), "numel": C(X, grad=False),
    # extras ---------------------------------------------------------------
    "add_n": C([F(3, 4), F(3, 4), F(3, 4)]),
    "as_complex": C(F(3, 2), grad=False), "as_real": C(
        F(3, 2), grad=False, call=lambda pkg, a: pkg.as_real(pkg.as_complex(a))),
    "block_diag": C([F(2, 2), F(1, 3)]),
    "broadcast_shape": C([3, 1], [1, 4], grad=False),
    "cast": C(X, "int32", grad=False), "cdist": C(F(4, 3), F(5, 3)),
    "cholesky_inverse": C(_chol, rtol=1e-4, grad=False),
    "combinations": C(F(4), 2),
    "cumulative_trapezoid": C(X), "trapezoid": C(X),
    "diag_embed": C(F(2, 3), offset=1), "diagonal": C(F(3, 4), offset=1),
    "diagonal_scatter": C(F(3, 3), F(3)),
    "dsplit": C(F(2, 2, 4), 2), "hsplit": C(F(2, 6), 3),
    "vsplit": C(F(6, 2), [2, 4]), "tensor_split": C(F(7, 2), 3),
    "frexp": C(X, grad=False), "gammaln": C(P(3, 4)),
    "gammainc": C(P(3, 4), P(3, 4), grad=False, rtol=1e-4),
    "gammaincc": C(P(3, 4), P(3, 4), grad=False, rtol=1e-4),
    "histogram_bin_edges": C(F(30), bins=4, grad=False),
    "i0e": C(X, rtol=1e-4), "i1e": C(X, rtol=1e-4),
    "index_fill": C(X, lambda r: np.array([0, 2], np.int64), 0, 1.5),
    "isin": C(I(3, 4, hi=8), I(5, hi=8), grad=False),
    "isneginf": C(lambda r: np.array([1.0, -np.inf, np.inf], np.float32),
                  grad=False),
    "isposinf": C(lambda r: np.array([1.0, -np.inf, np.inf], np.float32),
                  grad=False),
    "isreal": C(X, grad=False), "is_complex": C(X, grad=False),
    "is_floating_point": C(X, grad=False), "is_integer": C(I(3), grad=False),
    "logcumsumexp": C(X, axis=1),
    "masked_scatter": C(X, B(3, 4), F(12)),
    "multigammaln": C(F(3, 4, lo=2.0, hi=4.0), 2, rtol=1e-4),
    "negative": C(X), "positive": C(X), "polar": C(P(3), F(3), grad=False),
    "polygamma": C(P(3, 4), 1, rtol=1e-4, grad=False), "rank": C(X, grad=False),
    "renorm": C(X, 2.0, 0, 1.0), "reverse": C(X, [0]),
    "scatter_nd": C(lambda r: np.array([[0], [2], [0]], np.int64), F(3), [4]),
    "select_scatter": C(X, F(4), 0, 1),
    "slice_scatter": C(X, F(3, 2), [1], [1], [3], [1]),
    "sgn": C(X, grad=False), "shape": C(F(2, 5), grad=False),
    "shard_index": C(I(4, 1, lo=0, hi=20), 20, 2, 1, grad=False),
    "signbit": C(X, grad=False), "sinc": C(X), "take": C(X, I(5, lo=0, hi=12)),
    "top_p_sampling": C(lambda r: np.array([[0.0, 0.0, 10.0], [9.0, 0.0, 0.0]],
                                           np.float32),
                        lambda r: np.array([0.5, 0.5], np.float32), grad=False),
    "unflatten": C(F(12, 2), 0, [3, 4]), "unstack": C(X, axis=1),
    "vander": C(F(3), n=4),
    # tail -----------------------------------------------------------------
    "tril_indices": C(4, 3, -1, grad=False),
    "triu_indices": C(4, 3, 1, grad=False),
    "complex": C(*X2, grad=False),
    "fill_diagonal_": C(F(4, 3), 1.5, grad=False),
    "fill_diagonal_tensor": C(F(4, 3), F(3)),
    "fill_diagonal_tensor_": C(F(4, 3), F(3), grad=False),
    "reduce_as": C(F(2, 3, 4), F(3, 1)),
    "edit_distance": C(I(2, 5, hi=4), I(2, 4, hi=4), grad=False),
    "clip_by_norm": C(X, 1.0), "histogramdd": C(F(20, 2), bins=3,
                                                 grad=False),
}

# random draws, held by shape, dtype and distribution in test_random_draws
RANDOM = {"rand", "randn", "randint", "randint_like", "randperm", "uniform",
          "uniform_", "normal", "normal_", "standard_normal", "gaussian",
          "poisson", "bernoulli", "multinomial", "exponential_", "binomial",
          "standard_gamma", "cauchy_", "geometric_"}

# the in-place variants generated over _INPLACE_BASES, held through their
# base's case in test_inplace_variant
# names held another way, with the reason
LISTED = {
    "flatten_": "an alias of flatten in both packages (not in place); held "
                "by flatten's case",
}

INPLACE = {n for n in ref.tensor.__all__
           if n.endswith("_") and n[:-1] in CASES and n not in CASES
           and n not in RANDOM and n not in LISTED}


def test_every_name_is_a_case_or_listed():
    """The port's tensor.__all__ equals the reference's, and each name is
    a case, a random draw, an in-place variant or listed with a reason."""
    names = set(ref.tensor.__all__)
    assert set(port.tensor.__all__) == names
    assert len(port.tensor.__all__) == len(ref.tensor.__all__) == 414
    covered = set(CASES) | RANDOM | INPLACE | set(LISTED)
    assert names - covered == set()
    assert covered - names == set()
    for n in names:
        assert hasattr(port, n), n


def _run(pkg, name, case, arrays, grad):
    args = [_tensors(pkg, a, grad) for a in arrays]
    fn = getattr(pkg, name)
    if case.call is not None:
        return case.call(pkg, *args, **case.kw), args
    return fn(*args, **case.kw), args


def _first_float(out):
    for o in ([out] if not isinstance(out, (list, tuple)) else out):
        if hasattr(o, "numpy") and np.asarray(o.numpy()).dtype in (
                np.float32, np.float64) and not o.stop_gradient:
            return o
    return None


def _grads(pkg, out, args, w):
    o = _first_float(out)
    if o is None:
        return None
    (o * pkg.to_tensor(w.reshape(o.shape))).sum().backward()
    grads = []
    for a in args:
        for t in (a if isinstance(a, list) else [a]):
            if hasattr(t, "stop_gradient") and not t.stop_gradient:
                g = t.grad
                grads.append(np.zeros(t.shape, np.float32) if g is None
                             else np.asarray(g.numpy()))
    return grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_holds_to_reference(name):
    case = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    arrays = [_make(a, rng) for a in case.args]
    grad = case.grad
    r_out, r_args = _run(ref, name, case, arrays, grad)
    p_out, p_args = _run(port, name, case, arrays, grad)
    if case.check is not None:
        res = case.check(r_out, p_out, arrays)
        assert res is None or res
    else:
        _close(r_out, p_out, case.rtol, case.atol, name)
    if not grad:
        return
    ro = _first_float(r_out)
    assert ro is not None, f"{name}: no differentiable output"
    w = np.random.default_rng(1).uniform(0.5, 1.5, ro.shape).astype(np.float32)
    rg = _grads(ref, r_out, r_args, w)
    pg = _grads(port, p_out, p_args, w)
    assert len(rg) == len(pg) and rg
    for i, (a, b) in enumerate(zip(rg, pg)):
        np.testing.assert_allclose(b, a, rtol=max(case.rtol, 1e-4),
                                   atol=max(case.atol, 1e-4),
                                   err_msg=f"{name} grad[{i}]")


@pytest.mark.parametrize("name", sorted(INPLACE))
def test_inplace_variant(name):
    """`<op>_(x, ...)` returns x itself, holding the values of the
    reference's `<op>_` on the same inputs."""
    case = CASES[name[:-1]]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    arrays = [_make(a, rng) for a in case.args]
    outs = []
    for pkg in (ref, port):
        args = [_tensors(pkg, a, False) for a in arrays]
        out = getattr(pkg, name)(*args, **case.kw)
        assert out is args[0]
        outs.append(out)
    _close(outs[0], outs[1], case.rtol, case.atol, name)


def _moments(t):
    a = np.asarray(t.numpy(), np.float64)
    return a.mean(), a.std()


def test_random_draws():
    """Shape, dtype and distribution of every draw, beside the reference's
    (the generators differ; `seed` makes each package's draws repeat)."""
    port.seed(0)
    a = port.randn([4000])
    port.seed(0)
    assert np.array_equal(a.numpy(), port.randn([4000]).numpy())
    n = 20000
    checks = {
        "rand": (lambda pkg: pkg.rand([n]), 0.5, (1 / 12) ** 0.5),
        "randn": (lambda pkg: pkg.randn([n]), 0.0, 1.0),
        "standard_normal": (lambda pkg: pkg.standard_normal([n]), 0.0, 1.0),
        "gaussian": (lambda pkg: pkg.gaussian([n], mean=1.0, std=2.0), 1.0, 2.0),
        "normal": (lambda pkg: pkg.normal(1.0, 0.5, [n]), 1.0, 0.5),
        "uniform": (lambda pkg: pkg.uniform([n], min=-1.0, max=3.0), 1.0,
                    (16 / 12) ** 0.5),
        "randint": (lambda pkg: pkg.randint(0, 10, [n]), 4.5, (99 / 12) ** 0.5),
        "randint_like": (lambda pkg: pkg.randint_like(
            pkg.zeros([n], "int64"), 0, 10), 4.5, (99 / 12) ** 0.5),
        "poisson": (lambda pkg: pkg.poisson(pkg.full([n], 3.0)), 3.0, 3 ** 0.5),
        "bernoulli": (lambda pkg: pkg.bernoulli(pkg.full([n], 0.3)), 0.3,
                      (0.21) ** 0.5),
        "binomial": (lambda pkg: pkg.binomial(pkg.full([n], 10.0),
                                              pkg.full([n], 0.4)), 4.0,
                     2.4 ** 0.5),
        "standard_gamma": (lambda pkg: pkg.standard_gamma(pkg.full([n], 2.0)),
                           2.0, 2 ** 0.5),
        "uniform_": (lambda pkg: pkg.uniform_(pkg.zeros([n]), 0.0, 1.0), 0.5,
                     (1 / 12) ** 0.5),
        "normal_": (lambda pkg: pkg.normal_(pkg.zeros([n]), 2.0, 3.0), 2.0, 3.0),
        "exponential_": (lambda pkg: pkg.exponential_(pkg.zeros([n]), 2.0),
                         0.5, 0.5),
        "geometric_": (lambda pkg: pkg.geometric_(pkg.zeros([n]), 0.5), 2.0,
                       2 ** 0.5),
    }
    for name, (draw, mean, std) in checks.items():
        for pkg in (ref, port):
            t = draw(pkg)
            assert t.shape == [n], (name, t.shape)
            m, s = _moments(t)
            assert abs(m - mean) < 0.05 * max(1.0, abs(mean)) + 4 * std / n ** 0.5, \
                (name, pkg.__name__, m)
            assert abs(s - std) < 0.06 * std, (name, pkg.__name__, s)
        assert port.is_floating_point(draw(port)) == ref.is_floating_point(
            draw(ref)), name
    # permutations, categorical draws and the heavy-tailed Cauchy
    for pkg in (ref, port):
        p = pkg.randperm(50).numpy()
        assert sorted(p.tolist()) == list(range(50))
        probs = pkg.to_tensor(np.array([[0.1, 0.2, 0.7]] * 4000, np.float32))
        draws = pkg.multinomial(probs, 1).numpy().reshape(-1)
        freq = np.bincount(draws, minlength=3) / draws.size
        np.testing.assert_allclose(freq, [0.1, 0.2, 0.7], atol=0.03)
        c = pkg.cauchy_(pkg.zeros([n]), loc=1.0, scale=2.0).numpy()
        assert abs(np.median(c) - 1.0) < 0.1
        q1, q3 = np.percentile(c, [25, 75])
        assert abs((q3 - q1) / 2 - 2.0) < 0.15
