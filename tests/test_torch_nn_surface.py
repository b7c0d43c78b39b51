"""The nn surface of the port held to `paddle_tpu` on the CPU: every
functional name the port lacked before (`nn.functional` activations,
common, `normalize`, the extras tail and `flash_attn_qkvpacked`), forward
and the gradients of the float inputs on seeded numpy inputs, as
`tests/test_torch_op_sweep.py` holds the tensor surface (f32, rtol and
atol 1e-5 unless a case says otherwise); the thin layer classes over
them, with the reference's weights carried across; `interpolate` under
Paddle's coordinate rules (against the reference where its
`jax.image.resize` follows them, against a numpy form of the rules where
it does not: ROADMAP queue C); `embedding`'s `padding_idx`; `LayerDict`,
`ParameterList` and `SpectralNorm`; `sdp_kernel`; the namespaces'
completeness; and that the new modules import no JAX."""

import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.nn.functional as RF
import paddle_tpu_torch as port
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.convert import load_paddle_tpu_state

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.device._default = "cuda"


def F(*shape, lo=-2.0, hi=2.0):
    return ("f", shape, lo, hi)


def P(*shape):
    return F(*shape, lo=0.2, hi=2.0)


def U(*shape):
    return F(*shape, lo=-0.9, hi=0.9)


def I(*shape, lo=0, hi=5):  # noqa: E743
    return ("i", shape, lo, hi)


def S(*shape):
    """Signs, as float."""
    return ("s", shape, 0, 0)


def _make(spec, rng):
    if isinstance(spec, tuple) and spec and spec[0] in ("f", "i", "s"):
        kind, shape, lo, hi = spec
        if kind == "f":
            return rng.uniform(lo, hi, shape).astype(np.float32)
        if kind == "i":
            return rng.integers(lo, hi, shape).astype(np.int64)
        return np.where(rng.random(shape) > 0.5, 1.0, -1.0).astype(np.float32)
    return spec


class C:
    """One case: args (specs or values), kw, whether gradients are held,
    tolerances, and the name of the functional when it is not the key."""

    def __init__(self, *args, grad=True, rtol=1e-5, atol=1e-5, fn=None, **kw):
        self.args, self.kw, self.grad = list(args), kw, grad
        self.rtol, self.atol, self.fn = rtol, atol, fn


X = F(3, 4)
CASES = {
    # activations
    "elu": C(X, alpha=0.7), "leaky_relu": C(X), "leaky_relu_02":
    C(X, 0.2, fn="leaky_relu"), "sigmoid": C(X), "softplus": C(X),
    "softplus_beta": C(X, 2.0, 3.0, fn="softplus"),
    "relu6": C(F(3, 4, lo=-8, hi=8)), "selu": C(X), "celu": C(X, 1.3),
    "hardswish": C(F(3, 4, lo=-5, hi=5)),
    "hardsigmoid": C(F(3, 4, lo=-5, hi=5)), "hardtanh": C(X, -0.5, 0.7),
    "hardshrink": C(X), "softshrink": C(X, 0.3), "softsign": C(X),
    "tanhshrink": C(X), "log_sigmoid": C(X), "mish": C(X), "swish": C(X),
    "prelu": C(F(2, 3, 4, 4), F(3)), "prelu_one": C(X, F(1), fn="prelu"),
    "prelu_nhwc": C(F(2, 4, 4, 3), F(3), data_format="NHWC", fn="prelu"),
    "glu": C(F(3, 8)), "glu_axis0": C(F(4, 3), axis=0, fn="glu"),
    "maxout": C(F(2, 6, 3, 3), 2), "maxout_last": C(F(2, 3, 6), 3, axis=-1,
                                                     fn="maxout"),
    "thresholded_relu": C(X, 0.5),
    # common
    "one_hot": C(I(3, 4, hi=6), 6, grad=False),
    "label_smooth": C(U(3, 5), epsilon=0.2),
    "label_smooth_prior": C(U(3, 5), F(1, 5), epsilon=0.2, fn="label_smooth"),
    "pad": C(F(2, 3, 4, 4), [1, 2, 0, 1], value=0.5),
    "pad_reflect": C(F(2, 3, 4, 4), [1, 2, 2, 1], "reflect", fn="pad"),
    "pad_nhwc": C(F(2, 4, 4, 3), [1, 0, 2, 1], data_format="NHWC", fn="pad"),
    "upsample": C(F(1, 2, 4, 4), scale_factor=2, mode="bilinear"),
    "unfold": C(F(2, 3, 6, 6), 3, 2, 1, 1),
    "unfold_pads4": C(F(2, 2, 5, 6), [2, 3], 1, [1, 0, 2, 1], [1, 2],
                      fn="unfold"),
    "fold": C(F(2, 12, 16), [5, 5], 2),
    "fold_stride": C(F(1, 8, 16), [6, 6], [2, 2], 2, 1, fn="fold"),
    "cosine_similarity": C(X, F(3, 4)),
    "cosine_similarity_axis0": C(F(4, 5), F(4, 5), axis=0,
                                 fn="cosine_similarity"),
    "pixel_shuffle": C(F(1, 8, 3, 3), 2),
    "pixel_unshuffle": C(F(1, 2, 4, 6), 2),
    "channel_shuffle": C(F(1, 6, 2, 2), 3),
    "bilinear": C(F(3, 4), F(3, 5), F(6, 4, 5), F(1, 6)),
    "normalize": C(X), "normalize_l1": C(F(3, 4, 2), 1.0, 2, fn="normalize"),
    # the extras tail
    "affine_grid": C(F(2, 2, 3), [2, 3, 4, 5]),
    "affine_grid_half": C(F(2, 2, 3), [2, 3, 4, 5], False, fn="affine_grid"),
    "grid_sample": C(F(2, 3, 5, 6), U(2, 4, 3, 2)),
    "grid_sample_nearest": C(F(2, 3, 5, 6), U(2, 4, 3, 2), "nearest",
                             fn="grid_sample"),
    "grid_sample_border": C(F(2, 3, 5, 6), F(2, 4, 3, 2, lo=-1.3, hi=1.3),
                            padding_mode="border", align_corners=False,
                            fn="grid_sample"),
    "grid_sample_reflection": C(F(2, 3, 5, 6), F(2, 4, 3, 2, lo=-1.3, hi=1.3),
                                padding_mode="reflection", fn="grid_sample"),
    "pairwise_distance": C(X, F(3, 4)),
    "pairwise_distance_p1": C(X, F(3, 4), 1.0, keepdim=True,
                              fn="pairwise_distance"),
    "sequence_mask": C(I(4, lo=1, hi=6), 7, grad=False),
    "sequence_mask_auto": C(I(2, 3, lo=1, hi=6), grad=False,
                            fn="sequence_mask"),
    "zeropad2d": C(F(1, 2, 3, 3), [1, 2, 0, 1]),
    "temporal_shift": C(F(4, 8, 2, 2), 2, 0.25),
    "gather_tree": C(I(5, 2, 3, hi=9), I(5, 2, 3, hi=3), grad=False),
    "dice_loss": C(P(2, 3, 4), I(2, 3, 1, hi=4)),
    "gaussian_nll_loss": C(X, F(3, 4), P(3, 4), full=True),
    "gaussian_nll_loss_sum": C(X, F(3, 4), P(3, 4), reduction="sum",
                               fn="gaussian_nll_loss"),
    "poisson_nll_loss": C(X, P(3, 4)),
    "poisson_nll_loss_full": C(P(3, 4), P(3, 4), False, True,
                               fn="poisson_nll_loss"),
    "soft_margin_loss": C(X, S(3, 4)),
    "multi_label_soft_margin_loss": C(X, I(3, 4, hi=2), F(4)),
    "triplet_margin_with_distance_loss": C(X, F(3, 4), F(3, 4), swap=True),
    "triplet_margin_with_distance_loss_none": C(
        X, F(3, 4), F(3, 4), reduction="none",
        fn="triplet_margin_with_distance_loss"),
    "npair_loss": C(F(4, 5), F(4, 5), I(4, hi=3)),
    "flash_attn_qkvpacked": C(F(2, 8, 3, 2, 16), causal=True, rtol=1e-4,
                              atol=1e-4),
}

NEW_FUNCTIONALS = {c.fn or k for k, c in CASES.items()} | {"relu_",
                                                           "interpolate",
                                                           "sdp_kernel"}


def _run(pkg, case, name, arrays):
    fn = getattr(RF if pkg == "ref" else PF, case.fn or name)
    args = []
    for a in arrays:
        if isinstance(a, np.ndarray):
            if pkg == "ref":
                t = ref.to_tensor(a)
                if case.grad and a.dtype == np.float32:
                    t.stop_gradient = False
            else:
                t = torch.from_numpy(a.copy())
                if case.grad and a.dtype == np.float32:
                    t.requires_grad_()
            args.append(t)
        else:
            args.append(a)
    return fn(*args, **case.kw), args


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor)
                      else t.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_functional_holds_to_reference(name):
    case = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    arrays = [_make(a, rng) for a in case.args]
    r_out, r_args = _run("ref", case, name, arrays)
    p_out, p_args = _run("port", case, name, arrays)
    ro, po = _np(_first(r_out)), _np(_first(p_out))
    assert ro.shape == po.shape, name
    np.testing.assert_allclose(po.astype(np.float64), ro.astype(np.float64),
                               rtol=case.rtol, atol=case.atol, err_msg=name)
    if not case.grad:
        return
    w = np.random.default_rng(1).uniform(0.5, 1.5, ro.shape).astype(np.float32)
    (_first(r_out) * ref.to_tensor(w)).sum().backward()
    (_first(p_out) * torch.from_numpy(w)).sum().backward()
    for i, (a, b) in enumerate(zip(r_args, p_args)):
        if isinstance(b, torch.Tensor) and b.requires_grad:
            ga = np.zeros(b.shape, np.float32) if a.grad is None else \
                np.asarray(a.grad.numpy())
            gb = np.zeros(b.shape, np.float32) if b.grad is None else \
                b.grad.numpy()
            np.testing.assert_allclose(gb, ga, rtol=max(case.rtol, 1e-4),
                                       atol=max(case.atol, 1e-4),
                                       err_msg=f"{name} grad[{i}]")


def test_relu_in_place_returns_its_tensor():
    x = torch.tensor([-1.0, 0.5, 2.0])
    assert PF.relu_(x) is x
    np.testing.assert_array_equal(x.numpy(), [0.0, 0.5, 2.0])


# --------------------------------------------------------------------------- #
# interpolate under Paddle's rules
# --------------------------------------------------------------------------- #

def _np_src(n_in, n_out, mode, align_corners, align_mode):
    i = np.arange(n_out, dtype=np.float64)
    if align_corners:
        return i * ((n_in - 1) / (n_out - 1) if n_out > 1 else 0.0)
    if mode == "nearest" or align_mode == 1:
        return i * n_in / n_out
    return np.maximum((i + 0.5) * n_in / n_out - 0.5, 0.0)


def _np_resize(x, sizes, mode, align_corners=False, align_mode=0):
    """Paddle's interpolate rules on NC... numpy, axis by axis."""
    out = x.astype(np.float64)
    for k, n_out in enumerate(sizes):
        ax = 2 + k
        n_in = out.shape[ax]
        src = _np_src(n_in, n_out, mode, align_corners, align_mode)
        if mode == "nearest":
            idx = np.floor(src + 0.5 if align_corners else src).astype(int)
            out = np.take(out, np.minimum(idx, n_in - 1), axis=ax)
            continue
        lo = np.minimum(np.floor(src).astype(int), n_in - 1)
        hi = np.minimum(lo + 1, n_in - 1)
        shape = [1] * out.ndim
        shape[ax] = n_out
        wt = (src - lo).reshape(shape)
        out = np.take(out, lo, axis=ax) * (1 - wt) + np.take(out, hi,
                                                              axis=ax) * wt
    return out


INTERP = {
    # (input shape, kw, held to): "ref" where jax.image.resize follows
    # Paddle's rule (upsampling, half-pixel linear or integer nearest)
    "bilinear_up": ((2, 3, 4, 5), dict(size=[8, 10], mode="bilinear"), "ref"),
    "nearest_up2": ((2, 3, 4, 5), dict(scale_factor=2, mode="nearest"), "ref"),
    "linear_up": ((2, 3, 6), dict(size=[11], mode="linear",
                                  data_format="NCW"), "ref"),
    "trilinear_up": ((1, 2, 3, 4, 3), dict(size=[6, 5, 7], mode="trilinear",
                                           data_format="NCDHW"), "ref"),
    "bilinear_align_corners": ((2, 3, 4, 5), dict(size=[7, 9], mode="bilinear",
                                                  align_corners=True), "np"),
    "bilinear_align_mode1": ((2, 3, 4, 5), dict(size=[7, 9], mode="bilinear",
                                                align_mode=1), "np"),
    "bilinear_down": ((2, 3, 8, 9), dict(size=[3, 4], mode="bilinear"), "np"),
    "nearest_odd": ((2, 3, 4, 5), dict(size=[7, 9], mode="nearest"), "np"),
    "nearest_align_corners": ((2, 3, 4, 5), dict(size=[7, 9], mode="nearest",
                                                 align_corners=True), "np"),
    "bilinear_nhwc": ((2, 4, 5, 3), dict(size=[7, 9], mode="bilinear",
                                         data_format="NHWC"), "np"),
}


@pytest.mark.parametrize("name", sorted(INTERP))
def test_interpolate_follows_paddle_rules(name):
    shape, kw, held = INTERP[name]
    x = np.random.default_rng(zlib.crc32(name.encode())).uniform(
        -2, 2, shape).astype(np.float32)
    got = PF.interpolate(torch.from_numpy(x), **kw).numpy()
    if held == "ref":
        want = RF.interpolate(ref.to_tensor(x), **kw).numpy()
    else:
        last = not kw.get("data_format", "NCHW").startswith("NC")
        xx = np.moveaxis(x, -1, 1) if last else x
        want = _np_resize(xx, kw["size"], kw["mode"],
                          kw.get("align_corners", False),
                          kw.get("align_mode", 0))
        want = np.moveaxis(want, 1, -1) if last else want
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_interpolate_reference_fault_is_the_align_corners_rule():
    """The queue C fault, pinned: the reference's `jax.image.resize`
    ignores align_corners, so it misses Paddle's rule, which the port
    follows."""
    x = np.random.default_rng(0).uniform(-2, 2, (1, 1, 4, 5)).astype(
        np.float32)
    kw = dict(size=[7, 9], mode="bilinear", align_corners=True)
    want = _np_resize(x, [7, 9], "bilinear", True)
    r = RF.interpolate(ref.to_tensor(x), **kw).numpy()
    p = PF.interpolate(torch.from_numpy(x), **kw).numpy()
    assert np.abs(r - want).max() > 1e-2
    np.testing.assert_allclose(p, want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# the layer classes
# --------------------------------------------------------------------------- #

LAYERS = {
    # name: (args, kw, input shapes)
    "ReLU6": ((), {}, [(3, 4)]), "LeakyReLU": ((0.2,), {}, [(3, 4)]),
    "ELU": ((0.5,), {}, [(3, 4)]), "SELU": ((), {}, [(3, 4)]),
    "CELU": ((1.5,), {}, [(3, 4)]), "Swish": ((), {}, [(3, 4)]),
    "Mish": ((), {}, [(3, 4)]), "Hardswish": ((), {}, [(3, 4)]),
    "Hardsigmoid": ((), {}, [(3, 4)]), "Hardtanh": ((-0.5, 0.8), {}, [(3, 4)]),
    "Hardshrink": ((0.4,), {}, [(3, 4)]), "Softshrink": ((0.3,), {}, [(3, 4)]),
    "Tanhshrink": ((), {}, [(3, 4)]), "Softplus": ((2.0, 5.0), {}, [(3, 4)]),
    "Softsign": ((), {}, [(3, 4)]), "PReLU": ((3, 0.1), {}, [(2, 3, 4)]),
    "Softmax": ((0,), {}, [(3, 4)]), "LogSoftmax": ((), {}, [(3, 4)]),
    "Sigmoid": ((), {}, [(3, 4)]), "LogSigmoid": ((), {}, [(3, 4)]),
    "GLU": ((), {}, [(3, 4)]), "Maxout": ((2,), {}, [(2, 4, 3)]),
    "ThresholdedReLU": ((0.5,), {}, [(3, 4)]),
    "Upsample": ((), dict(size=[6, 8], mode="bilinear"), [(1, 2, 3, 4)]),
    "UpsamplingNearest2D": ((), dict(scale_factor=2), [(1, 2, 3, 4)]),
    "Pad1D": (([1, 2],), {}, [(2, 3, 4)]),
    "Pad2D": (([1, 2, 0, 1],), dict(mode="replicate"), [(2, 3, 4, 4)]),
    "Pad3D": (([1, 0, 0, 1, 2, 1],), dict(value=0.5), [(1, 2, 3, 3, 3)]),
    "ZeroPad2D": (([1, 1, 2, 0],), {}, [(1, 2, 3, 3)]),
    "CosineSimilarity": ((), {}, [(3, 4), (3, 4)]),
    "Bilinear": ((4, 5, 6), {}, [(3, 4), (3, 5)]),
    "Unfold": ((2,), {}, [(1, 2, 4, 4)]),
    "Fold": (([4, 4], 2), {}, [(1, 8, 9)]),
    "PixelShuffle": ((2,), {}, [(1, 8, 2, 3)]),
    "PixelUnshuffle": ((2,), {}, [(1, 2, 4, 6)]),
    "ChannelShuffle": ((2,), {}, [(1, 4, 2, 2)]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_holds_to_reference(name):
    args, kw, shapes = LAYERS[name]
    ref.seed(0)
    rl = getattr(ref.nn, name)(*args, **kw)
    pl = getattr(port.nn, name)(*args, **kw)
    load_paddle_tpu_state(pl, {k: np.asarray(v.numpy())
                               for k, v in rl.state_dict().items()})
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    xs = [rng.uniform(-2, 2, s).astype(np.float32) for s in shapes]
    want = rl(*[ref.to_tensor(x) for x in xs]).numpy()
    got = pl(*[torch.from_numpy(x) for x in xs]).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_upsampling_bilinear_takes_align_corners():
    x = np.random.default_rng(2).uniform(-2, 2, (1, 2, 3, 4)).astype(
        np.float32)
    got = port.nn.UpsamplingBilinear2D(scale_factor=2)(
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _np_resize(x, [6, 8], "bilinear", True),
                               rtol=1e-5, atol=1e-5)


def test_embedding_padding_idx():
    """The padding row is zero at build, comes out zero, and takes no
    gradient, as the reference's; a negative index counts from the end."""
    ref.seed(0)
    re_ = ref.nn.Embedding(10, 4, padding_idx=-2)
    pe = port.nn.Embedding(10, 4, padding_idx=-2, sparse=True)
    assert bool((pe.weight[8] == 0).all())
    load_paddle_tpu_state(pe, {"weight": np.asarray(re_.weight.numpy())})
    ids = np.array([[1, 8, 3], [8, 0, 9]])
    want = re_(ref.to_tensor(ids))
    got = pe(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=1e-6)
    got.sum().backward()
    assert bool((pe.weight.grad[8] == 0).all())
    assert bool((pe.weight.grad[1] == 1).all())
    w = torch.randn(10, 4)
    out = PF.embedding(torch.tensor([8, 2]), w, padding_idx=8)
    assert bool((out[0] == 0).all()) and torch.equal(out[1], w[2])


def test_layer_dict_and_parameter_list_names():
    rd = ref.nn.LayerDict({"a": ref.nn.Linear(2, 3), "b": ref.nn.ReLU()})
    pd = port.nn.LayerDict([("a", port.nn.Linear(2, 3)),
                            ("b", port.nn.ReLU())])
    assert list(pd.state_dict()) == list(rd.state_dict())
    assert list(pd.keys()) == ["a", "b"] and "a" in pd and len(pd) == 2
    rp = ref.nn.ParameterList([ref.create_parameter([2], "float32"),
                               ref.create_parameter([3], "float32")])
    pp = port.nn.ParameterList([port.create_parameter([2], "float32"),
                                port.create_parameter([3], "float32")])
    assert list(pp.state_dict()) == list(rp.state_dict()) == ["0", "1"]
    assert pp[-1].shape == (3,)


def test_spectral_norm_layer_holds_to_reference():
    ref.seed(0)
    rl = ref.nn.SpectralNorm([6, 4, 3], dim=1, power_iters=3)
    pl = port.nn.SpectralNorm([6, 4, 3], dim=1, power_iters=3)
    assert not pl.weight_u.requires_grad and pl.weight_v.shape == (18,)
    load_paddle_tpu_state(pl, {k: np.asarray(v.numpy())
                               for k, v in rl.state_dict().items()})
    w = np.random.default_rng(5).normal(size=(6, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(pl(torch.from_numpy(w)).numpy(),
                               rl(ref.to_tensor(w)).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_sdp_kernel_keeps_the_kernel_route():
    with PF.sdp_kernel(enable_flash=True, enable_math=False) as k:
        assert k.enable_flash
    with pytest.raises(NotImplementedError, match="no switch away"):
        PF.sdp_kernel(enable_flash=False)


# --------------------------------------------------------------------------- #
# the namespaces and the import rule
# --------------------------------------------------------------------------- #

ITEM8 = {"BiRNN", "GRU", "GRUCell", "LSTM", "LSTMCell", "RNN", "RNNCellBase",
         "SimpleRNN", "SimpleRNNCell", "rnn", "LocalResponseNorm",
         "local_response_norm"}


def test_namespaces_expose_every_reference_name():
    """Every public name of the reference's nn and nn.functional is in the
    port's, but ROADMAP's item 8 (the rnn classes, LocalResponseNorm); the
    unpool, lp and fractional pools and ctc_loss are there and raise
    naming item 8."""
    for rmod, pmod in ((ref.nn, port.nn), (RF, PF)):
        missing = {n for n in dir(rmod) if not n.startswith("_")} - set(
            dir(pmod)) - ITEM8
        assert not missing, missing
    assert port.ParamAttr is port.nn.ParamAttr
    assert {"L1Decay", "L2Decay"} <= set(dir(port.regularizer))
    assert NEW_FUNCTIONALS <= set(PF.__all__)
    with pytest.raises(NotImplementedError, match="item 8"):
        PF.lp_pool2d(torch.zeros(1, 1, 4, 4), 2, 2)


def test_new_modules_import_no_jax():
    """The nn surface's modules, imported first in a fresh interpreter,
    load no jax and nothing of the JAX package."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch.nn.initializer\n"
        "import paddle_tpu_torch.nn.utils\n"
        "import paddle_tpu_torch.nn.quant\n"
        "import paddle_tpu_torch.regularizer\n"
        "import paddle_tpu_torch.nn.functional.extras\n"
        "from paddle_tpu_torch import ParamAttr\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib') or n == 'paddle_tpu' or n.startswith('paddle_tpu.'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
