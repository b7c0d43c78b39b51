"""The port's `group_norm`, `instance_norm` and loss functionals
(`paddle_tpu_torch.nn.functional`) held to the JAX package's on the CPU in
f32: group norm over "NC*" and "N*C" layouts (1-D, 2-D and 3-D positions),
instance norm with and without an affine, and every ported loss over each
reduction; the layers (`GroupNorm`, `InstanceNorm*D`, the loss classes)
against their functionals; `GroupNorm` under O2 (bf16 parameters after
`amp.decorate`, f32 output); `CTCLoss` and `ctc_loss` raising.

The JAX results are computed once for the module."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as F

# f32 on both sides: means, variances and sums over at most a few hundred
# values of O(1), taken in other orders: a few ulps
TOL = dict(rtol=1e-5, atol=1e-6)
REDUCTIONS = ("mean", "sum", "none")


def _rng(name):
    return np.random.default_rng(sum(map(ord, name)))


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# name: (x shape, groups, data_format); the channels are at dim 1 ("NC*")
# or last ("N*C")
GROUP_CASES = {
    "nchw_g4": ((2, 8, 5, 3), 4, "NCHW"),
    "nhwc_g2": ((2, 5, 3, 8), 2, "NHWC"),
    "ncl_g3": ((3, 6, 7), 3, "NCL"),
    "nlc_per_channel": ((3, 7, 6), 6, "NLC"),
    "ncdhw_g1": ((2, 4, 3, 2, 2), 1, "NCDHW"),
}
# name: (x shape, affine)
INSTANCE_CASES = {"1d": ((2, 4, 6), True), "2d": ((2, 3, 4, 5), True),
                  "3d_no_affine": ((2, 3, 2, 3, 2), False)}


def _group_args(name):
    shape, g, fmt = GROUP_CASES[name]
    rng = _rng(name)
    c = shape[1] if fmt.startswith("NC") else shape[-1]
    return (_normal(rng, *shape) * 3 + 1, g, _normal(rng, c), _normal(rng, c),
            fmt)


def _instance_args(name):
    shape, affine = INSTANCE_CASES[name]
    rng = _rng(name)
    x = _normal(rng, *shape) * 2 - 1
    if not affine:
        return x, None, None
    return x, _normal(rng, shape[1]), _normal(rng, shape[1])


def _labels_pm1(rng, n):
    return np.where(rng.random(n) > 0.5, 1.0, -1.0).astype(np.float32)


def _loss_inputs(name):
    """(positional arrays, keyword arguments) of a LOSS_CASES case."""
    rng = _rng(name)
    if name.startswith(("mse", "l1", "smooth_l1", "square_error")):
        return (_normal(rng, 4, 5), _normal(rng, 4, 5)), {}
    if name.startswith("nll"):
        shape = (6, 5, 3) if "spatial" in name else (6, 5)
        logp = np.log(np.abs(_normal(rng, *shape)) + 0.1).astype(np.float32)
        lab = rng.integers(0, 5, (shape[0],) + shape[2:])
        lab.reshape(-1)[1] = -100
        kw = {"weight": np.abs(_normal(rng, 5)) + 0.5} if "weight" in name else {}
        return (logp, lab), kw
    if name.startswith("bce_logits"):
        kw = {"weight": np.abs(_normal(rng, 4, 3)),
              "pos_weight": np.abs(_normal(rng, 3)) + 0.5} if "weights" in name else {}
        return (_normal(rng, 4, 3) * 4, rng.random((4, 3)).astype(np.float32)), kw
    if name.startswith("bce"):
        p = rng.random((4, 3)).astype(np.float32)
        p[0, 0] = 0.0  # clipped at 1e-12
        kw = {"weight": np.abs(_normal(rng, 4, 3))} if "weight" in name else {}
        return (p, (rng.random((4, 3)) > 0.5).astype(np.float32)), kw
    if name.startswith("kl_div"):
        logp = np.log(rng.dirichlet(np.ones(5), 4)).astype(np.float32)
        tgt = rng.dirichlet(np.ones(5), 4).astype(np.float32)
        tgt[1, 2] = 0.0  # a zero target contributes 0
        if "log_target" in name:
            return (logp, np.log(tgt + 1e-3).astype(np.float32)), {"log_target": True}
        return (logp, tgt), {}
    if name.startswith("margin_ranking"):
        return (_normal(rng, 7), _normal(rng, 7), _labels_pm1(rng, 7)), {"margin": 0.3}
    if name.startswith("cosine"):
        return (_normal(rng, 6, 4), _normal(rng, 6, 4), _labels_pm1(rng, 6)), {"margin": 0.2}
    if name.startswith("triplet"):
        kw = {"p": 1.0, "swap": True} if "p1_swap" in name else {"margin": 0.5}
        return (_normal(rng, 5, 4), _normal(rng, 5, 4), _normal(rng, 5, 4)), kw
    if name.startswith("hinge"):
        return (_normal(rng, 8), _labels_pm1(rng, 8)), {"margin": 0.7}
    if name.startswith("log_loss"):
        return (rng.random((4, 3)).astype(np.float32),
                (rng.random((4, 3)) > 0.5).astype(np.float32)), {}
    raise KeyError(name)


# name: the functional, and whether it takes `reduction`
LOSS_CASES = {
    "mse": ("mse_loss", True), "l1": ("l1_loss", True),
    "nll": ("nll_loss", True), "nll_weight": ("nll_loss", True),
    "nll_spatial": ("nll_loss", True),
    "bce": ("binary_cross_entropy", True),
    "bce_weight": ("binary_cross_entropy", True),
    "bce_logits": ("binary_cross_entropy_with_logits", True),
    "bce_logits_weights": ("binary_cross_entropy_with_logits", True),
    "smooth_l1": ("smooth_l1_loss", True), "kl_div": ("kl_div", True),
    "kl_div_log_target": ("kl_div", True),
    "margin_ranking": ("margin_ranking_loss", True),
    "cosine_embedding": ("cosine_embedding_loss", True),
    "triplet": ("triplet_margin_loss", True),
    "triplet_p1_swap": ("triplet_margin_loss", True),
    "hinge_embedding": ("hinge_embedding_loss", True),
    "square_error_cost": ("square_error_cost", False),
    "log_loss": ("log_loss", False),
}
LOSS_RUNS = [(n, r) for n, (_, red) in LOSS_CASES.items()
             for r in (REDUCTIONS + (("batchmean",) if n.startswith("kl_div") else ())
                       if red else (None,))]


def _call(mod, name, red, to):
    fn, _ = LOSS_CASES[name]
    args, kw = _loss_inputs(name)
    kw = {k: to(v) for k, v in kw.items()}
    if red is not None:
        kw["reduction"] = red
    return getattr(mod, fn)(*(to(a) for a in args), **kw)


def _jt(a):
    return paddle.to_tensor(a) if isinstance(a, np.ndarray) else a


def _tt(a):
    return torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a


@pytest.fixture(scope="module")
def jax_refs():
    refs = {}
    for name in GROUP_CASES:
        x, g, w, b, fmt = _group_args(name)
        refs["group", name] = JF.group_norm(_jt(x), g, 1e-5, _jt(w), _jt(b),
                                            fmt).numpy()
    for name in INSTANCE_CASES:
        x, w, b = _instance_args(name)
        refs["instance", name] = JF.instance_norm(
            _jt(x), weight=None if w is None else _jt(w),
            bias=None if b is None else _jt(b), eps=1e-5).numpy()
    for name, red in LOSS_RUNS:
        refs[name, red] = np.asarray(_call(JF, name, red, _jt).numpy())
    return refs


@pytest.mark.parametrize("name", list(GROUP_CASES))
def test_group_norm_matches_jax(name, jax_refs):
    x, g, w, b, fmt = _group_args(name)
    got = F.group_norm(_tt(x), g, 1e-5, _tt(w), _tt(b), fmt)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), jax_refs["group", name], **TOL)


@pytest.mark.parametrize("name", list(INSTANCE_CASES))
def test_instance_norm_matches_jax(name, jax_refs):
    x, w, b = _instance_args(name)
    got = F.instance_norm(_tt(x), weight=_tt(w), bias=_tt(b), eps=1e-5)
    np.testing.assert_allclose(got.numpy(), jax_refs["instance", name], **TOL)


@pytest.mark.parametrize("name,red", LOSS_RUNS)
def test_loss_matches_jax(name, red, jax_refs):
    got = _call(F, name, red, _tt)
    want = jax_refs[name, red]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_norm_layers_start_at_one_and_zero_and_call_their_functionals():
    x = torch.from_numpy(_group_args("nchw_g4")[0])
    gn = pnn.GroupNorm(4, 8, device="cpu")
    assert gn.weight.eq(1).all() and gn.bias.eq(0).all()
    torch.testing.assert_close(gn(x), F.group_norm(x, 4, 1e-5, gn.weight, gn.bias))
    assert pnn.GroupNorm(2, 8, weight_attr=False, device="cpu").weight is None
    with pytest.raises(ValueError, match="groups"):
        pnn.GroupNorm(3, 8, device="cpu")
    for cls, shape in ((pnn.InstanceNorm1D, (2, 4, 6)),
                       (pnn.InstanceNorm2D, (2, 4, 3, 5)),
                       (pnn.InstanceNorm3D, (2, 4, 2, 3, 2))):
        layer = cls(4, device="cpu")
        assert layer.weight.eq(1).all() and layer.bias.eq(0).all()
        xi = torch.randn(*shape)
        torch.testing.assert_close(layer(xi), F.instance_norm(
            xi, weight=layer.weight, bias=layer.bias))
        assert cls(4, weight_attr=False, device="cpu").bias is None


def test_group_norm_under_o2_keeps_bf16_parameters_and_f32_output():
    """`amp.decorate` casts GroupNorm's parameters to bf16 (it keeps only
    LayerNorm and the batch norms in f32, as the reference's); group_norm
    is on the black list, so under O2 it computes in f32 from the bf16
    input and returns f32, and its gradients reach the bf16 parameters."""
    model = torch.nn.Sequential(pnn.Conv2D(3, 8, 3, padding=1, device="cpu"),
                                pnn.GroupNorm(4, 8, device="cpu"),
                                pnn.LayerNorm(5, device="cpu"))
    amp.decorate(model, level="O2", dtype="bfloat16")
    gn, ln = model[1], model[2]
    assert gn.weight.dtype == gn.bias.dtype == torch.bfloat16
    assert ln.weight.dtype == torch.float32
    x = torch.randn(2, 3, 5, 5)
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        h = model[0](x)
        out = gn(h)
    assert h.dtype == torch.bfloat16 and out.dtype == torch.float32
    ref = F.group_norm(h.float(), 4, 1e-5, gn.weight.float(), gn.bias.float())
    torch.testing.assert_close(out, ref)
    out.square().sum().backward()
    assert gn.weight.grad.dtype == torch.bfloat16
    assert gn.weight.grad.abs().sum() > 0


# layer: (functional case, constructor keywords)
LOSS_LAYERS = {
    "MSELoss": ("mse", {}), "L1Loss": ("l1", {}), "NLLLoss": ("nll_weight", {}),
    "BCELoss": ("bce_weight", {}), "BCEWithLogitsLoss": ("bce_logits_weights", {}),
    "SmoothL1Loss": ("smooth_l1", {"delta": 0.5}),
    "KLDivLoss": ("kl_div_log_target", {"log_target": True}),
    "MarginRankingLoss": ("margin_ranking", {"margin": 0.3}),
    "CosineEmbeddingLoss": ("cosine_embedding", {"margin": 0.2}),
    "TripletMarginLoss": ("triplet_p1_swap", {"p": 1.0, "swap": True}),
    "HingeEmbeddingLoss": ("hinge_embedding", {"margin": 0.7}),
}


@pytest.mark.parametrize("layer", list(LOSS_LAYERS))
def test_loss_layers_call_their_functionals(layer):
    case, kw = LOSS_LAYERS[layer]
    args, fkw = _loss_inputs(case)
    weights = {k: _tt(v) for k, v in fkw.items() if k in ("weight", "pos_weight")}
    for red in ("sum", "none"):
        got = getattr(pnn, layer)(reduction=red, **weights, **kw)(
            *(_tt(a) for a in args))
        want = getattr(F, LOSS_CASES[case][0])(
            *(_tt(a) for a in args), reduction=red, **weights, **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cross_entropy_loss_and_the_exports():
    logits = torch.randn(6, 5)
    lab = torch.tensor([0, 4, -100, 2, 1, 3])
    torch.testing.assert_close(pnn.CrossEntropyLoss()(logits, lab),
                               F.cross_entropy(logits, lab))
    for name in ("GroupNorm", "InstanceNorm1D", "MSELoss", "CrossEntropyLoss",
                 "CTCLoss"):
        assert name in pnn.__all__
    for name in ("group_norm", "instance_norm", "mse_loss", "nll_loss",
                 "square_error_cost", "ctc_loss"):
        assert name in F.__all__


def test_ctc_loss_raises_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 8"):
        pnn.CTCLoss()
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 8"):
        F.ctc_loss(torch.zeros(3, 1, 4), torch.zeros(1, 2), torch.tensor([3]),
                   torch.tensor([2]))
