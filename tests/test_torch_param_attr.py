"""`ParamAttr` and the regularizers of the port held to `paddle_tpu` on the
CPU:

- the signature walk: every layer class that the two packages' `nn`,
  their mp layers and their `incubate.nn` share takes the reference's
  positional parameters, in order, up to the first keyword-only one;
- `ParamAttr` through every layer that creates parameters (nn, the mp
  layers, the fused incubate layers): each parameter's learning-rate
  factor, regularizer, need_clip and trainability equal the reference
  layer's under the same attributes, its initializer the attribute's
  (where the reference's layer default wins instead, the fault is pinned:
  ROADMAP queue C), and False drops the parameter;
- the eager step over SGD, Momentum, Adam and AdamW, 3 steps: each
  parameter's regularizer added before the global-norm clip and in place
  of the weight decay, its rate scaled, need_clip honoured, held to the
  reference's eager step (f32, rtol 1e-5); the port's compiled step
  (`jit.TrainStep`) held to the reference's compiled step where that is
  right (regularizers only) and to the reference's eager step where it is
  not (the rate factor and need_clip, which its compiled step ignores);
- the reference's two faults pinned (its compiled step moves a
  learning-rate-0 parameter; `weight_decay=L2Decay(...)` fails at its
  first step), and the port's refusal of the second."""

import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.distributed.fleet.layers.mpu as RM
import paddle_tpu.incubate.nn as RIN
import paddle_tpu.optimizer as ropt
from paddle_tpu.jit import TrainStep as RefTrainStep
import paddle_tpu_torch as port
import paddle_tpu_torch.distributed.fleet.layers.mpu as PM
import paddle_tpu_torch.incubate.nn as PIN
import paddle_tpu_torch.optimizer as popt
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.jit import TrainStep as PortTrainStep


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.device._default = "cuda"


# --------------------------------------------------------------------------- #
# the signature walk
# --------------------------------------------------------------------------- #

def _positional(cls):
    out = []
    for n, p in inspect.signature(cls.__init__).parameters.items():
        if n == "self":
            continue
        if p.kind in (p.KEYWORD_ONLY, p.VAR_KEYWORD):
            break
        out.append(("*" if p.kind == p.VAR_POSITIONAL else "") + n)
    return out


def _shared_classes():
    pairs = []
    for rmod, pmod in ((ref.nn, port.nn), (RM, PM), (RIN, PIN)):
        for name in sorted(set(dir(rmod)) & set(dir(pmod))):
            a, b = getattr(rmod, name), getattr(pmod, name)
            if inspect.isclass(a) and inspect.isclass(b) and name != "ParamAttr":
                pairs.append((f"{pmod.__name__}.{name}", a, b))
    return pairs


SHARED = _shared_classes()


def test_the_walk_covers_the_layers():
    names = {n.rsplit(".", 1)[1] for n, _, _ in SHARED}
    assert {"Linear", "Embedding", "RMSNorm", "ColumnParallelLinear",
            "RowParallelLinear", "VocabParallelEmbedding", "Conv2D",
            "FusedMultiTransformer", "PReLU", "LayerDict"} <= names
    assert len(SHARED) > 100


@pytest.mark.parametrize("name,rcls,pcls", SHARED, ids=[n for n, _, _ in SHARED])
def test_positional_parameters_are_the_references(name, rcls, pcls):
    assert _positional(pcls) == _positional(rcls)


# --------------------------------------------------------------------------- #
# ParamAttr through every layer
# --------------------------------------------------------------------------- #

def _attrs(pkg):
    I, R = pkg.nn.initializer, pkg.regularizer
    w = pkg.ParamAttr(initializer=I.Constant(0.3), learning_rate=0.5,
                      regularizer=R.L2Decay(0.1), need_clip=False)
    b = pkg.ParamAttr(initializer=I.Constant(-0.2), learning_rate=2.0,
                      regularizer=R.L1Decay(0.05), trainable=False)
    return w, b


def _wb(w, b):
    return dict(weight_attr=w, bias_attr=b)


# name: constructor(package, weight attribute, bias attribute)
LAYERS = {
    "Linear": lambda k, w, b: k.nn.Linear(4, 6, w, b),
    "Embedding": lambda k, w, b: k.nn.Embedding(10, 4, weight_attr=w),
    "LayerNorm": lambda k, w, b: k.nn.LayerNorm(6, **_wb(w, b)),
    "RMSNorm": lambda k, w, b: k.nn.RMSNorm(6, weight_attr=w),
    "BatchNorm1D": lambda k, w, b: k.nn.BatchNorm1D(6, **_wb(w, b)),
    "BatchNorm2D": lambda k, w, b: k.nn.BatchNorm2D(6, **_wb(w, b)),
    "BatchNorm3D": lambda k, w, b: k.nn.BatchNorm3D(6, **_wb(w, b)),
    "GroupNorm": lambda k, w, b: k.nn.GroupNorm(2, 6, **_wb(w, b)),
    "InstanceNorm2D": lambda k, w, b: k.nn.InstanceNorm2D(6, **_wb(w, b)),
    "Conv1D": lambda k, w, b: k.nn.Conv1D(3, 6, 3, **_wb(w, b)),
    "Conv2D": lambda k, w, b: k.nn.Conv2D(3, 6, 3, **_wb(w, b)),
    "Conv3D": lambda k, w, b: k.nn.Conv3D(3, 6, 3, **_wb(w, b)),
    "MultiHeadAttention": lambda k, w, b: k.nn.MultiHeadAttention(
        8, 2, **_wb(w, b)),
    "TransformerEncoderLayer": lambda k, w, b: k.nn.TransformerEncoderLayer(
        8, 2, 16, **_wb(w, b)),
    "TransformerDecoderLayer": lambda k, w, b: k.nn.TransformerDecoderLayer(
        8, 2, 16, **_wb(w, b)),
    "Transformer": lambda k, w, b: k.nn.Transformer(8, 2, 1, 1, 16,
                                                    **_wb(w, b)),
    "PReLU": lambda k, w, b: k.nn.PReLU(6, weight_attr=w),
    "Bilinear": lambda k, w, b: k.nn.Bilinear(3, 4, 5, w, b),
    "ColumnParallelLinear": lambda k, w, b: _mpu(k).ColumnParallelLinear(
        4, 6, w),
    "RowParallelLinear": lambda k, w, b: _mpu(k).RowParallelLinear(4, 6, w),
    "VocabParallelEmbedding": lambda k, w, b: _mpu(
        k).VocabParallelEmbedding(10, 4, w),
    "FusedMultiHeadAttention": lambda k, w, b: _inn(k).FusedMultiHeadAttention(
        8, 2, qkv_weight_attr=w, qkv_bias_attr=b, linear_weight_attr=w,
        linear_bias_attr=b, ln_scale_attr=w, ln_bias_attr=b),
    "FusedFeedForward": lambda k, w, b: _inn(k).FusedFeedForward(
        8, 16, linear1_weight_attr=w, linear1_bias_attr=b,
        linear2_weight_attr=w, linear2_bias_attr=b, ln2_scale_attr=w,
        ln2_bias_attr=b),
    "FusedTransformerEncoderLayer": lambda k, w, b: _inn(
        k).FusedTransformerEncoderLayer(8, 2, 16, weight_attr=w, bias_attr=b),
    "FusedBiasDropoutResidualLayerNorm": lambda k, w, b: _inn(
        k).FusedBiasDropoutResidualLayerNorm(8, weight_attr=w, bias_attr=b),
}
# the reference's create_parameter takes default_initializer before
# attr.initializer (paddle_tpu/nn/layer/layers.py:150): these parameters
# keep the layer's default there, where Paddle and the port take the
# attribute's initializer
REF_DEFAULT_WINS = ("norm", "_mean", "_variance", "prelu", "ln_scale",
                    "ln1_scale", "ln2_scale", "_scale")


def _mpu(pkg):
    return RM if pkg is ref else PM


def _inn(pkg):
    return RIN if pkg is ref else PIN


def _desc(p, ref_side):
    reg = p.regularizer
    lr = p.optimize_attr.get("learning_rate")
    trainable = (not p.stop_gradient) if ref_side else p.requires_grad
    return (lr, type(reg).__name__ if reg is not None else None,
            getattr(reg, "_coeff", None), bool(getattr(p, "need_clip", True)),
            trainable)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_param_attr_through_layer(name):
    mk = LAYERS[name]
    ref.seed(0)
    rl = mk(ref, *_attrs(ref))
    pl = mk(port, *_attrs(port))
    rp = dict(rl.named_parameters())
    pp = dict(pl.named_parameters())
    assert sorted(pp) == sorted(rp)
    for k, p in pp.items():
        assert _desc(p, False) == _desc(rp[k], True), k
        lr = p.optimize_attr["learning_rate"]
        if lr == 1.0:
            continue   # a parameter the layer makes without an attribute
        is_bias = lr == 2.0
        want = -0.2 if is_bias else 0.3
        assert bool((p == want).all()), (k, p)
        r = np.asarray(rp[k].numpy())
        if any(t in k.lower() or t in name.lower() for t in REF_DEFAULT_WINS) \
                and not is_bias:
            # the reference fault: its layer default wins
            assert not np.all(r == want), k
        else:
            np.testing.assert_array_equal(r, p.detach().numpy(), err_msg=k)


def test_false_drops_the_parameter_and_invalid_attr_raises():
    assert port.nn.Linear(4, 6, bias_attr=False).bias is None
    conv = port.nn.Conv2D(3, 6, 3, bias_attr=False)
    assert conv.bias is None and "bias" not in conv.state_dict()
    ln = port.nn.LayerNorm(6, weight_attr=False)
    assert ln.weight is None and list(ln.state_dict()) == ["bias"]
    with pytest.raises(TypeError, match="ParamAttr"):
        port.nn.Linear(4, 6, weight_attr=3.5)
    P = port.ParamAttr
    assert P._to_attr(None).learning_rate == 1.0
    assert P._to_attr("w").name == "w"
    init = port.nn.initializer.Normal()
    assert P._to_attr(init).initializer is init
    assert P._to_attr(False) is False
    lin = port.nn.Linear(4, 6, "fc.w")
    assert lin.weight.name == "fc.w"


def test_fused_multi_transformer_stacked_attrs():
    """One attribute a stacked [L, ...] parameter: a ParamAttr, or a list
    of one a layer whose entries agree (the list's length gives
    num_layers); lists that differ raise."""
    w = port.ParamAttr(learning_rate=0.25)
    m = PIN.FusedMultiTransformer(8, 2, 16, qkv_weight_attrs=[w, w],
                                  ffn1_bias_attrs=port.ParamAttr(
                                      need_clip=False))
    assert m.num_layers == 2 and m.qkv_weight.shape[0] == 2
    assert m.qkv_weight.optimize_attr["learning_rate"] == 0.25
    assert m.ffn1_bias.need_clip is False
    with pytest.raises(ValueError, match="differ"):
        PIN.FusedMultiTransformer(8, 2, 16, qkv_weight_attrs=[
            w, port.ParamAttr(learning_rate=0.5)])


# --------------------------------------------------------------------------- #
# the optimizers
# --------------------------------------------------------------------------- #

def _mlp(pkg):
    """fc1 (L2Decay on the weight, rate 0.5 on the bias), fc2 (L1Decay,
    need_clip False on the weight, rate 0 on the bias)."""
    R = pkg.regularizer
    P = pkg.ParamAttr
    fc1 = pkg.nn.Linear(6, 8, P(regularizer=R.L2Decay(0.05)),
                        P(learning_rate=0.5))
    fc2 = pkg.nn.Linear(8, 3, P(regularizer=R.L1Decay(0.01), need_clip=False),
                        P(learning_rate=0.0))
    return pkg.nn.Sequential(fc1, pkg.nn.ReLU(), fc2)


def _pair(regularizers_only=False):
    ref.seed(0)
    rm = _mlp(ref)
    pm = _mlp(port)
    if regularizers_only:
        for m in (rm, pm):
            for p in m.parameters():
                p.optimize_attr["learning_rate"] = 1.0
                p.need_clip = True
    load_paddle_tpu_state(pm, {k: np.asarray(v.numpy())
                               for k, v in rm.state_dict().items()})
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    y = rng.normal(size=(5, 3)).astype(np.float32)
    return rm, pm, x, y


OPTS = {
    "SGD": dict(learning_rate=0.1, weight_decay=0.01),
    "Momentum": dict(learning_rate=0.1, momentum=0.9, weight_decay=0.01),
    "Adam": dict(learning_rate=0.01, weight_decay=0.01),
    "AdamW": dict(learning_rate=0.01, weight_decay=0.01),
}
CLIP = 0.1


def _ref_eager(rm, x, y, opt_name, steps=3):
    opt = getattr(ropt, opt_name)(parameters=rm.parameters(),
                                  grad_clip=ref.nn.ClipGradByGlobalNorm(CLIP),
                                  **OPTS[opt_name])
    out = []
    for _ in range(steps):
        loss = ((rm(ref.to_tensor(x)) - ref.to_tensor(y)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append({k: np.asarray(v.numpy()) for k, v in rm.state_dict().items()})
    return out


def _port_opt(pm, opt_name):
    return getattr(popt, opt_name)(parameters=pm.parameters(),
                                   grad_clip=port.nn.ClipGradByGlobalNorm(CLIP),
                                   **OPTS[opt_name])


def _mse(o, t):
    return ((o - t) ** 2).mean()


def _close(got, want, what, atol=1e-7):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("opt_name", sorted(OPTS))
def test_eager_step_holds_to_reference_eager(opt_name):
    rm, pm, x, y = _pair()
    want = _ref_eager(rm, x, y, opt_name)
    opt = _port_opt(pm, opt_name)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    b0 = pm[2].bias.detach().clone()
    for i in range(3):
        _mse(pm(xt), yt).backward()
        opt.step()
        opt.clear_grad()
        _close({k: v.detach().numpy() for k, v in pm.state_dict().items()},
               want[i], f"{opt_name} step {i + 1}")
    assert torch.equal(pm[2].bias.detach(), b0)


@pytest.mark.parametrize("opt_name", sorted(OPTS))
def test_compiled_step_holds_to_reference_eager(opt_name):
    """The rate factor, rate 0 bit for bit, and need_clip on the port's
    TrainStep, held to the reference's eager step (its compiled step
    ignores both: queue C)."""
    rm, pm, x, y = _pair()
    want = _ref_eager(rm, x, y, opt_name)
    step = PortTrainStep(pm, _mse, _port_opt(pm, opt_name))
    b0 = pm[2].bias.detach().clone()
    for i in range(3):
        step(torch.from_numpy(x), torch.from_numpy(y))
        _close({k: v.detach().numpy() for k, v in pm.state_dict().items()},
               want[i], f"{opt_name} compiled step {i + 1}")
    assert torch.equal(pm[2].bias.detach(), b0)


@pytest.mark.parametrize("opt_name", ["SGD", "AdamW"])
def test_compiled_step_holds_to_reference_compiled_with_regularizers(opt_name):
    rm, pm, x, y = _pair(regularizers_only=True)
    ropt_ = getattr(ropt, opt_name)(parameters=rm.parameters(),
                                    grad_clip=ref.nn.ClipGradByGlobalNorm(CLIP),
                                    **OPTS[opt_name])
    rstep = RefTrainStep(rm, lambda o, t: ((o - t) ** 2).mean(), ropt_,
                         donate=False)
    pstep = PortTrainStep(pm, _mse, _port_opt(pm, opt_name))
    for i in range(3):
        rl = float(rstep(ref.to_tensor(x), ref.to_tensor(y)))
        pl = float(pstep(torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(rl - pl) <= 1e-5 * abs(rl)
    rstep.sync_weights()
    # XLA fuses the update's products (last-bit differences near zero)
    _close({k: v.detach().numpy() for k, v in pm.state_dict().items()},
           {k: np.asarray(v.numpy()) for k, v in rm.state_dict().items()},
           f"{opt_name} vs the reference's compiled step", atol=1e-6)


def test_regularizer_applies_before_clip():
    """The reference's own case (tests/test_op_tail.py:617-630)."""
    R = port.regularizer
    lin = port.nn.Linear(4, 4, port.ParamAttr(regularizer=R.L2Decay(0.5)))
    w0 = lin.weight.detach().clone()
    opt = popt.SGD(learning_rate=0.1, parameters=lin.parameters())
    lin(port.to_tensor(np.zeros((2, 4), np.float32))).sum().backward()
    opt.step()
    np.testing.assert_allclose(lin.weight.detach().numpy(),
                               (w0 * (1 - 0.1 * 0.5)).numpy(), rtol=1e-5)
    g = R.L1Decay(0.3)(port.to_tensor(np.array([2.0, -3.0], np.float32)))
    np.testing.assert_allclose(g.numpy(), [0.3, -0.3])
    assert repr(R.L2Decay(0.5)) == "L2Decay(coeff=0.5)"


# --------------------------------------------------------------------------- #
# queue C: the reference's faults
# --------------------------------------------------------------------------- #

def test_reference_compiled_step_ignores_the_rate_factor():
    """Pinned: a weight at ParamAttr(learning_rate=0.0) stays put under the
    reference's eager step and moves under its compiled step
    (paddle_tpu/jit/__init__.py:295-375 against optimizer.py:130); the
    port's compiled step leaves it bit for bit."""
    x = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    moved = {}
    for route in ("eager", "compiled"):
        ref.seed(0)
        lin = ref.nn.Linear(4, 4, ref.ParamAttr(learning_rate=0.0))
        w0 = np.asarray(lin.weight.numpy()).copy()
        opt = ropt.SGD(learning_rate=1.0, parameters=lin.parameters())
        if route == "eager":
            lin(ref.to_tensor(x)).sum().backward()
            opt.step()
        else:
            step = RefTrainStep(lin, lambda o, t: (o * t).sum(), opt,
                                donate=False)
            step(ref.to_tensor(x), ref.to_tensor(np.ones((3, 4), np.float32)))
            step.sync_weights()
        moved[route] = float(np.abs(np.asarray(lin.weight.numpy()) - w0).max())
    assert moved["eager"] == 0.0 and moved["compiled"] > 0.1
    lin = port.nn.Linear(4, 4, port.ParamAttr(learning_rate=0.0))
    w0 = lin.weight.detach().clone()
    step = PortTrainStep(lin, lambda o, t: (o * t).sum(),
                         popt.SGD(learning_rate=1.0,
                                  parameters=lin.parameters()))
    step(torch.from_numpy(x), torch.ones(3, 4))
    assert torch.equal(lin.weight.detach(), w0)


def test_weight_decay_takes_no_regularizer():
    """Pinned: the reference takes `weight_decay=L2Decay(...)` and fails at
    its first step with a TypeError from float() (optimizer.py:72-76); the
    port refuses it at construction, naming ParamAttr."""
    lin = ref.nn.Linear(4, 4)
    opt = ropt.SGD(learning_rate=0.1, parameters=lin.parameters(),
                   weight_decay=ref.regularizer.L2Decay(0.5))
    lin(ref.to_tensor(np.ones((2, 4), np.float32))).sum().backward()
    with pytest.raises(TypeError, match="float"):
        opt.step()
    plin = port.nn.Linear(4, 4)
    with pytest.raises(TypeError, match="ParamAttr"):
        popt.SGD(learning_rate=0.1, parameters=plin.parameters(),
                 weight_decay=port.regularizer.L2Decay(0.5))
