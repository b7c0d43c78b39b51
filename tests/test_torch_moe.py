"""The port's MoE (paddle_tpu_torch.incubate.distributed.models.moe) held
against the JAX package's (paddle_tpu.incubate.distributed.models.moe,
its Pallas grouped GEMM run in interpret mode on the CPU):

- the gates' routes, combine weights, l_aux and capacity drops, in both
  forms (`_route` of the sorted fast path, `_routing`'s dense [S, E, C]
  tensors), for naive, gshard (random_routing=False) and switch
  (switch_eps=0) gates, in training (capacity factor 1.2, drops) and in
  eval; the lower expert id first on tied probabilities;
- `MoELayer`'s sorted fast path against JAX's fast path and against the
  port's own dense einsum path: values, gradients and l_aux;
- bench.py's gpt3_moe rung (`MoEDecoder`) at tiny widths: three AdamW
  steps under AMP O2 bf16 against JAX's;
- GShard random routing on the port: the gate's own generator, so one
  seed gives one set of routes.

The two packages draw random routing from different generators, so every
comparison with JAX turns it off. On CPU tensors the port's grouped GEMM
runs its plain version, which the CUDA kernel is held to on the card
(chip_smoke.py). Mirrors tests/test_moe.py:51, :347, :434."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import DistributedTrainStep
from paddle_tpu_torch.incubate.distributed.models import moe as tmoe
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import grouped_gemm as port_gg
from paddle_tpu_torch.optimizer import AdamW


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


# f32 on both sides: the same routes and the same products summed in other
# orders; outputs and l_aux of magnitude ~1 to a few ulps, gradients
# (sums over tokens that cancel) to 1e-5 of each tensor's largest entry.
VAL_TOL = 1e-5
GRAD_TOL = 1e-5

E, M, H, S = 4, 16, 32, 24

# name: (gate config, training)
GATES = {
    "naive_eval": ({"type": "naive", "top_k": 2}, False),
    "gshard_train": ({"type": "gshard", "top_k": 2, "random_routing": False},
                     True),
    "gshard_eval": ({"type": "gshard", "top_k": 2, "random_routing": False},
                    False),
    "switch_train": ({"type": "switch", "top_k": 1, "switch_eps": 0.0}, True),
}


def _x(seed=0, n=S):
    return np.random.default_rng(seed).standard_normal((n, M)).astype(np.float32)


def _jax_layer(name):
    cfg, training = GATES[name]
    paddle.seed(7)
    layer = jmoe.MoELayer(M, jmoe.ExpertFFN(E, M, H), gate=dict(cfg))
    layer.train() if training else layer.eval()
    return layer


def _port_layer(name, state):
    cfg, training = GATES[name]
    layer = tmoe.MoELayer(M, tmoe.ExpertFFN(E, M, H, device="cpu"),
                          gate=dict(cfg), device="cpu")
    load_paddle_tpu_state(layer, state)
    layer.train(training)
    return layer


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


_GRADS = ("experts.w1", "experts.b1", "experts.w2", "experts.b2",
          "gate.gate.weight", "gate.gate.bias")


@pytest.fixture(scope="module")
def jax_layers():
    """Per gate case: the JAX layer's state, its fast path's output, l_aux,
    the parameters' and the input's gradients of out.sum() + l_aux, and the
    gate's raw routing of the same input."""
    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        mp.setenv("PADDLE_TPU_MOE_FAST", "1")
        for name in GATES:
            layer = _jax_layer(name)
            state = _state(layer)
            x = paddle.to_tensor(_x(), stop_gradient=False)
            out = layer(x)
            l_aux = layer.l_aux
            (out.sum() + l_aux).backward()
            params = dict(layer.named_parameters())
            g = layer.gate
            xv, w, b = (jnp.asarray(a) for a in (
                _x(), state["gate.gate.weight"], state["gate.gate.bias"]))
            route = [np.asarray(a) for a in g._route(xv, w, b)]
            dense = [np.asarray(a) for a in g._routing(xv, w, b)]
            refs[name] = dict(
                state=state, out=out.numpy(), l_aux=float(l_aux.numpy()),
                grads={k: np.asarray(params[k].grad.numpy()) for k in _GRADS},
                dx=np.asarray(x.grad.numpy()), route=route, dense=dense,
                cap=g.capacity(S))
    return refs


@pytest.mark.parametrize("name", list(GATES))
def test_gate_routes_match_jax(name, jax_layers):
    """Routes, weights, kept choices and l_aux (`_route`), and the dense
    combine/dispatch tensors with their capacity drops (`_routing`)."""
    ref = jax_layers[name]
    layer = _port_layer(name, ref["state"])
    g = layer.gate
    assert g.capacity(S) == ref["cap"]
    args = (torch.from_numpy(_x()), g.gate.weight.detach(), g.gate.bias.detach())
    topi, topv, keep, l_aux = g._route(*args)
    np.testing.assert_array_equal(topi.numpy(), ref["route"][0])
    np.testing.assert_allclose(topv.numpy(), ref["route"][1], rtol=0,
                               atol=VAL_TOL)
    np.testing.assert_array_equal(keep.numpy(), ref["route"][2])
    np.testing.assert_allclose(l_aux.item(), ref["route"][3], rtol=VAL_TOL)
    combine, dispatch, l_aux = g._routing(*args)
    np.testing.assert_array_equal(dispatch.numpy(), ref["dense"][1])
    np.testing.assert_allclose(combine.numpy(), ref["dense"][0], rtol=0,
                               atol=VAL_TOL)
    np.testing.assert_allclose(l_aux.item(), ref["dense"][2], rtol=VAL_TOL)
    if name in ("gshard_train", "switch_train"):  # capacity 8 < routed pairs
        kept = dispatch.sum((0, 2))
        assert kept.max() == ref["cap"] and int(dispatch.sum()) < \
            g.top_k * S


def test_ties_pick_the_lower_expert_first():
    """jax.lax.top_k puts the lower index first on ties; the port's stable
    descending sort does the same (torch.topk promises no order on CUDA)."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.1, 0.3, 0.3]], np.float32)
    want_i, want_v = jax.lax.top_k(jnp.asarray(probs), 2)[::-1]
    from paddle_tpu_torch.incubate.distributed.models.moe.gate import _topk
    got_v, got_i = _topk(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(), [[0, 1], [1, 2], [0, 2]])
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # a gate whose router is all zeros: every probability ties
    gate = tmoe.GShardGate(M, E, random_routing=False, device="cpu")
    with torch.no_grad():
        gate.gate.weight.zero_()
    topi = gate._route(torch.from_numpy(_x()), gate.gate.weight,
                       gate.gate.bias)[0]
    assert (topi == torch.tensor([0, 1])).all()


@pytest.mark.parametrize("name", list(GATES))
def test_fast_path_matches_jax_and_the_dense_path(name, jax_layers):
    """The sorted fast path (two grouped GEMMs) against JAX's fast path
    (the Pallas grouped GEMM in interpret mode) and against the port's own
    dense einsum path: values, l_aux, the parameters' and the input's
    gradients of out.sum() + l_aux."""
    ref = jax_layers[name]
    runs = {}
    for path in ("fast", "dense"):
        layer = _port_layer(name, ref["state"])
        x = torch.from_numpy(_x()).requires_grad_()
        out = layer(x) if path == "fast" else layer._forward_dense(x)
        (out.sum() + layer.l_aux).backward()
        params = dict(layer.named_parameters())
        runs[path] = dict(out=out.detach().numpy(), l_aux=layer.l_aux.item(),
                          grads={k: params[k].grad.numpy() for k in _GRADS},
                          dx=x.grad.numpy())
    for path, want in (("fast", ref), ("fast", runs["dense"])):
        got = runs[path]
        np.testing.assert_allclose(got["out"], want["out"], rtol=0,
                                   atol=VAL_TOL * np.abs(want["out"]).max())
        np.testing.assert_allclose(got["l_aux"], want["l_aux"], rtol=VAL_TOL)
        for k in _GRADS + ("dx",):
            g = got["grads"][k] if k != "dx" else got["dx"]
            w = want["grads"][k] if k != "dx" else want["dx"]
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=GRAD_TOL * max(np.abs(w).max(), 1e-3),
                                       err_msg=k)
    assert np.abs(runs["fast"]["out"]).max() > 0
    assert port_gg.LAUNCHES == 0  # CPU tensors never launch the kernel


def test_state_dict_names_equal_the_reference(jax_layers):
    state = jax_layers["gshard_train"]["state"]
    layer = _port_layer("gshard_train", state)
    assert {k: tuple(v.shape) for k, v in layer.state_dict().items()} == \
        {k: v.shape for k, v in state.items()}
    assert tuple(layer.gate.gate.weight.shape) == (M, E)  # Linear [in, out]


def test_list_experts_take_the_dense_path():
    """A list of expert modules runs the dense path, each expert on its
    [C, M] slice: equal to the stacked layer with the same weights."""
    stacked = tmoe.MoELayer(M, tmoe.ExpertFFN(E, M, H, device="cpu"),
                            gate={"type": "naive", "top_k": 2}, device="cpu")
    stacked.eval()
    e = stacked.experts

    class Expert(torch.nn.Module):
        def __init__(self, i):
            super().__init__()
            self.fc1 = tnn.Linear(M, H, device="cpu")
            self.fc2 = tnn.Linear(H, M, device="cpu")
            with torch.no_grad():
                self.fc1.weight.copy_(e.w1[i])
                self.fc1.bias.copy_(e.b1[i, 0])
                self.fc2.weight.copy_(e.w2[i])
                self.fc2.bias.copy_(e.b2[i, 0])

        def forward(self, x):
            return self.fc2(TF.gelu(self.fc1(x), approximate=True))

    listed = tmoe.MoELayer(M, [Expert(i) for i in range(E)], gate=stacked.gate)
    x = torch.from_numpy(_x(2, 12))
    torch.testing.assert_close(listed(x), stacked(x), rtol=1e-5, atol=1e-5)
    assert isinstance(listed.experts, tnn.LayerList)
    with pytest.raises(NotImplementedError, match="queue A item 1e"):
        tmoe.MoELayer(M, tmoe.ExpertFFN(E, M, H, device="cpu"),
                      moe_group=object(), device="cpu")


def test_gshard_random_routing_follows_the_gate_generator():
    """Random routing draws from the generator the gate owns: one seed gives
    one set of routes, the next call draws anew, another seed differs."""

    def routes(seed, calls=2):
        gate = tmoe.GShardGate(M, E, seed=seed, device="cpu",
                               generator=torch.Generator().manual_seed(0))
        gate.train()
        x = torch.from_numpy(_x(3, 256))
        return [gate._route(x, gate.gate.weight, gate.gate.bias)[2]
                for _ in range(calls)]

    a, b = routes(5), routes(5)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], routes(6)[0])
    assert a[0][:, 0].all() and not a[0][:, 1].all()  # only 2nd choices drop


# bench.py run_moe_rung's MoEDecoder (bench.py:533-549) at tiny widths
DM, DH, DL, DV, DE, DB, DS = 32, 64, 2, 128, 8, 2, 32
MOE_GATE = {"type": "gshard", "top_k": 2, "random_routing": False}


class JaxMoEDecoder(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.embed = jnn.Embedding(DV, DM)
        self.norms = jnn.LayerList([jnn.LayerNorm(DM) for _ in range(DL)])
        self.moes = jnn.LayerList([
            jmoe.MoELayer(DM, jmoe.ExpertFFN(DE, DM, DH), gate=dict(MOE_GATE))
            for _ in range(DL)])
        self.head = jnn.Linear(DM, DV)

    def forward(self, ids):
        x = self.embed(ids)
        for norm, moe in zip(self.norms, self.moes):
            x = x + moe(norm(x))
        return self.head(x)


class PortMoEDecoder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.embed = tnn.Embedding(DV, DM, device="cpu")
        self.norms = tnn.LayerList([tnn.LayerNorm(DM, device="cpu")
                                    for _ in range(DL)])
        self.moes = tnn.LayerList([
            tmoe.MoELayer(DM, tmoe.ExpertFFN(DE, DM, DH, device="cpu"),
                          gate=dict(MOE_GATE), device="cpu")
            for _ in range(DL)])
        self.head = tnn.Linear(DM, DV, device="cpu")

    def forward(self, ids):
        x = self.embed(ids)
        for norm, moe in zip(self.norms, self.moes):
            x = x + moe(norm(x))
        return self.head(x)


def test_moe_rung_o2_adamw_steps_match_jax():
    """The gpt3_moe rung's recipe at tiny widths (8 experts, GShard top-2
    without random routing, AdamW, AMP O2 bf16 over f32 parameters,
    DistributedTrainStep on one device) in both packages from the same
    weights: the bf16 losses of three steps agree to bf16 rounding placed
    differently by the two frameworks (a few 1e-4 of a loss of ~5), and
    every parameter moves."""
    steps, lr = 3, 1e-3
    rng = np.random.default_rng(0)
    ids = rng.integers(0, DV, (DB, DS))
    labels = rng.integers(0, DV, (DB, DS))

    def loss_j(lg, lb):
        return JF.cross_entropy(lg.reshape([-1, DV]), lb.reshape([-1, 1]))

    def loss_t(lg, lb):
        return TF.cross_entropy(lg.reshape(-1, DV), lb.reshape(-1, 1))

    with pytest.MonkeyPatch.context() as mp:
        if os.environ.get("PADDLE_TPU_HW") != "1":
            mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        mp.setenv("PADDLE_TPU_MOE_FAST", "1")
        paddle.seed(0)
        jm = JaxMoEDecoder()
        state = _state(jm)
        jstep = jdist.DistributedTrainStep(
            jm, loss_j, jopt.AdamW(learning_rate=lr, parameters=jm.parameters()),
            mesh=jdist.build_mesh(devices=jax.devices()[:1]),
            batch_axes=("dp", "ep"), amp_level="O2", amp_dtype="bfloat16")
        jl = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels)))
              for _ in range(steps)]
    tm = PortMoEDecoder()
    assert sorted(tm.state_dict()) == sorted(state)
    load_paddle_tpu_state(tm, state)
    tstep = DistributedTrainStep(
        tm, loss_t, AdamW(learning_rate=lr, parameters=tm.parameters()),
        mesh=None, batch_axes=("dp", "ep"), amp_level="O2",
        amp_dtype="bfloat16")
    tl = [tstep(ids, labels).item() for _ in range(steps)]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]
    for k, v in tm.state_dict().items():
        assert v.dtype == torch.float32, k  # O2 keeps f32 parameters
        assert not torch.equal(v, torch.tensor(state[k])), k
