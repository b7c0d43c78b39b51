"""The port's expert parallelism (the MoE layer routed over the token
ranks and cut over an ep axis, its all-to-alls, `global_scatter` /
`global_gather`), held to the JAX package at 2 and 4 gloo ranks on the
CPU (the pattern of `tests/test_moe.py`'s expert-parallel cases).

A 2-rank and a 4-rank group (suite "expert_parallel"; the cases are in
`tests/torch_ep_cases.py`) are spawned once for the module; they run
while the JAX references trace here, once each, on the conftest's virtual
CPU devices. The weights are the JAX package's initial ones, carried by
`convert.load_paddle_tpu_state` into a model whose experts the step has
cut already, so each rank takes its experts.

The model is a Linear, an `MoELayer(ExpertFFN(4 experts, 8, 16))` and a
Linear; the loss is the MSE plus 0.01 x the gate's aux loss. The gates are
naive top-2 and GShard top-2 with capacity (0.5, 0.5), random routing
off: 16 tokens, 32 (choice, token) pairs, 2 slots an expert, so most pairs
are dropped, and which depends on every rank's tokens.

- The step: at ep 2 (both gates), ep 4, dp 2 x ep 2 and sharding 2 x ep 2
  at stage 2 with `batch_axes` over the ep axis, and `ep_axis="dp"` at dp
  2 (`tests/test_moe.py:130-156`), 3 AdamW steps: losses (atol 1e-6, as
  `tests/test_moe.py:503-524` holds fast against dense), the aux loss
  before the first update and in each step's forward, and every gathered
  parameter against the JAX `DistributedTrainStep` on the same mesh; each
  rank holds E / n experts.
- a2a_chunks 1 and 2 give the same losses and parameters (`:552-558`).
- The all-to-alls: 2 x chunks a forward in `distributed.moe_comm` under
  `moe/a2a/ep x n`, and in the registry's
  `collective_calls_total{op="all_to_all"}` with the backward's.
- `convert` into an ep-cut model and `full_state_dict` back, bit for bit.
- `global_scatter` / `global_gather` (TestGlobalScatterGather): uniform
  counts against the JAX package's exchange, ragged counts against the
  count contract in numpy, the round trip and its gradient.
"""

import numpy as np
import pytest

import jax
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.utils import global_scatter as jax_global_scatter
from paddle_tpu.incubate.distributed.models.moe import ExpertFFN as JaxExperts
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JaxMoE
from torch_dist_worker import Ranks, check

WORLDS = (2, 4)
LOSS_TOL = dict(rtol=0, atol=1e-6)
# AdamW moves a coordinate whose gradient is rounding noise by up to lr a
# step either way (tests/test_torch_pipeline.py's ADAM_PARAM_TOL)
ADAM_PARAM_TOL = dict(rtol=1e-4, atol=3e-5)
LR = 1e-4
M, E, H = 8, 4, 16
GATES = {"naive": {"type": "naive", "top_k": 2},
         "gshard": {"type": "gshard", "top_k": 2, "capacity": (0.5, 0.5),
                    "random_routing": False}}
GATES["gshard_dp"] = GATES["gshard"]
# case -> (gate, JAX mesh, batch axes, ep axis, sharding stage, ranks)
CASES = {
    "naive_ep2": ("naive", dict(ep=2), ("dp", "ep"), "ep", 0, 2),
    "gshard_ep2": ("gshard", dict(ep=2), ("dp", "ep"), "ep", 0, 2),
    "gshard_dp2_ep_axis_dp": ("gshard_dp", dict(dp=2), ("dp", "sharding"),
                              "dp", 0, 2),
    "gshard_ep4": ("gshard", dict(ep=4), ("dp", "ep"), "ep", 0, 4),
    "gshard_dp2_ep2": ("gshard", dict(dp=2, ep=2), ("dp", "ep"), "ep", 0, 4),
    "gshard_sharding2_ep2_stage2": ("gshard", dict(sharding=2, ep=2),
                                    ("dp", "sharding", "ep"), "ep", 2, 4),
}


def _jt(a):
    t = paddle.to_tensor(np.asarray(a))
    t.stop_gradient = True
    return t


def _state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


class _JaxNet(jnn.Layer):
    def __init__(self, gate, ep_axis, listed=False):
        super().__init__()
        self.inp = jnn.Linear(M, M)
        experts = ([jnn.Linear(M, M) for _ in range(E)] if listed
                   else JaxExperts(E, M, H, ep_axis=ep_axis))
        self.moe = JaxMoE(M, experts, gate=dict(gate), ep_axis=ep_axis)
        self.out = jnn.Linear(M, M)

    def forward(self, x):
        return self.out(self.moe(self.inp(x))), self.moe.l_aux


def _jax_loss(o, l_aux, y):
    return jnn.functional.mse_loss(o, y) + l_aux * 0.01


def _net(gate, ep_axis="ep", listed=False):
    paddle.seed(0)
    return _JaxNet(GATES[gate], ep_axis, listed)


def _exchange_inputs(rng):
    """Per-rank counts and rows of 4 ranks: uniform (one expert a rank, a
    row to each: rank p's rows are 4p..4p+3 of the JAX test's arange(16))
    and ragged (two experts a rank, 0-3 rows each, two columns)."""
    n = 4
    out = {}
    for name, L, width in (("uniform", 1, 1), ("ragged", 2, 2)):
        local = (np.ones((n, n * L), np.int64) if name == "uniform"
                 else rng.integers(0, 4, (n, n * L)))
        glob = np.stack([np.concatenate([local[p, q * L:(q + 1) * L]
                                         for p in range(n)])
                         for q in range(n)])
        start = np.concatenate([[0], np.cumsum(local.sum(1))])
        x = [np.arange(start[p] * width, start[p + 1] * width,
                       dtype=np.float32).reshape(-1, width)
             for p in range(n)]
        out[name] = {"local": local, "global": glob, "x": x, "L": L}
    return out


def _inputs():
    rng = np.random.default_rng(9)
    return dict(
        gates=GATES, lr=LR,
        net={**{g: _state(_net(g)) for g in GATES},
             "gshard_listed": _state(_net("gshard", None, listed=True))},
        x=rng.random((16, M)).astype(np.float32),
        y=rng.random((16, M)).astype(np.float32),
        exchange=_exchange_inputs(rng))


def _jax_case(inp, gate, mesh_kw, axes, ep_axis, stage, listed=False):
    """Losses, the aux loss at the initial weights and after each update
    (an eager forward on the whole batch without a mesh: the global
    routing), and the final parameters of the JAX step."""
    net = _net(gate, ep_axis, listed)
    x, y = _jt(inp["x"]), _jt(inp["y"])

    def aux():
        jdist.env.set_global_mesh(None)
        net.eval()
        _, la = net(x)
        net.train()
        return float(la.numpy())

    l_aux = [aux()] * 2
    n = int(np.prod(list(mesh_kw.values())))
    mesh = jdist.build_mesh(**mesh_kw, devices=jax.devices()[:n])
    step = jdist.DistributedTrainStep(
        net, _jax_loss, jopt.AdamW(learning_rate=LR,
                                   parameters=net.parameters()),
        mesh=mesh, batch_axes=axes, sharding_stage=stage)
    losses = []
    for i in range(3):
        jdist.env.set_global_mesh(mesh)
        losses.append(float(step([x], [y])))
        step.sync_weights()
        if i < 2:
            l_aux.append(aux())
    jdist.env.set_global_mesh(None)
    return dict(losses=losses, l_aux=l_aux, params=_state(net))


def _jax_refs(inp):
    ref = {name: _jax_case(inp, *spec[:5]) for name, spec in CASES.items()}
    ref["gshard_listed_dp2"] = _jax_case(inp, "gshard", dict(dp=2),
                                         ("dp", "sharding"), None, 0,
                                         listed=True)
    ref["gshard_ep2_whole_batch"] = _jax_case(
        dict(inp, x=inp["x"][:15], y=inp["y"][:15]), "gshard", dict(ep=2),
        ("dp", "ep"), "ep", 0)
    grp = jdist.new_group(list(range(4)))
    x = paddle.to_tensor(np.arange(16, dtype=np.float32).reshape(16, 1))
    cnt = paddle.to_tensor(np.full((4,), 4, np.int64))
    ref["global_scatter"] = jax_global_scatter(x, cnt, cnt,
                                               group=grp).numpy()
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inp = _inputs()
    groups = {w: Ranks("expert_parallel", w,
                       tmp_path_factory.mktemp(f"ep{w}"), inp)
              for w in WORLDS}
    out = {"inp": inp, "jax": _jax_refs(inp)}
    for w, g in groups.items():
        try:
            out[w] = g.results(timeout=240)
        except RuntimeError as e:
            out[w] = e
    return out


def _case(runs, world, name):
    r = runs[world]
    if isinstance(r, Exception):
        raise r
    return [check(v) for v in r[name]]


def _hold(got, want, what):
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_TOL,
                               err_msg=what)
    np.testing.assert_allclose(got["l_aux"], want["l_aux"], **LOSS_TOL,
                               err_msg=f"{what} l_aux")
    assert set(got["params"]) == set(want["params"]), what
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, **ADAM_PARAM_TOL,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_expert_parallel_step_matches_jax(runs, name):
    """Losses, aux losses and parameters of the step against the JAX step
    on the same mesh, every rank; the experts cut over the ep axis (E / n a
    rank) and the pairs dropped by the global capacity."""
    gate, mesh_kw, _, ep_axis, _, world = CASES[name]
    want = runs["jax"][name]
    n = mesh_kw.get(ep_axis, 1)
    for rank, r in enumerate(_case(runs, world, name)):
        _hold(r, want, f"{name} rank {rank}")
        assert r["shapes"]["moe.experts.w1"] == (E // n, M, H)
        assert r["a2a"][f"moe/a2a/{ep_axis}x{n}"]["calls"] == 3 * 2 * 2


def test_dense_path_routes_over_the_batch_ranks(runs):
    """List experts take the dense path, whole on every rank: at dp 2 its
    gate routes the two ranks' tokens as one set (the global capacity and
    slots), against the JAX step; no all-to-all."""
    for rank, r in enumerate(_case(runs, 2, "gshard_listed_dp2")):
        _hold(r, runs["jax"]["gshard_listed_dp2"], f"rank {rank}")
        assert r["a2a"] == {} and "all_to_all" not in r["calls"]


def test_a_batch_taken_whole_is_routed_once(runs):
    """15 rows do not divide over ep 2, so every rank takes the whole batch
    (as the JAX step replicates it): each rank's experts take their rows
    from its own buffer and only the combine exchanges (2 all-to-alls a
    forward); losses, aux losses and parameters against the JAX step."""
    for rank, r in enumerate(_case(runs, 2, "gshard_ep2_whole_batch")):
        _hold(r, runs["jax"]["gshard_ep2_whole_batch"], f"rank {rank}")
        assert r["a2a"]["moe/a2a/epx2"]["calls"] == 3 * 2


def test_capacity_drops_tokens_in_the_gshard_cases(runs):
    """GShard at capacity 0.5 keeps 2 slots an expert for 32 pairs: the
    routed rows are fewer than the pairs, so the drops decide the step."""
    from paddle_tpu_torch.incubate.distributed.models.moe import (ExpertFFN,
                                                                  MoELayer)
    import torch

    layer = MoELayer(M, ExpertFFN(E, M, H, device="cpu"),
                     gate=dict(GATES["gshard"]), device="cpu")
    x = torch.tensor(runs["inp"]["x"])
    topi, _, keep, _ = layer.gate._route(x, layer.gate.gate.weight,
                                         layer.gate.gate.bias)
    assert int(keep.sum()) == 32 > E * layer.gate.capacity(16)


def test_chunks_one_and_two_agree(runs):
    """a2a_chunks=1 (one exposed exchange each way) against the default 2:
    the same losses and parameters, half the all-to-alls, and the bytes of
    each layout's whole buffer: E x R rows each way a forward, R =
    row_stride(capacity) = 16 in one chunk, 2 x row_stride(ceil(capacity /
    2)) = 32 in two (capacity 2)."""
    for one, two in zip(_case(runs, 2, "gshard_ep2_chunks1"),
                        _case(runs, 2, "gshard_ep2")):
        np.testing.assert_allclose(one["losses"], two["losses"], **LOSS_TOL)
        for k, v in two["params"].items():
            np.testing.assert_allclose(one["params"][k], v, rtol=0, atol=1e-6,
                                       err_msg=k)
        for rec, chunks, R in ((one, 1, 16), (two, 2, 32)):
            a2a = rec["a2a"]["moe/a2a/epx2"]
            assert a2a["calls"] == 3 * 2 * chunks
            assert a2a["bytes"] == 3 * 2 * E * R * M * 4


@pytest.mark.parametrize("name", ["gshard_ep2", "gshard_ep4"])
def test_all_to_all_counts(runs, name):
    """Per forward 2 x chunks all-to-alls in moe_comm, each sending this
    rank's whole [E, Rc, M] chunk; collective_calls_total counts the backward's
    too (the combine's always, the dispatch's since the input Linear needs
    its gradient): 4 x chunks a step."""
    world = CASES[name][-1]
    for r in _case(runs, world, name):
        rec = r["a2a"][f"moe/a2a/epx{world}"]
        assert rec["forwards"] == 3
        assert r["calls"]["all_to_all"] == 3 * 4 * 2


def test_convert_into_an_ep_cut_model_and_back(runs):
    """load_paddle_tpu_state gives each rank its E / n experts and
    full_state_dict gathers them back, bit for bit."""
    state = runs["inp"]["net"]["gshard"]
    for world in WORLDS:
        for rank, r in enumerate(_case(runs, world, "convert")):
            assert r["w1"] == (E // world, M, H)
            assert tuple(r["part"]) == (0, rank, world)
            assert set(r["params"]) == set(state)
            for k, v in state.items():
                np.testing.assert_array_equal(r["params"][k], v, err_msg=k)


def test_global_scatter_uniform_matches_jax(runs):
    """Uniform counts at 4 ranks, a row from each rank to each: the ranks'
    scattered rows, rank after rank, are the JAX package's exchange of the
    stacked arange(16) (`tests/test_moe.py`'s TestGlobalScatterGather),
    whose rows 4p..4p+3 are the port's rank p's."""
    got = _case(runs, 4, "exchange")
    stacked = np.concatenate([r["uniform"]["scattered"] for r in got])
    np.testing.assert_array_equal(stacked, runs["jax"]["global_scatter"])


@pytest.mark.parametrize("name", ["uniform", "ragged"])
def test_global_scatter_gather_count_contract(runs, name):
    """Rank q receives, rank p after rank p - 1 and expert e after e - 1,
    the rows each rank sent to its experts; global_gather sends them back
    in x's order; the backward of the round trip is 2 (the gather's input
    was scattered x 2), an exchange each; the bytes on the wire are the
    rows alone."""
    g = runs["inp"]["exchange"][name]
    n, L = 4, g["L"]
    got = _case(runs, 4, "exchange")
    starts = [np.concatenate([[0], np.cumsum(g["local"][p])]) for p in range(n)]
    for q, r in enumerate(got):
        want = np.concatenate([
            g["x"][p][starts[p][q * L + e]:starts[p][q * L + e + 1]]
            for p in range(n) for e in range(L)])
        res = r[name]
        np.testing.assert_array_equal(res["scattered"], want)
        np.testing.assert_array_equal(res["back"], 2 * g["x"][q])
        np.testing.assert_array_equal(res["dx"], np.full_like(g["x"][q], 2))
        assert res["calls"]["all_to_all"] == 4
        assert res["bytes"]["all_to_all"] == 2 * 4 * (g["x"][q].size
                                                      + want.size)
