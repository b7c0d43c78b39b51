"""The port's collectives, topology and counters held to Paddle's per-rank
semantics at 2 and 4 gloo ranks on the CPU.

Each world is spawned once for the module (`torch_dist_worker.Ranks`, a
file-store rendezvous under the test's tmp dir, a 180 s limit on the
group); every rank runs every case and each case is asserted here on its
own: the collectives of `tests/multiproc_worker.py:32-80` (all_reduce SUM
and MAX, all_gather, broadcast, broadcast_object_list and all_gather_object
with payloads of different sizes, alltoall_single, send/recv from rank 0
to rank 1, barrier), the regressions of `tests/test_distributed.py:308-357`
(send/recv to a non-zero destination, the alltoall_single transpose,
reduce_scatter MAX, the dp x sep group), the other collectives of the
port, and the per-op counters. `CommunicateTopology` and
`HybridCommunicateGroup` are held to the JAX package's on the same dims.
The 2-rank group also runs `eager_multiproc`'s cases
(`tests/torch_eager_cases.py`), held to the JAX package's reductions, and
the sharded step (sharding 2, stages 1-3) over an MLP whose parameters
carry ParamAttr attributes (regularizers, rates, need_clip), held to the
JAX package's eager step on the whole batch.
"""

import numpy as np
import pytest

from paddle_tpu.distributed.fleet.base.topology import \
    CommunicateTopology as JaxTopology
from paddle_tpu_torch.distributed.fleet.base.topology import \
    CommunicateTopology
from torch_dist_worker import Ranks, check

WORLDS = (2, 4)
HCG_DIMS = {2: [(2, 1, 1, 1, 1), (1, 1, 2, 1, 1), (1, 1, 1, 1, 2)],
            4: [(2, 1, 1, 1, 2), (2, 1, 1, 2, 1), (1, 1, 1, 2, 2),
                (2, 1, 2, 1, 1)]}


def _rs_vals(world):
    rng = np.random.default_rng(world)
    return rng.integers(0, 100, (world, world)).tolist()


# the attributes of the sharded-step case: {parameter: ParamAttr keywords},
# a regularizer as (class name, coefficient)
ATTRS = {"l1.weight": {"regularizer": ("L2Decay", 0.05)},
         "l2.weight": {"regularizer": ("L1Decay", 0.002)},
         "l1.bias": {"learning_rate": 0.5}, "l2.bias": {"learning_rate": 0.0},
         "l3.weight": {"need_clip": False}}
ATTR_CLIP = 0.05


def _attr_inputs():
    import paddle_tpu as paddle
    from torch_dist_worker import H

    paddle.seed(0)
    model = _attr_reference_mlp()
    rng = np.random.default_rng(3)
    return {"attr_mlp": {k: np.asarray(v.numpy())
                         for k, v in model.state_dict().items()},
            "attrs": ATTRS, "attr_clip": ATTR_CLIP,
            "attr_x": rng.normal(size=(32, H)).astype(np.float32),
            "attr_y": rng.normal(size=(32, 8)).astype(np.float32)}


def _attr_reference_mlp():
    import paddle_tpu.nn as jnn
    from paddle_tpu import ParamAttr, regularizer
    from torch_dist_worker import H

    def attr(name):
        kw = dict(ATTRS.get(name, {}))
        if "regularizer" in kw:
            kind, coeff = kw["regularizer"]
            kw["regularizer"] = getattr(regularizer, kind)(coeff)
        return ParamAttr(**kw)

    class MLP(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = jnn.Linear(H, H, attr("l1.weight"), attr("l1.bias"))
            self.l2 = jnn.Linear(H, H, attr("l2.weight"), attr("l2.bias"))
            self.l3 = jnn.Linear(H, 8, attr("l3.weight"), attr("l3.bias"))

        def forward(self, x):
            h = jnn.functional.relu(self.l1(x))
            h = jnn.functional.relu(self.l2(h))
            return self.l3(h)

    return MLP()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    # the 2-rank group also runs the eager_multiproc cases and the sharded
    # step under attributes
    extra = {2: {"eager_multiproc": True, **_attr_inputs()}}
    groups = {w: Ranks("collective", w, tmp_path_factory.mktemp(f"coll{w}"),
                       {"rs_vals": _rs_vals(w), "hcg_dims": HCG_DIMS[w],
                        **extra.get(w, {})})
              for w in WORLDS}
    out = {}
    for w, g in groups.items():
        try:
            out[w] = g.results(timeout=180)
        except RuntimeError as e:
            out[w] = e
    return out


def _case(results, world, name):
    r = results[world]
    if isinstance(r, Exception):
        raise r
    return [check(v) for v in r[name]]


def _expected(world, name):
    """Each rank's result as Paddle's semantics give it."""
    ranks = range(world)
    rs = _rs_vals(world)
    return {
        "all_reduce_sum": [[world * (world + 1) / 2] * 4 for _ in ranks],
        "all_reduce_max": [[world - 1.0] * 2 for _ in ranks],
        "all_gather": [list(ranks) for _ in ranks],
        "broadcast": [[1.0] * 3 for _ in ranks],
        "broadcast_object_list": [{"rank": 0, "blob": "x" * 5} for _ in ranks],
        "all_gather_object": [list(ranks) for _ in ranks],
        "alltoall_single": [[[float(i)] * 2 for i in ranks] for _ in ranks],
        "send_recv": [None, list(np.arange(5.0))] + [None] * (world - 2),
        "barrier": [True] * world,
        "send_recv_nonzero_dst": [None] * (world - 1) + [[10.0, 11.0, 12.0, 13.0]],
        "alltoall_single_transpose": [[float(i * world + j) for i in ranks]
                                      for j in ranks],
        "reduce_scatter_max": [[float(max(rs[i][j] for i in ranks))]
                               for j in ranks],
        "alltoall_list": [[float(i * 10 + j) for i in ranks] for j in ranks],
        "scatter": [[float(j)] * 2 for j in ranks],
        "reduce": [[world * (world + 1) / 2] * 2] + [None] * (world - 1),
        "batch_isend_irecv": [[float((j - 1) % world)] * 3 for j in ranks],
    }[name]


CASES = ["all_reduce_sum", "all_reduce_max", "all_gather", "broadcast",
         "broadcast_object_list", "all_gather_object", "alltoall_single",
         "send_recv", "barrier", "send_recv_nonzero_dst",
         "alltoall_single_transpose", "reduce_scatter_max", "alltoall_list",
         "scatter", "reduce", "batch_isend_irecv"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", CASES)
def test_collective_per_rank(results, world, name):
    assert _case(results, world, name) == _expected(world, name)


@pytest.mark.parametrize("world", WORLDS)
def test_counters_count_each_op(results, world):
    for got in _case(results, world, "counters"):
        assert got["calls"] == {"all_reduce": 1, "all_gather": 1,
                                "broadcast": 1, "reduce_scatter": 1,
                                "all_to_all": 1, "barrier": 1}
        # a call of no payload (the barrier) adds no byte series: the
        # registry's family holds only the ops that moved bytes
        assert got["bytes"] == {"all_reduce": 12, "all_gather": 8,
                                "broadcast": 16, "reduce_scatter": 4 * world,
                                "all_to_all": 4 * world}


def test_communicate_topology_matches_jax():
    """tests/test_distributed.py:26-51 and the dims of the rank groups."""
    for dims in [(2, 1, 1, 1, 4), (2, 1, 1, 2, 2), (1, 2, 2, 1, 2)]:
        mine, ref = CommunicateTopology(dims=dims), JaxTopology(dims=dims)
        assert mine.world_size() == ref.world_size()
        for name in ref.get_hybrid_group_names():
            assert mine.get_comm_list(name) == ref.get_comm_list(name)
            assert mine.get_axis_list(name, 0) == ref.get_axis_list(name, 0)
        for r in range(ref.world_size()):
            assert mine.get_coord(r) == ref.get_coord(r)
    topo = CommunicateTopology(dims=(2, 1, 1, 1, 4))
    assert topo.get_rank(data=1, pipe=0, sharding=0, sep=0, model=2) == 6
    assert topo.get_comm_list("model") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert topo.get_comm_list("data") == [[0, 4], [1, 5], [2, 6], [3, 7]]


def _jax_hcg(dims):
    """The JAX package's HybridCommunicateGroup on `dims` (its one
    controller is global rank 0)."""
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed.fleet.base.topology import \
        HybridCommunicateGroup

    try:
        return HybridCommunicateGroup(JaxTopology(dims=dims))
    finally:
        jenv.set_global_mesh(None)


@pytest.mark.parametrize("world", WORLDS)
def test_hybrid_communicate_group_matches_jax(results, world):
    """Every rank's groups are the reference topology's comm lists through
    that rank; rank 0's equal the JAX HybridCommunicateGroup's, and so do
    the parallel mode, the degrees and the mesh (dp x sep: the dp-sep group
    of tests/test_distributed.py:345)."""
    got = _case(results, world, "topology")
    for dims in HCG_DIMS[world]:
        ref = _jax_hcg(dims)
        topo = JaxTopology(dims=dims)
        fixed = ("pipe", "sharding", "model")
        for rank, per_rank in enumerate(got):
            g = per_rank[tuple(dims)]
            for name in ("data", "model", "sharding", "sep", "pipe"):
                want = next(c for c in topo.get_comm_list(name) if rank in c)
                assert g[name] == want, (dims, rank, name)
            coord = dict(zip(topo.get_hybrid_group_names(), topo.get_coord(rank)))
            assert g["dp_sep"] == sorted(
                r for r in range(world) if all(
                    dict(zip(topo.get_hybrid_group_names(), topo.get_coord(r)))[n]
                    == coord[n] for n in fixed)), (dims, rank)
            assert g["mode"] == ref.get_parallel_mode()
            assert g["sizes"] == (ref.get_data_parallel_world_size(),
                                  ref.get_model_parallel_world_size(),
                                  ref.get_sharding_parallel_world_size(),
                                  ref.get_sep_parallel_world_size())
            assert g["mesh"] == {k: int(v) for k, v in ref.mesh.shape.items()}
        r0 = got[0][tuple(dims)]
        assert r0["dp_sep"] == ref.get_dp_sep_parallel_group().ranks
        assert r0["data"] == ref.get_data_parallel_group().ranks
        assert r0["model"] == ref.get_model_parallel_group().ranks


# --------------------------------------------------------------------------- #
# eager_multiproc at 2 ranks (tests/torch_eager_cases.py), against the JAX
# package's reductions over the same stacked values
# --------------------------------------------------------------------------- #


def _rows(world=2):
    return np.stack([np.asarray([r + 1.5, -2.0 * r, 3.0], np.float32)
                     for r in range(world)])


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod", "avg"])
def test_eager_allreduce_value_matches_the_reference(results, op):
    from paddle_tpu.distributed.eager_multiproc import _reduce_rows

    want = _reduce_rows(_rows(), op)
    for got in _case(results, 2, f"em_allreduce_{op}"):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_eager_gathers_broadcasts_and_alltoall(results):
    from paddle_tpu.distributed.eager_multiproc import _reduce_rows

    assert _case(results, 2, "em_world") == [(2, 0), (2, 1)]
    for got in _case(results, 2, "em_allgather"):
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, [[0, 0], [1, 10]])
    for got in _case(results, 2, "em_allgather_bool"):
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, [[True, True], [False, True]])
    want = _reduce_rows(np.asarray([[0, 3], [1, 3]], np.int32), "avg")
    for got in _case(results, 2, "em_allreduce_int_avg"):
        np.testing.assert_array_equal(got, want)
    assert _case(results, 2, "em_allgather_objects") == [
        [{"r": 0, "s": "xxx"}, {"r": 1, "s": "xxxx"}]] * 2
    for got in _case(results, 2, "em_broadcast"):
        np.testing.assert_array_equal(got, [7.0] * 3)
    assert _case(results, 2, "em_broadcast_objects") == [{"from": 1}] * 2
    assert _case(results, 2, "em_barrier") == [True, True]
    # the reference's rule: row chunk j of every rank's input lands on j
    g = np.stack([np.arange(8, dtype=np.float32).reshape(4, 2) + 100 * r
                  for r in range(2)])
    for r, got in enumerate(_case(results, 2, "em_alltoall")):
        np.testing.assert_array_equal(
            got, np.concatenate([g[j, 2 * r:2 * r + 2] for j in range(2)]))


def test_eager_store_group_reduce_and_p2p(results):
    got = _case(results, 2, "em_store")
    for r, res in enumerate(got):
        assert res["rounds"] == [[1.0 + 2 * k, 2.0] for k in range(3)]
        # the rolling cleanup kept the last two rounds, the sweep none
        assert res["live_before"] == [False, True, True]
        assert res["live_after"] == [False, False, False]
    assert got[1]["recv"] == [[0, 2, 4], [1.0, 1.0]]
    assert got[1]["consumed"] is None


@pytest.mark.parametrize("stage", (1, 2, 3))
def test_sharded_step_with_attributes_matches_reference_eager(results, stage):
    """ZeRO stage 1-3 over 2 ranks with per-parameter regularizers (before
    the clip, in place of the weight decay), rates and need_clip, against
    the JAX package's eager AdamW step on the whole batch, 3 steps: the
    losses and every parameter (f32, rtol 1e-4: the batch's halves summed
    across ranks), the rate-0 bias unchanged bit for bit."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    import paddle_tpu.optimizer as jopt

    inp = _attr_inputs()
    paddle.seed(0)
    model = _attr_reference_mlp()
    opt = jopt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                     parameters=model.parameters(),
                     grad_clip=jnn.ClipGradByGlobalNorm(ATTR_CLIP))
    x, y = paddle.to_tensor(inp["attr_x"]), paddle.to_tensor(inp["attr_y"])
    losses = []
    for _ in range(3):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    want = {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}
    for got in _case(results, 2, f"attr_sharded_stage{stage}"):
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
        for k, v in want.items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(got["params"]["l2.bias"],
                                      inp["attr_mlp"]["l2.bias"])
