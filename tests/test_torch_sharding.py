"""The port's data-parallel and ZeRO step (`DistributedTrainStep`, stages
0-3, offload, comm_overlap, the global-norm clip) and its eager API held
to the JAX package at 4 gloo ranks on the CPU, and to itself at 1 rank.

A 4-rank and a 1-rank group are spawned once for the module
(`torch_dist_worker.Ranks`: file-store rendezvous under the test's tmp dir,
180 s limit); they run every case while the JAX references are traced
here, once each, on the conftest's virtual CPU devices. The model is the
reference's `_MLP` of `tests/test_sharding_stages.py:28` (H 256, B 32,
AdamW lr 1e-3) with the JAX package's initial weights carried across by
`convert.load_paddle_tpu_state`; gpt3_tiny runs at `dryrun_multichip`'s
shape (`__graft_entry__.py:111-142`: 2 layers, B 4 x 16, AdamW 1e-4,
seed 0).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.distributed import group_sharded_parallel
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import AdamW
from torch_dist_worker import Ranks, check, mlp, mse

H, B = 256, 32
MESHES = {"sharding4": dict(sharding=4), "dp2_sharding2": dict(dp=2, sharding=2)}
STAGES = (0, 1, 2, 3)
LOSS_TOL = dict(rtol=2e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
CLIP_NORM = 0.05


class _MLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.l1 = jnn.Linear(H, H)
        self.l2 = jnn.Linear(H, H)
        self.l3 = jnn.Linear(H, 8)

    def forward(self, x):
        h = jnn.functional.relu(self.l1(x))
        h = jnn.functional.relu(self.l2(h))
        return self.l3(h)


def _state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _data():
    rng = np.random.default_rng(0)
    return (np.asarray(rng.normal(size=(B, H)), np.float32),
            np.asarray(rng.normal(size=(B, 8)), np.float32))


def _gpt_inputs():
    from paddle_tpu.models import GPTForCausalLM, gpt3_tiny

    paddle.seed(0)
    cfg = gpt3_tiny()
    cfg.num_layers = 2
    state = _state(GPTForCausalLM(cfg))
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16))
    labels = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16))
    return state, ids, labels


def _jax_mlp(mesh_kw, stage, steps=4):
    paddle.seed(0)
    model = _MLP()
    crit = jnn.MSELoss()
    step = jdist.DistributedTrainStep(
        model, lambda o, y: crit(o, y),
        jopt.AdamW(learning_rate=1e-3, parameters=model.parameters()),
        mesh=jdist.build_mesh(**mesh_kw), sharding_stage=stage)
    x, y = _data()
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
              for _ in range(steps)]
    step.sync_weights()
    jdist.env.set_global_mesh(None)
    return losses, _state(model)


def _jax_gpt(mesh_kw, stage):
    """dryrun_multichip's one_step (`__graft_entry__.py:111-142`)."""
    from paddle_tpu.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                   gpt3_tiny)

    paddle.seed(0)
    cfg = gpt3_tiny()
    cfg.num_layers = 2
    model = GPTForCausalLM(cfg)
    crit = GPTPretrainingCriterion(cfg)
    n = int(np.prod(list(mesh_kw.values()))) if mesh_kw else 1
    import jax

    step = jdist.DistributedTrainStep(
        model, lambda lg, lb: crit(lg, lb),
        jopt.AdamW(learning_rate=1e-4, parameters=model.parameters()),
        mesh=jdist.build_mesh(**mesh_kw, devices=jax.devices()[:n]),
        sharding_stage=stage)
    _, ids, labels = _gpt_inputs()
    loss = float(step(paddle.to_tensor(ids), paddle.to_tensor(labels)))
    jdist.env.set_global_mesh(None)
    return loss


# Lamb and Lars, which read norms of the whole parameter
NORM_OPTS = {"lamb": ("Lamb", dict(learning_rate=0.02,
                                   lamb_weight_decay=0.01)),
             "lars": ("Lars", dict(learning_rate=0.5, lars_coeff=0.02,
                                   lars_weight_decay=0.001))}
ZERO_D_OPTS = {"nadam": ("NAdam", dict(learning_rate=0.02)),
               "asgd": ("ASGD", dict(learning_rate=0.05, batch_num=3))}
NORM_CASES = {"dp2_sharding2_stage2": ("mlp", dict(dp=2, sharding=2), 2),
              "sharding4_stage2_offload": ("mlp", dict(sharding=4), 2),
              "dp2_mp2": ("tp_mlp", dict(dp=2, mp=2), 0)}


class _JaxTPMLP(jnn.Layer):
    """tests/torch_tp_cases.py's TPMLP in the JAX package."""

    def __init__(self):
        super().__init__()
        from paddle_tpu.distributed.fleet.layers import mpu

        self.fc1 = mpu.ColumnParallelLinear(8, 32, gather_output=False)
        self.fc2 = mpu.RowParallelLinear(32, 8, input_is_parallel=True)

    def forward(self, x):
        return self.fc2(jnn.functional.relu(self.fc1(x)))


def _tp_inputs():
    rng = np.random.default_rng(1)
    paddle.seed(7)
    return (_state(_JaxTPMLP()), rng.random((8, 8)).astype(np.float32),
            rng.random((8, 8)).astype(np.float32))


def _jax_whole_norms(opt_name, case):
    """The JAX DistributedTrainStep with Lamb or Lars (norms over its
    global arrays) on the case's model and mesh, 3 steps; offload runs the
    same values, so the reference is the step without it."""
    import jax

    model_kind, mesh_kw, stage = NORM_CASES[case]
    if model_kind == "mlp":
        paddle.seed(0)
        model = _MLP()
        x, y = _data()
    else:
        state, x, y = _tp_inputs()
        model = _JaxTPMLP()
        model.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    crit = jnn.MSELoss()
    cls, kw = NORM_OPTS[opt_name]
    n = int(np.prod(list(mesh_kw.values())))
    step = jdist.DistributedTrainStep(
        model, lambda o, t: crit(o, t),
        getattr(jopt, cls)(parameters=model.parameters(), **kw),
        mesh=jdist.build_mesh(**mesh_kw, devices=jax.devices()[:n]),
        sharding_stage=stage)
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
              for _ in range(3)]
    step.sync_weights()
    jdist.env.set_global_mesh(None)
    return losses, _state(model)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    paddle.seed(0)
    init = _state(_MLP())
    x, y = _data()
    gpt, ids, labels = _gpt_inputs()
    tp_mlp, tp_x, tp_y = _tp_inputs()
    inputs = dict(mlp=init, x=x, y=y, clip_norm=CLIP_NORM, gpt=gpt,
                  gpt_ids=ids, gpt_labels=labels, tp_mlp=tp_mlp, tp_x=tp_x,
                  tp_y=tp_y, norm_opts=NORM_OPTS, zero_d_opts=ZERO_D_OPTS)
    four = Ranks("sharding", 4, tmp_path_factory.mktemp("shard4"), inputs)
    one = Ranks("sharding", 1, tmp_path_factory.mktemp("shard1"), inputs)
    jax_ref = {(m, s): _jax_mlp(kw, s) for m, kw in MESHES.items()
               for s in STAGES}
    gpt_ref = {"single": _jax_gpt({}, 0)}
    for s in (2, 3):
        gpt_ref[s] = _jax_gpt(dict(dp=2, sharding=2), s)
    norm_ref = {(o, c): _jax_whole_norms(o, c) for o in NORM_OPTS
                for c in NORM_CASES}
    out = {"init": init, "jax": jax_ref, "gpt": gpt_ref, "norms": norm_ref}
    for name, g in (("four", four), ("one", one)):
        try:
            out[name] = g.results(timeout=180)
        except RuntimeError as e:
            out[name] = e
    return out


def _case(runs, name, world="four"):
    r = runs[world]
    if isinstance(r, Exception):
        raise r
    return [check(v) for v in r[name]]


def _port_mlp_run(init, steps, clip=None):
    """The port's one-device step on the whole batch (mesh=None)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    model = mlp(init)
    step = TrainStep(model, mse, AdamW(
        learning_rate=1e-3, parameters=model.parameters(),
        grad_clip=None if clip is None else ClipGradByGlobalNorm(clip)))
    x, y = _data()
    losses = [step(x, y).item() for _ in range(steps)]
    return losses, {k: v.numpy() for k, v in model.state_dict().items()}


def _assert_params(got, want, tol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_stage_matches_jax_distributed_train_step(runs, mesh, stage):
    """Losses over 4 steps and the gathered parameters after them, on every
    rank, against the JAX DistributedTrainStep on build_mesh of the same
    shape (tests/test_sharding_stages.py:84, tests/test_distributed.py:216)."""
    losses, params = runs["jax"][(mesh, stage)]
    for rank, got in enumerate(_case(runs, f"{mesh}_stage{stage}")):
        np.testing.assert_allclose(got["losses"], losses, **LOSS_TOL)
        _assert_params(got["params"], params, PARAM_TOL, f"rank {rank}")
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("stage", (1, 2))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_optimizer_state_per_rank_at_most_half(runs, mesh, stage):
    """tests/test_sharding_stages.py:97: one rank's optimizer state at
    stages 1-2 is at most half of stage 0's."""
    base = _case(runs, f"{mesh}_stage0")
    for r, got in enumerate(_case(runs, f"{mesh}_stage{stage}")):
        assert got["state_bytes"] <= base[r]["state_bytes"] / 2


@pytest.mark.parametrize("mesh", list(MESHES))
def test_stage3_parameters_per_rank_at_most_half(runs, mesh):
    """tests/test_sharding_stages.py:106: stage 3 holds at most half of
    the parameter bytes on one rank (the shards)."""
    base = _case(runs, f"{mesh}_stage0")
    for r, got in enumerate(_case(runs, f"{mesh}_stage3")):
        assert got["param_bytes"] <= base[r]["param_bytes"] / 2


@pytest.mark.parametrize("stage", (2, 3))
def test_offload_follows_the_non_offload_trajectory(runs, stage):
    """offload=True gives the non-offload run's losses and parameters, and
    every state tensor is on the host between steps (the CPU itself here:
    host_memory_kind gives "unpinned_host")."""
    ref = _case(runs, f"sharding4_stage{stage}")
    for r, got in enumerate(_case(runs, f"sharding4_stage{stage}_offload")):
        np.testing.assert_allclose(got["losses"], ref[r]["losses"], **LOSS_TOL)
        _assert_params(got["params"], ref[r]["params"], LOSS_TOL, "offload")
        assert got["state_devices"] == ["cpu"]
        assert got["host_kind"] == "unpinned_host"


@pytest.mark.parametrize("case", ["sharding4_stage2", "sharding4_stage3",
                                  "dp2_sharding2_stage2",
                                  "dp2_sharding2_stage3",
                                  "sharding4_stage2_offload",
                                  "sharding4_stage3_offload"])
def test_comm_overlap_on_and_off_are_bit_for_bit(runs, case):
    """tests/test_sharding_stages.py:149-175: the in-backward bucket
    collectives change when they start, not what they give."""
    for on, off in zip(_case(runs, case), _case(runs, case + "_no_overlap")):
        assert on["losses"] == off["losses"]
        for k in on["params"]:
            np.testing.assert_array_equal(on["params"][k], off["params"][k])


@pytest.mark.parametrize("case", ["stage1", "stage2", "stage3",
                                  "stage2_offload", "stage3_offload"])
def test_one_rank_equals_stage0_bit_for_bit(runs, case):
    """Over a group of one the gathers and reduce-scatters run and change
    nothing: stages 1-3 and offload are stage 0, bit for bit."""
    (ref,) = _case(runs, "one_rank_stage0", "one")
    (got,) = _case(runs, f"one_rank_{case}", "one")
    assert got["losses"] == ref["losses"]
    for k in ref["params"]:
        np.testing.assert_array_equal(got["params"][k], ref["params"][k])


@pytest.mark.parametrize("stage", (2, 3))
def test_gpt3_tiny_dp2_sharding2_matches_jax(runs, stage):
    """dryrun_multichip's gate at dp=2 x sharding=2: the step's loss within
    rtol 2e-3 of the JAX single-device step and of the JAX
    DistributedTrainStep on the same mesh."""
    for loss in _case(runs, f"gpt3_tiny_dp2_sharding2_stage{stage}"):
        np.testing.assert_allclose(loss, runs["gpt"]["single"], rtol=2e-3)
        np.testing.assert_allclose(loss, runs["gpt"][stage], rtol=2e-3)


def test_global_norm_clip_in_the_step_matches_jax_train_step(runs):
    """ClipGradByGlobalNorm in the port's step against the JAX
    jit.TrainStep with grad_clip, at a clip norm that binds, 3 steps."""
    model = mlp(runs["init"])
    x, y = _data()
    mse(model(torch.as_tensor(x)), torch.as_tensor(y)).backward()
    norm = torch.cat([p.grad.reshape(-1) for p in model.parameters()]).norm()
    assert norm > 2 * CLIP_NORM  # the clip binds
    paddle.seed(0)
    jm = _MLP()
    crit = jnn.MSELoss()
    jstep = JaxTrainStep(jm, lambda o, t: crit(o, t), jopt.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(),
        grad_clip=jnn.ClipGradByGlobalNorm(CLIP_NORM)))
    want = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)))
            for _ in range(3)]
    got, params = _port_mlp_run(runs["init"], 3, clip=CLIP_NORM)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jstep.sync_weights()
    _assert_params(params, _state(jm), PARAM_TOL, "clip")


@pytest.mark.parametrize("stage", (2, 3))
def test_global_norm_clip_sharded_matches_one_rank(runs, stage):
    """At 4 ranks the clip's squared sum spans the shards: the clipped run
    follows the one-device clipped run."""
    want, params = _port_mlp_run(runs["init"], 3, clip=CLIP_NORM)
    for got in _case(runs, f"sharding4_stage{stage}_clip"):
        np.testing.assert_allclose(got["losses"], want, rtol=2e-4)
        _assert_params(got["params"], params, PARAM_TOL, "clip")


def _pairs(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * 3
            for s in [(4, 3), (7,), (2, 2, 5)]]


@pytest.mark.parametrize("kind", ["value", "norm", "global_norm"])
def test_eager_clip_classes_match_jax(kind):
    grads = _pairs(1)
    mk = {"value": lambda m: m.ClipGradByValue(0.5, -0.25),
          "norm": lambda m: m.ClipGradByNorm(1.0),
          "global_norm": lambda m: m.ClipGradByGlobalNorm(1.0)}[kind]
    want = [g.numpy() for _, g in mk(jnn)(
        [(None, paddle.to_tensor(g)) for g in grads])]
    got = [g.numpy() for _, g in mk(pnn)(
        [(None, torch.from_numpy(g)) for g in grads])]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("fn", ["clip_grad_norm_", "clip_grad_norm_inf",
                                "clip_grad_value_"])
def test_clip_grad_functions_match_jax(fn):
    import jax.numpy as jnp
    from paddle_tpu.framework.core import Parameter
    from paddle_tpu.nn import clip as jclip
    from paddle_tpu_torch.nn import clip as tclip

    grads = _pairs(2)
    jp, tp = [], []
    for g in grads:
        p = Parameter(jnp.zeros(g.shape, jnp.float32))
        p.grad = paddle.to_tensor(g)
        jp.append(p)
        q = torch.nn.Parameter(torch.zeros(g.shape))
        q.grad = torch.from_numpy(g.copy())
        tp.append(q)
    if fn == "clip_grad_value_":
        jclip.clip_grad_value_(jp, 0.7)
        tclip.clip_grad_value_(tp, 0.7)
    else:
        nt = float("inf") if fn.endswith("inf") else 2.0
        jt = jclip.clip_grad_norm_(jp, 1.5, norm_type=nt)
        tt = tclip.clip_grad_norm_(tp, 1.5, norm_type=nt)
        np.testing.assert_allclose(tt.numpy(), jt.numpy(), rtol=1e-6)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-6)


def test_group_sharded_parallel_levels(runs):
    """tests/test_distributed.py:243-258: each level marks its stage and a
    step built on the annotated optimizer runs it; p_g_os annotates the
    parameters' FSDP specs."""
    for got in _case(runs, "group_sharded_levels"):
        assert {k: (v["stage"], v["step"]) for k, v in got.items()} == {
            "os": (1, 1), "os_g": (2, 2), "p_g_os": (3, 3)}
        assert got["p_g_os"]["dist_attr"] is not None
        assert "sharding" in got["p_g_os"]["dist_attr"]
        assert len({v["loss"] for v in got.values()}) == 1


def test_save_group_sharded_model_saves_full_tensors(runs):
    """reference parallel.py:92: a stage-3 model with offload saved from 4
    ranks holds its full parameters under the reference's names, and the
    optimizer's state by parameter name at full shape."""
    got = _case(runs, "save_group_sharded_model")
    model = torch.load(got[0]["path"] + ".pdmodel")
    opt = torch.load(got[0]["path"] + ".pdopt")
    assert set(model) == set(runs["init"]) == set(opt)
    for k, v in model.items():
        assert tuple(v.shape) == runs["init"][k].shape
        for rank in got:
            np.testing.assert_array_equal(v.numpy(), rank["params"][k])
        assert {n: tuple(t.shape) for n, t in opt[k].items()} == {
            "m": v.shape, "v": v.shape}


def test_a_dropped_step_releases_its_model(runs):
    """A DistributedTrainStep that nothing refers to any more lets go of
    its model (and with it the parameters and states): its gradient hooks
    hold it weakly."""
    for got in _case(runs, "released"):
        assert got == [True, True]


def test_group_sharded_parallel_bad_level_raises():
    net = mlp(_state(_MLP()))
    opt = AdamW(learning_rate=0.1, parameters=net.parameters())
    with pytest.raises(ValueError):
        group_sharded_parallel(net, opt, "bogus")


def _eager_one_rank(init, steps, clip=None):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    model = mlp(init)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                grad_clip=None if clip is None else ClipGradByGlobalNorm(clip))
    x, y = _data()
    for _ in range(steps):
        mse(model(torch.as_tensor(x)), torch.as_tensor(y)).backward()
        opt.step()
        opt.clear_grad()
    return {k: v.numpy() for k, v in model.state_dict().items()}


def test_data_parallel_eager_loop_matches_one_rank(runs):
    """An eager loop (backward, step, clear_grad) through DataParallel, a
    quarter of the batch on each of 4 ranks, against the whole batch on
    one."""
    want = _eager_one_rank(runs["init"], 3)
    for got in _case(runs, "data_parallel_eager"):
        _assert_params(got, want, PARAM_TOL, "dp")


def test_fleet_init_distributed_model_and_optimizer_run_a_dp_step(runs):
    want = _eager_one_rank(runs["init"], 1, clip=CLIP_NORM)
    for got in _case(runs, "fleet_data_parallel"):
        assert got["mode"] == "data_parallel"
        assert got["wrapped"] == "DataParallel"
        assert got["clip"] == "_HybridParallelClipGrad"
        _assert_params(got["params"], want, PARAM_TOL, "fleet")


def test_unported_parallelisms_raise_naming_their_items(runs):
    """Every parallelism builds: an mp, pp, sep or ep mesh gives a
    DistributedTrainStep (a model with no stages is whole on every pp
    rank, one without context parallelism on every sep rank, one without
    expert layers on every ep rank), fleet's tensor_parallel mode and its
    pipeline_parallel mode on a model that is not a PipelineLayer give
    TensorParallel, its segment_parallel mode SegmentParallel, as the
    reference's (tests/test_torch_tensor_parallel.py,
    tests/test_torch_pipeline.py, tests/test_torch_ring_attention.py and
    tests/test_torch_expert_parallel.py hold what they do)."""
    for got in _case(runs, "unported"):
        assert got == {"mp": "DistributedTrainStep",
                       "pp": "DistributedTrainStep",
                       "sep": "DistributedTrainStep",
                       "ep": "DistributedTrainStep",
                       "tensor_parallel": "TensorParallel",
                       "pipeline_parallel": "TensorParallel",
                       "segment_parallel": "SegmentParallel"}


@pytest.mark.parametrize("case", list(NORM_CASES))
@pytest.mark.parametrize("opt_name", list(NORM_OPTS))
def test_whole_parameter_norms_under_a_cut_match_jax(runs, opt_name, case):
    """Lamb's trust ratio and Lars's local rate take the norms of the whole
    parameter, as the JAX step's over its global arrays: under a ZeRO
    shard, offload slices of a shard, and an mp-cut ColumnParallelLinear;
    each piece's own norms are the control that must miss."""
    losses, params = runs["norms"][(opt_name, case)]
    for rank, got in enumerate(_case(runs, f"{opt_name}_{case}")):
        np.testing.assert_allclose(got["losses"], losses, **LOSS_TOL)
        _assert_params(got["params"], params, PARAM_TOL, f"rank {rank}")
    local = _case(runs, f"{opt_name}_{case}_local")[0]["params"]
    miss = max(np.abs(local[k] - params[k]).max()
               / (1e-5 + 1e-4 * np.abs(params[k]).max()) for k in params)
    assert miss > 10, miss


@pytest.mark.parametrize("opt_name", list(ZERO_D_OPTS))
def test_offload_slices_step_a_zero_d_state_once(runs, opt_name):
    """NAdam's mu_prod and ASGD's ring index are the whole parameter's:
    under offload every slice of a shard steps from the value before the
    step and the value moves once a step, so the run follows the one
    without offload."""
    ref = _case(runs, f"{opt_name}_sharding4_stage2")
    for r, got in enumerate(_case(runs, f"{opt_name}_sharding4_stage2_offload")):
        np.testing.assert_allclose(got["losses"], ref[r]["losses"], **LOSS_TOL)
        _assert_params(got["params"], ref[r]["params"], LOSS_TOL, "offload")
