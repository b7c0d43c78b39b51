"""The port's tensor and sequence parallelism, and the sharded step's loss
over the global batch, held to the JAX package at 2 and 4 gloo ranks on
the CPU.

A 2-rank and a 4-rank group are spawned once for the module
(`torch_dist_worker.Ranks`, suite "tensor_parallel": the cases of
`tests/torch_tp_cases.py`); they run while the JAX references trace here,
once each, on the conftest's virtual CPU devices. Every weight is the JAX
package's initial one, carried across by `convert.load_paddle_tpu_state`
into a model the step (or `shard_model`) has cut already, so each rank
takes its slice.

- The mp layers (Column/Row/VocabParallel, ParallelCrossEntropy with
  `ignore_index`) at mp 2 and 4: each rank's outputs and gradients put
  together against the JAX layers and a numpy dense oracle (the pattern of
  `tests/test_distributed.py:121-157`), LAYER_TOL.
- The four sequence-parallel ops and the sequence-parallel linears,
  forward and backward, against their dense duals, LAYER_TOL.
- The TP MLP of `tests/test_distributed.py:190-216` (dp 2 x mp 2, SGD, 5
  steps, `input_specs`), gpt3_tiny with `sequence_parallel` at sharding 2
  x mp 2 at stages 1-3 (`dryrun_multichip`'s stage-2/3 configs with dp cut
  to 1: 2 layers, B 4 x 16, AdamW 1e-4, seed 0; stage 3 with recompute),
  llama_tiny (GQA 4 over 2, RoPE, SwiGLU, untied head) with
  `sequence_parallel` and recompute at mp 2, and a binding global-norm
  clip under SGD at mp 2 and at sharding 2 x mp 2 (stage 3 with
  offload): losses and parameters against the JAX step
  (STEP_TOL, PARAM_TOL: the gate's rtol is 2e-3, these hold tighter).
- fleet's tensor_parallel mode in an eager loop at dp 2 x mp 2.
- `convert` into an mp-cut model (mp 2; and sharding 2 x mp 2 at stage 3)
  and `full_state_dict` back, bit for bit.
- The loss over the global batch (queue C): a `loss_mask`ed
  `GPTPretrainingCriterion` whose mask keeps unequal rows per rank, and a
  summed cross entropy with and without a binding global-norm clip, under
  SGD (where no AdamW normalisation hides a scaled gradient), at dp 2 and
  4 over 3 steps.
"""

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.fleet.layers import mpu as jmpu
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt3_tiny as jax_gpt3_tiny
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import SGD
from torch_dist_worker import Ranks, check
from torch_tp_cases import TPMLP, Cls, mse

WORLDS = (2, 4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
GPT_LR, SGD_LR, SUM_LR = 1e-4, 0.5, 0.05
GPT_CLIP, SUM_CLIP, TP_CLIP = 0.1, 1.0, 0.05
MISS_BY = 100 * PARAM_TOL["atol"]


def _state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _jt(a, grad=False):
    t = paddle.to_tensor(np.asarray(a))
    t.stop_gradient = not grad
    return t


def _layer_inputs():
    """JAX layers' initial weights (random biases), inputs and output
    gradients of the layer cases."""
    rng = np.random.default_rng(3)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    paddle.seed(0)
    col = jmpu.ColumnParallelLinear(8, 16, gather_output=False)
    row = jmpu.RowParallelLinear(16, 8, input_is_parallel=True)
    emb = jmpu.VocabParallelEmbedding(16, 8)
    labels = rng.integers(0, 16, (2, 5))
    labels[0, 2] = labels[1, 4] = -100
    return dict(col_w=col.weight.numpy(), col_b=f32(16),
                row_w=row.weight.numpy(), row_b=f32(8),
                emb_w=emb.weight.numpy(), x8=f32(2, 3, 8), x16=f32(2, 3, 16),
                dy16=f32(2, 3, 16), dy8=f32(2, 3, 8),
                ids=rng.integers(0, 16, (2, 5)), dy_emb=f32(2, 5, 8),
                logits=f32(2, 5, 16) * 3, ce_labels=labels, dloss=f32(2, 5))


def _jax_layers(L):
    """Every layer case's full outputs and gradients from the JAX layers."""
    out = {}

    def grads(layer, x, y, dy):
        (y * _jt(dy)).sum().backward()
        return dict(out=y.numpy(), dx=None if x is None else x.grad.numpy(),
                    dw=layer.weight.grad.numpy(),
                    db=None if getattr(layer, "bias", None) is None
                    else layer.bias.grad.numpy())

    for gather in (False, True):
        col = jmpu.ColumnParallelLinear(8, 16, gather_output=gather)
        col.weight.set_value(L["col_w"])
        col.bias.set_value(L["col_b"])
        x = _jt(L["x8"], True)
        out[f"column_gather_{gather}"] = grads(col, x, col(x), L["dy16"])
    for parallel in (True, False):
        row = jmpu.RowParallelLinear(16, 8, input_is_parallel=parallel)
        row.weight.set_value(L["row_w"])
        row.bias.set_value(L["row_b"])
        x = _jt(L["x16"], True)
        out[f"row_parallel_input_{parallel}"] = grads(row, x, row(x), L["dy8"])
    emb = jmpu.VocabParallelEmbedding(16, 8)
    emb.weight.set_value(L["emb_w"])
    out["vocab_embedding"] = grads(emb, None, emb(_jt(L["ids"])), L["dy_emb"])
    lg = _jt(L["logits"], True)
    loss = jmpu.ParallelCrossEntropy()(lg, _jt(L["ce_labels"]))
    (loss * _jt(L["dloss"])).sum().backward()
    out["parallel_cross_entropy"] = dict(loss=loss.numpy(),
                                         dlogits=lg.grad.numpy())
    return out


def _oracle(L):
    """The dense numpy forward of each layer case."""
    lg = L["logits"].astype(np.float64)
    lse = np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1)) + lg.max(-1)
    ids = np.where(L["ce_labels"] < 0, 0, L["ce_labels"])
    ce = lse - np.take_along_axis(lg, ids[..., None], -1)[..., 0]
    col = L["x8"] @ L["col_w"] + L["col_b"]
    row = L["x16"] @ L["row_w"] + L["row_b"]
    return {"column_gather_False": col, "column_gather_True": col,
            "row_parallel_input_True": row, "row_parallel_input_False": row,
            "vocab_embedding": L["emb_w"][L["ids"]],
            "parallel_cross_entropy": np.where(L["ce_labels"] < 0, 0.0, ce)}


def _gpt_state(cls=JaxGPT, cfg_fn=jax_gpt3_tiny):
    paddle.seed(0)
    cfg = cfg_fn()
    cfg.num_layers = 2
    return _state(cls(cfg))


def _jax_step(model, loss_fn, opt, mesh_kw, stage, inputs, labels, steps):
    """Losses and final parameters of the JAX DistributedTrainStep on a
    mesh of the conftest's virtual devices (jit.TrainStep without one)."""
    if mesh_kw:
        n = int(np.prod(list(mesh_kw.values())))
        step = jdist.DistributedTrainStep(
            model, loss_fn, opt, sharding_stage=stage,
            mesh=jdist.build_mesh(**mesh_kw, devices=jax.devices()[:n]))
    else:
        step = JaxTrainStep(model, loss_fn, opt)
    losses = [float(step([_jt(x) for x in inputs], [_jt(y) for y in labels]))
              for _ in range(steps)]
    step.sync_weights()
    jdist.env.set_global_mesh(None)
    return losses, _state(model)


def _jax_gpt(inp, mesh_kw, stage, cfg_fn=jax_gpt3_tiny, cls=JaxGPT,
             opt=None, clip=None, steps=3, **cfg_kw):
    paddle.seed(0)
    cfg = cfg_fn(**cfg_kw)
    cfg.num_layers = 2
    model = cls(cfg)
    crit = JaxCriterion(cfg)
    grad_clip = None if clip is None else jnn.ClipGradByGlobalNorm(clip)
    o = (jopt.SGD(learning_rate=SGD_LR, parameters=model.parameters(),
                  grad_clip=grad_clip) if opt == "sgd" else
         jopt.AdamW(learning_rate=GPT_LR, parameters=model.parameters()))
    return _jax_step(model, lambda lg, lb: crit(lg, lb), o, mesh_kw, stage,
                     [inp["gpt_ids"]], [inp["gpt_labels"]], steps)


class _JaxTPMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jmpu.ColumnParallelLinear(8, 32, gather_output=False)
        self.fc2 = jmpu.RowParallelLinear(32, 8, input_is_parallel=True)

    def forward(self, x):
        return self.fc2(jnn.functional.relu(self.fc1(x)))


class _JaxCls(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.l1 = jnn.Linear(16, 32)
        self.l2 = jnn.Linear(32, 8)

    def forward(self, x):
        return self.l2(jnn.functional.relu(self.l1(x)))


def _inputs():
    rng = np.random.default_rng(1)
    paddle.seed(7)
    tp_mlp = _state(_JaxTPMLP())
    paddle.seed(0)
    cls = _state(_JaxCls())
    mask = np.zeros((4, 16), np.float32)
    mask[0] = 1.0          # rank 0 of dp 2 keeps 19 tokens, rank 1 keeps 24
    mask[1, :3] = 1.0
    mask[2:, :12] = 1.0
    sp_x = rng.normal(size=(2, 8, 6)).astype(np.float32)
    paddle.seed(1)
    sp_pair = {"col.weight": jmpu.ColumnParallelLinear(6, 8).weight.numpy(),
               "col.bias": rng.normal(size=8).astype(np.float32),
               "row.weight": jmpu.RowParallelLinear(8, 6).weight.numpy(),
               "row.bias": rng.normal(size=6).astype(np.float32)}
    return dict(
        layers=_layer_inputs(), sp_x=sp_x,
        sp_dy=rng.normal(size=sp_x.shape).astype(np.float32), sp_pair=sp_pair,
        gpt=_gpt_state(), llama=_gpt_state(JaxLlama, jax_llama_tiny),
        gpt_ids=np.random.default_rng(0).integers(0, 1024, (4, 16)),
        gpt_labels=np.random.default_rng(1).integers(0, 1024, (4, 16)),
        mask=mask, tp_mlp=tp_mlp,
        tp_x=rng.random((8, 8)).astype(np.float32),
        tp_y=rng.random((8, 8)).astype(np.float32), cls=cls,
        cls_x=rng.normal(size=(16, 16)).astype(np.float32),
        cls_y=rng.integers(0, 8, 16), gpt_lr=GPT_LR,
        sgd_lr=SGD_LR, sum_lr=SUM_LR, gpt_clip=GPT_CLIP, sum_clip=SUM_CLIP,
        tp_clip=TP_CLIP)


def _jax_refs(inp):
    ref = {"layers": _jax_layers(inp["layers"])}
    for stage in (1, 2, 3):
        ref[f"gpt_sp_stage{stage}"] = _jax_gpt(
            inp, dict(sharding=2, mp=2), stage, sequence_parallel=True)
    ref["llama_sp_mp2"] = _jax_gpt(inp, dict(mp=2), 0, jax_llama_tiny,
                                   JaxLlama, sequence_parallel=True)
    ref["gpt_clip_sgd"] = _jax_gpt(inp, {}, 0, opt="sgd", clip=GPT_CLIP)
    ref["gpt_sp_stage3_clip_sgd"] = _jax_gpt(
        inp, dict(sharding=2, mp=2), 3, opt="sgd", clip=GPT_CLIP,
        sequence_parallel=True)
    paddle.seed(7)
    net = _JaxTPMLP()
    ref["tp_mlp"] = _jax_step(
        net, lambda o, y: jnn.functional.mse_loss(o, y),
        jopt.SGD(learning_rate=0.1, parameters=net.parameters()),
        dict(dp=2, mp=2), 0, [inp["tp_x"]], [inp["tp_y"]], 5)
    for w in WORLDS:
        paddle.seed(0)
        cfg = jax_gpt3_tiny()
        model = JaxGPT(cfg)
        crit = JaxCriterion(cfg)
        ref[f"masked_dp{w}"] = _jax_step(
            model, lambda lg, lb, m: crit(lg, lb, m),
            jopt.SGD(learning_rate=SGD_LR, parameters=model.parameters()),
            dict(dp=w), 0, [inp["gpt_ids"]], [inp["gpt_labels"], inp["mask"]],
            3)
        for clip in (None, SUM_CLIP):
            paddle.seed(0)
            net = _JaxCls()
            ref[f"summed{'_clip' if clip else ''}_dp{w}"] = _jax_step(
                net, lambda o, y: jnn.functional.cross_entropy(
                    o, y, reduction="sum"),
                jopt.SGD(learning_rate=SUM_LR, parameters=net.parameters(),
                         grad_clip=None if clip is None
                         else jnn.ClipGradByGlobalNorm(clip)),
                dict(dp=w), 0, [inp["cls_x"]], [inp["cls_y"]], 3)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inp = _inputs()
    groups = {w: Ranks("tensor_parallel", w, tmp_path_factory.mktemp(f"tp{w}"),
                       inp) for w in WORLDS}
    out = {"inp": inp, "jax": _jax_refs(inp)}
    for w, g in groups.items():
        try:
            out[w] = g.results(timeout=180)
        except RuntimeError as e:
            out[w] = e
    return out


def _case(runs, world, name):
    r = runs[world]
    if isinstance(r, Exception):
        raise r
    return [check(v) for v in r[name]]


def _close_params(got, want, tol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=f"{what} {k}")


def _cat(ranks, key, axis):
    return np.concatenate([r[key] for r in ranks], axis)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("gather", (False, True))
def test_column_parallel_linear(runs, world, gather):
    """Output features cut over mp: the ranks' outputs (gathered or put
    together) and weight and bias gradients, and the input gradient after
    c_identity's all-reduce, against the JAX layer and the dense oracle."""
    name = f"column_gather_{gather}"
    want = runs["jax"]["layers"][name]
    got = _case(runs, world, name)
    for r in got:
        np.testing.assert_allclose(r["dx"], want["dx"], **LAYER_TOL)
        if gather:
            np.testing.assert_allclose(r["out"], want["out"], **LAYER_TOL)
    out = got[0]["out"] if gather else _cat(got, "out", -1)
    np.testing.assert_allclose(out, want["out"], **LAYER_TOL)
    np.testing.assert_allclose(out, _oracle(runs["inp"]["layers"])[name],
                               **LAYER_TOL)
    np.testing.assert_allclose(_cat(got, "dw", 1), want["dw"], **LAYER_TOL)
    np.testing.assert_allclose(_cat(got, "db", 0), want["db"], **LAYER_TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("parallel", (True, False))
def test_row_parallel_linear(runs, world, parallel):
    """Input features cut over mp, the bias added once after the
    all-reduce: every rank's output, the input gradient (this rank's part
    with `input_is_parallel`, else whole), the weight rows' and the bias
    gradients."""
    name = f"row_parallel_input_{parallel}"
    want = runs["jax"]["layers"][name]
    got = _case(runs, world, name)
    for r in got:
        np.testing.assert_allclose(r["out"], want["out"], **LAYER_TOL)
        np.testing.assert_allclose(r["out"], _oracle(runs["inp"]["layers"])[name],
                                   **LAYER_TOL)
        np.testing.assert_allclose(r["db"], want["db"], **LAYER_TOL)
        if not parallel:
            np.testing.assert_allclose(r["dx"], want["dx"], **LAYER_TOL)
    if parallel:
        np.testing.assert_allclose(_cat(got, "dx", -1), want["dx"], **LAYER_TOL)
    np.testing.assert_allclose(_cat(got, "dw", 0), want["dw"], **LAYER_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_vocab_parallel_embedding(runs, world):
    want = runs["jax"]["layers"]["vocab_embedding"]
    got = _case(runs, world, "vocab_embedding")
    for r in got:
        np.testing.assert_allclose(r["out"], want["out"], **LAYER_TOL)
        np.testing.assert_allclose(
            r["out"], _oracle(runs["inp"]["layers"])["vocab_embedding"],
            **LAYER_TOL)
    np.testing.assert_allclose(_cat(got, "dw", 0), want["dw"], **LAYER_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_parallel_cross_entropy(runs, world):
    """Vocab-sharded logits with `ignore_index` rows: the per-token loss on
    every rank (0 where ignored) and each rank's logits gradient."""
    want = runs["jax"]["layers"]["parallel_cross_entropy"]
    got = _case(runs, world, "parallel_cross_entropy")
    oracle = _oracle(runs["inp"]["layers"])["parallel_cross_entropy"]
    for r in got:
        np.testing.assert_allclose(r["loss"], want["loss"], **LAYER_TOL)
        np.testing.assert_allclose(r["loss"], oracle, **LAYER_TOL)
        assert (r["loss"][runs["inp"]["layers"]["ce_labels"] < 0] == 0).all()
    np.testing.assert_allclose(_cat(got, "dlogits", -1), want["dlogits"],
                               **LAYER_TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op", ("scatter", "gather", "all_gather",
                                "reduce_scatter"))
def test_sequence_parallel_ops(runs, world, op):
    """Each op and its backward dual along the sequence dim: scatter
    (rows / all-gather), gather (all-gather / rows), all_gather (all-gather
    / reduce-scatter), reduce_scatter (reduce-scatter / all-gather); each
    rank's inputs and output gradients differ where the dual sums them."""
    x, dy = runs["inp"]["sp_x"], runs["inp"]["sp_dy"]
    k = x.shape[1] // world
    total = sum(range(1, world + 1))
    for rank, res in enumerate(_case(runs, world, "sp_ops")):
        mine = slice(rank * k, (rank + 1) * k)
        want_out, want_dx = {
            "scatter": (x[:, mine], dy),
            "gather": (x, dy[:, mine]),
            "all_gather": (x, dy[:, mine] * total),
            "reduce_scatter": (x[:, mine] * total, dy)}[op]
        np.testing.assert_allclose(res[op]["out"], want_out, **LAYER_TOL)
        np.testing.assert_allclose(res[op]["dx"], want_dx, **LAYER_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sequence_parallel_linears(runs, world):
    """ColumnSequenceParallelLinear then RowSequenceParallelLinear on the
    sequence shard against the dense pair: each rank's output rows and
    input gradient rows, the weights' shards' gradients, and the row bias's
    gradient summed over mp by register_sequence_parallel_allreduce_hooks."""
    inp = runs["inp"]
    st = {k: torch.tensor(v, requires_grad=True) for k, v in inp["sp_pair"].items()}
    x = torch.tensor(inp["sp_x"], requires_grad=True)
    y = (x @ st["col.weight"] + st["col.bias"]) @ st["row.weight"] + st["row.bias"]
    (y * torch.tensor(inp["sp_dy"])).sum().backward()
    got = _case(runs, world, "sp_linears")
    k = x.shape[1] // world
    for rank, r in enumerate(got):
        mine = slice(rank * k, (rank + 1) * k)
        np.testing.assert_allclose(r["out"], y.detach().numpy()[:, mine], **LAYER_TOL)
        np.testing.assert_allclose(r["dx"], x.grad.numpy()[:, mine], **LAYER_TOL)
        np.testing.assert_allclose(r["grads"]["row.bias"],
                                   st["row.bias"].grad.numpy(), **LAYER_TOL)
    for name, axis in (("col.weight", 1), ("col.bias", 0), ("row.weight", 0)):
        np.testing.assert_allclose(
            np.concatenate([r["grads"][name] for r in got], axis),
            st[name].grad.numpy(), **LAYER_TOL)


def _hold_step(got, want, what):
    losses, params = want
    for rank, r in enumerate(got):
        np.testing.assert_allclose(r["losses"], losses, **STEP_TOL,
                                   err_msg=f"{what} rank {rank}")
        _close_params(r["params"], params, PARAM_TOL, f"{what} rank {rank}")


def test_tp_mlp_dp2_mp2_matches_jax(runs):
    """tests/test_distributed.py:190-216 at dp 2 x mp 2: SGD 0.1, 5 steps,
    the batch cut by `input_specs` / `label_specs` of
    PartitionSpec("dp", None)."""
    _hold_step(_case(runs, 4, "tp_mlp_dp2_mp2"), runs["jax"]["tp_mlp"],
               "tp_mlp")
    assert runs["jax"]["tp_mlp"][0][-1] < runs["jax"]["tp_mlp"][0][0]


@pytest.mark.parametrize("stage", (1, 2, 3))
def test_gpt3_tiny_sequence_parallel_sharding2_mp2(runs, stage):
    """dryrun_multichip's stage-2/3 configs with dp cut to 1 (and stage 1):
    gpt3_tiny with sequence_parallel at sharding 2 x mp 2, 3 AdamW steps,
    against the JAX DistributedTrainStep on the same mesh; the mp
    collectives ran (all-gathers and reduce-scatters of the sequence)."""
    got = _case(runs, 4, f"gpt_sp_sharding2_mp2_stage{stage}")
    _hold_step(got, runs["jax"][f"gpt_sp_stage{stage}"], f"stage {stage}")
    for r in got:
        assert r["calls"]["all_gather"] > 0 and r["calls"]["reduce_scatter"] > 0


def test_gpt3_tiny_stage3_offload_clip_sharding2_mp2(runs):
    """Stage 3 with offload over sharding 2 x mp 2, sequence_parallel, SGD
    under a binding global-norm clip: the clip's squared sum adds shards
    cut over sharding, over mp, over both, and replicated parameters once
    each; against the JAX DistributedTrainStep at the same mesh and
    stage."""
    _hold_step(_case(runs, 4, "gpt_sp_sharding2_mp2_stage3_offload_clip_sgd"),
               runs["jax"]["gpt_sp_stage3_clip_sgd"], "stage 3 offload clip")


def test_llama_tiny_sequence_parallel_mp2(runs):
    """GQA 4 query heads over 2 kv heads cut to 2 and 1 a rank, RoPE on the
    local heads at the whole sequence's positions, SwiGLU's gate and up as
    column shards and down as a row shard, the untied head vocab-sharded,
    with sequence_parallel and recompute."""
    _hold_step(_case(runs, 2, "llama_sp_mp2"), runs["jax"]["llama_sp_mp2"],
               "llama")


def test_global_norm_clip_binds_at_mp2(runs):
    """ClipGradByGlobalNorm at mp 2 under SGD against the JAX TrainStep on
    one device: the squared sum adds the mp shards' sums over mp and counts
    the replicated parameters once. The clip binds from the first step."""
    from paddle_tpu_torch.convert import load_paddle_tpu_state
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_tiny)

    inp = runs["inp"]
    model = load_paddle_tpu_state(GPTForCausalLM(gpt3_tiny(), device="cpu"),
                                  inp["gpt"])
    GPTPretrainingCriterion()(model(torch.tensor(inp["gpt_ids"])),
                              torch.tensor(inp["gpt_labels"])).backward()
    norm = torch.cat([p.grad.reshape(-1) for p in model.parameters()]).norm()
    assert norm > 2 * GPT_CLIP
    _hold_step(_case(runs, 2, "gpt_mp2_clip_sgd"), runs["jax"]["gpt_clip_sgd"],
               "clip")


def test_fleet_tensor_parallel_eager_loop(runs):
    """fleet.init(dp 2, mp 2) + distributed_model (TensorParallel) +
    distributed_optimizer with a binding global-norm clip: 3 eager SGD
    steps on half the batch a dp rank against the uncut model on the whole
    batch."""
    inp = runs["inp"]
    from paddle_tpu_torch.convert import load_paddle_tpu_state

    net = load_paddle_tpu_state(TPMLP(), inp["tp_mlp"])
    opt = SGD(learning_rate=0.1, parameters=net.parameters(),
              grad_clip=ClipGradByGlobalNorm(TP_CLIP))
    x, y = torch.tensor(inp["tp_x"]), torch.tensor(inp["tp_y"])
    for i in range(3):
        mse(net(x), y).backward()
        if i == 0:
            norm = torch.cat([p.grad.reshape(-1) for p in net.parameters()]).norm()
            assert norm > 2 * TP_CLIP
        opt.step()
        opt.clear_grad()
    want = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    for r in _case(runs, 4, "fleet_tensor_parallel_dp2_mp2"):
        assert (r["mode"], r["wrapped"]) == ("tensor_parallel", "TensorParallel")
        _close_params(r["params"], want, PARAM_TOL, "fleet")


@pytest.mark.parametrize("case,world", [("convert_mp2", 2),
                                        ("convert_stage3_sharding2_mp2", 4)])
def test_convert_into_an_mp_cut_model_and_back(runs, case, world):
    """load_paddle_tpu_state slices each full array to the rank's part (mp,
    then the stage-3 shard) and full_state_dict gathers it back, bit for
    bit; a rank holds a quarter (or half) of q_proj's columns."""
    state = runs["inp"]["gpt"]
    for r in _case(runs, world, case):
        assert r["shapes"]["gpt.layers.0.self_attn.q_proj.weight"][1] == 32
        assert set(r["params"]) == set(state)
        for k, v in state.items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_masked_loss_is_the_global_batch_loss(runs, world):
    """A loss_mask that keeps unequal rows per rank: the step's losses and
    parameters over 3 SGD steps are the JAX step's on the global batch.
    The same masked mean computed without its note (the equal-weight mean
    of the ranks' losses, what the step ran before) misses the reference's
    parameters by more than MISS_BY."""
    got = _case(runs, world, f"masked_dp{world}")
    want = runs["jax"][f"masked_dp{world}"]
    _hold_step(got, want, "masked")
    for r in _case(runs, world, f"masked_unnoted_dp{world}"):
        miss = max(np.abs(r["params"][k] - v).max() for k, v in want[1].items())
        assert miss > MISS_BY


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("clip", (False, True))
def test_summed_loss_is_the_global_batch_loss(runs, world, clip):
    """cross_entropy(reduction="sum") under SGD, and under a global-norm
    clip that binds: losses and parameters over 3 steps against the JAX
    step at dp 2 and 4."""
    name = f"summed{'_clip' if clip else ''}_dp{world}"
    _hold_step(_case(runs, world, name), runs["jax"][name], name)
    if clip:
        from paddle_tpu_torch.convert import load_paddle_tpu_state
        from paddle_tpu_torch.nn import functional as F

        inp = runs["inp"]
        net = load_paddle_tpu_state(Cls(), inp["cls"])
        F.cross_entropy(net(torch.tensor(inp["cls_x"])),
                        torch.tensor(inp["cls_y"]), reduction="sum").backward()
        norm = torch.cat([p.grad.reshape(-1) for p in net.parameters()]).norm()
        assert norm > 2 * SUM_CLIP
