"""The port's BERT (`models.bert`) held to the JAX package's on `bert_tiny`
in f32, the weights carried across by `load_paddle_tpu_state`: the
pretraining heads' logits (masked-LM at the masked positions, NSP) and
the sequence classifier's on a padded mask; the criterion with -100
slots; three AdamW steps of `bench.py`'s bert rung recipe (dropouts 0)
through `DistributedTrainStep` against the JAX step (losses, step-1
gradients, parameters); and the sequence classifier at dp 2 over gloo
ranks against the JAX `DistributedTrainStep` on a 2-device mesh, as
`tests/test_bert_unet.py::TestBert::test_sequence_classification_dp_trains`
trains it. The JAX side's attention runs its flash key-bias kernel in
interpret mode (the mask is a [B, 1, 1, S] key-padding mask); the port's
runs the kernels' plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.models.bert import BertForPretraining as JaxPretraining
from paddle_tpu.models.bert import \
    BertForSequenceClassification as JaxClassifier
from paddle_tpu.models.bert import BertPretrainingCriterion as JaxCriterion
from paddle_tpu.models.bert import bert_tiny as jax_tiny
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import DistributedTrainStep
from paddle_tpu_torch.models import (BertForPretraining,
                                     BertForSequenceClassification,
                                     BertPretrainingCriterion, bert_tiny)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as port_fa
from paddle_tpu_torch.optimizer import AdamW
from torch_dist_worker import Ranks, check

B, S, M, STEPS, LR = 4, 32, 6, 3, 1e-3
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
# f32 both sides: matmuls, norms and softmaxes sum in other orders; logits
# of magnitude ~10 (the tied decode against N(0, 1) embeddings) and losses
# ~20 agree to a few 1e-6 relative
TOL = dict(rtol=1e-5, atol=1e-4)
# The k-projection biases get an analytically zero gradient (q . b_k is
# the same for every key of a row, which the softmax cancels), so both
# packages see rounding noise there: each side's is held under 1e-3 of
# the largest gradient, and the parameters to |diff| <= 2 lr per step:
# AdamW moves each side's by at most about lr a step, in the directions
# of its own noise
NOISE_ONLY = "self_attn.k_proj.bias"


@pytest.fixture(autouse=True)
def _interpret_mode(pallas_interpret_unless_hw):
    pass


def _state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _inputs(seed=0):
    """(ids, token types, attention mask with padding on rows 1 and 3,
    masked positions, masked-LM labels with a -100 slot, NSP labels)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, (B, S))
    tt = (rng.random((B, S)) > 0.5).astype(np.int64)
    am = np.ones((B, S), np.float32)
    am[1, 20:] = 0
    am[3, 9:] = 0
    mpos = rng.integers(0, S, (B, M))
    mlab = rng.integers(0, 1024, (B, M))
    mlab[2, 1] = -100
    nlab = rng.integers(0, 2, (B,))
    return ids, tt, am, mpos, mlab, nlab


def _pretraining_pair():
    paddle.seed(0)
    jm = JaxPretraining(jax_tiny(**NO_DROPOUT))
    tm = BertForPretraining(bert_tiny(**NO_DROPOUT), device="cpu")
    load_paddle_tpu_state(tm, _state(jm))
    return jm, tm


def _jt(*xs):
    return [paddle.to_tensor(x) for x in xs]


def _tt(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def test_pretraining_and_classifier_logits_on_a_padded_mask():
    jm, tm = _pretraining_pair()
    ids, tt, am, mpos, _, _ = _inputs()
    jm.eval()
    tm.eval()
    jmlm, jnsp = jm(*_jt(ids, tt, am, mpos))
    tmlm, tnsp = tm(*_tt(ids, tt, am, mpos))
    assert tuple(tmlm.shape) == (B, M, 1024)
    np.testing.assert_allclose(tmlm.detach().numpy(), jmlm.numpy(), **TOL)
    np.testing.assert_allclose(tnsp.detach().numpy(), jnsp.numpy(), **TOL)
    assert port_fa.FWD_LAUNCHES == 0

    paddle.seed(1)
    jc = JaxClassifier(jax_tiny(), num_classes=3)
    tc = BertForSequenceClassification(bert_tiny(), num_classes=3, device="cpu")
    load_paddle_tpu_state(tc, _state(jc))
    jc.eval()
    tc.eval()
    np.testing.assert_allclose(tc(*_tt(ids, tt, am)).detach().numpy(),
                               jc(*_jt(ids, tt, am)).numpy(), **TOL)


def test_padded_keys_do_not_reach_the_pooled_output():
    """As the reference's test_model_shapes_and_mask: changing the ids at
    padded positions leaves row 1's pooled output alone."""
    _, tm = _pretraining_pair()
    tm.eval()
    ids, tt, am, _, _, _ = _inputs()
    ids2 = ids.copy()
    ids2[1, 20:] = (ids2[1, 20:] + 7) % 1024
    _, p1 = tm.bert(*_tt(ids, tt, am))
    _, p2 = tm.bert(*_tt(ids2, tt, am))
    torch.testing.assert_close(p1[1], p2[1], rtol=0, atol=1e-6)


def test_criterion_drops_minus_100_slots():
    rng = np.random.default_rng(3)
    mlm = rng.normal(size=(2, 5, 1024)).astype(np.float32)
    nsp = rng.normal(size=(2, 2)).astype(np.float32)
    mlab = rng.integers(0, 1024, (2, 5))
    mlab[0, 2:] = -100
    nlab = np.array([0, 1])
    want = float(JaxCriterion()(*_jt(mlm, nsp, mlab, nlab)))
    got = BertPretrainingCriterion()(*_tt(mlm, nsp, mlab, nlab)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    mlab_all = mlab.copy()
    mlab_all[0, 2:] = 5
    assert abs(BertPretrainingCriterion()(*_tt(mlm, nsp, mlab_all, nlab)).item()
               - got) > 1e-3


@pytest.fixture(scope="module")
def jax_steps():
    """bench.py's run_bert_rung recipe at bert_tiny, f32: AdamW, the JAX
    DistributedTrainStep on a one-device mesh, three steps; with the step-1
    gradients of an eager backward first."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        jm, _ = _pretraining_pair()
        init = _state(jm)
        crit = JaxCriterion()
        ids, tt, am, mpos, mlab, nlab = _inputs()
        loss = crit(*jm(*_jt(ids, tt, am, mpos)), *_jt(mlab, nlab))
        loss.backward()
        grads = {k: p.grad.numpy() for k, p in jm.named_parameters()}
        jm.clear_gradients()
        step = jdist.DistributedTrainStep(
            jm, lambda a, b, c, d: crit(a, b, c, d),
            jopt.AdamW(learning_rate=LR, parameters=jm.parameters()),
            mesh=jdist.build_mesh(devices=jax.devices()[:1]))
        losses = [float(step(_jt(ids, tt, am, mpos), _jt(mlab, nlab)))
                  for _ in range(STEPS)]
        step.sync_weights()
        jdist.env.set_global_mesh(None)
        return init, grads, losses, _state(jm)


def test_three_adamw_steps_match_jax(jax_steps):
    init, jgrads, jlosses, jstate = jax_steps
    tm = BertForPretraining(bert_tiny(**NO_DROPOUT), device="cpu")
    load_paddle_tpu_state(tm, init)
    crit = BertPretrainingCriterion()
    ids, tt, am, mpos, mlab, nlab = _inputs()
    crit(*tm(*_tt(ids, tt, am, mpos)), *_tt(mlab, nlab)).backward()
    gmax = max(float(np.abs(g).max()) for g in jgrads.values())
    for k, p in tm.named_parameters():
        assert p.grad is not None, k
        if NOISE_ONLY in k:
            assert max(p.grad.abs().max().item(),
                       float(np.abs(jgrads[k]).max())) <= 1e-3 * gmax, k
            continue
        scale = max(1.0, float(np.abs(jgrads[k]).max()))
        np.testing.assert_allclose(p.grad.numpy(), jgrads[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)
    tm.zero_grad(set_to_none=True)
    step = DistributedTrainStep(tm, lambda a, b, c, d: crit(a, b, c, d),
                                AdamW(learning_rate=LR,
                                      parameters=tm.parameters()))
    losses = [step([ids, tt, am, mpos], [mlab, nlab]).item()
              for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _held_params(tm.state_dict(), jstate, "after three steps")


def _held_params(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, v in got.items():
        v = np.asarray(v)
        if NOISE_ONLY in k:
            assert np.abs(v - want[k]).max() <= 2 * LR * STEPS, f"{what}: {k}"
        else:
            np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{what}: {k}")


def _classifier_inputs():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 1024, (8, 16))
    tt = np.zeros((8, 16), np.int64)
    am = np.ones((8, 16), np.float32)
    am[::3, 11:] = 0
    y = rng.integers(0, 2, (8,))
    return ids, tt, am, y


PT_LR = 0.1


def _pretraining_inputs():
    """_inputs with 8 masked slots a row, rank 0's rows (0 and 1) keeping
    12 of their 16 and rank 1's 2 of 16 at dp 2."""
    ids, tt, am, _, _, nlab = _inputs(5)
    rng = np.random.default_rng(6)
    mpos = rng.integers(0, S, (B, 8))
    mlab = np.full((B, 8), -100)
    kept = np.zeros((B, 8), bool)
    kept[:2].flat[rng.choice(16, 12, replace=False)] = True
    kept[2:].flat[rng.choice(16, 2, replace=False)] = True
    mlab[kept] = rng.integers(0, 1024, int(kept.sum()))
    return [ids, tt, am, mpos], [mlab, nlab]


def _pretraining_losses():
    """The pretraining losses the dp 2 cases train on, by case: the
    criterion, the criterion plus an auxiliary mean, and two cross
    entropies (on labels that keep every slot)."""
    crit = JaxCriterion()
    return {"pretrain": lambda a, b, c, d: crit(a, b, c, d),
            "pretrain_aux": lambda a, b, c, d:
                crit(a, b, c, d) + 0.1 * (b * b).mean(),
            "two_cross_entropy": lambda a, b, c, d:
                JF.cross_entropy(a, c) + JF.cross_entropy(b, d)}


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """The sequence classifier and the pretraining heads (unequal kept
    slots, SGD) at dp 2: the port's 2 gloo ranks (started first) and the
    JAX DistributedTrainStep on a 2-device mesh, which takes the criterion
    over the global batch."""
    paddle.seed(0)
    jm = JaxClassifier(jax_tiny(**NO_DROPOUT), num_classes=2)
    init = _state(jm)
    ids, tt, am, y = _classifier_inputs()
    jp, _ = _pretraining_pair()
    pt_state = _state(jp)
    pt_inputs, pt_labels = _pretraining_inputs()
    pt_full = [np.random.default_rng(7).integers(0, 1024, pt_labels[0].shape),
               pt_labels[1]]
    ranks = Ranks("bert_dp", 2, tmp_path_factory.mktemp("bert_dp"),
                  dict(state=init, ids=ids, tt=tt, am=am, y=y, lr=5e-4,
                       steps=STEPS, pt_state=pt_state, pt_inputs=pt_inputs,
                       pt_labels=pt_labels, pt_labels_full=pt_full,
                       pt_lr=PT_LR))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        mesh = jdist.build_mesh(dp=2, devices=jax.devices()[:2])
        step = jdist.DistributedTrainStep(
            jm, lambda lg, lb: JF.cross_entropy(lg, lb),
            jopt.AdamW(learning_rate=5e-4, parameters=jm.parameters()),
            mesh=mesh)
        losses = [float(step(_jt(ids, tt, am), paddle.to_tensor(y)))
                  for _ in range(STEPS)]
        step.sync_weights()
        pt = {}
        for case, loss in _pretraining_losses().items():
            jp, _ = _pretraining_pair()
            pstep = jdist.DistributedTrainStep(
                jp, loss,
                jopt.SGD(learning_rate=PT_LR, parameters=jp.parameters()),
                mesh=mesh)
            labels = pt_full if case == "two_cross_entropy" else pt_labels
            pt_losses = [float(pstep(_jt(*pt_inputs), _jt(*labels)))
                         for _ in range(STEPS)]
            pstep.sync_weights()
            pt[case] = (pt_losses, _state(jp))
        jdist.env.set_global_mesh(None)
    return losses, _state(jm), ranks.results(), pt


def test_pretraining_criterion_over_the_global_batch_dp2(dp2):
    """The criterion notes its two means, so each rank's masked-LM term is
    weighed by its kept slots: losses and parameters as the reference's
    criterion over the global batch; the criterion that notes nothing
    (each rank's loss weighed equally) is the control that must miss."""
    _held_pretraining(dp2, "pretrain")
    want_losses, want_state = dp2[3]["pretrain"]
    ctl = check(dp2[2]["pretrain_unnoted"][0])
    miss = max(max(abs(a - b) for a, b in zip(ctl["losses"], want_losses)),
               max(np.abs(v - want_state[k]).max()
                   for k, v in ctl["state"].items()))
    assert miss > 1e-2, miss


def _held_pretraining(dp2, case):
    want_losses, want_state = dp2[3][case]
    for rank, res in enumerate(dp2[2][case]):
        res = check(res)
        np.testing.assert_allclose(res["losses"], want_losses, rtol=1e-4,
                                   err_msg=f"rank {rank}")
        for k, v in res["state"].items():
            np.testing.assert_allclose(v, want_state[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"rank {rank}: {k}")


@pytest.mark.parametrize("case", ["pretrain_aux", "two_cross_entropy"])
def test_composite_losses_over_the_global_batch_dp2(dp2, case):
    """A loss that adds an un-noted auxiliary mean to the noted criterion
    keeps the auxiliary term in its gradient at weight 1, and a loss of
    two cross entropies (two notes without terms) keeps the equal weight,
    exact here where every rank keeps all its slots: both as the
    reference's loss over the global batch."""
    _held_pretraining(dp2, case)


def test_sequence_classification_dp2_matches_jax(dp2):
    losses, state, ranks, _ = dp2
    for rank, res in enumerate(ranks["seq_cls"]):
        res = check(res)
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5,
                                   err_msg=f"rank {rank}")
        _held_params(res["state"], state, f"rank {rank}")
    assert losses[-1] < losses[0], losses
