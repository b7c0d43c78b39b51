"""The rest of the port's losses held against the JAX package's on the CPU,
values and input gradients: `cross_entropy`'s composite modes (class
weights with `ignore_index`, soft labels with and without weights or label
smoothing, label smoothing on hard labels, `use_softmax=False`, a class
axis other than the last, with every reduction), `softmax_with_cross_entropy`
(hard and soft labels, `return_softmax`), `sigmoid_focal_loss` (with and
without a normalizer), `hsigmoid_loss` (the default heap tree and a custom
path table, with a bias), `margin_cross_entropy` and `class_center_sample`
on one device.

A 2-rank gloo group (suite "amp_loss", `tests/torch_amp_loss_cases.py`),
spawned once for the module: `margin_cross_entropy` over an mp group
against the reference on the whole logits (the loss, each rank's softmax
shard and gradient shard); `class_center_sample` over the group (every
rank keeps the positives of its shard of both ranks' labels); a
class-weighted cross entropy through a dp-2 `DistributedTrainStep` whose
ranks hold unequal counts and weights of valid rows, against the JAX
package's `TrainStep` on the whole batch (an un-noted control must miss);
and `PipelineParallel.train_batch` with an `amp.GradScaler` at pp 2: a
power-of-two scale changes no bit of the unscaled run, and an inf planted
in one stage's gradient skips the step on both ranks and halves the
scale on both.

f32 on both sides: the same expressions summed in other orders, a few
ulps (TOL)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu_torch.nn import functional as TF
from torch_dist_worker import Ranks, check

TOL = dict(rtol=1e-5, atol=1e-6)
RNG = np.random.default_rng(7)
X = RNG.standard_normal((6, 5)).astype(np.float32)
LAB = np.array([0, 3, -100, 4, 1, -100], np.int64)
CW = np.array([0.5, 2.0, 1.0, 0.25, 3.0], np.float32)
SOFT = np.abs(RNG.standard_normal((6, 5))).astype(np.float32)
SOFT /= SOFT.sum(-1, keepdims=True)
PROBS = np.exp(X) / np.exp(X).sum(-1, keepdims=True)
X3 = RNG.standard_normal((3, 5, 4)).astype(np.float32)
LAB3 = RNG.integers(0, 5, (3, 4)).astype(np.int64)

# name: (input, label, keyword arguments of cross_entropy)
CE_CASES = {
    "weight_mean": (X, LAB, dict(weight=CW)),
    "weight_sum": (X, LAB, dict(weight=CW, reduction="sum")),
    "weight_none": (X, LAB, dict(weight=CW, reduction="none")),
    "soft_label": (X, SOFT, dict(soft_label=True)),
    "soft_label_weight": (X, SOFT, dict(soft_label=True, weight=CW,
                                        reduction="sum")),
    "soft_label_smoothing": (X, SOFT, dict(soft_label=True,
                                           label_smoothing=0.1)),
    "smoothing_ignore": (X, LAB, dict(label_smoothing=0.2)),
    "smoothing_weight_none": (X, LAB, dict(label_smoothing=0.2, weight=CW,
                                           reduction="none")),
    "no_softmax": (PROBS, np.abs(LAB) % 5, dict(use_softmax=False)),
    "axis1": (X3, LAB3, dict(axis=1)),
    "axis1_label_kept_axis": (X3, LAB3[:, None, :], dict(axis=1,
                                                          reduction="sum")),
}


def _jt(a, grad=False):
    return paddle.to_tensor(np.asarray(a), stop_gradient=not grad)


def _both(jfn, tfn, *arrays, grad_of=(0,)):
    """(JAX value, JAX grads, port value, port grads) of the same call; the
    gradients are of sum(value) with respect to `grad_of`."""
    jin = [_jt(a, i in grad_of) for i, a in enumerate(arrays)]
    jout = jfn(*jin)
    jouts = jout if isinstance(jout, tuple) else (jout,)
    jouts[0].sum().backward()
    tin = [torch.tensor(np.asarray(a), requires_grad=i in grad_of)
           for i, a in enumerate(arrays)]
    tout = tfn(*tin)
    touts = tout if isinstance(tout, tuple) else (tout,)
    touts[0].sum().backward()
    return ([o.numpy() for o in jouts], [jin[i].grad.numpy() for i in grad_of],
            [o.detach().numpy() for o in touts],
            [tin[i].grad.numpy() for i in grad_of])


def _assert_same(jv, jg, tv, tg):
    for t, j in zip(tv, jv):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, **TOL)
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("name", list(CE_CASES))
def test_cross_entropy_modes_match_jax(name):
    x, lab, kw = CE_CASES[name]
    kwj = dict(kw)
    kwt = dict(kw)
    extra = ()
    if "weight" in kw:
        kwj.pop("weight")
        kwt.pop("weight")
        extra = (kw["weight"],)
    _assert_same(*_both(
        lambda a, b, *w: JF.cross_entropy(a, b, *(w and [w[0]]), **kwj),
        lambda a, b, *w: TF.cross_entropy(a, b, *(w and [w[0]]), **kwt),
        x, lab, *extra))


@pytest.mark.parametrize("soft", [False, True])
def test_softmax_with_cross_entropy_matches_jax(soft):
    lab = SOFT if soft else np.abs(LAB[:, None]) % 5
    for ret in (False, True):
        jv, jg, tv, tg = _both(
            lambda a, b: JF.softmax_with_cross_entropy(
                a, b, soft_label=soft, return_softmax=ret),
            lambda a, b: TF.softmax_with_cross_entropy(
                a, b, soft_label=soft, return_softmax=ret), X, lab)
        assert tv[0].shape == (6, 1)
        _assert_same(jv, jg, tv, tg)


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("normalized", [False, True])
def test_sigmoid_focal_loss_matches_jax(reduction, normalized):
    y = (RNG.random((6, 5)) > 0.7).astype(np.float32)
    arrays = (X, y) + ((np.array([3.0], np.float32),) if normalized else ())
    _assert_same(*_both(
        lambda a, b, *n: JF.sigmoid_focal_loss(
            a, b, normalizer=n[0] if n else None, reduction=reduction),
        lambda a, b, *n: TF.sigmoid_focal_loss(
            a, b, normalizer=n[0] if n else None, reduction=reduction),
        *arrays))


@pytest.mark.parametrize("tree", ["default", "custom"])
def test_hsigmoid_loss_matches_jax(tree):
    """Values [N, 1] and the gradients of the input, the node weights and
    their bias."""
    rng = np.random.default_rng(3)
    N, D, C = 5, 8, 6
    x = rng.standard_normal((N, D)).astype(np.float32)
    lab = np.array([0, 5, 2, 3, 1], np.int64)
    w = rng.standard_normal((C - 1, D)).astype(np.float32)
    b = rng.standard_normal((C - 1, 1)).astype(np.float32)
    if tree == "default":
        arrays = (x, lab, w, b)

        def call(F):
            return lambda a, l_, ww, bb: F.hsigmoid_loss(a, l_, C, ww, bb)
    else:
        table = np.array([[0, 1, -1], [0, 2, 4], [0, 1, 3], [0, 2, -1],
                          [0, 1, 3]], np.int64)
        code = np.array([[1, 0, -1], [0, 1, 1], [1, 1, 0], [0, 0, -1],
                         [1, 1, 1]], np.int64)
        arrays = (x, lab, w, b, table, code)

        def call(F):
            return lambda a, l_, ww, bb, t, c: F.hsigmoid_loss(
                a, l_, C, ww, bb, path_table=t, path_code=c)
    jv, jg, tv, tg = _both(call(JF), call(TF), *arrays, grad_of=(0, 2, 3))
    assert tv[0].shape == (N, 1)
    _assert_same(jv, jg, tv, tg)


@pytest.mark.parametrize("reduction", ["mean", "sum", None])
def test_margin_cross_entropy_matches_jax(reduction):
    rng = np.random.default_rng(4)
    cos = np.tanh(rng.standard_normal((6, 10))).astype(np.float32)
    lab = rng.integers(0, 10, 6).astype(np.int64)
    jv, jg, tv, tg = _both(
        lambda a, b: JF.margin_cross_entropy(a, b, return_softmax=True,
                                             reduction=reduction),
        lambda a, b: TF.margin_cross_entropy(a, b, return_softmax=True,
                                             reduction=reduction), cos, lab)
    np.testing.assert_allclose(tv[0], jv[0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tv[1], jv[1], **TOL)
    np.testing.assert_allclose(tg[0], jg[0], rtol=1e-5, atol=1e-5)


def _check_centers(lab, remapped, sampled, lo, per, num_samples, all_labels):
    """The sampled set holds every positive of [lo, lo + per) among
    `all_labels` first, in order, then distinct negatives up to
    `num_samples`; a label of the shard maps to its index in the set, any
    other label stays as it was."""
    pos = np.unique(all_labels[(all_labels >= lo) & (all_labels < lo + per)]) - lo
    assert len(sampled) == max(num_samples, len(pos))
    np.testing.assert_array_equal(sampled[:len(pos)], pos)
    assert len(set(sampled.tolist())) == len(sampled)
    assert ((sampled >= 0) & (sampled < per)).all()
    own = (lab >= lo) & (lab < lo + per)
    np.testing.assert_array_equal(sampled[remapped[own]], lab[own] - lo)
    np.testing.assert_array_equal(remapped[~own], lab[~own])


def test_class_center_sample_keeps_the_reference_positives():
    """One device: the reference's positives and remapping; its negatives
    are drawn from an unseeded generator, the port's from its own, so the
    negatives are held by their properties."""
    lab = np.array([3, 7, 3, 0, 12, 7], np.int64)
    jnew, jsampled = JF.class_center_sample(_jt(lab), 20, 8)
    tnew, tsampled = TF.class_center_sample(torch.tensor(lab), 20, 8)
    npos = len(np.unique(lab))
    np.testing.assert_array_equal(tsampled.numpy()[:npos],
                                  jsampled.numpy()[:npos])
    np.testing.assert_array_equal(tnew.numpy(), jnew.numpy())
    _check_centers(lab, tnew.numpy(), tsampled.numpy(), 0, 20, 8, lab)
    new, sampled = TF.class_center_sample(torch.tensor(lab), 20, 2)
    np.testing.assert_array_equal(sampled.numpy(), np.unique(lab))


# -- the 2-rank group ------------------------------------------------------ #

WCE = dict(lr=0.5, steps=3)


def _inputs():
    rng = np.random.default_rng(11)
    margin = dict(logits=np.tanh(rng.standard_normal((6, 12))).astype(np.float32),
                  label=np.array([0, 7, 11, 5, 6, 2], np.int64))
    ccs = dict(labels=[np.array([1, 9, 14, 1], np.int64),
                       np.array([17, 3, 9, 19], np.int64)],
               per_rank=10, num_samples=5)
    x = rng.standard_normal((8, 6)).astype(np.float32)
    # the first half (rank 0) keeps 4 rows, the second (rank 1) 1 row
    y = np.array([0, 2, 1, 3, -100, -100, 4, -100], np.int64)
    wce = dict(x=x, y=y, w=(rng.standard_normal((6, 5)) * 0.3).astype(np.float32),
               b=np.zeros(5, np.float32), class_w=CW, **WCE)
    pipe = dict(W=(rng.standard_normal((4, 8, 8)) * 0.3).astype(np.float32),
                b=(rng.standard_normal((4, 8)) * 0.1).astype(np.float32),
                x=rng.standard_normal((4, 8)).astype(np.float32),
                y=rng.standard_normal((4, 8)).astype(np.float32))
    return dict(margin=margin, ccs=ccs, wce=wce, pipe=pipe)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inp = _inputs()
    group = Ranks("amp_loss", 2, tmp_path_factory.mktemp("amp_loss"), inp)
    # the JAX references while the ranks run
    a = inp["wce"]
    net = jnn.Linear(6, 5)
    net.weight.set_value(a["w"])
    net.bias.set_value(a["b"])
    cw = _jt(a["class_w"])
    step = JaxTrainStep(net, lambda lg, lb: JF.cross_entropy(lg, lb, weight=cw),
                        jopt.SGD(learning_rate=a["lr"],
                                 parameters=net.parameters()))
    losses = [float(step(_jt(a["x"]), _jt(a["y"]))) for _ in range(a["steps"])]
    step.sync_weights()
    wce = dict(losses=losses, w=net.weight.numpy(), b=net.bias.numpy())
    return inp, wce, group.results(timeout=180)


def test_margin_cross_entropy_over_an_mp_group_matches_jax(ranks):
    inp, _, res = ranks
    m = inp["margin"]
    jv, jg, _, _ = _both(
        lambda a, b: JF.margin_cross_entropy(a, b, return_softmax=True),
        lambda a, b: TF.margin_cross_entropy(a, b, return_softmax=True),
        m["logits"], m["label"])
    rows = JF.margin_cross_entropy(_jt(m["logits"]), _jt(m["label"]),
                                   reduction=None).numpy()
    c = m["logits"].shape[1] // 2
    for rank, r in enumerate(res["margin_mp"]):
        r = check(r)
        np.testing.assert_allclose(r["loss"], jv[0], rtol=1e-5)
        np.testing.assert_allclose(r["rows"], rows, rtol=1e-5, atol=1e-5)
        part = slice(rank * c, (rank + 1) * c)
        np.testing.assert_allclose(r["softmax"], jv[1][:, part], **TOL)
        np.testing.assert_allclose(r["grad"], jg[0][:, part], rtol=1e-5,
                                   atol=1e-5)


def test_class_center_sample_over_an_mp_group(ranks):
    inp, _, res = ranks
    a = inp["ccs"]
    everyone = np.concatenate(a["labels"])
    for rank, r in enumerate(res["class_center_mp"]):
        r = check(r)
        _check_centers(a["labels"][rank], r["remapped"], r["sampled"],
                       rank * a["per_rank"], a["per_rank"], a["num_samples"],
                       everyone)


def test_weighted_cross_entropy_over_a_sharded_step_matches_jax(ranks):
    """dp 2 with 4 valid rows on rank 0 and 1 on rank 1: the step's loss is
    the global weighted mean, sum(w l) / sum(w) over both ranks, as the JAX
    step on the whole batch; the control that weighs each rank's mean
    equally misses."""
    _, want, res = ranks
    for rank, r in enumerate(res["weighted_ce"]):
        r = check(r)
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(r["w"], want["w"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["b"], want["b"], rtol=1e-5, atol=1e-6)
    ctl = check(res["weighted_ce_unnoted"][0])
    assert abs(ctl["losses"][0] - want["losses"][0]) > 1e-3 * abs(
        want["losses"][0])


def test_pipeline_train_batch_with_a_grad_scaler(ranks):
    _, _, res = ranks
    for rank in range(2):
        plain = check(res["pipeline_plain"][rank])
        scaled = check(res["pipeline_scaler"][rank])
        inf = check(res["pipeline_scaler_inf"][rank])
        # a power-of-two scale: the same bits as the unscaled run
        assert scaled["losses"] == plain["losses"]
        for a, b in zip(scaled["params"], plain["params"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert scaled["scales"] == [1024.0] * 3
        # the planted inf (stage 0, call 1): both ranks skip, both back off
        assert inf["scales"] == [1024.0, 512.0, 512.0]
        for x, y in zip(inf["params"][1], inf["params"][0]):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(inf["params"][0], plain["params"][0]):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(inf["params"][2], plain["params"][1]):
            np.testing.assert_array_equal(x, y)
        assert plain["losses"][-1] < plain["losses"][0]


def test_pipeline_scaler_skips_on_every_mp_rank(ranks):
    """pp 1 x mp 2: an inf in mp rank 0's shard of a cut weight's gradient
    makes both mp ranks skip the step and halve the scale; the next call
    steps as the clean run's first did, and the replicated row bias stays
    equal across the ranks."""
    _, _, res = ranks
    biases = []
    for rank in range(2):
        clean = check(res["pipeline_scaler_mp"][rank])
        inf = check(res["pipeline_scaler_mp_inf"][rank])
        assert clean["scales"] == [1024.0, 1024.0]
        assert inf["scales"] == [512.0, 512.0], f"rank {rank}"
        for x, y in zip(inf["params"][1], inf["params"][0]):
            np.testing.assert_array_equal(x, y, err_msg=f"rank {rank}")
        for x, y in zip(inf["params"][2], clean["params"][1]):
            np.testing.assert_array_equal(x, y, err_msg=f"rank {rank}")
        assert any(not np.array_equal(x, y) for x, y in
                   zip(clean["params"][1], clean["params"][0]))
        biases.append(inf["params"][2][-1])
    np.testing.assert_array_equal(biases[0], biases[1])
