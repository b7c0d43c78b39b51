"""The rank cases of `tests/test_torch_random.py` (suite "random" of
`tests/torch_dist_worker.py`): the rank rule of the port's generators
(`framework.random`) over a 2-rank gloo group. Imports torch and the port
only."""

import traceback

import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers import \
    is_distributed
from paddle_tpu_torch.framework import random
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW


def _run(out, name, fn):
    try:
        out[name] = fn()
    except Exception:  # the case's test reports the traceback
        out[name] = "ERROR " + traceback.format_exc()


def _masks():
    """A draw of the shared generator and one of the mp-cut generator."""
    x = torch.ones(4096)
    shared = F.dropout(x, 0.5) > 0
    with random.cut_over_mp():
        cut = F.dropout(x, 0.5) > 0
    return dict(shared=shared.numpy(), cut=cut.numpy())


def random_cases(rank, world, inp):
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_tiny)

    out = {}

    def gpt_mp(fold_mp_everywhere=False):
        """gpt3_tiny with hidden and attention dropout 0.1 at mp = WORLD,
        three AdamW steps: the replicated parameters after them. With
        `fold_mp_everywhere` every draw folds in the mp coordinate (the
        control)."""
        saved = random.generator

        def folded(device):
            with random.cut_over_mp():
                return saved(device)

        if fold_mp_everywhere:
            random.generator = folded
        try:
            random.seed(0)
            cfg = gpt3_tiny(hidden_dropout_prob=0.1,
                            attention_dropout_prob=0.1)
            cfg.num_layers = 2
            model = GPTForCausalLM(cfg, device="cpu")
            crit = GPTPretrainingCriterion(cfg)
            step = dist.DistributedTrainStep(
                model, lambda lg, lb: crit(lg, lb),
                AdamW(learning_rate=1e-3, parameters=model.parameters()),
                mesh=dist.build_mesh(mp=world))
            losses = [step(inp["ids"], inp["ids"]).item() for _ in range(3)]
            return dict(losses=losses, replicated={
                k: p.detach().numpy().copy()
                for k, p in model.named_parameters() if not is_distributed(p)})
        finally:
            random.generator = saved

    def step_over(shape, draws=None):
        """One step over the mesh `shape` of a Linear whose forward appends
        its draws to `draws` (draws nothing when it is None)."""
        class Probe(torch.nn.Linear):
            def forward(self, x):
                if draws is not None:
                    draws.append(_masks())
                return super().forward(x)

        net = Probe(4, 4)
        step = dist.DistributedTrainStep(
            net, lambda o, y: ((o - y) ** 2).mean(),
            AdamW(parameters=net.parameters()),
            mesh=dist.build_mesh(**shape))
        x = torch.ones(2 * world, 4)
        step(x, x)

    def ranks(shape):
        """The draws inside a step over the mesh `shape`."""
        random.seed(0)
        draws = []
        step_over(shape, draws)
        return draws[0]

    def no_leak():
        """Eager draws after a step over dp = WORLD was built and run
        equal those of the seed alone: the step's rank stays inside it."""
        random.seed(0)
        ref = _masks()
        random.seed(0)
        step_over(dict(dp=world))
        got = _masks()
        return {k: bool((ref[k] == got[k]).all()) for k in ref}

    _run(out, "gpt_mp", gpt_mp)
    _run(out, "gpt_mp_fold_everywhere", lambda: gpt_mp(True))
    _run(out, "dp_masks", lambda: ranks(dict(dp=world)))
    _run(out, "mp_masks", lambda: ranks(dict(mp=world)))
    _run(out, "no_leak", no_leak)
    return out
