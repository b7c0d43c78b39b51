"""Hybrid-parallel optimizer wrappers
(↔ paddle_tpu/distributed/fleet/meta_optimizers.py).

`HybridParallelOptimizer` (:92) wraps the user's optimizer for an eager
hybrid-parallel loop: a `ClipGradByGlobalNorm` becomes
`_HybridParallelClipGrad` (:28), whose squared sum is reduced over the
ranks that hold distinct parts of the parameters (the mp group for a
parameter marked `is_distributed`, the pp group for the stages' disjoint
parameters), and `step()` updates a parameter listed twice once.
`DygraphShardingOptimizer` (:178) marks the optimizer for sharding stage 1,
which `DistributedTrainStep` runs. A step builds on the inner optimizer
(`_inner_opt`), whose clip is the wrapped one.
"""

from __future__ import annotations

import torch

from ...nn.clip import ClipGradByGlobalNorm, global_norm_scale, scale_grad
from .. import collective as coll

__all__ = ["DygraphShardingOptimizer", "HybridParallelOptimizer"]


class _HybridParallelClipGrad:
    """||g||^2 = mp_allreduce(sum over mp-distributed parameters) + the sum
    over replicated ones, then pp_allreduce of the total when pipeline
    stages hold disjoint parameters (reference :28)."""

    def __init__(self, clip, hcg):
        self._clip = clip
        self._hcg = hcg
        self.clip_norm = clip.clip_norm

    @torch.no_grad()
    def __call__(self, params_grads):
        kept = [(p, g) for p, g in params_grads
                if g is not None and getattr(p, "need_clip", True)
                and getattr(p, "is_firstly_shared", True)]
        dev = params_grads[0][1].device if params_grads else "cpu"
        dist_sq = sum((g.float().square().sum() for p, g in kept
                       if getattr(p, "is_distributed", False)),
                      torch.zeros((), device=dev))
        rep_sq = sum((g.float().square().sum() for p, g in kept
                      if not getattr(p, "is_distributed", False)),
                     torch.zeros((), device=dev))
        hcg = self._hcg
        if hcg is not None and hcg.get_model_parallel_world_size() > 1:
            coll.all_reduce(dist_sq, group=hcg.get_model_parallel_group())
        total = dist_sq + rep_sq
        if hcg is not None and hcg.get_pipe_parallel_world_size() > 1:
            coll.all_reduce(total, group=hcg.get_pipe_parallel_group())
        scale = global_norm_scale(total, self.clip_norm)
        return [(p, scale_grad(g, scale)
                 if g is not None and getattr(p, "need_clip", True) else g)
                for p, g in params_grads]


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._dist_clip = None
        clip = getattr(optimizer, "_grad_clip", None)
        if isinstance(clip, ClipGradByGlobalNorm) and hcg is not None:
            self._dist_clip = _HybridParallelClipGrad(clip, hcg)
            optimizer._grad_clip = self._dist_clip

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner_opt"], name)

    def _obtain_optimizer_parameters_list(self):
        """The parameters once each (a tied parameter listed twice counts
        once)."""
        seen, out = set(), []
        for p in self._inner_opt._parameter_list or []:
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
        return out

    def step(self):
        inner = self._inner_opt
        saved = inner._parameter_list
        inner._parameter_list = self._obtain_optimizer_parameters_list()
        try:
            inner.step()
        finally:
            inner._parameter_list = saved

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad(set_to_zero)


class DygraphShardingOptimizer(HybridParallelOptimizer):
    """ZeRO stage 1 (reference :178): the optimizer is marked so that a
    DistributedTrainStep keeps each rank's state for its shards only."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        super().__init__(optimizer, hcg, strategy)
        optimizer._sharding_stage = 1
