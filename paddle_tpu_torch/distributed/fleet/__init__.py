"""The fleet facade (↔ paddle_tpu/distributed/fleet/__init__.py):
`fleet.init` builds the hybrid topology and its mesh from
`strategy.hybrid_configs` (initialising the process group if need be),
`distributed_model` wraps the model by parallel mode, and
`distributed_optimizer` wraps the optimizer in `HybridParallelOptimizer`.

Data, sharding, segment, tensor and pipeline parallelism are ported. The
first two wrap the model in `DataParallel`, over the dp group and over the
(dp, sharding) group, whose ranks each take a part of the batch; segment
parallelism (a sep degree above 1 with mp 1) wraps it in
`meta_parallel.SegmentParallel`, the `DataParallel` of the (dp, sep)
group, whose ranks each take their rows and their chunk of the sequence;
tensor
parallelism (a topology whose mp degree is above 1) wraps it in
`meta_parallel.TensorParallel`, which cuts it over the mp group; pipeline
parallelism (pp degree above 1) wraps a `meta_parallel.PipelineLayer` in
`meta_parallel.PipelineParallel`, which cuts it over the mp group as
`TensorParallel` does and whose `train_batch` reads the strategy's
`pp_configs` and averages over the batch ranks, and any other model in
`TensorParallel`, as the reference (:78-82).
"""

from __future__ import annotations

from .. import env as _env
from .base.distributed_strategy import DistributedStrategy
from .base.topology import CommunicateTopology, HybridCommunicateGroup

__all__ = ["CommunicateTopology", "DistributedStrategy",
           "HybridCommunicateGroup", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group", "init",
           "is_initialized", "worker_index", "worker_num"]

_fleet_state = {"initialized": False, "strategy": None, "hcg": None}


def init(role_maker=None, is_collective=False, strategy=None, log_level="INFO"):
    """reference :28. The process group comes from `init_parallel_env()`
    (on `cuda`) unless the caller made it first, e.g. on the CPU."""
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    topo = CommunicateTopology(dims=(hc["dp_degree"], hc["pp_degree"],
                                     hc["sharding_degree"], hc["sep_degree"],
                                     hc["mp_degree"]))
    _env.init_parallel_env()
    hcg = HybridCommunicateGroup(topo)
    _fleet_state.update(initialized=True, strategy=strategy, hcg=hcg)


def is_initialized():
    return _fleet_state["initialized"]


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    return _fleet_state["hcg"]


def worker_index():
    return _env.get_rank()


def worker_num():
    return _env.get_world_size()


def distributed_model(model):
    """reference :61 (fleet/model.py:135-185)."""
    from ..parallel import DataParallel
    from .meta_parallel import (PipelineLayer, PipelineParallel,
                                SegmentParallel, TensorParallel)

    hcg = _fleet_state["hcg"]
    if hcg is None:
        raise RuntimeError("call fleet.init() first")
    mode = hcg.get_parallel_mode()
    strategy = _fleet_state["strategy"]
    if mode == "segment_parallel":
        return SegmentParallel(model, hcg, strategy)
    if mode == "pipeline_parallel" and isinstance(model, PipelineLayer):
        return PipelineParallel(model, hcg, strategy)
    if mode in ("tensor_parallel", "pipeline_parallel"):
        return TensorParallel(model, hcg, strategy)
    if mode == "data_parallel":
        return DataParallel(model, group=hcg.get_data_parallel_group())
    if mode == "sharding_parallel":
        return DataParallel(model, group=hcg.get_dp_sharding_parallel_group())
    return model


def distributed_optimizer(optimizer, strategy=None):
    """reference :95: HybridParallelOptimizer."""
    from .meta_optimizers import HybridParallelOptimizer

    return HybridParallelOptimizer(optimizer, _fleet_state["hcg"],
                                   strategy or _fleet_state["strategy"])

