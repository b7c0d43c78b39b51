"""DistributedStrategy (↔ paddle_tpu/distributed/fleet/base/
distributed_strategy.py): a plain config object whose `hybrid_configs`
carries the dp/mp/pp/sharding/sep degrees."""

from __future__ import annotations

import copy

__all__ = ["DistributedStrategy"]

_DEFAULT_HYBRID = {
    "dp_degree": 1,
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "order": ["dp", "pp", "sharding", "sep", "mp"],
    "mp_configs": {},
    "pp_configs": {
        "micro_batch_size": 1,
        "accumulate_steps": 1,
        "schedule_mode": "1F1B",
        "p2p_cache_shape": True,
        "enable_partial_send_recv": True,
    },
    "sharding_configs": {
        "tensor_fusion": False,
        "comm_overlap": False,
        "split_param": False,
    },
}


class DistributedStrategy:
    def __init__(self):
        self._hybrid_configs = copy.deepcopy(_DEFAULT_HYBRID)
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0,
            "custom_white_list": [],
            "custom_black_list": [],
            "use_pure_fp16": False,
            "use_bf16": True,
            "level": "O1",
        }
        self.recompute = False
        self.recompute_configs = {"checkpoints": [], "enable_offload": False}
        self.sharding = False
        self.sharding_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1}
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32

    @property
    def hybrid_configs(self):
        return self._hybrid_configs

    @hybrid_configs.setter
    def hybrid_configs(self, configs):
        for k, v in configs.items():
            if isinstance(v, dict) and k in self._hybrid_configs:
                self._hybrid_configs[k].update(v)
            else:
                self._hybrid_configs[k] = v

    def __repr__(self):
        return f"DistributedStrategy(hybrid_configs={self._hybrid_configs})"
