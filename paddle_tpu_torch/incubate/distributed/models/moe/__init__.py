"""The MoE layer and its gates (↔ paddle_tpu/incubate/distributed/models/
moe): `MoELayer` with a stacked `ExpertFFN` runs the sorted fast path
through the grouped-GEMM kernel (`ops.grouped_gemm`)."""

from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate
from .moe_layer import ExpertFFN, MoELayer

__all__ = ["BaseGate", "ExpertFFN", "GShardGate", "MoELayer", "NaiveGate",
           "SwitchGate"]
