"""The meta-parallel model wrappers (↔ paddle_tpu/distributed/fleet/meta_parallel/):
`TensorParallel` (`tensor_parallel`), and the pipeline's `LayerDesc`,
`SharedLayerDesc` and `PipelineLayer` (`pp_layers`) and `PipelineParallel`
(`pipeline_parallel`)."""

from .pipeline_parallel import PipelineParallel
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc
from .tensor_parallel import TensorParallel

__all__ = ["LayerDesc", "PipelineLayer", "PipelineParallel",
           "SharedLayerDesc", "TensorParallel"]
