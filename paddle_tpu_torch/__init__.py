"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu`, for one NVIDIA
H100 (Hopper, sm_90a).

The public surface keeps Paddle's names and layouts (`Linear.weight` is
`[in, out]`, attention tensors are `[B, S, H, D]`, `state_dict` keys equal
`paddle_tpu`'s); inside, it is plain PyTorch: `nn.Module`s, explicit devices
and dtypes, explicit `torch.Generator`s. Every kernel that `paddle_tpu`
wrote in Pallas for the TPU is a hand-written CUDA kernel here
(`paddle_tpu_torch/csrc/`), built with nvcc at first use and bound with
ctypes (`ops/_build.py`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; without
a GPU they raise rather than quietly run on the CPU. On CPU tensors each
kernel wrapper runs its plain PyTorch version, which is what the CPU tests
hold against `paddle_tpu`.

Ported so far: GPT-3 serving (`models.gpt`,
`inference.create_serving_engine`: the paged engine with bf16 or int8 KV
pages and optional int8 weights, the dense continuous-batching engine,
`GPTForCausalLM.generate`, incubate `masked_multihead_attention`) with the
fused LayerNorm/RMSNorm forward, paged (full precision and int8) and
dense-cache decode attention kernels, and the GPT-3 training step
(`jit.TrainStep` / `distributed.DistributedTrainStep` with
`optimizer.AdamW`, `amp` O1/O2 and per-layer recompute) with the
flash-attention forward, dq and dk/dv kernels and the fused-norm dx
kernel; the LLaMA form (`models.llama`: RMSNorm, SwiGLU, RoPE, GQA, an
untied head) in the same engines and training step, with the fused-RoPE
kernel and flashmask attention (forward, dq and dk/dv kernels); the MoE
layer (`incubate.distributed.models.moe`) through the grouped-GEMM kernel
and `bench.py`'s gpt3_moe step; packed-document attention
(`nn.functional.flash_attn_unpadded`) through the varlen forward, dq and
dk/dv kernels; the hybrid-parallel step over ranks (`distributed`: data,
ZeRO, tensor, sequence and pipeline parallelism, the schedules in
`parallel`); BERT (`models.bert`, on `nn.TransformerEncoder`, its
key-padding mask through the flash kernels' key bias) and the ResNet
family (`vision.models`: conv, pooling, batch norm with Paddle's running
statistics) with `optimizer.Momentum`; dropout and the other random
draws from explicit generators (`seed`, `framework.random`), the
learning-rate schedulers (`optimizer.lr`) and the rest of the optimizers;
the framework core and the tensor op surface (`framework`: `Tensor` over one
torch tensor, `Parameter`, `to_tensor`, the grad modes, dtypes, flags,
`save` / `load`; `autograd`; the ten `tensor/` modules with their `Tensor`
methods and in-place variants; `amp.debugging`; `nn.Layer`, the base of
every layer, whose `__call__` is the boundary between Paddle `Tensor`s and
the plain torch tensors of the models and kernels), so a script written as
Paddle users write it (`import paddle_tpu_torch as paddle`) runs on the
card; the telemetry (`observability`: the metrics registry, spans, the
step timeline, the flight recorder; `profiler`, its device trace from
`torch.profiler`), the comm watchdog and the crash-safe sharded
checkpoint (`distributed.checkpoint`); the rest of the nn surface
(`ParamAttr`, `nn.initializer`, `regularizer`, every functional and layer
name of the reference but ROADMAP's item 8, `nn.utils`, `nn.quant`). See
ROADMAP.md for the rest.
"""

from . import autograd, framework, tensor
from .autograd import PyLayer, grad
from .device import (CPUPlace, CUDAPlace, device_count, get_device,
                     resolve_device, set_device)
from .framework import (Parameter, Tensor, enable_grad, get_default_dtype,
                        get_flags, is_grad_enabled, load, no_grad, save,
                        set_default_dtype, set_flags, set_grad_enabled,
                        to_tensor)
from .framework.dtype import (  # noqa: F401
    bfloat16,
    bool_ as bool,  # noqa: A001
    complex64,
    complex128,
    float16,
    float32,
    float64,
    int8,
    int16,
    int32,
    int64,
    uint8,
)
from .framework.random import get_rng_state, seed, set_rng_state
from .tensor import *  # noqa: F401,F403
from .tensor import linalg  # namespace: paddle.linalg.*
from .tensor.logic import is_tensor
from . import (amp, device, distributed, incubate, inference, jit, nn,  # noqa: E402
               observability, optimizer, profiler, quantization, regularizer,
               vision)
from .nn.layer.layers import ParamAttr  # noqa: E402

__all__ = ["CPUPlace", "CUDAPlace", "ParamAttr", "Parameter", "PyLayer",
           "Tensor", "autograd", "device_count", "enable_grad",
           "get_default_dtype", "get_device", "get_flags", "get_rng_state",
           "grad", "is_compiled_with_cuda", "is_compiled_with_custom_device",
           "is_compiled_with_rocm", "is_compiled_with_xpu", "is_grad_enabled",
           "is_tensor", "linalg", "load", "no_grad", "observability",
           "profiler", "regularizer", "resolve_device", "save",
           "seed", "set_default_dtype", "set_device", "set_flags",
           "set_grad_enabled", "set_rng_state", "to_tensor",
           *tensor.__all__]


def is_compiled_with_cuda() -> bool:
    """The port is built for CUDA: True (the reference, built for the TPU,
    answers False)."""
    return True


def is_compiled_with_rocm() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_custom_device(name: str) -> bool:
    return False
