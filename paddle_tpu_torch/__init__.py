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
learning-rate schedulers (`optimizer.lr`) and the rest of the optimizers.
See ROADMAP.md for the rest.
"""

from .device import resolve_device
from .framework.random import get_rng_state, seed, set_rng_state

__all__ = ["get_rng_state", "resolve_device", "seed", "set_rng_state"]
