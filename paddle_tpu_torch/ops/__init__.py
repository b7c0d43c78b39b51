"""The port's kernels: each module pairs a hand-written CUDA kernel
(`paddle_tpu_torch/csrc/`) with its plain PyTorch version and a launch
counter.

- `fused_norm` ↔ `paddle_tpu/ops/pallas/fused_norm.py` (forward).
- `decode_attention` ↔ `paddle_tpu/ops/pallas/decode_attention.py` (paged,
  full precision).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""
