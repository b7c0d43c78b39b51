"""The port's kernels: each module pairs hand-written CUDA kernels
(`paddle_tpu_torch/csrc/`) with their plain PyTorch versions and launch
counters.

- `fused_norm` ↔ `paddle_tpu/ops/pallas/fused_norm.py` (forward and dx,
  with `FusedNorm`, the autograd Function).
- `decode_attention` ↔ `paddle_tpu/ops/pallas/decode_attention.py` (paged
  full precision, paged int8 and dense-cache decode, the page appends; no
  gradient).
- `flash_attention` ↔ `paddle_tpu/ops/pallas/flash_attention.py` (forward,
  dq and dk/dv, with `FlashAttention`, the autograd Function).
- `masked_flash` ↔ `paddle_tpu/ops/pallas/masked_flash.py`: flashmask
  (forward, dq and dk/dv under per-column masked row ranges, with
  `FlashmaskAttention`) and varlen (the same over packed documents, with
  `VarlenAttention`); the same tile kernels as `flash_attention` under
  other mask policies.
- `grouped_gemm` ↔ `paddle_tpu/ops/pallas/grouped_gemm.py` (the MoE
  experts' ragged grouped GEMM, with `GroupedMatmul`, whose dlhs is the
  same kernel against the transposed weights).
- `fused_rope` ↔ `paddle_tpu/ops/pallas/fused_rope.py` (RoPE on 1-3
  tensors in one launch, with `FusedRope`, whose backward is the same
  kernel with sin negated).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""
