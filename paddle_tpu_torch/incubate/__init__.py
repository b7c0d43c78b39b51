"""paddle_tpu_torch.incubate (↔ paddle_tpu/incubate): the fused
functionals of `nn.functional` (MMHA, RoPE, SwiGLU, fused norms) and the
MoE layer of `distributed.models.moe`."""
