"""paddle_tpu_torch.incubate.distributed (↔ paddle_tpu/incubate/distributed):
so far `models.moe`."""
