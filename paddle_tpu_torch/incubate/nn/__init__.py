"""paddle_tpu_torch.incubate.nn (↔ paddle_tpu/incubate/nn)."""
