"""paddle_tpu_torch.incubate.distributed.models: so far `moe`."""
