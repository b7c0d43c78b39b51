"""paddle_tpu_torch.incubate (↔ paddle_tpu/incubate): so far only
`nn.functional.masked_multihead_attention`."""
