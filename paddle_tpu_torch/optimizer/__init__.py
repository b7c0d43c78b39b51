"""paddle_tpu_torch.optimizer (↔ paddle_tpu/optimizer)."""

from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["Adam", "AdamW", "Momentum", "Optimizer", "SGD"]
