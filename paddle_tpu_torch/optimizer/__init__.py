"""paddle_tpu_torch.optimizer (↔ paddle_tpu/optimizer)."""

from .optimizer import SGD, Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "Optimizer", "SGD"]
