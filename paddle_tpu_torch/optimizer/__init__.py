"""paddle_tpu_torch.optimizer (↔ paddle_tpu/optimizer)."""

from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "Optimizer"]
