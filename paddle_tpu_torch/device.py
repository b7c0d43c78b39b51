"""Device resolution for every entry point of the port.

The port is written for one CUDA card. An entry point given no device runs
on `cuda`; a caller that wants the CPU (the tests) says so with
`device="cpu"`. Asking for CUDA on a machine without a usable GPU raises:
nothing quietly carries on on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """`None` -> `cuda`; a string or `torch.device` passes through. Raises
    RuntimeError when the result is a CUDA device and CUDA is unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
