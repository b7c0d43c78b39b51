"""Device resolution for every entry point of the port, Paddle's
`set_device` / `get_device` and places, and the device memory statistics
(↔ paddle_tpu/__init__.py:50-93 and paddle_tpu/device/__init__.py:82-141).

The port is written for one CUDA card. An entry point given no device runs
on the default device, which starts as `cuda`; a caller that wants the CPU
(the tests) says so with `device="cpu"`, or for every entry point at once
with `set_device("cpu")`. Asking for CUDA on a machine without a usable
GPU raises: nothing quietly carries on on the CPU.

The memory statistics are torch's caching allocator's counters on the
card (`torch.cuda.memory_*`). The CPU has no allocator statistics: there
every counter reads 0.
"""

from __future__ import annotations

import torch

__all__ = ["CPUPlace", "CUDAPlace", "device_count",
           "get_device", "max_memory_allocated", "max_memory_reserved",
           "memory_allocated", "memory_reserved", "memory_stats",
           "reset_max_memory_allocated", "resolve_device", "set_device"]

_default = "cuda"


class CPUPlace:
    def __repr__(self):
        return "Place(cpu)"

    def __eq__(self, other):
        return isinstance(other, CPUPlace)

    def __hash__(self):
        return hash("cpu")


class CUDAPlace:
    def __init__(self, idx: int = 0):
        self.idx = int(idx)

    def __repr__(self):
        return f"Place(gpu:{self.idx})"

    def __eq__(self, other):
        return isinstance(other, CUDAPlace) and other.idx == self.idx

    def __hash__(self):
        return hash(("gpu", self.idx))


def _torch_device(device) -> torch.device:
    """A torch device for a Paddle or torch device spec: "gpu", "gpu:1",
    "cuda", "cpu", a place or a torch.device."""
    if isinstance(device, torch.device):
        return device
    if isinstance(device, CUDAPlace):
        return torch.device("cuda", device.idx)
    if isinstance(device, CPUPlace):
        return torch.device("cpu")
    name = str(device).lower()
    if name.startswith("gpu"):
        name = "cuda" + name[3:]
    return torch.device(name)


def resolve_device(device=None) -> torch.device:
    """`None` -> the default device (`cuda` until `set_device` says
    otherwise); a string, place or `torch.device` passes through. Raises
    RuntimeError when the result is a CUDA device and CUDA is unavailable."""
    dev = _torch_device(_default if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or call set_device('cpu')) to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'gpu', 'cuda' or 'cpu'")
    return dev


def set_device(device):
    """paddle.set_device: the device every entry point given no device runs
    on from now on ("gpu", "gpu:0", "cuda", "cpu"). Raises for a CUDA
    device on a machine without one. Returns the device as a place."""
    global _default
    dev = resolve_device(device)
    _default = str(dev)
    return CPUPlace() if dev.type == "cpu" else CUDAPlace(dev.index or 0)


def get_device() -> str:
    """paddle.get_device: "gpu:<index>" or "cpu"."""
    dev = _torch_device(_default)
    if dev.type == "cpu":
        return "cpu"
    idx = dev.index if dev.index is not None else (
        torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return f"gpu:{idx}"


def device_count() -> int:
    return torch.cuda.device_count()


def _cuda(device):
    """The CUDA device the statistics are of, or None on the CPU."""
    if not torch.cuda.is_available():
        return None
    dev = _torch_device(_default if device is None else device)
    return dev if dev.type == "cuda" else None


def memory_stats(device=None) -> dict:
    """The allocator's counters under the reference's names
    ("bytes_in_use", "peak_bytes_in_use", "bytes_reserved",
    "peak_bytes_reserved"), beside torch's own."""
    dev = _cuda(device)
    if dev is None:
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                "bytes_reserved": 0, "peak_bytes_reserved": 0}
    stats = dict(torch.cuda.memory_stats(dev))
    stats.update(
        bytes_in_use=torch.cuda.memory_allocated(dev),
        peak_bytes_in_use=torch.cuda.max_memory_allocated(dev),
        bytes_reserved=torch.cuda.memory_reserved(dev),
        peak_bytes_reserved=torch.cuda.max_memory_reserved(dev))
    return stats


def memory_allocated(device=None) -> int:
    dev = _cuda(device)
    return 0 if dev is None else int(torch.cuda.memory_allocated(dev))


def max_memory_allocated(device=None) -> int:
    dev = _cuda(device)
    return 0 if dev is None else int(torch.cuda.max_memory_allocated(dev))


def memory_reserved(device=None) -> int:
    dev = _cuda(device)
    return 0 if dev is None else int(torch.cuda.memory_reserved(dev))


def max_memory_reserved(device=None) -> int:
    dev = _cuda(device)
    return 0 if dev is None else int(torch.cuda.max_memory_reserved(dev))


def reset_max_memory_allocated(device=None):
    dev = _cuda(device)
    if dev is not None:
        torch.cuda.reset_peak_memory_stats(dev)
