"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import functools
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one (the CPU tests pass ``device="cpu"``). A CUDA request on a
    machine without a card raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' explicitly to run on the CPU")
    return dev


def as_f32(x, device: torch.device) -> torch.Tensor:
    """float32 tensor on ``device`` from a tensor, array or sequence."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=64)
def device_constant(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``value`` (a number, or a tuple of them) as a tensor on ``device``,
    copied from the host once per (value, dtype, device): a control cycle
    that reads it then neither copies nor waits, and a CUDA-graph recording
    of it can hold it. Shared between callers: never written to."""
    return torch.tensor(value, dtype=dtype, device=device)
