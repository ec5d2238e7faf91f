"""Device selection shared by every entry point of the port.

The port runs on ``cuda`` unless the caller asks for the CPU. With no
CUDA device and no explicit CPU request it raises: it never carries on
quietly on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device", "device_label"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA request needs a visible card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(CLI: --device cpu) to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    return dev


def device_label(device: torch.device) -> str:
    """``name (platform)`` as the reports and JSON records print it."""
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} (gpu)"
    return "cpu (cpu)"
