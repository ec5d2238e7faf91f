"""Static-shape padding and alignment helpers.

Counterpart of the JAX package's ``utils/padding.py`` on tensors.
"""

from __future__ import annotations

import torch

__all__ = ["round_up", "pad_to"]


def round_up(x: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= x (and >= multiple)."""
    if multiple <= 1:
        return max(int(x), 1)
    return max(-(-int(x) // multiple) * multiple, multiple)


def pad_to(arr: torch.Tensor, total: int, fill=0) -> torch.Tensor:
    """Pad a 1-D tensor to ``total`` elements with ``fill``, on its device
    and in its dtype (returned as it is when already that long)."""
    cur = arr.shape[0]
    if cur >= total:
        return arr
    return torch.cat([arr, torch.full((total - cur,), fill, dtype=arr.dtype,
                                      device=arr.device)])
