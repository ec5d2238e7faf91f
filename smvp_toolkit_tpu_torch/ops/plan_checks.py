"""Preconditions of the Hopper SELL kernels, checked before any launch.

Counterpart of the JAX package's ``ops/mosaic_check.py``, whose TPU tiling
rules have no meaning on the card. What the CUDA kernels need instead:

* the plan fits the merged rel‖slice word: ``window_tiles <= 511`` (rel
  in 9 bits, 511 marks a dead sublane) and ``n_slices < (1 << 23) - 1``
  (slice in 23 bits, all ones marks a dead sublane);
* a resident-y plan (streamed-y plans belong to K3);
* planes of the dtypes the kernels are compiled for, contiguous, on one
  device.

Plans that fail the relsl gates need the split-plane kernels (K4), which
a later slice of the port adds. Every check raises; none falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from smvp_toolkit_tpu_torch.ops.sell_plan import SellPlan

__all__ = [
    "REL_DEAD",
    "SLICE_SHIFT",
    "SLICE_DEAD",
    "check_plan",
    "check_planes",
]

REL_DEAD = (1 << 9) - 1  # 9-bit rel field; 511 marks a dead sublane
SLICE_SHIFT = 9  # slice id sits above the rel field
SLICE_DEAD = (1 << (32 - SLICE_SHIFT)) - 1  # 23-bit slice field, all ones

VALUE_DTYPES = (torch.float32, torch.bfloat16)
LIDX_DTYPES = (torch.int8, torch.int32)


def check_plan(plan: SellPlan) -> None:
    """Raise unless the port's K1/K2 kernels can run ``plan``."""
    if plan.y_block_slices:
        raise NotImplementedError(
            "streamed-y SELL plans need the streamed-y kernel (K3), which "
            "is not ported yet"
        )
    if plan.window_tiles > REL_DEAD:
        raise ValueError(
            f"plan window of {plan.window_tiles} tiles exceeds the 9-bit "
            f"rel field (<= {REL_DEAD}); such plans need the split-plane "
            "kernels (K4), which a later slice of the port adds"
        )
    if plan.n_slices >= SLICE_DEAD:
        raise ValueError(
            f"plan has {plan.n_slices} row slices; the 23-bit slice field "
            f"holds fewer than {SLICE_DEAD}. Such plans need the "
            "split-plane kernels (K4), which a later slice of the port adds"
        )
    if plan.vals.shape != plan.lane_idx.shape or plan.vals.shape[1] != 128:
        raise ValueError("vals and lane_idx planes must both be (S, 128)")
    if plan.n_sublanes % plan.chunk:
        raise ValueError("sublane count must be a multiple of the chunk")
    # The kernels index x and y with these fields unchecked, so a plan
    # that breaks the planner's invariants must fail here.
    lidx = plan.lane_idx
    if lidx.size and (lidx.min() < 0 or lidx.max() >= 128):
        raise ValueError("lane indices must lie in [0, 128)")
    rel = plan.rel_tile.reshape(-1).astype(np.int64)
    sl = plan.slice_of.reshape(-1).astype(np.int64)
    live = (rel >= 0) & (sl >= 0)
    if live.any():
        if sl[live].max() >= plan.n_slices:
            raise ValueError("a live sublane's slice lies outside y")
        tile = np.repeat(plan.tile_base.astype(np.int64), plan.chunk)
        if (tile[live] + rel[live]).max() >= plan.n_coltiles:
            raise ValueError("a live sublane's tile lies outside x")


def check_planes(*, vals: torch.Tensor, lidx: torch.Tensor,
                 relsl: torch.Tensor, tile_base: torch.Tensor,
                 x: torch.Tensor, chunk: int) -> None:
    """Dtypes, shapes, contiguity and a common device for one launch."""
    if vals.dtype not in VALUE_DTYPES:
        raise TypeError(f"vals must be float32 or bfloat16, got {vals.dtype}")
    if x.dtype != vals.dtype:
        raise TypeError(f"x ({x.dtype}) must have the vals dtype "
                        f"({vals.dtype})")
    if lidx.dtype not in LIDX_DTYPES:
        raise TypeError(f"lane indices must be int8 or int32, got "
                        f"{lidx.dtype}")
    if relsl.dtype != torch.int32 or tile_base.dtype != torch.int32:
        raise TypeError("relsl and tile_base must be int32")
    named = dict(vals=vals, lidx=lidx, relsl=relsl, tile_base=tile_base, x=x)
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != vals.device:
            raise ValueError(
                f"{name} is on {t.device}, vals on {vals.device}: all "
                "planes and x must be on one device"
            )
    s = relsl.numel()
    if vals.shape != (s, 128) or lidx.shape != (s, 128):
        raise ValueError(
            f"vals {tuple(vals.shape)} and lidx {tuple(lidx.shape)} must be "
            f"({s}, 128), one row per rel‖slice word"
        )
    if chunk < 1 or s % chunk or tile_base.numel() != s // chunk:
        raise ValueError(
            f"{s} sublanes do not split into {tile_base.numel()} chunks "
            f"of {chunk}"
        )
    if x.numel() % 128:
        raise ValueError("x must be padded to whole 128-wide column tiles")
