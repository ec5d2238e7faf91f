"""Preconditions of the Hopper SELL kernels, checked before any launch.

Counterpart of the JAX package's ``ops/mosaic_check.py``, whose TPU tiling
rules have no meaning on the card. The kernels index x and y with the
plan's fields unchecked, so what they need is checked here:

* lane indices in [0, 128); each live sublane's tile inside x and its
  row inside y;
* a live rel below the plan's window (the merged word's 9-bit field
  relies on it);
* on a streamed-y plan: one block id per chunk, in range and
  non-decreasing, and block-local slice ids below the block's slices;
* planes of the dtypes the kernels are compiled for and of matching
  lengths, contiguous, on one device;
* for the k-column kernels, X and G as row-major (rows, k) blocks with
  k >= 1 and at least CT·128 (X) or NS·128 (G) rows, since the kernels
  read row ``col`` of X and row ``row`` of G unchecked.

Which planes a plan runs on (the merged rel‖slice word or the split
rel_tile / slice_of planes) is the operator's route choice, not a check.
Every check raises; none falls back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from smvp_toolkit_tpu_torch.ops.sell_plan import (
    REL_DEAD,
    SLICE_DEAD,
    SLICE_SHIFT,
    SellPlan,
)

__all__ = [
    "REL_DEAD",
    "SLICE_SHIFT",
    "SLICE_DEAD",
    "check_block",
    "check_plan",
    "check_planes",
]

VALUE_DTYPES = (torch.float32, torch.bfloat16)
LIDX_DTYPES = (torch.int8, torch.int32)


def _check_int32(name: str, a, size: int) -> None:
    if a is None or np.asarray(a).dtype != np.int32 or np.asarray(a).size != size:
        raise ValueError(f"{name} must be int32 with {size} entries")


def check_plan(plan: SellPlan) -> None:
    """Raise unless every invariant the kernels rely on holds for ``plan``."""
    if plan.vals.shape != plan.lane_idx.shape or plan.vals.shape[1] != 128:
        raise ValueError("vals and lane_idx planes must both be (S, 128)")
    if plan.chunk < 1 or plan.n_sublanes % plan.chunk:
        raise ValueError("sublane count must be a multiple of the chunk")
    s, nch = plan.n_sublanes, plan.n_chunks
    _check_int32("rel_tile", plan.rel_tile, s)
    _check_int32("slice_of", plan.slice_of, s)
    _check_int32("tile_base", plan.tile_base, nch)
    lidx = plan.lane_idx
    if lidx.size and (lidx.min() < 0 or lidx.max() >= 128):
        raise ValueError("lane indices must lie in [0, 128)")
    nsb = plan.y_block_slices
    if nsb:
        _check_int32("y_block_id", plan.y_block_id, nch)
        blk = plan.y_block_id.astype(np.int64)
        if nch and (blk.min() < 0 or (blk + 1).max() * nsb > plan.n_slices):
            raise ValueError("a y block id lies outside y")
        if (np.diff(blk) < 0).any():
            raise ValueError("y block ids must be non-decreasing")
    rel = plan.rel_tile.reshape(-1).astype(np.int64)
    sl = plan.slice_of.reshape(-1).astype(np.int64)
    live = (rel >= 0) & (sl >= 0)
    if not live.any():
        return
    if rel[live].max() >= plan.window_tiles:
        raise ValueError("a live sublane's rel lies outside its window")
    if sl[live].max() >= (nsb or plan.n_slices):
        raise ValueError("a live sublane's slice lies outside y"
                         + (" (its y block)" if nsb else ""))
    tile = np.repeat(plan.tile_base.astype(np.int64), plan.chunk)
    if tile.min() < 0 or (tile[live] + rel[live]).max() >= plan.n_coltiles:
        raise ValueError("a live sublane's tile lies outside x")


def check_planes(*, lidx: torch.Tensor, tile_base: torch.Tensor, chunk: int,
                 vals: Optional[torch.Tensor] = None,
                 x: Optional[torch.Tensor] = None,
                 relsl: Optional[torch.Tensor] = None,
                 rel: Optional[torch.Tensor] = None,
                 slice_of: Optional[torch.Tensor] = None,
                 y_block_id: Optional[torch.Tensor] = None) -> None:
    """Dtypes, shapes, contiguity and a common device for one launch.

    The per-sublane metadata is either ``relsl`` (the merged word) or
    ``rel`` and ``slice_of`` (the split planes); ``y_block_id`` is given
    for a streamed-y plan. ``vals`` is left out by the values-gradient
    kernel, which does not read it, and ``x`` by the k-column kernels,
    whose blocks ``check_block`` checks.
    """
    if vals is not None and vals.dtype not in VALUE_DTYPES:
        raise TypeError(f"vals must be float32 or bfloat16, got {vals.dtype}")
    if x is not None and vals is not None and x.dtype != vals.dtype:
        raise TypeError(f"x ({x.dtype}) must have the vals dtype "
                        f"({vals.dtype})")
    if lidx.dtype not in LIDX_DTYPES:
        raise TypeError(f"lane indices must be int8 or int32, got "
                        f"{lidx.dtype}")
    if (relsl is None) == (rel is None) or (rel is None) != (slice_of is None):
        raise ValueError("give either the merged relsl word or both split "
                         "planes (rel, slice_of)")
    index = dict(relsl=relsl, rel=rel, slice_of=slice_of,
                 tile_base=tile_base, y_block_id=y_block_id)
    index = {k: t for k, t in index.items() if t is not None}
    for name, t in index.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    given = dict(vals=vals, lidx=lidx, x=x, **index)
    for name, t in given.items():
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != lidx.device:
            raise ValueError(
                f"{name} is on {t.device}, lidx on {lidx.device}: all "
                "planes and x must be on one device"
            )
    meta = relsl if relsl is not None else rel
    s = meta.numel()
    for name, t in (("lidx", lidx), ("vals", vals)):
        if t is not None and t.shape != (s, 128):
            raise ValueError(
                f"{name} {tuple(t.shape)} must be ({s}, 128), one row per "
                "sublane's metadata word"
            )
    if slice_of is not None and slice_of.numel() != s:
        raise ValueError(f"slice_of has {slice_of.numel()} entries, rel {s}")
    if chunk < 1 or s % chunk or tile_base.numel() != s // chunk:
        raise ValueError(
            f"{s} sublanes do not split into {tile_base.numel()} chunks "
            f"of {chunk}"
        )
    if y_block_id is not None and y_block_id.numel() != s // chunk:
        raise ValueError(f"y_block_id has {y_block_id.numel()} entries, "
                         f"the plan {s // chunk} chunks")
    if x is not None and x.numel() % 128:
        raise ValueError("x must be padded to whole 128-wide column tiles")


def check_block(name: str, t: torch.Tensor, *, rows: int, dtypes,
                device: torch.device) -> int:
    """A row-major (rows, k) block of the k-column kernels (X, or the
    cotangent G): two dimensions, at least ``rows`` rows, k >= 1, one of
    ``dtypes``, contiguous, on ``device``. Returns k."""
    if t.dim() != 2 or t.shape[1] < 1:
        raise ValueError(f"{name} must be a (rows, k) block with k >= 1, "
                         f"got shape {tuple(t.shape)}")
    if t.shape[0] < rows:
        raise ValueError(f"{name} has {t.shape[0]} rows, the plan needs "
                         f"at least {rows}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {list(dtypes)}, got "
                        f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major); copy a "
                         "strided or expanded view with .contiguous()")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the planes on {device}")
    return int(t.shape[1])
