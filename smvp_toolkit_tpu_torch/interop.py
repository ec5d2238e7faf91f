"""Carry state across from the JAX package as plain numpy arrays.

The port imports nothing of the JAX package; a caller that holds
both (the parity tests) hands the JAX objects' fields over as numpy
arrays and ints, so that both packages run on *the same plan* and the
kernels compare plan by plan.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.ops.sell_plan import SellPlan

__all__ = ["plan_from_arrays", "plan_fields", "coo_from_triplets"]

_ARRAY_FIELDS = ("vals", "lane_idx", "rel_tile", "slice_of", "tile_base",
                 "slice_base", "y_block_id")


def plan_fields(plan) -> Dict[str, Union[np.ndarray, int, Tuple[int, int]]]:
    """Every field of a SellPlan (either package's) as numpy arrays/ints."""
    out = {}
    for f in dataclasses.fields(SellPlan):
        v = getattr(plan, f.name)
        if f.name in _ARRAY_FIELDS:
            out[f.name] = None if v is None else np.asarray(v)
        elif f.name == "shape":
            out[f.name] = (int(v[0]), int(v[1]))
        else:
            out[f.name] = int(v)
    return out


def plan_from_arrays(fields: Dict[str, Union[np.ndarray, int]]) -> SellPlan:
    """The port's SellPlan from a JAX SellPlan's fields.

    ``fields`` maps each SellPlan field name to a numpy array (planes and
    per-chunk vectors) or an int (``nnz``, ``n_slices``, ...); ``shape``
    is a pair. Missing optional fields take their defaults.
    """
    names = {f.name for f in dataclasses.fields(SellPlan)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"not SellPlan fields: {sorted(unknown)}")
    kw = {}
    for name, v in fields.items():
        if name in _ARRAY_FIELDS:
            kw[name] = None if v is None else np.ascontiguousarray(v)
        elif name == "shape":
            kw[name] = (int(v[0]), int(v[1]))
        else:
            kw[name] = int(v)
    return SellPlan(**kw)


def coo_from_triplets(rows, cols, vals, shape, *, dtype=None,
                      device=None) -> COOMatrix:
    """The port's COOMatrix from host triplets (file order kept)."""
    return COOMatrix.from_numpy(
        np.asarray(rows), np.asarray(cols), np.asarray(vals),
        shape=shape, dtype=dtype, device=device,
    )
