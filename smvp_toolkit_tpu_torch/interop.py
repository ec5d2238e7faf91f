"""Carry state across from the JAX package as plain numpy arrays.

The port imports nothing of the JAX package; a caller that holds
both (the parity tests) hands the JAX objects' fields over as numpy
arrays and ints, so that both packages run on *the same plan* and the
kernels compare plan by plan.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.formats.csr import CSRMatrix
from smvp_toolkit_tpu_torch.models.graph import GCN
from smvp_toolkit_tpu_torch.ops.ilu import IC0Factors
from smvp_toolkit_tpu_torch.ops.sell_plan import SellPlan
from smvp_toolkit_tpu_torch.utils.device import resolve_device

__all__ = ["plan_from_arrays", "plan_fields", "coo_from_triplets",
           "gcn_params_from_arrays", "csr_from_arrays",
           "ic0_factors_from_arrays", "df64_from_arrays"]

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


def gcn_params_from_arrays(pairs: Sequence[Tuple[np.ndarray, np.ndarray]], *,
                           device=None) -> GCN:
    """The port's GCN from a JAX GCN's ``(W, b)`` list given as numpy
    arrays (``[(np.asarray(w), np.asarray(b)) for w, b in params]``),
    float32, on ``device`` (default: the card)."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return GCN([(tensor(w), tensor(b)) for w, b in pairs])


def csr_from_arrays(fields: Dict[str, object], *, dtype=None,
                    device=None) -> CSRMatrix:
    """The port's CSRMatrix from a JAX CSRMatrix's fields: ``row_ptr``,
    ``col_ind`` and ``vals`` as numpy arrays (padding included), ``shape``
    and ``nnz``. Values go to ``dtype`` (default float32) on ``device``
    (default: the card)."""
    dev = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype

    def index(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)

    shape = fields["shape"]
    return CSRMatrix(
        row_ptr=index(fields["row_ptr"]), col_ind=index(fields["col_ind"]),
        vals=torch.from_numpy(np.array(fields["vals"], dtype=np.float32)).to(
            dtype).to(dev),
        shape=(int(shape[0]), int(shape[1])), nnz=int(fields["nnz"]),
    )


def ic0_factors_from_arrays(strict: Dict[str, object],
                            strict_t: Dict[str, object], diag, *,
                            dtype=None, device=None) -> IC0Factors:
    """The port's IC0Factors from a JAX ``IC0Factors``: ``strict`` and
    ``strict_t`` are the fields of its two CSR matrices (as
    :func:`csr_from_arrays` takes them), ``diag`` its diagonal as a numpy
    array. Both packages' fused IC(0) solvers then run the same
    factors."""
    dev = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    return IC0Factors(
        strict=csr_from_arrays(strict, dtype=dtype, device=dev),
        strict_t=csr_from_arrays(strict_t, dtype=dtype, device=dev),
        diag=torch.from_numpy(np.array(diag, dtype=np.float32)).to(dtype).to(
            dev),
    )


def df64_from_arrays(fields: Dict[str, Union[np.ndarray, int]],
                     vals_lo=None, *, device=None):
    """The port's ``SellDf64SpMV`` from a JAX ``SellDf64SpMV``: ``fields``
    are its plan's fields (:func:`plan_fields`), ``vals_lo`` its lo plane
    as a numpy array (``np.asarray(op.vals_lo)``) or None when it has
    none. Both packages then run the same planes."""
    from smvp_toolkit_tpu_torch.ops.spmv_df64 import SellDf64SpMV

    lo = None if vals_lo is None else np.asarray(vals_lo, dtype=np.float32)
    return SellDf64SpMV(plan_from_arrays(fields), vals_lo=lo, device=device)
