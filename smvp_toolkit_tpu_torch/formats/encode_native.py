"""Host fast path for COO→CSR / COO→TJDS encode (native counting sorts).

Counterpart of the JAX package's ``formats/encode_native.py``. The torch
encoders (``formats/csr.py``, ``formats/tjds.py``) sort on the COO's
device, which is the right shape for a card; on the host a large matrix
pays general comparison sorts. Every encode sort key is a bounded
integer, so ``csrc/encode.cpp`` replaces them with stable counting sorts:
O(nnz + nrows + ncols), the same output order, array for array.

This module only computes permutations and integer side-products; the
format modules apply the permutation to the value tensor (any dtype) and
assemble the dataclasses.

Dispatch rule (``use_native``): the fast path takes a COO whose tensors
lie on the CPU; a COO on the card keeps the torch encoder unless
``SMVP_NATIVE_ENCODE=1`` forces the pull to the host, and
``SMVP_NATIVE_ENCODE=0`` turns the native path off. The library is built
by ``ops/_build.py`` on first use, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np
import torch

__all__ = ["use_native", "host_triplets", "csr_order", "tjds_order"]

_LL = ctypes.c_longlong
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_SIGNATURES = {
    "csr_encode_order": (None, [_I32P, _I32P, _LL, _LL, _LL, _LL, _I64P,
                                _I32P]),
    "tjds_encode_order": (_LL, [_I32P, _I32P, _LL, _LL, _LL, _LL, _LL,
                                _I64P, _I32P, _I32P, _I32P]),
}


def _lib() -> ctypes.CDLL:
    """The library of ``csrc/encode.cpp``, built on first use
    (``KernelBuildError`` when no host compiler is found or it fails)."""
    from smvp_toolkit_tpu_torch.ops import _build

    return _build.load("encode", _SIGNATURES)


def use_native(coo) -> bool:
    """True when the native encoder should handle this COO."""
    mode = os.environ.get("SMVP_NATIVE_ENCODE")
    if mode == "0":
        return False
    return mode == "1" or coo.device.type == "cpu"


def host_triplets(coo) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """(rows, cols) as host int32 arrays and the values as a CPU tensor,
    with the encoders' sentinels forced: padding slots carry ``row ==
    nrows``, ``col == 0``, ``val == 0`` however the COO was built."""
    nnz = coo.nnz
    r = coo.rows.cpu().numpy().astype(np.int32, copy=True)
    c = coo.cols.cpu().numpy().astype(np.int32, copy=True)
    v = coo.vals.cpu().clone()
    r[nnz:] = coo.shape[0]
    c[nnz:] = 0
    v[nnz:] = 0
    return r, c, v


def csr_order(r: np.ndarray, c: np.ndarray, nnz: int, nrows: int,
              ncols: int) -> Tuple[np.ndarray, np.ndarray]:
    """Stable (row, col) sort order (int64) and row_ptr (int32)."""
    npad = int(r.shape[0])
    order = np.empty(npad, dtype=np.int64)
    row_ptr = np.empty(nrows + 1, dtype=np.int32)
    _lib().csr_encode_order(r, c, nnz, npad, nrows, ncols, order, row_ptr)
    return order, row_ptr


def tjds_order(
    r: np.ndarray, c: np.ndarray, nnz: int, nrows: int, ncols: int,
    diag_bound: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """TJDS pack order, offsets, perm, start_pos and num_diags."""
    npad = int(r.shape[0])
    order = np.empty(npad, dtype=np.int64)
    offsets = np.empty(npad, dtype=np.int32)
    perm = np.empty(max(ncols, 1), dtype=np.int32)
    start_pos = np.empty(diag_bound + 1, dtype=np.int32)
    num_diags = _lib().tjds_encode_order(
        r, c, nnz, npad, nrows, ncols, diag_bound, order, offsets, perm,
        start_pos,
    )
    return order, offsets, perm[:ncols], start_pos, int(num_diags)
