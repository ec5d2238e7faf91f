"""Extended-precision SpMV: double-float (float32-pair) arithmetic.

Counterpart of the JAX package's ``ops/precision.py``. A value is the
unevaluated sum ``hi + lo`` of two float32s (``df_split``, ``df_to_f64``).
The error-free transformations ``two_sum``, ``two_prod`` (Dekker with a
Veltkamp split, no FMA) and the compensated ``_df_add`` give the same
bits as the JAX functions on float32 tensors: every torch operation here
is its own rounding, so nothing contracts into an FMA.

``spmv_csr_df64`` is plain PyTorch (the JAX function is XLA code, not a
Pallas kernel): the products and row sums are taken in float64 and the
row sums split into the float32 pair. That is at least as accurate as
the JAX compensated prefix scan, whose error is about 2^-48 of the
*prefix* magnitude at the row's end rather than of the row's own sum.
The double-float SELL kernel is ``ops/spmv_df64.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.csr import CSRMatrix
from smvp_toolkit_tpu_torch.utils.device import resolve_device

__all__ = [
    "two_sum",
    "two_prod",
    "df_split",
    "df_to_f64",
    "spmv_csr_df64",
]

_SPLITTER = 4097.0  # 2^12 + 1 (Veltkamp split for float32)

Pair = Tuple[torch.Tensor, torch.Tensor]


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Error-free sum: a + b = s + e exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _veltkamp(a: torch.Tensor) -> Pair:
    c = a * _SPLITTER
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Error-free product: a * b = p + e exactly (Dekker, FMA-free)."""
    p = a * b
    ah, al = _veltkamp(a)
    bh, bl = _veltkamp(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _df_add(a: Pair, b: Pair) -> Pair:
    """Compensated (hi, lo) + (hi, lo) with renormalization."""
    a_hi, a_lo = a
    b_hi, b_lo = b
    s, e = two_sum(a_hi, b_hi)
    e = e + (a_lo + b_lo)
    return two_sum(s, e)


def df_split(x64, device=None) -> Pair:
    """Split float64 values into (hi, lo) float32 pairs.

    A tensor is split on its own device; anything else (a numpy array, a
    list) is taken as host float64 and the pair goes to ``device`` (the
    card unless ``"cpu"`` is asked for).
    """
    if isinstance(x64, torch.Tensor):
        x = x64.double()
    else:
        x = torch.from_numpy(np.asarray(x64, dtype=np.float64)).to(
            resolve_device(device))
    hi = x.float()
    lo = (x - hi.double()).float()
    return hi, lo


def df_to_f64(hi, lo) -> np.ndarray:
    """Combine a double-float result into host numpy float64."""
    def host(t):
        if isinstance(t, torch.Tensor):
            return t.detach().double().cpu().numpy()
        return np.asarray(t, dtype=np.float64)

    return host(hi) + host(lo)


def spmv_csr_df64(csr: CSRMatrix, x_hi: torch.Tensor, x_lo: torch.Tensor,
                  vals_lo: Optional[torch.Tensor] = None) -> Pair:
    """y = A·x in double-float: returns (y_hi, y_lo), float32 each.

    ``vals_lo`` optionally carries the low words of float64 matrix values
    (from :func:`df_split`, aligned with ``csr.vals``); stored float32
    values pass ``None``. Each product ``(v_hi + v_lo)·(x_hi + x_lo)``
    and each row sum is taken in float64; padded entries (beyond ``nnz``)
    are dropped.
    """
    n = csr.nnz
    col = csr.col_ind[:n].long()
    x = x_hi.double() + x_lo.double()
    v = csr.vals[:n].double()
    if vals_lo is not None:
        v = v + vals_lo[:n].double()
    row_ids = csr.with_row_ids().row_ids
    y = torch.zeros(csr.nrows, dtype=torch.float64, device=x.device)
    y.index_add_(0, row_ids[:n].long(), v * x[col])
    hi = y.float()
    return hi, (y - hi.double()).float()
