"""Sparse algebra on COO triplets.

Counterpart of the JAX package's ``ops/algebra.py``, for the part the
solvers use: :func:`diagonal`, the Jacobi-preconditioned CG's input
(``pcg(csr, b, diagonal(coo))``). Padding entries (``row == nrows``,
``val == 0``) drop out by their sentinel row, as in the JAX package.
"""

from __future__ import annotations

import torch

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix

__all__ = ["diagonal"]


def diagonal(coo: COOMatrix) -> torch.Tensor:
    """Main diagonal as a dense vector (duplicates summed), in the COO's
    value dtype and on its device."""
    n = min(coo.shape)
    rows, cols = coo.rows.long(), coo.cols.long()
    on_diag = (rows == cols) & (rows < n)
    vals = torch.where(on_diag, coo.vals, torch.zeros((), dtype=coo.dtype,
                                                      device=coo.device))
    idx = torch.where(on_diag, rows, n)
    out = torch.zeros(n + 1, dtype=coo.dtype, device=coo.device)
    return out.index_add_(0, idx, vals)[:n]
