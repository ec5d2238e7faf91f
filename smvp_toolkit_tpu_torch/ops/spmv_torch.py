"""Plain-PyTorch CSR and TJDS SpMV and CSR SpMM (gather + ``index_add``).

Counterpart of the JAX package's ``ops/spmv_xla.py::spmv_csr``,
``spmv_tjds`` and ``spmm_csr``. They are the CLI's explicit ``--kernel
torch`` choice and in-package oracles (``spmm_csr`` is the GCN's); the
main path runs the SELL CUDA kernels (``ops.spmv_sell``) instead.
``spmm_csr`` is differentiable by autograd in X and in the values.
"""

from __future__ import annotations

import torch

from smvp_toolkit_tpu_torch.formats.csr import CSRMatrix, row_ids_from_ptr
from smvp_toolkit_tpu_torch.formats.tjds import TJDSMatrix

__all__ = ["spmv_csr", "spmv_tjds", "spmm_csr"]


def spmv_csr(csr: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A·x from CSR: gather x by ``col_ind``, sum products per row.

    Padded entries (beyond ``nnz``) are dropped. The result has the dtype
    of ``vals · x``.
    """
    row_ids = csr.row_ids if csr.row_ids is not None else row_ids_from_ptr(csr)
    n = csr.nnz
    products = csr.vals[:n] * x[csr.col_ind[:n].long()]
    y = torch.zeros(csr.nrows, dtype=products.dtype, device=products.device)
    return y.index_add_(0, row_ids[:n].long(), products)


def spmv_tjds(tjds: TJDSMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A·x from TJDS: x permuted once, read by position within each
    jagged diagonal (``offsets``), products summed per ``row_ind``.

    Padded entries (beyond ``nnz``) are dropped. The result has the dtype
    of ``vals · x``.
    """
    n = tjds.nnz
    xp = x[tjds.perm.long()]
    products = tjds.vals[:n] * xp[tjds.offsets[:n].long()]
    y = torch.zeros(tjds.nrows, dtype=products.dtype, device=products.device)
    return y.index_add_(0, tjds.row_ind[:n].long(), products)


def spmm_csr(csr: CSRMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A·X for a dense block X (ncols, k): gather X's rows by
    ``col_ind``, scale by the values, sum per row. Padded entries (beyond
    ``nnz``) are dropped, so their values get no gradient. The result has
    the dtype of ``vals · X``."""
    row_ids = csr.row_ids if csr.row_ids is not None else row_ids_from_ptr(csr)
    n = csr.nnz
    products = csr.vals[:n, None] * X[csr.col_ind[:n].long()]
    Y = torch.zeros(csr.nrows, X.shape[1], dtype=products.dtype,
                    device=products.device)
    return Y.index_add(0, row_ids[:n].long(), products)
