"""Plain-PyTorch COO, CSR and TJDS SpMV and CSR and TJDS SpMM (gather +
``index_add``), and the scatter-free CSR SpMV by prefix sums.

Counterpart of the JAX package's ``ops/spmv_xla.py`` (``spmv_coo``,
``spmv_csr``, ``spmv_csr_cumsum``, ``spmv_tjds``, ``spmm_csr``,
``spmm_tjds``). They are the CLI's explicit ``--kernel torch`` choice, the
SpMVs of complex matrices (the SELL kernels are real-valued), the default
kernels of ``utils.aot.export_spmv`` and in-package oracles (``spmm_csr``
is the GCN's); the main path runs the SELL CUDA kernels
(``ops.spmv_sell``) instead. All six work on complex64 as on float32.
``spmm_csr`` is differentiable by autograd in X and in the values.
"""

from __future__ import annotations

import torch

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.formats.csr import CSRMatrix
from smvp_toolkit_tpu_torch.formats.tjds import TJDSMatrix

__all__ = ["spmv_coo", "spmv_csr", "spmv_csr_cumsum", "spmv_tjds",
           "spmm_csr", "spmm_tjds"]


def spmv_coo(coo: COOMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A·x from COO triplets (the device oracle).

    Padding entries carry ``row == nrows`` and are dropped; their value is
    0, so their x gather (column 0) is harmless.
    """
    nrows = coo.shape[0]
    products = coo.vals * x[coo.cols.long()]
    y = torch.zeros(nrows + 1, dtype=products.dtype, device=products.device)
    return y.index_add_(0, coo.rows.long(), products)[:nrows]


def spmv_csr(csr: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A·x from CSR: gather x by ``col_ind``, sum products per row.

    Padded entries (beyond ``nnz``) are dropped. The result has the dtype
    of ``vals · x``.
    """
    row_ids = csr.with_row_ids().row_ids
    n = csr.nnz
    products = csr.vals[:n] * x[csr.col_ind[:n].long()]
    y = torch.zeros(csr.nrows, dtype=products.dtype, device=products.device)
    return y.index_add_(0, row_ids[:n].long(), products)


def spmv_csr_cumsum(csr: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A·x from CSR by the prefix-difference form (no scatter).

    ``y[r] = P[row_ptr[r+1]] − P[row_ptr[r]]``, P the exclusive prefix sum
    (``torch.cumsum`` with a leading 0) of the per-entry products: one
    scan and two gathers. Each row's sum carries the rounding of the
    global prefix, so its error scales with the prefix's magnitude, not
    the row's (the usual float32 cumsum caveat, as in JAX).
    """
    products = csr.vals * x[csr.col_ind.long()]
    prefix = torch.cat([products.new_zeros(1), torch.cumsum(products, 0)])
    ptr = csr.row_ptr.long()
    return prefix[ptr[1:]] - prefix[ptr[:-1]]


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
    row_ids = csr.with_row_ids().row_ids
    n = csr.nnz
    products = csr.vals[:n, None] * X[csr.col_ind[:n].long()]
    Y = torch.zeros(csr.nrows, X.shape[1], dtype=products.dtype,
                    device=products.device)
    return Y.index_add(0, row_ids[:n].long(), products)


def spmm_tjds(tjds: TJDSMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A·X from TJDS for a dense block X (ncols, k): X's rows permuted
    once, read by position within each jagged diagonal, summed per
    ``row_ind``. Padded entries (beyond ``nnz``) are dropped."""
    n = tjds.nnz
    Xp = X[tjds.perm.long()]
    products = tjds.vals[:n, None] * Xp[tjds.offsets[:n].long()]
    Y = torch.zeros(tjds.nrows, X.shape[1], dtype=products.dtype,
                    device=products.device)
    return Y.index_add_(0, tjds.row_ind[:n].long(), products)
