"""Plain-PyTorch CSR SpMV (gather + ``index_add_`` segment sum).

Counterpart of the JAX package's ``ops/spmv_xla.py::spmv_csr``. It is the
CLI's explicit ``--kernel torch`` choice and an in-package oracle; the
main path runs the SELL CUDA kernels (``ops.spmv_sell``) instead.
"""

from __future__ import annotations

import torch

from smvp_toolkit_tpu_torch.formats.csr import CSRMatrix, row_ids_from_ptr

__all__ = ["spmv_csr"]


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
