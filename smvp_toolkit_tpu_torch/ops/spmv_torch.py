"""Plain-PyTorch CSR and TJDS SpMV (gather + ``index_add_`` segment sum).

Counterpart of the JAX package's ``ops/spmv_xla.py::spmv_csr`` and
``spmv_tjds``. They are the CLI's explicit ``--kernel torch`` choice and
in-package oracles; the main path runs the SELL CUDA kernels
(``ops.spmv_sell``) instead.
"""

from __future__ import annotations

import torch

from smvp_toolkit_tpu_torch.formats.csr import CSRMatrix, row_ids_from_ptr
from smvp_toolkit_tpu_torch.formats.tjds import TJDSMatrix

__all__ = ["spmv_csr", "spmv_tjds"]


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
