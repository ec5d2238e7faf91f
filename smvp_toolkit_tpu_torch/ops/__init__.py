"""SpMV operators: the SELL planner, the CUDA SELL kernels, the plain
PyTorch SpMVs, the native host backend, the algebra ops, the factors and
the fused solves.

The JAX package's ``ops`` exports, where the port has them; loaded
lazily, as the top-level package's are (importing ``ops`` builds no
kernel). One name differs: ``ops.spmv_cisr`` is the module, whose
function is ``ops.spmv_cisr.spmv_cisr`` (a lazy export of the same name
would depend on import order).
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "spmv_coo": "spmv_torch",
    "spmv_csr": "spmv_torch",
    "spmv_csr_cumsum": "spmv_torch",
    "spmv_tjds": "spmv_torch",
    "spmm_csr": "spmv_torch",
    "spmm_tjds": "spmv_torch",
    "CisrSpMV": "spmv_cisr",
    "transpose": "algebra",
    "diagonal": "algebra",
    "row_sums": "algebra",
    "col_sums": "algebra",
    "scale": "algebra",
    "add": "algebra",
    "matmul": "algebra",
    "fused_cg": "cg_fused",
    "ilu0": "ilu",
    "ic0": "ilu",
    "trisolve_neumann": "ilu",
    "ILU0Factors": "ilu",
    "IC0Factors": "ilu",
    "NativeCsrSpMV": "spmv_native",
    "NativeTjdsSpMV": "spmv_native",
    "spmv_csr_native": "spmv_native",
    "spmv_tjds_native": "spmv_native",
    "native_spmv_available": "spmv_native",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
