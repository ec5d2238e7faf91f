"""Format-independent bytes of the work a cell asks for.

Each input is counted as read once and each output as written once,
whatever layout or padding the port moves: these counts stay the same
whatever a later change does to the format, so a roofline share on them
cannot rise by moving padding. Indices are 4 bytes (CSR: column index per
nonzero, row pointer per row and one more). The solver state is float32.
"""

from __future__ import annotations

INDEX_BYTES = 4
STATE_BYTES = 4


def spmv_bytes(nnz: int, nrows: int, ncols: int, value_bytes: int = 4) -> int:
    """y = A·x: the values and column indices, the row pointer, x read
    once, y written once."""
    return (nnz * (value_bytes + INDEX_BYTES) + (nrows + 1) * INDEX_BYTES
            + ncols * value_bytes + nrows * value_bytes)


def cg_step_bytes(nnz: int, n: int, value_bytes: int = 4) -> int:
    """One CG step: q = A·p (p read, q written in the SpMV), then q read
    once, x and r read and written once, p written once."""
    return spmv_bytes(nnz, n, n, value_bytes) + 6 * n * STATE_BYTES


def pcg_ic0_step_bytes(nnz: int, n: int, nnz_strict: int, sweeps: int,
                       value_bytes: int = 4) -> int:
    """One IC(0)-preconditioned CG step with ``sweeps`` truncated-Neumann
    sweeps per triangle: the SpMV with A, (sweeps − 1) SpMVs with the
    strict lower factor and as many with its transpose (``nnz_strict``
    entries each), and beyond those SpMVs x, r, p, q, z and 1/diag(L)
    read once, x, r, p and z written once."""
    spmvs = (spmv_bytes(nnz, n, n, value_bytes)
             + 2 * (sweeps - 1) * spmv_bytes(nnz_strict, n, n, value_bytes))
    return spmvs + 10 * n * STATE_BYTES
