"""Sparse algebra on COO triplets.

Counterpart of the JAX package's ``ops/algebra.py``: :func:`diagonal`
(the Jacobi-preconditioned CG's input, ``pcg(csr, b, diagonal(coo))``),
:func:`row_sums` and :func:`col_sums` (degree vectors), :func:`transpose`,
:func:`scale`, :func:`add` and :func:`matmul` (SpGEMM, on the host with
scipy, as in the JAX package: the product's pattern is data-dependent).
Padding entries (``row == nrows``, ``val == 0``) drop out by their sentinel
row, as in the JAX package, and the typecode rules are the JAX ones:
:func:`transpose` drops a symmetry claim, :func:`add` expands operands
whose symmetries differ, :func:`matmul` expands one-triangle operands.
The results live on the input's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix

__all__ = [
    "transpose",
    "diagonal",
    "row_sums",
    "col_sums",
    "scale",
    "add",
    "matmul",
]


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Σ vals per index in [0, n); indices ≥ n (padding) drop out."""
    out = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, torch.clamp(idx.long(), max=n), vals)[:n]


def diagonal(coo: COOMatrix) -> torch.Tensor:
    """Main diagonal as a dense vector (duplicates summed), in the COO's
    value dtype and on its device."""
    n = min(coo.shape)
    rows, cols = coo.rows.long(), coo.cols.long()
    on_diag = (rows == cols) & (rows < n)
    vals = torch.where(on_diag, coo.vals, torch.zeros((), dtype=coo.dtype,
                                                      device=coo.device))
    return _segment_sum(vals, torch.where(on_diag, rows, n), n)


def row_sums(coo: COOMatrix) -> torch.Tensor:
    """Σ_j A[i, j] per row (padding rows drop via the sentinel)."""
    return _segment_sum(coo.vals, coo.rows, coo.shape[0])


def col_sums(coo: COOMatrix) -> torch.Tensor:
    """Σ_i A[i, j] per column (padding values are 0; their column is
    clipped into range, as in the JAX package)."""
    live = coo.rows.long() < coo.shape[0]
    vals = torch.where(live, coo.vals, torch.zeros((), dtype=coo.dtype,
                                                   device=coo.device))
    cols = torch.clamp(coo.cols.long(), max=coo.shape[1] - 1)
    return _segment_sum(vals, cols, coo.shape[1])


def transpose(coo: COOMatrix) -> COOMatrix:
    """Aᵀ as a new COO (entries re-sorted row-major by a stable sort,
    padding kept last). A non-general symmetry claim is dropped:
    transposing flips which triangle is stored."""
    live = coo.rows.long() < coo.shape[0]
    r = torch.where(live, coo.cols.long(), coo.shape[1])
    c = torch.where(live, coo.rows.long(), 0)
    order = torch.sort(r * max(coo.shape[0], 1) + c, stable=True).indices
    tc = coo.typecode
    if tc.symmetry != "general":
        tc = dataclasses.replace(tc, symmetry="general")
    return dataclasses.replace(
        coo,
        rows=r[order].to(torch.int32),
        cols=c[order].to(torch.int32),
        vals=coo.vals[order],
        shape=(coo.shape[1], coo.shape[0]),
        typecode=tc,
    )


def scale(coo: COOMatrix, alpha) -> COOMatrix:
    """alpha · A (padding zeros stay zero)."""
    return dataclasses.replace(coo, vals=coo.vals * alpha)


def _as_general(m: COOMatrix) -> COOMatrix:
    """Full (mirrored) storage of a one-triangle operand, typed general."""
    if m.typecode.is_general:
        return m
    r, c, v = m._export_triplets()
    return COOMatrix.from_numpy(
        r, c, v, shape=m.shape, dtype=m.dtype,
        pad_to=max(128, m.rows.shape[0]), device=m.device,
    )


def matmul(a: COOMatrix, b: COOMatrix, *, pad_to: int = 128) -> COOMatrix:
    """A @ B as a new sparse COO (SpGEMM), formed on the host by scipy's
    CSR product: the output's pattern is data-dependent, so, as SELL
    planning, this is encode-time work. One-triangle operands are expanded
    first. The product is float32 (complex64 for complex operands), on
    A's device."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(
            f"inner dimensions differ: {a.shape} @ {b.shape}"
        )
    out = (a.to_scipy().tocsr() @ b.to_scipy().tocsr()).tocoo()
    dtype = (torch.complex64 if np.iscomplexobj(out.data)
             else torch.float32)
    return COOMatrix.from_numpy(out.row, out.col, out.data, shape=out.shape,
                                dtype=dtype, pad_to=pad_to, device=a.device)


def add(a: COOMatrix, b: COOMatrix, beta=1.0) -> COOMatrix:
    """A + beta·B as a concatenated COO (duplicates kept, summed on use).

    Both operands must share the shape. Operands whose symmetries differ
    (or a hermitian A with a complex ``beta``) are expanded to full general
    storage first; operands of one symmetry keep one-triangle storage. The
    result holds both operands' true entries and no padding.
    """
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    sym_a, sym_b = a.typecode.symmetry, b.typecode.symmetry
    hermitian_break = sym_a == "hermitian" and np.iscomplexobj(beta)
    if sym_a != sym_b or hermitian_break:
        a, b = _as_general(a), _as_general(b)
    return dataclasses.replace(
        a,
        rows=torch.cat([a.rows[: a.nnz], b.rows[: b.nnz]]),
        cols=torch.cat([a.cols[: a.nnz], b.cols[: b.nnz]]),
        vals=torch.cat([a.vals[: a.nnz], b.vals[: b.nnz] * beta]),
        nnz=a.nnz + b.nnz,
    )
